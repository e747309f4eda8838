"""The port's UNet held against the JAX package's, with identical weights
and BatchNorm statistics carried across by `models.convert.from_jax_variables`:
the module path and the fused path (K1 nine times, BN folded; the plain
K1 on the CPU) both against the JAX `UNet.apply(train=False)`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmentation_tpu.models import UNet as JaxUNet
from image_segmentation_tpu_torch.config import UNET_NOAUG, build_model
from image_segmentation_tpu_torch.models.convert import from_jax_variables
from image_segmentation_tpu_torch.models.unet import UNet

torch.set_num_threads(1)

BASE = 8
# f32 on both sides, ten double convs deep, logits of magnitude ~1: the
# same sums in another order, with BN applied (module path) or folded
# (fused path). The largest difference seen is 2.1e-6.
ATOL = 2e-5


def _pixels(n=2, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, 64, 64, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_unet():
    """A JAX UNet(base=8) whose BN statistics come from a train-mode
    apply (as tests/test_pallas.py:190-193), so they are not 0 and 1."""
    model = JaxUNet(num_classes=4, base=BASE)
    x = jnp.asarray(_pixels())
    v = model.init(jax.random.PRNGKey(0), x, train=False)
    _, mut = model.apply(v, x, train=True, mutable=["batch_stats"])
    v = jax.tree_util.tree_map(np.asarray, {"params": v["params"],
                                            "batch_stats": mut["batch_stats"]})
    return model, v


def _port(variables, **kw):
    port = UNet(base=BASE, **kw)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return port.to(memory_format=torch.channels_last).eval()


@pytest.mark.parametrize("use_kernels", [False, True])
def test_unet_eval_forward_matches_jax(jax_unet, use_kernels):
    """Module path (use_kernels=False) and fused path (True) against the
    JAX eval forward; f32 NHWC logits, atol 2e-5."""
    model, variables = jax_unet
    x = _pixels(seed=1)
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    port = _port(variables, use_kernels=use_kernels)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 64, 64, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_full_width_unet_has_the_jax_parameters():
    """base=64 (the served width): every JAX parameter and BN statistic
    has its counterpart of the same size (31,043,716 parameters)."""
    shapes = jax.eval_shape(JaxUNet(num_classes=4).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))
    leaves = jax.tree_util.tree_leaves(shapes)
    sd = UNet().state_dict()
    assert sum(a.size for a in leaves) == sum(t.numel() for t in sd.values())
    assert len(leaves) == len(sd)
    assert sum(p.numel() for p in UNet().parameters()) == 31_043_716


def test_build_model_unet_is_seeded_and_uses_jax_distributions():
    """build_model(UNET_NOAUG) on the CPU: f32, plain versions, same seed →
    same weights; convs and transpose convs Kaiming-uniform over fan_in."""
    make = lambda: build_model(UNET_NOAUG, "cpu", torch.Generator().manual_seed(3), base=BASE)
    a, b = make(), make()
    assert a.dtype == torch.float32 and not a.use_kernels and not a.training
    sa, sb = a.state_dict(), b.state_dict()
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0)
    for key, fan_in in (("up1.conv.conv1.conv.weight", 9 * 16 * BASE),  # cat of 8b + 8b
                        ("up1.up.up.weight", 4 * 16 * BASE),  # (I, O, kH, kW), fan_in kH·kW·I
                        ("down1.conv1.conv.weight", 9 * 3)):
        bound = (6 / fan_in) ** 0.5
        m = sa[key].abs().max().item()
        assert 0.9 * bound < m <= bound, (key, m, bound)
    assert sa["up1.conv.conv1.conv.bias"].abs().max().item() == 0.0


# Train mode. Tolerances: the running statistics are means over batch and
# pixels of f32 conv outputs, sums in another order: 1e-5 absolute (flax's
# update, ra = 0.9·ra + 0.1·batch, biased variance, on both sides). The
# train-mode logits: each BN divides by its batch std, and the deepest
# level has 32 samples a channel (2 images of 4×4 px), which amplifies the
# f32 rounding of the conv sums (another order in each package; flax also
# takes the variance as E[x²] − E[x]²): 2e-4, the largest seen 9.0e-5.
STATS_ATOL = 1e-5
TRAIN_ATOL = 2e-4


def test_batchnorm_train_mode_matches_flax():
    """The port's BatchNorm in train mode normalises with the batch's mean
    and biased variance and moves the running statistics as flax does."""
    import flax.linen as fnn

    from image_segmentation_tpu_torch.models.layers import BatchNorm

    x = np.random.default_rng(2).normal(1.5, 2.0, (3, 5, 6, 7)).astype(np.float32)  # NHWC
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": {"scale": jnp.linspace(0.5, 1.5, 7), "bias": jnp.linspace(-1, 1, 7)},
         "batch_stats": {"mean": jnp.full((7,), 0.3), "var": jnp.full((7,), 2.0)}}
    want, mut = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    port = BatchNorm(7)
    with torch.no_grad():
        port.weight.copy_(torch.linspace(0.5, 1.5, 7))
        port.bias.copy_(torch.linspace(-1, 1, 7))
        port.running_mean.fill_(0.3)
        port.running_var.fill_(2.0)
    got = port.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=ATOL)
    biased = x.reshape(-1, 7).var(axis=0)  # numpy's default ddof=0
    np.testing.assert_allclose(port.running_var.numpy(), 0.9 * 2.0 + 0.1 * biased,
                               atol=STATS_ATOL)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]), atol=STATS_ATOL)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]), atol=STATS_ATOL)


def test_train_mode_unet_matches_jax(jax_unet):
    """Logits and every updated running mean and (biased) variance against
    `apply(train=True, mutable=['batch_stats'])`."""
    model, variables = jax_unet
    x = _pixels(seed=3)
    want, mut = model.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    port = _port(variables).train()
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TRAIN_ATOL)
    want_sd = from_jax_variables({"params": variables["params"],
                                  "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                                        mut["batch_stats"])})
    sd = port.state_dict()
    keys = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 36  # 18 BatchNorms
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), want_sd[k].numpy(), atol=STATS_ATOL,
                                   err_msg=k)


def test_kernel_unet_trains_on_the_module_path(jax_unet, monkeypatch):
    """A UNet built with kernels takes the module path in train mode and
    whenever autograd records, and gets the module path's gradients and
    statistics; K1's forward runs only in eval mode without autograd."""
    from image_segmentation_tpu_torch.models import unet as unet_module

    calls = []
    real = unet_module.fused_unet_forward
    monkeypatch.setattr(unet_module, "fused_unet_forward",
                        lambda m, x: calls.append(1) or real(m, x))
    _, variables = jax_unet
    x = torch.from_numpy(_pixels(seed=4))
    a, b = _port(variables, use_kernels=True).train(), _port(variables).train()
    out_a, out_b = a(x), b(x)
    torch.testing.assert_close(out_a, out_b, rtol=0, atol=0)
    out_a.square().mean().backward()
    out_b.square().mean().backward()
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert pa.grad is not None, name
        torch.testing.assert_close(pa.grad, pb.grad, rtol=0, atol=0)
    for (name, ta), tb in zip(a.named_buffers(), b.buffers()):
        torch.testing.assert_close(ta, tb, rtol=0, atol=0)
    assert not calls
    a.eval()
    a(x).sum().backward()  # eval mode with autograd: still the module path
    assert not calls
    with torch.no_grad():
        a(x)
    assert calls == [1]
