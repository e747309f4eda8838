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
