"""The port's SegmentationAutoencoder held against the JAX package's, with
identical weights and BatchNorm statistics carried across by
`models.convert.from_jax_variables`, at the JAX demo width (base 8)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmentation_tpu.models import SegmentationAutoencoder as JaxAE
from image_segmentation_tpu.models.layers import center_crop_to as jax_center_crop_to
from image_segmentation_tpu_torch.config import AUTOENCODER, build_model
from image_segmentation_tpu_torch.models.autoencoder import SegmentationAutoencoder
from image_segmentation_tpu_torch.models.convert import from_jax_variables
from image_segmentation_tpu_torch.models.layers import center_crop_to

torch.set_num_threads(1)

BASE = 8
# f32 on both sides, eight conv layers deep, logits of magnitude ~1: the
# same sums in another order. The largest difference seen is about 1e-6.
ATOL = 2e-5


def _pixels(hw, n=2, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n,) + hw + (3,)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_ae():
    """A JAX SegmentationAutoencoder(base=8) whose BN statistics come from
    a train-mode apply, so they are not 0 and 1."""
    model = JaxAE(num_classes=4, base=BASE)
    x = jnp.asarray(_pixels((64, 64)))
    v = model.init(jax.random.PRNGKey(0), x, train=False)
    _, mut = model.apply(v, x, train=True, mutable=["batch_stats"])
    v = jax.tree_util.tree_map(np.asarray, {"params": v["params"],
                                            "batch_stats": mut["batch_stats"]})
    return model, v


def _port(variables):
    port = SegmentationAutoencoder(base=BASE)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return port.to(memory_format=torch.channels_last).eval()


@pytest.mark.parametrize("hw,out_hw", [((64, 64), (64, 64)), ((60, 60), (56, 56)),
                                       ((48, 72), (48, 72))])
def test_autoencoder_eval_forward_matches_jax(jax_ae, hw, out_hw):
    """f32 NHWC logits against the JAX eval forward, atol 2e-5. At 60 px
    the pooled sizes are 30, 15, 7, so every decoder block centre-crops
    its skip (15→14, 30→28, 60→56)."""
    model, variables = jax_ae
    x = _pixels(hw, seed=1)
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = _port(variables)(torch.from_numpy(x))
    assert got.shape == want.shape == (2,) + out_hw + (4,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("shape,target", [((2, 15, 15, 3), (14, 14)), ((1, 30, 31, 2), (28, 28)),
                                          ((1, 8, 9, 1), (8, 9))])
def test_center_crop_matches_jax(shape, target):
    """The NCHW crop of the port takes the pixels the NHWC crop of the JAX
    package takes; an upsample larger than its skip raises in both."""
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = np.asarray(jax_center_crop_to(jnp.asarray(x), target))
    got = center_crop_to(torch.from_numpy(x).permute(0, 3, 1, 2), target).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="larger than skip"):
        center_crop_to(torch.zeros(1, 1, 4, 4), (5, 4))


def test_full_width_autoencoder_has_the_jax_parameters():
    """base=64 (the served width): every JAX parameter and BN statistic
    has its counterpart of the same size."""
    shapes = jax.eval_shape(JaxAE(num_classes=4).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))
    leaves = jax.tree_util.tree_leaves(shapes)
    sd = SegmentationAutoencoder().state_dict()
    assert sum(a.size for a in leaves) == sum(t.numel() for t in sd.values())
    assert len(leaves) == len(sd)


def test_build_model_autoencoder_is_seeded_f32_on_cpu():
    make = lambda: build_model(AUTOENCODER, "cpu", torch.Generator().manual_seed(3), base=BASE)
    a, b = make(), make()
    assert a.dtype == torch.float32 and not a.training
    for k, v in a.state_dict().items():
        torch.testing.assert_close(v, b.state_dict()[k], rtol=0, atol=0)
    w = a.state_dict()["decoder.decoderBlock1.conv1.conv.weight"]  # cat of 2b + 4b
    bound = (6 / (9 * 6 * BASE)) ** 0.5
    assert 0.9 * bound < w.abs().max().item() <= bound
    assert "decoder.decoderBlock1.conv1.conv.bias" not in a.state_dict()  # bias-free
