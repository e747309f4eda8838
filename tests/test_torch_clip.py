"""The port's ClipViT and ClipUNet held against the JAX package's, with
identical weights carried across by `models.convert.from_jax_variables`.

The config is small but keeps hidden 128 and MLP 256: any width that is
not a multiple of 128 sends the JAX side down its XLA MLP path
(clip_vit.py:161), and the test would then hold nothing against K4. The
JAX side runs its Pallas kernels in interpret mode (use_pallas on CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmentation_tpu.models.clip_unet import ClipUNet as JaxClipUNet
from image_segmentation_tpu.models.clip_vit import ClipViT as JaxClipViT
from image_segmentation_tpu.models.clip_vit import ClipViTConfig as JaxViTConfig
from image_segmentation_tpu_torch.models.clip_unet import ClipUNet, resize_linear
from image_segmentation_tpu_torch.models.clip_vit import ClipViT, ClipViTConfig
from image_segmentation_tpu_torch.models.convert import from_jax_variables

torch.set_num_threads(1)

VIT = dict(image_size=32, patch_size=16, hidden_size=128, num_layers=3,
           num_heads=2, mlp_dim=256)
UNET = dict(num_classes=4, skip_indices=(0, 1, 2, 3),
            decoder_channels=(32, 16, 8, 8, 8))


def _pixels(n=2, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, 32, 32, 3)).astype(np.float32)


def _randomize(tree, rng, scale=0.2):
    """Replace every leaf with seeded noise (embeddings and biases that
    init leaves at zero would hide a mapping bug)."""
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.normal(size=a.shape)).astype(np.float32), tree)


def _jax_clip_unet_variables(seed=0):
    model = JaxClipUNet(vit=JaxViTConfig(**VIT), use_pallas_attention=True, **UNET)
    x = jnp.asarray(_pixels())
    v = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(seed), x))
    rng = np.random.default_rng(seed)
    params = _randomize(v["params"], rng, scale=0.05)
    # non-trivial running statistics: init (mean 0, var 1) hides BN bugs
    def stats(bn):
        c = bn["mean"].shape
        return {"mean": (0.5 * rng.normal(size=c)).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}

    batch_stats = {
        blk: {cbr: {"BatchNorm_0": stats(d["BatchNorm_0"])} for cbr, d in blocks.items()}
        for blk, blocks in v["batch_stats"].items()
    }
    return model, {"params": params, "batch_stats": batch_stats}


def test_vit_matches_jax():
    """Last hidden state and every hidden state, f32, atol 1e-4."""
    model = JaxClipViT(JaxViTConfig(**VIT), use_pallas=True)
    x = _pixels()
    v = jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    v = {"params": _randomize(v["params"], np.random.default_rng(1), scale=0.05)}
    want_last, want_hidden = model.apply(v, jnp.asarray(x))

    port = ClipViT(ClipViTConfig(**VIT), use_kernels=True)
    port.load_state_dict(from_jax_variables(v), strict=True)
    with torch.no_grad():
        last, hidden = port(torch.from_numpy(x))
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last), atol=1e-4)
    assert len(hidden) == len(want_hidden) == VIT["num_layers"] + 1
    for got, want in zip(hidden, want_hidden):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_clip_unet_eval_forward_matches_jax():
    """Whole eval forward, f32 logits, atol 1e-3 (3 ViT blocks + 4 decoder
    blocks of accumulated sum-order differences)."""
    model, variables = _jax_clip_unet_variables()
    x = _pixels()
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))

    port = ClipUNet(vit=ClipViTConfig(**VIT), use_kernels=True, **UNET)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    port = port.to(memory_format=torch.channels_last).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 32, 32, 4)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


@pytest.mark.parametrize("out", [28, 56, 112, 224])
def test_skip_resize_matches_jax_image_resize(out):
    """The decoder's skip upsampling from the 14×14 ViT-B/16 grid
    (clip_unet.py:59-64), f32, atol 1e-5."""
    x = np.random.default_rng(out).normal(size=(1, 14, 14, 8)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (1, out, out, 8), method="linear")
    got = resize_linear(torch.from_numpy(x).permute(0, 3, 1, 2), (out, out))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-5)


def test_init_is_seeded_and_uses_jax_distributions():
    """Same generator seed → same weights; spreads follow flax's
    initialisers (LeCun-normal dense, Kaiming-uniform decoder convs)."""
    make = lambda: ClipUNet(vit=ClipViTConfig(**VIT), **UNET).init_weights(
        torch.Generator().manual_seed(3))
    a, b = make().state_dict(), make().state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    fc1 = a["vision_model.encoder.layers.0.mlp.fc1.weight"]
    assert abs(fc1.std().item() - (1 / 128) ** 0.5) < 0.01
    conv = a["dec.0.conv1.conv.weight"]  # fan_in 3·3·32
    bound = (6 / (9 * 32)) ** 0.5
    assert conv.abs().max().item() <= bound and conv.abs().max().item() > 0.9 * bound
