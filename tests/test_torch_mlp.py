"""K4 in the PyTorch port: the plain version, the CPU routing of
`fused_mlp`, and the ViT block's routing rule, held against the JAX
package's Pallas kernel run in interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmentation_tpu.ops.pallas import mlp as jax_mlp
from image_segmentation_tpu_torch.ops.kernels import mlp as K4

torch.set_num_threads(1)


def _args(b=2, s=197, h=128, f=256, seed=0):
    """Arguments in the JAX layout: kernels (in, out)."""
    rng = np.random.default_rng(seed)
    return [
        (rng.normal(size=(b, s, h)) * 0.5).astype(np.float32),
        rng.normal(size=(h,)).astype(np.float32),
        rng.normal(size=(h,)).astype(np.float32),
        (rng.normal(size=(h, f)) * 0.05).astype(np.float32),
        rng.normal(size=(f,)).astype(np.float32),
        (rng.normal(size=(f, h)) * 0.05).astype(np.float32),
        rng.normal(size=(h,)).astype(np.float32),
    ]


def _torch_args(args):
    """JAX layout → the port's nn.Linear layout (w1 (F, H), w2 (H, F))."""
    x, lw, lb, w1, b1, w2, b2 = (torch.from_numpy(a) for a in args)
    return x, lw, lb, w1.t().contiguous(), b1, w2.t().contiguous(), b2


@pytest.mark.parametrize("b,s", [(2, 197), (1, 131)])
def test_plain_version_matches_jax_kernel(b, s):
    """f32, atol 2e-5 (sum order only). S=131 is not a multiple of the
    JAX kernel's 128-token tile, so its padded rows must not leak."""
    args = _args(b=b, s=s)
    want = jax_mlp.fused_mlp(*(jnp.asarray(a) for a in args), 1e-5, True)
    got = K4.mlp_reference(*_torch_args(args), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    targs = _torch_args(_args(b=1, s=7))
    before = K4.LAUNCHES
    got = K4.fused_mlp(*targs, 1e-5)
    assert K4.LAUNCHES == before
    torch.testing.assert_close(got, K4.mlp_reference(*targs, 1e-5), rtol=0, atol=0)


def test_h64_routes_to_plain_mlp_in_both_packages(monkeypatch):
    """Hidden 64 is not a multiple of 128: neither package may call its
    fused MLP, even with the kernels switched on (clip_vit.py:161)."""
    from image_segmentation_tpu.models import clip_vit as jax_vit
    from image_segmentation_tpu_torch.models import clip_vit as port_vit

    calls = []

    def spy(*a, **k):
        calls.append(1)
        raise AssertionError("fused MLP called at H=64")

    monkeypatch.setattr(jax_mlp, "fused_mlp", spy)
    monkeypatch.setattr(port_vit, "fused_mlp", spy)
    cfg_j = jax_vit.ClipViTConfig(image_size=32, patch_size=16, hidden_size=64,
                                  num_layers=1, num_heads=1, mlp_dim=128)
    x = jnp.zeros((1, 32, 32, 3))
    m = jax_vit.ClipViT(cfg_j, use_pallas=True)
    m.apply(m.init(jax.random.PRNGKey(0), x), x)

    cfg_p = port_vit.ClipViTConfig(image_size=32, patch_size=16, hidden_size=64,
                                   num_layers=1, num_heads=1, mlp_dim=128)
    vit = port_vit.ClipViT(cfg_p, use_kernels=True)
    assert not vit.encoder.layers[0].fuse_mlp
    vit(torch.zeros(1, 32, 32, 3))
    assert calls == []

    wide = port_vit.ClipViT(port_vit.ClipViTConfig(
        image_size=32, patch_size=16, hidden_size=128, num_layers=1,
        num_heads=2, mlp_dim=256), use_kernels=True)
    assert wide.encoder.layers[0].fuse_mlp


def test_wrapper_rejects_other_devices():
    args = [t.to("meta") for t in _torch_args(_args(b=1, s=3))]
    with pytest.raises(ValueError, match="cpu or cuda"):
        K4.fused_mlp(*args)


@pytest.mark.parametrize("tokens,fdim", [(1, 3072), (197, 3072), (333, 3072),
                                         (1576, 3072), (6304, 3072), (131, 256)])
def test_f_splits_cover_f_once(tokens, fdim):
    """The CUDA grid's F splits: every F slice in exactly one split, no
    empty split, and about one block per SM when tokens are few."""
    splits, per = K4.f_splits(tokens, fdim, sms=132)
    steps = fdim // K4.F_SLICE
    assert (splits - 1) * per < steps <= splits * per
    tiles = -(-tokens // K4.TOKEN_TILE)
    assert tiles * splits < 132 + tiles
    if tiles >= 132:
        assert splits == 1
