"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA card and nvcc; elsewhere they skip. The
file imports no jax (the machine with the card has none), so run it
without the jax-forcing conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: two bf16 steps of the output's largest magnitude. Kernel and
plain version round at the same points and sum in another order, so an
output, or an intermediate it depends on, can land one step apart.
"""
import numpy as np
import pytest
import torch

from image_segmentation_tpu_torch.ops.kernels import attention as K3
from image_segmentation_tpu_torch.ops.kernels import mlp as K4

pytestmark = pytest.mark.cuda

REL_TOL = 2.0**-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= REL_TOL * want.abs().max().item(), err


@pytest.mark.parametrize("shape,v_offset", [((1, 197, 12, 64), 0.0), ((8, 197, 12, 64), 0.0),
                                            ((2, 130, 2, 64), 10.0), ((1, 1, 1, 64), 0.0)])
def test_attention_kernel(cuda, shape, v_offset):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
               for _ in range(3))
    q, k, v = q.bfloat16(), k.bfloat16(), (v + v_offset).bfloat16()
    before = K3.LAUNCHES
    got = K3.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert K3.LAUNCHES == before + 1 and got.dtype == torch.bfloat16
    _close(got, K3.attention_reference(q, k, v))


def test_attention_kernel_reads_strided_heads(cuda):
    """q/k/v sliced out of one fused (B, S, 3·H·D) projection: the kernel
    reads them through their strides, no copy."""
    qkv = torch.randn(2, 197, 3 * 12 * 64, device=cuda).bfloat16()
    q, k, v = (t.view(2, 197, 12, 64) for t in qkv.split(12 * 64, dim=-1))
    assert not q.is_contiguous()
    _close(K3.fused_attention(q, k, v), K3.attention_reference(q, k, v))


def test_attention_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.randn(1, 8, 2, 64, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        K3.fused_attention(q, q, q)
    q = torch.randn(1, 8, 2, 32, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="head dim"):
        K3.fused_attention(q, q, q)


def _mlp_args(m, h, f, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g).to(device)
    return ((0.5 * rnd(1, m, h)).bfloat16(), 1 + 0.1 * rnd(h), 0.1 * rnd(h),
            (0.03 * rnd(f, h)).bfloat16(), 0.1 * rnd(f),
            (0.03 * rnd(h, f)).bfloat16(), 0.1 * rnd(h), 1e-5)


@pytest.mark.parametrize("m,h,f", [(197, 768, 3072), (1576, 768, 3072), (333, 768, 3072),
                                   (131, 128, 256), (1, 640, 128), (1, 768, 3072)])
def test_mlp_kernel(cuda, m, h, f):
    args = _mlp_args(m, h, f, cuda)
    before = K4.LAUNCHES
    got = K4.fused_mlp(*args)
    torch.cuda.synchronize()
    assert K4.LAUNCHES == before + 1 and got.dtype == torch.bfloat16
    _close(got, K4.mlp_reference(*args))


def test_mlp_refuses_what_the_kernel_does_not_take(cuda):
    x, lw, lb, w1, b1, w2, b2, eps = _mlp_args(4, 768, 3072, cuda)
    with pytest.raises(TypeError):
        K4.fused_mlp(x.float(), lw, lb, w1, b1, w2, b2, eps)
    x, lw, lb, w1, b1, w2, b2, eps = _mlp_args(4, 64, 128, cuda)
    with pytest.raises(ValueError, match="H in"):
        K4.fused_mlp(x, lw, lb, w1, b1, w2, b2, eps)


def test_small_clip_unet_runs_both_kernels(cuda):
    """A reduced ClipUNet built as the config builds it on CUDA (bf16,
    kernels on): one launch of each kernel per block, finite logits close
    to the same weights through the plain versions."""
    import dataclasses

    from image_segmentation_tpu_torch.config import CLIPUNET, build_model
    from image_segmentation_tpu_torch.serve.app import DEMO_VIT

    kw = dict(vit=DEMO_VIT, skip_indices=(0, 1, 2, 3), decoder_channels=(64, 32, 16, 8, 8))
    model = build_model(CLIPUNET, cuda, torch.Generator().manual_seed(0), **kw)
    plain = build_model(dataclasses.replace(CLIPUNET, use_kernels=False), cuda,
                        torch.Generator().manual_seed(0), **kw)
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(1)).to(cuda)
    a, m = K3.LAUNCHES, K4.LAUNCHES
    with torch.inference_mode():
        got, want = model(x), plain(x)
    assert (K3.LAUNCHES - a, K4.LAUNCHES - m) == (DEMO_VIT.num_layers,) * 2
    assert got.shape == (2, 64, 64, 4) and torch.isfinite(got).all()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    assert agree > 0.9, agree
