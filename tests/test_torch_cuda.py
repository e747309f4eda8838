"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA card and nvcc; elsewhere they skip. The
file imports no jax (the machine with the card has none), so run it
without the jax-forcing conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: two bf16 steps of the output's largest magnitude. Kernel and
plain version round at the same points and sum in another order, so an
output, or an intermediate it depends on, can land one step apart.
"""
import dataclasses

import numpy as np
import pytest
import torch

from image_segmentation_tpu_torch.ops.kernels import attention as K3
from image_segmentation_tpu_torch.ops.kernels import double_conv as K1
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


def _k1_args(xshape, c, bias1_offset, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g).to(device)
    cin = xshape[-1]
    return (rnd(*xshape).bfloat16(), (rnd(3, 3, cin, c) * (2 / (9 * cin)) ** 0.5).bfloat16(),
            1 + 0.1 * rnd(c), 0.1 * rnd(c) + bias1_offset,
            (rnd(3, 3, c, c) * (2 / (9 * c)) ** 0.5).bfloat16(), 1 + 0.1 * rnd(c), 0.1 * rnd(c))


# The UNet-64 levels chip_smoke.py checks, a ragged shape (W not a
# multiple of the 16-column tile, two images, C not a multiple of the 64
# channel block) and the deepest demo level; bias1 = +1 shows at every
# edge whether conv2 sees zero padding or relu(bias1) outside the image.
# Then the shapes batching and the prompt model's selection UNet bring:
# the Cin = 4 stem at 224 px, N = 8 (no split), N = 2 at 16² (split-K
# across two images) and the 14² deepest level of a 224 px UNet.
@pytest.mark.parametrize("xshape,c,bias1_offset", [
    ((1, 256, 256, 3), 64, 0.0), ((1, 128, 128, 64), 128, 0.0),
    ((1, 16, 16, 512), 1024, 0.0), ((1, 32, 32, 1024), 512, 0.0),
    ((1, 256, 256, 128), 64, 0.0), ((2, 37, 45, 24), 72, 1.0), ((1, 4, 4, 64), 128, 1.0),
    ((1, 20, 40, 8), 16, 1.0),
    ((1, 224, 224, 4), 64, 1.0), ((8, 64, 64, 4), 64, 0.0), ((8, 16, 16, 512), 1024, 0.0),
    ((2, 16, 16, 512), 1024, 1.0), ((4, 14, 14, 512), 1024, 1.0), ((8, 28, 28, 1024), 512, 0.0)])
def test_double_conv_kernel(cuda, xshape, c, bias1_offset):
    args = _k1_args(xshape, c, bias1_offset, cuda)
    before = K1.LAUNCHES
    got = K1.fused_double_conv(*args)
    torch.cuda.synchronize()
    assert K1.LAUNCHES == before + 1 and got.dtype == torch.bfloat16
    assert got.shape == xshape[:3] + (c,)
    _close(got, K1.double_conv_reference(*args))


def test_double_conv_refuses_what_the_kernel_does_not_take(cuda):
    x, w1, s1, b1, w2, s2, b2 = _k1_args((1, 8, 8, 16), 16, 0.0, cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        K1.fused_double_conv(x.float(), w1, s1, b1, w2, s2, b2)
    with pytest.raises(TypeError, match="float32"):
        K1.fused_double_conv(x, w1, s1.bfloat16(), b1, w2, s2, b2)
    with pytest.raises(ValueError, match="is on"):
        K1.fused_double_conv(x, w1.cpu(), s1, b1, w2, s2, b2)
    nchw_memory = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="contiguous"):
        K1.fused_double_conv(nchw_memory, w1, s1, b1, w2, s2, b2)
    x, w1, s1, b1, w2, s2, b2 = _k1_args((1, 8, 8, 16), 12, 0.0, cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        K1.fused_double_conv(x, w1, s1, b1, w2, s2, b2)


def test_small_unet_runs_k1_nine_times(cuda):
    """The demo UNet (base 8) built as the config builds it on CUDA (bf16,
    kernels on): nine K1 launches a forward, finite logits close to the
    same weights through the module path (cuDNN, bf16)."""
    from image_segmentation_tpu_torch.config import UNET_NOAUG, build_model

    model = build_model(UNET_NOAUG, cuda, torch.Generator().manual_seed(0), base=8)
    plain = build_model(dataclasses.replace(UNET_NOAUG, use_kernels=False), cuda,
                        torch.Generator().manual_seed(0), base=8)
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(1)).to(cuda)
    before = K1.LAUNCHES
    with torch.inference_mode():
        got, want = model(x), plain(x)
    assert K1.LAUNCHES - before == 9
    assert got.shape == (2, 64, 64, 4) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    assert agree > 0.9, agree


def _demo_families(cuda, fast_transfer=True):
    from image_segmentation_tpu_torch.serve import app
    from image_segmentation_tpu_torch.serve.engine import InferenceEngine

    eng = InferenceEngine(device=cuda, fast_transfer=fast_transfer)
    app.register_families(eng, app.demo_model_specs(cuda))
    return eng


def test_prompt_cache_launch_counts(cuda):
    """The demo prompt family on the card: the first click on an image runs
    the clip branch (one K3 and one K4 launch per ViT block) and the
    selection UNet (nine K1 launches); later clicks hit the cache and
    launch K1 nine times only."""
    from image_segmentation_tpu_torch.serve.app import DEMO_VIT
    from image_segmentation_tpu_torch.serve.render import render_points

    eng = _demo_families(cuda)
    cache = eng.models["prompt_model"].score_cache
    img = np.random.default_rng(0).uniform(0, 1, (75, 100, 3)).astype(np.float32)
    deltas = []
    for x in (10, 50, 90):
        before = (K3.LAUNCHES, K4.LAUNCHES, K1.LAUNCHES)
        out = eng.segment(img, "prompt_model", render_points([{"x": x, "y": 40}], (75, 100)))
        deltas.append(tuple(a - b for a, b in zip((K3.LAUNCHES, K4.LAUNCHES, K1.LAUNCHES),
                                                   before)))
        assert out["mask"].shape == (75, 100) and out["mask"].max() <= 3
    n = DEMO_VIT.num_layers
    assert deltas == [(n, n, 9), (0, 0, 9), (0, 0, 9)]
    assert (cache.misses, cache.hits) == (1, 2)


def test_batching_engine_on_the_card(cuda):
    """16 concurrent requests over the four demo families through the
    BatchingEngine on the engine's CUDA stream agree with direct segment()
    on at least 0.99 of the pixels of every request (batch composition
    changes K1's split-K and cuDNN's algorithm, so a bf16 tie may flip),
    and at least one batch holds more than one request."""
    import threading

    from image_segmentation_tpu_torch.serve.batching import BatchingEngine
    from image_segmentation_tpu_torch.serve.render import render_bbox

    eng = _demo_families(cuda)
    names = eng.available()
    rng = np.random.default_rng(1)
    imgs = [rng.uniform(0, 1, (60 + i, 80, 3)).astype(np.float32) for i in range(16)]
    prompts = [render_bbox({"x": 10, "y": 10, "width": 40, "height": 30}, im.shape[:2])
               if names[i % 4] == "prompt_model" else None for i, im in enumerate(imgs)]
    want = [eng.segment(im, names[i % 4], prompts[i])["mask"] for i, im in enumerate(imgs)]
    sizes = []
    for entry in eng.models.values():
        def counted(*inputs, dispatch=entry.dispatch):
            sizes.append(inputs[0].shape[0])
            return dispatch(*inputs)
        entry.dispatch = counted
    be = BatchingEngine(eng, max_batch=8, max_wait_ms=5)
    got = [None] * len(imgs)
    try:
        be.warmup()
        sizes.clear()

        def run(i):
            got[i] = be.segment(imgs[i], names[i % 4], prompts[i], timeout=120)["mask"]

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(imgs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert not any(t.is_alive() for t in threads)
    finally:
        be.close()
    agree = min(float((g == w).mean()) for g, w in zip(got, want))
    assert agree >= 0.99, agree
    assert max(sizes) > 1, sizes
