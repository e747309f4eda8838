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
import math

import numpy as np
import pytest
import torch

from image_segmentation_tpu_torch.ops.kernels import attention as K3
from image_segmentation_tpu_torch.ops.kernels import double_conv as K1
from image_segmentation_tpu_torch.ops.kernels import mlp as K4
from image_segmentation_tpu_torch.ops.kernels import relpos_attention as K5

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


# Every sequence-length regime of the kernel's key padding (one key, one
# whole 64-key chunk, one key past it, ViT-B/16's 197, the longest
# admitted), at one request and at the BatchingEngine's largest bucket;
# then S = 130 with V offset by +10, where attention mass leaking onto the
# padded keys would show.
@pytest.mark.parametrize("shape,v_offset", [((b, s, 12, 64), 0.0) for b in (1, 8)
                                            for s in (1, 64, 65, 197, 256)]
                         + [((2, 130, 2, 64), 10.0)])
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
    assert torch.equal(got, K3.fused_attention(q, k, v))  # no atomics: the same bits


def test_attention_kernel_reads_strided_heads(cuda):
    """q/k/v sliced out of one fused (B, S, 3·H·D) projection: the kernel
    reads them through their strides, no copy."""
    qkv = torch.randn(2, 197, 3 * 12 * 64, device=cuda).bfloat16()
    q, k, v = (t.view(2, 197, 12, 64) for t in qkv.split(12 * 64, dim=-1))
    assert not q.is_contiguous()
    _close(K3.fused_attention(q, k, v), K3.attention_reference(q, k, v))


def test_attention_refuses_past_256_tokens(cuda):
    q = torch.randn(1, 257, 2, 64, device=cuda).bfloat16()
    before = K3.LAUNCHES
    with pytest.raises(ValueError, match="256"):
        K3.fused_attention(q, q, q)
    assert K3.LAUNCHES == before


def test_attention_launches_the_plan_it_is_given(cuda, monkeypatch):
    """The C entry point cuts the call as attention_plan says: a plan with
    more key chunks than S needs still gives the same result (the extra
    keys are masked), one that leaves keys or queries out is refused."""
    q, k, v = (torch.randn(1, 130, 2, 64, device=cuda).bfloat16() for _ in range(3))
    want = K3.fused_attention(q, k, v)
    plan = K3.attention_plan(1, 130, 2)
    wider = K3.attention_plan(1, 256, 2)
    monkeypatch.setattr(K3, "attention_plan", lambda *a: dataclasses.replace(
        plan, chunks=wider.chunks, smem_bytes=wider.smem_bytes))
    torch.testing.assert_close(K3.fused_attention(q, k, v), want, rtol=0, atol=0)
    for short in (dataclasses.replace(plan, chunks=plan.chunks - 1),
                  dataclasses.replace(plan, grid=(plan.grid[0] - 1, *plan.grid[1:])),
                  dataclasses.replace(plan, smem_bytes=plan.smem_bytes - 1024)):
        monkeypatch.setattr(K3, "attention_plan", lambda *a, _p=short: _p)
        with pytest.raises(RuntimeError, match="CUDA error"):
            K3.fused_attention(q, k, v)


def test_attention_calls_a_launcher_swapped_into_its_module(cuda, monkeypatch):
    """The route looks `_launch` up at each call: a wrapper put in its place
    (as perfbench/tracing.py's `wrap_kernel_launches` puts one) sees every
    eager call, and the kernel still runs through it."""
    q, k, v = (torch.randn(1, 65, 2, 64, device=cuda).bfloat16() for _ in range(3))
    launch, seen = K3._launch, []

    def wrapped(*args, **kw):
        seen.append(tuple(args[0].shape))
        return launch(*args, **kw)

    monkeypatch.setattr(K3, "_launch", wrapped)
    before = K3.LAUNCHES
    got = K3.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert seen == [(1, 65, 2, 64)] and K3.LAUNCHES == before + 1
    _close(got, K3.attention_reference(q, k, v))


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


# Token counts around the 64-token tile (1, 63, 64, 65), one request (197),
# the BatchingEngine's largest bucket (1576) and four times that; then
# narrower widths, and an F that is a multiple of 64 but not of 128.
@pytest.mark.parametrize("m,h,f", [(m, 768, 3072) for m in (1, 63, 64, 65, 197, 1576, 6304)]
                         + [(333, 768, 3072), (131, 128, 256), (1, 640, 128), (65, 256, 192)])
def test_mlp_kernel(cuda, m, h, f):
    args = _mlp_args(m, h, f, cuda)
    before = K4.LAUNCHES
    got = K4.fused_mlp(*args)
    torch.cuda.synchronize()
    assert K4.LAUNCHES == before + 1 and got.dtype == torch.bfloat16
    _close(got, K4.mlp_reference(*args))
    assert torch.equal(got, K4.fused_mlp(*args))  # splits reduced in order: the same bits


def test_mlp_refuses_what_the_kernel_does_not_take(cuda):
    x, lw, lb, w1, b1, w2, b2, eps = _mlp_args(4, 768, 3072, cuda)
    with pytest.raises(TypeError):
        K4.fused_mlp(x.float(), lw, lb, w1, b1, w2, b2, eps)
    x, lw, lb, w1, b1, w2, b2, eps = _mlp_args(4, 64, 128, cuda)
    with pytest.raises(ValueError, match="H in"):
        K4.fused_mlp(x, lw, lb, w1, b1, w2, b2, eps)


# SAM's encoder MLP (models/sam.py): the exact GELU at eps 1e-6, at one
# image's 4,096 tokens and at ragged and ClipUNet-sized token counts.
@pytest.mark.parametrize("m", [65, 1576, 4096])
def test_mlp_kernel_erf_gelu(cuda, m):
    x, lw, lb, w1, b1, w2, b2, _ = _mlp_args(m, 768, 3072, cuda, seed=3)
    before = K4.LAUNCHES
    got = K4.fused_mlp(x, lw, lb, w1, b1, w2, b2, 1e-6, activation="gelu")
    torch.cuda.synchronize()
    assert K4.LAUNCHES == before + 1
    _close(got, K4.mlp_reference(x, lw, lb, w1, b1, w2, b2, 1e-6, activation="gelu"))
    quick = K4.fused_mlp(x, lw, lb, w1, b1, w2, b2, 1e-6)
    assert not torch.equal(got, quick)


# K4 v3, the many-token design (SAM's micro-batch of 8: 32,768 tokens), at
# ragged token counts past the last 128-token band too, with both GELUs
# and both LayerNorm eps; the same bits over two calls.
@pytest.mark.parametrize("m", [32768, 32700, 8260])
@pytest.mark.parametrize("activation,eps", [("gelu", 1e-6), ("quick_gelu", 1e-5),
                                            ("gelu", 1e-5), ("quick_gelu", 1e-6)])
def test_mlp_many_token_kernel(cuda, m, activation, eps):
    x, lw, lb, w1, b1, w2, b2, _ = _mlp_args(m, 768, 3072, cuda, seed=m)
    assert isinstance(K4.mlp_plan(m, 768, 3072, 132), K4.ManyTokenPlan)
    before = K4.LAUNCHES, K4.MANY_TOKEN_LAUNCHES
    got = K4.fused_mlp(x, lw, lb, w1, b1, w2, b2, eps, activation=activation)
    torch.cuda.synchronize()
    assert (K4.LAUNCHES - before[0], K4.MANY_TOKEN_LAUNCHES - before[1]) == (1, 1)
    _close(got, K4.mlp_reference(x, lw, lb, w1, b1, w2, b2, eps, activation=activation))
    assert torch.equal(got, K4.fused_mlp(x, lw, lb, w1, b1, w2, b2, eps, activation=activation))


def test_mlp_many_token_kernel_keeps_v2s_bits(cuda, monkeypatch):
    """v3 and v2 round at the same points and sum each output over K in the
    same k16 order, so at SAM's 32,768 tokens with the exact GELU no output
    differs (0 of 25,165,824 on the card)."""
    x, lw, lb, w1, b1, w2, b2, _ = _mlp_args(32768, 768, 3072, cuda, seed=5)
    v3 = K4.fused_mlp(x, lw, lb, w1, b1, w2, b2, 1e-6, activation="gelu")
    monkeypatch.setattr(K4, "MANY_TOKENS", 10**9)
    before = K4.MANY_TOKEN_LAUNCHES
    v2 = K4.fused_mlp(x, lw, lb, w1, b1, w2, b2, 1e-6, activation="gelu")
    torch.cuda.synchronize()
    assert K4.MANY_TOKEN_LAUNCHES == before
    assert int((v3 != v2).sum()) == 0


# One ClipUNet request, a batch of 8 and the TP entry stay on v2 (the
# parent's kernels and bits).
@pytest.mark.parametrize("m,activation,partial", [(197, "quick_gelu", False),
                                                  (1576, "quick_gelu", False),
                                                  (1576, "gelu", False),
                                                  (1576, "quick_gelu", True)])
def test_mlp_few_tokens_and_tp_entry_run_v2(cuda, m, activation, partial):
    x, lw, lb, w1, b1, w2, b2, eps = _mlp_args(m, 768, 1536 if partial else 3072, cuda)
    before = K4.LAUNCHES, K4.MANY_TOKEN_LAUNCHES, K4.PARTIAL_LAUNCHES
    if partial:
        K4.fused_mlp_partial(x, lw, lb, w1, b1, w2, eps)
    else:
        K4.fused_mlp(x, lw, lb, w1, b1, w2, b2, eps, activation=activation)
    torch.cuda.synchronize()
    moved = tuple(a - b for a, b in zip((K4.LAUNCHES, K4.MANY_TOKEN_LAUNCHES,
                                         K4.PARTIAL_LAUNCHES), before))
    assert moved == ((0, 0, 1) if partial else (1, 0, 0))


def _relpos_args(b, h, w, device, seed=0):
    """q, k, v sliced out of one (B, S, 3, 12, 64) qkv projection, as SAM's
    encoder hands them to K5, and random bf16 tables."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, h * w, 3, 12, 64, generator=g).to(device).bfloat16()
    q, k, v = qkv.unbind(2)
    rh = (0.1 * torch.randn(2 * h - 1, 64, generator=g)).to(device).bfloat16()
    rw = (0.1 * torch.randn(2 * w - 1, 64, generator=g)).to(device).bfloat16()
    return q, k, v, rh, rw


# The windowed blocks' 14 x 14 windows (25 an image), a global map at
# 64 x 64 (the row-tile path), and maps that take neither path's shape.
@pytest.mark.parametrize("b,h,w", [(25, 14, 14), (2, 64, 64), (3, 9, 11), (1, 32, 64)])
def test_relpos_attention_kernel(cuda, b, h, w):
    args = _relpos_args(b, h, w, cuda)
    assert not args[0].is_contiguous()
    before = K5.LAUNCHES
    got = K5.relpos_attention(*args)
    torch.cuda.synchronize()
    assert K5.LAUNCHES == before + 1 and got.dtype == torch.bfloat16
    _close(got, K5.relpos_attention_reference(*args))


def test_relpos_attention_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v, rh, rw = _relpos_args(1, 4, 4, cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        K5.relpos_attention(q.float(), k.float(), v.float(), rh, rw)
    with pytest.raises(ValueError, match="map"):
        K5.relpos_attention(q, k, v, rh, rw[:5])
    with pytest.raises(RuntimeError, match="no backward"):
        K5.relpos_attention(q.detach().clone().requires_grad_(True), k, v, rh, rw)


# K4's tensor-parallel entry at ViT-B/16's F / 2 (one request, the largest
# bucket), a ragged token count, and an F a multiple of 64 only.
@pytest.mark.parametrize("m,h,f", [(197, 768, 1536), (1576, 768, 1536), (333, 768, 1536),
                                   (65, 256, 192)])
def test_mlp_partial_entry(cuda, m, h, f):
    x, lw, lb, w1, b1, w2, _, eps = _mlp_args(m, h, f, cuda)
    before, whole = K4.PARTIAL_LAUNCHES, K4.LAUNCHES
    got = K4.fused_mlp_partial(x, lw, lb, w1, b1, w2, eps)
    torch.cuda.synchronize()
    assert (K4.PARTIAL_LAUNCHES, K4.LAUNCHES) == (before + 1, whole)
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close(got, K4.mlp_partial_reference(x, lw, lb, w1, b1, w2, eps))
    assert torch.equal(got, K4.fused_mlp_partial(x, lw, lb, w1, b1, w2, eps))


def test_mlp_partial_entry_refuses_grad(cuda):
    x, lw, lb, w1, b1, w2, _, eps = _mlp_args(4, 768, 1536, cuda)
    with pytest.raises(RuntimeError, match="fused_mlp_partial: the CUDA kernel has no backward"):
        K4.fused_mlp_partial(x, lw.requires_grad_(), lb, w1, b1, w2, eps)


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
    assert torch.equal(got, K1.fused_double_conv(*args))  # split-K summed in order: same bits


# K1 on the row slabs of spatial partitioning (parallel/sp.py): an interior
# shard's rows with 2 rows of each neighbour, cropped by 2 on each side, and
# the top and bottom shards' with none on the image's side (K1's own zero
# padding acts there), each equal to the plain double conv of the whole
# image on those rows; odd slab heights run on 16-row tiles.
@pytest.mark.parametrize("xshape,c,rows", [((2, 256, 256, 3), 64, (128, 256)),
                                           ((2, 256, 256, 3), 64, (0, 128)),
                                           ((1, 64, 64, 128), 64, (16, 32)),
                                           ((1, 16, 16, 512), 1024, (4, 8))])
def test_double_conv_on_haloed_slabs(cuda, xshape, c, rows):
    args = _k1_args(xshape, c, 1.0, cuda)
    a, b = rows
    top, bottom = min(2, a), min(2, xshape[1] - b)
    slab = args[0][:, a - top:b + bottom].contiguous()
    got = K1.fused_double_conv(slab, *args[1:])[:, top:top + b - a]
    _close(got, K1.double_conv_reference(*args)[:, a:b])


# The up block's double conv with the concat in the load stage: the
# 256² level of UNet-64, the 32² one, and channel counts that are not
# multiples of the 64-channel K step on a ragged image.
@pytest.mark.parametrize("nhw,skip_c,up_c,c", [((1, 256, 256), 64, 64, 64),
                                               ((1, 32, 32), 512, 512, 512),
                                               ((2, 37, 45), 24, 48, 72)])
def test_double_conv_concat_entry(cuda, nhw, skip_c, up_c, c):
    x, *w = _k1_args(nhw + (skip_c + up_c,), c, 1.0, cuda)
    skip, up = x[..., :skip_c].contiguous(), x[..., skip_c:].contiguous()
    before = K1.LAUNCHES
    got = K1.fused_double_conv_cat(skip, up, *w)
    torch.cuda.synchronize()
    assert K1.LAUNCHES == before + 1 and got.shape == nhw + (c,)
    _close(got, K1.double_conv_cat_reference(skip, up, *w))
    assert torch.equal(got, K1.fused_double_conv_cat(skip, up, *w))


def test_kernels_refuse_inputs_that_require_grad(cuda):
    """No kernel has a backward: under grad mode an argument that requires
    grad raises (no silent drop of the gradient); under no_grad it runs."""
    q = torch.randn(1, 8, 2, 64, device=cuda).bfloat16().requires_grad_()
    mlp = list(_mlp_args(4, 128, 256, cuda))
    mlp[3] = mlp[3].requires_grad_()
    dc = list(_k1_args((1, 8, 8, 16), 16, 0.0, cuda))
    dc[1] = dc[1].requires_grad_()
    calls = [lambda: K3.fused_attention(q, q.detach(), q.detach()),
             lambda: K4.fused_mlp(*mlp), lambda: K1.fused_double_conv(*dc),
             lambda: K1.fused_double_conv_cat(dc[0][..., :8].contiguous(),
                                              dc[0][..., 8:].contiguous(), *dc[1:])]
    counts = (K3.LAUNCHES, K4.LAUNCHES, K1.LAUNCHES)
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
    assert (K3.LAUNCHES, K4.LAUNCHES, K1.LAUNCHES) == counts
    with torch.no_grad():
        for call in calls:
            call()
    assert (K3.LAUNCHES, K4.LAUNCHES, K1.LAUNCHES) == (counts[0] + 1, counts[1] + 1,
                                                       counts[2] + 2)


def test_frozen_clip_unet_trains_on_the_card(cuda):
    """A reduced ClipUNet built as the config builds it on CUDA (bf16, K3
    and K4 on, encoder frozen) takes one train step: its ViT runs the
    kernels under no_grad (one launch of each a block) and gets no .grad,
    and every decoder parameter gets a finite one."""
    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch.serve.app import DEMO_VIT
    from image_segmentation_tpu_torch.train.state import TrainState
    from image_segmentation_tpu_torch.train.steps import train_step

    kw = dict(vit=DEMO_VIT, skip_indices=(0, 1, 2, 3), decoder_channels=(64, 32, 16, 8, 8))
    model = C.build_model(C.CLIPUNET, cuda, torch.Generator().manual_seed(0), **kw)
    st = TrainState(model, *C.build_optimizer(C.CLIPUNET, model))
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand(2, 64, 64, 3, generator=g, device=cuda)
    y = torch.randint(0, 4, (2, 64, 64), generator=g, device=cuda)
    a, m = K3.LAUNCHES, K4.LAUNCHES
    loss = train_step(st, C.build_loss(C.CLIPUNET), x, y)
    assert torch.isfinite(loss)
    assert (K3.LAUNCHES - a, K4.LAUNCHES - m) == (DEMO_VIT.num_layers,) * 2
    for n, p in model.named_parameters():
        if n.startswith("vision_model."):
            assert p.grad is None, n
        else:
            assert p.grad is not None and torch.isfinite(p.grad).all(), n


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


# Training (unet_noaug) on the card.


def test_train_step_on_the_card_matches_the_cpu_step(cuda):
    """One step of the recipe at base 8, 32 px, micro 2 × accum 2, on the
    card in f32 and in bf16 against f32 on the CPU from the same weights
    and batch, with chip_smoke.py's stated tolerances (its phase 8 runs
    base 16)."""
    from chip_smoke import check_cross_step, cross_check_step

    check_cross_step(cross_check_step(base=8, side=32, micro=2, accum=2))


def test_full_width_train_step_has_a_finite_loss(cuda):
    """UNet base 64 at 256 px, micro 8 × accum 2, bf16: one optimizer step,
    a finite loss, every parameter moved, no K1 launch (train mode)."""
    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch.train.state import TrainState
    from image_segmentation_tpu_torch.train.steps import train_step

    cfg = C.UNET_NOAUG
    model = C.build_model(cfg, cuda, torch.Generator().manual_seed(0))
    st = TrainState(model, *C.build_optimizer(cfg, model))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand(16, 256, 256, 3, generator=g, device=cuda)
    y = torch.randint(0, 4, (16, 256, 256), generator=g, device=cuda)
    k1 = K1.LAUNCHES
    loss = train_step(st, C.build_loss(cfg), x, y, accum_steps=2)
    assert torch.isfinite(loss) and st.step == 1 and K1.LAUNCHES == k1
    for n, p in model.named_parameters():
        assert not torch.equal(p.detach(), before[n]), n


def test_k1_eval_inside_evaluate_matches_the_module_path(cuda):
    """The trainer's device-protocol eval with K1 (eval mode, no autograd)
    against the same weights on the module path: mIoU within 0.01 and the
    confusion within 1% of the pixels; nine K1 launches per eval batch."""
    from chip_smoke import _perturb_batchnorm_

    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch.metrics import MetricsHistory
    from image_segmentation_tpu_torch.run import synthetic_materialized
    from image_segmentation_tpu_torch.train.loop import evaluate
    from image_segmentation_tpu_torch.train.state import TrainState

    cfg = C.UNET_NOAUG
    model = C.build_model(cfg, cuda, torch.Generator().manual_seed(0), base=16)
    _perturb_batchnorm_(model, 1)
    model.train()  # as the trainer leaves it; evaluate must still run K1
    state = TrainState(model)
    val = synthetic_materialized(12, 64, seed=1, keep_orig_labels=True)
    out = []
    for kernels in (True, False):
        model.use_kernels = kernels
        agg = MetricsHistory(4, ignore_index=3)
        before = K1.LAUNCHES
        res = evaluate(state, val, loss_cfg=C.build_val_loss(cfg), agg=agg, verbose=False,
                       batch_size=8)
        out.append((res, agg.confusion.copy(), K1.LAUNCHES - before))
    (k_res, k_conf, k_n), (m_res, m_conf, m_n) = out
    assert (k_n, m_n) == (9 * 2, 0) and model.training
    assert abs(k_res["iou"] - m_res["iou"]) <= 0.01
    assert np.abs(k_conf - m_conf).sum() / 2 <= 0.01 * k_conf.sum()


def test_stream_rows_on_the_card_gathers_each_batch(cuda):
    """`stream_rows` on cuda: each batch is its host gather, on the card,
    in order, with the worker gathering and copying ahead; closing the
    stream early leaves no worker."""
    import threading

    from image_segmentation_tpu_torch.train.steps import stream_rows

    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (64, 32, 32, 3)).astype(np.float32)
    b = rng.integers(0, 4, (64, 32, 32)).astype(np.int32)
    rows = [rng.permutation(64)[:16] for _ in range(8)]
    got = list(stream_rows((a, b), iter(rows), cuda))
    assert len(got) == 8
    for (x, y), idx in zip(got, rows):
        assert x.device.type == "cuda" and y.dtype == torch.int32
        np.testing.assert_array_equal(x.cpu().numpy(), a[idx])
        np.testing.assert_array_equal(y.cpu().numpy(), b[idx])
    gen = stream_rows((a, b), iter(rows), cuda)
    next(gen)
    gen.close()
    assert not [t for t in threading.enumerate() if t.name.startswith("stream_rows")]


def _streaming_fit_setup(cuda, tmp_path):
    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch.run import synthetic_materialized
    from image_segmentation_tpu_torch.train.state import TrainState

    cfg = C.UNET_NOAUG
    train = synthetic_materialized(32, 64, seed=0)
    val = synthetic_materialized(20, 64, seed=1, keep_orig_labels=True)

    def fit(name):
        from image_segmentation_tpu_torch.train.loop import fit as fit_

        model = C.build_model(cfg, cuda, torch.Generator().manual_seed(0), base=8)
        return fit_(TrainState(model, *C.build_optimizer(cfg, model)), train, val,
                    loss_fn=C.build_loss(cfg), epochs=2, batch_size=8, accum_steps=2,
                    save_dir=str(tmp_path / name), name="unet_noaug",
                    eval_loss_cfg=C.build_val_loss(cfg), verbose=False)

    return train, val, fit


def test_streamed_fit_on_the_card_equals_the_resident_fit(cuda, tmp_path, monkeypatch):
    """unet_noaug at base 8, 64 px, micro 4 × accum 2, 2 epochs of 4
    steps: streamed from pinned host memory (both budgets 0) against the
    resident set, cuDNN deterministic: the same batches, so the same
    losses and val metrics; K1 runs in both evals."""
    from image_segmentation_tpu_torch.train import loop

    monkeypatch.delenv(loop.BUDGET_ENV, raising=False)
    monkeypatch.delenv(loop.EVAL_BUDGET_ENV, raising=False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    train, val, fit = _streaming_fit_setup(cuda, tmp_path)
    before = K1.LAUNCHES
    resident = fit("r").history
    k1 = K1.LAUNCHES - before
    assert train.device_train_cache is not None and k1 > 0
    monkeypatch.setenv(loop.BUDGET_ENV, "0")
    monkeypatch.setenv(loop.EVAL_BUDGET_ENV, "0")
    before = K1.LAUNCHES
    streamed = fit("s").history
    assert train.device_train_cache is None and val.device_eval_cache is None
    assert K1.LAUNCHES - before == k1
    for k in ("train_loss", "val_loss", "val_iou", "val_acc"):
        assert streamed[k] == resident[k], (k, streamed[k], resident[k])


def test_per_batch_eval_on_the_card_equals_the_resident_eval(cuda, monkeypatch):
    """A base-16 UNet through K1 on 20 val images (canvas buckets): the
    per-batch eval's confusion and loss equal the resident eval's, with
    the same K1 launches."""
    from chip_smoke import _perturb_batchnorm_

    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch.metrics import MetricsHistory
    from image_segmentation_tpu_torch.run import synthetic_materialized
    from image_segmentation_tpu_torch.train import loop
    from image_segmentation_tpu_torch.train.state import TrainState

    cfg = C.UNET_NOAUG
    model = C.build_model(cfg, cuda, torch.Generator().manual_seed(0), base=16)
    _perturb_batchnorm_(model, 1)
    val = synthetic_materialized(20, 64, seed=1, keep_orig_labels=True)
    out = []
    for budget in (None, "0"):
        if budget is None:
            monkeypatch.delenv(loop.EVAL_BUDGET_ENV, raising=False)
        else:
            monkeypatch.setenv(loop.EVAL_BUDGET_ENV, budget)
        agg = MetricsHistory(4, ignore_index=3)
        before = K1.LAUNCHES
        res = loop.evaluate(TrainState(model), val, loss_cfg=C.build_val_loss(cfg), agg=agg,
                            verbose=False, batch_size=8)
        out.append((res, agg.confusion.copy(), K1.LAUNCHES - before))
        # resident: each canvas bucket's set held on the card; per batch: none
        assert all((v.device_eval_cache is None) == (budget == "0")
                   for v in val.bucket_views or [val])
    (r_res, r_conf, r_n), (s_res, s_conf, s_n) = out
    assert r_n == s_n > 0
    np.testing.assert_array_equal(s_conf, r_conf)
    assert s_res["loss"] == r_res["loss"]


def test_write_behind_checkpoint_holds_the_state_of_its_epoch(cuda, tmp_path):
    """A save submitted after a step, then another step at once (in-place
    parameter and moment updates on the same stream): the files hold the
    first step's state exactly, and restore it."""
    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch.train import checkpoint as ckpt
    from image_segmentation_tpu_torch.train.state import TrainState
    from image_segmentation_tpu_torch.train.steps import train_step

    cfg = C.UNET_NOAUG

    def fresh():
        model = C.build_model(cfg, cuda, torch.Generator().manual_seed(0), base=8)
        return TrainState(model, *C.build_optimizer(cfg, model))

    st = fresh()
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand(4, 64, 64, 3, generator=g, device=cuda)
    y = torch.randint(0, 4, (4, 64, 64), generator=g, device=cuda)
    train_step(st, C.build_loss(cfg), x, y, accum_steps=2)
    want = {k: v.detach().cpu().clone() for k, v in st.model.state_dict().items()}
    want_opt = [(s["exp_avg"].cpu().clone(), s["exp_avg_sq"].cpu().clone())
                for s in st.optimizer.state.values()]
    writer = ckpt.CheckpointWriter()
    ckpt.save_checkpoint_async(writer, str(tmp_path / "c"), st, epoch=0,
                               params_only_path=str(tmp_path / "MO_c"))
    train_step(st, C.build_loss(cfg), x, y, accum_steps=2)
    writer.wait()
    restored = fresh()
    ckpt.restore_checkpoint(str(tmp_path / "c"), restored)
    assert restored.step == 1
    for k, v in restored.model.state_dict().items():
        assert torch.equal(v.cpu(), want[k]), k
    got_opt = [(s["exp_avg"].cpu(), s["exp_avg_sq"].cpu()) for s in restored.optimizer.state.values()]
    assert all(torch.equal(a, c) and torch.equal(b, d)
               for (a, b), (c, d) in zip(got_opt, want_opt))
    mo = ckpt.load_model_state(str(tmp_path / "MO_c"))
    assert all(torch.equal(mo[k], want[k]) for k in want)


def test_augment_batch_on_the_card_matches_the_cpu(cuda):
    """The same drawn parameters through apply_augment_batch on the card and
    on the CPU. Only the rotation's cos and sin may differ (the float64
    values rounded on the card, the C library's cosf and sinf on the CPU,
    one ulp apart for about 2% of angles), which moves a sample by up to
    ~1e-4 px at 256 px: in the rotated rows whose cos or sin differ, images
    within 1e-3 and label pixels on at most 1e-3 of their pixels (rounding
    ties); every other row within 1e-5, its labels equal. Neither the draws
    nor the call wait on the card: the rows are grouped on the host."""
    from image_segmentation_tpu_torch.ops import augment as Aug

    n, size = 64, 256
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 4, (n, size, size)))
    params = Aug.draw_augment_params(n, size, torch.Generator().manual_seed(1))
    on_card = Aug.AugmentParams(params.sel, params.use, *(t.to(cuda) for t in params[2:]))
    xc, yc = x.to(cuda), y.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = Aug.apply_augment_batch(xc, yc, on_card)
        # the values drawn on the card's generator, the gate on the host
        p = Aug.draw_augment_params(4096, 32, torch.Generator().manual_seed(0), cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = Aug.apply_augment_batch(x, y, params)
    rad = params.angle * (math.pi / 180.0)
    cos_sin = [t.cpu() for t in Aug._cos_sin(rad.to(cuda))]
    odd = params.use & (params.sel == Aug.AUGMENTER_NAMES.index("rotation")) & (
        (cos_sin[0] != Aug._cos_sin(rad)[0]) | (cos_sin[1] != Aug._cos_sin(rad)[1]))
    err = (got[0].cpu() - want[0]).abs().flatten(1).amax(1)
    differ = (got[1].cpu() != want[1]).flatten(1).sum(1)
    assert err[~odd].max().item() <= 1e-5 and differ[~odd].sum() == 0
    assert (err[odd] <= 1e-3).all() and (differ[odd] <= 1e-3 * size * size).all()
    assert p.angle.is_cuda and not p.use.is_cuda
    assert abs((~p.use).float().mean().item() - 0.5) <= 0.03


def test_recon_forward_in_bf16_on_the_card_is_near_the_cpu_f32(cuda):
    """The full-width ReconstructionAutoencoder (base 64, 256 px) in bf16 on
    the card against the same weights in f32 on the CPU, eval mode: each of
    its 20 conv layers rounds its inputs and weights at 2^-9 relative, and
    the sigmoid's slope is at most 1/4: the outputs within 2^-5, their mean
    difference within 2^-9."""
    from image_segmentation_tpu_torch import config as C

    card = C.build_model(C.RECON_AE, cuda, torch.Generator().manual_seed(0))
    cpu = C.build_model(C.RECON_AE, "cpu", torch.Generator().manual_seed(0))
    assert card.dtype == torch.bfloat16 and cpu.dtype == torch.float32
    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (2, 256, 256, 3))
                         .astype(np.float32))
    with torch.no_grad():
        got, want = card(x.to(cuda)).float().cpu(), cpu(x)
    assert got.shape == want.shape == (2, 256, 256, 3) and torch.isfinite(got).all()
    diff = (got - want).abs()
    assert diff.max().item() <= 2.0**-5 and diff.mean().item() <= 2.0**-9, \
        (diff.max().item(), diff.mean().item())


def _clip_step_setup(cuda, cfg, use_kernels=True, **extra):
    """A reduced model of a CLIP config as build_model builds it on CUDA
    (bf16; K3/K4 on unless `use_kernels` is False), its ViT frozen out of
    AdamW as run.py freezes it, and its train state."""
    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch.serve.app import DEMO_VIT
    from image_segmentation_tpu_torch.train.state import TrainState, freeze_

    kw = dict(vit=DEMO_VIT, skip_indices=(0, 1, 2, 3), decoder_channels=(64, 32, 16, 8, 8),
              **extra)
    model = C.build_model(dataclasses.replace(cfg, use_kernels=use_kernels), cuda,
                          torch.Generator().manual_seed(0), **kw)
    frozen = ("clip.vision_model",) if cfg.model == "prompt" else ("vision_model",)
    freeze_(model, frozen)
    return model, TrainState(model, *C.build_optimizer(cfg, model, frozen_prefixes=frozen))


def _clip_batch(cuda, n=16, side=64, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0, 1, (n, side, side, 3)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.integers(0, 4, (n, side, side))).to(cuda)
    return x, y


def test_clipunet_train_step_with_kernels_matches_the_plain_versions(cuda):
    """One clipunet train step (micro 8 x accum 2, bf16) through K3/K4 and the
    same step through their plain versions, from the same weights: one
    launch of each kernel per block and micro-batch, none on the plain path; the losses within two bf16 steps (2^-6, relative), and the whole
    decoder gradient within 5% relative L2 (the ViT's features differ by
    at most a bf16 step here and there, and the bf16 decoder carries that
    through four train-mode BatchNorms)."""
    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch.serve.app import DEMO_VIT
    from image_segmentation_tpu_torch.train.steps import train_step

    x, y = _clip_batch(cuda)
    out = {}
    for kernels in (True, False):
        model, st = _clip_step_setup(cuda, C.CLIPUNET, use_kernels=kernels)
        a, m = K3.LAUNCHES, K4.LAUNCHES
        loss = train_step(st, C.build_loss(C.CLIPUNET), x, y, 2)
        torch.cuda.synchronize()
        launches = (K3.LAUNCHES - a, K4.LAUNCHES - m)
        grads = torch.cat([p.grad.float().flatten() for n, p in model.named_parameters()
                           if not n.startswith("vision_model.")])
        out[kernels] = (float(loss), launches, grads)
    (lk, nk, gk), (lp, np_, gp) = out[True], out[False]
    assert nk == (2 * DEMO_VIT.num_layers,) * 2 and np_ == (0, 0)
    assert math.isfinite(lk) and abs(lk - lp) <= 2.0**-6 * abs(lp), (lk, lp)
    assert torch.isfinite(gk).all()
    rel = ((gk - gp).norm() / gp.norm()).item()
    assert rel <= 0.05, rel


def test_cached_and_in_line_first_step_losses_are_equal(cuda):
    """The first step's loss of the in-line frozen clipunet step and of the
    decoder-only step on features from `encode_clip_features` (batches of
    8 = the micro-batches), from the same weights on the same batch: equal,
    as the features are the in-line ViT's own values (bf16, stored as f32)."""
    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch.train import feature_cache as FC
    from image_segmentation_tpu_torch.train.state import TrainState
    from image_segmentation_tpu_torch.train.steps import train_step

    x, y = _clip_batch(cuda)
    model, st = _clip_step_setup(cuda, C.CLIPUNET)
    inline = train_step(st, C.build_loss(C.CLIPUNET), x, y, 2)
    model, _ = _clip_step_setup(cuda, C.CLIPUNET)
    before = K3.LAUNCHES
    feats = FC.encode_clip_features(model, x.cpu().numpy(), batch_size=8)
    assert K3.LAUNCHES - before == 2 * model.vit.num_layers and feats.dtype == np.float32
    decoder = model.decoder_only()
    sd = TrainState(decoder, *C.build_optimizer(C.CLIPUNET, decoder))
    cached = train_step(sd, C.build_loss(C.CLIPUNET), torch.from_numpy(feats).to(cuda), y, 2)
    assert float(inline) == float(cached), (float(inline), float(cached))


def test_prompt_train_step_on_the_card(cuda):
    """One step of the prompt config (freeze_clip False: the clip decoder
    and the selection UNet train; the ViT stays frozen) on images and
    heatmaps: K3/K4 once a block per micro-batch, K1 not at all (the
    selection UNet trains on the module path); finite loss, no .grad in
    clip.vision_model, finite ones elsewhere."""
    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch.train.steps import train_step

    x, y = _clip_batch(cuda, seed=1)
    hm = torch.rand(16, 64, 64, 1, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(1))
    model, st = _clip_step_setup(cuda, C.PROMPT, unet_base=8)
    assert not model.freeze_clip and model.clip.freeze_encoder
    counts = (K3.LAUNCHES, K4.LAUNCHES, K1.LAUNCHES)
    loss = train_step(st, C.build_loss(C.PROMPT), (x, hm), y, 2)
    assert torch.isfinite(loss)
    delta = tuple(k.LAUNCHES - c for k, c in zip((K3, K4, K1), counts))
    assert delta == (6, 6, 0), delta
    for n, p in model.named_parameters():
        if n.startswith("clip.vision_model."):
            assert p.grad is None, n
        else:
            assert p.grad is not None and torch.isfinite(p.grad).all(), n


def _launch_counts():
    return K3.LAUNCHES, K4.LAUNCHES, K1.LAUNCHES


def test_export_on_the_card_holds_and_launches_the_kernels(cuda):
    """The demo clip and unet families traced on the card: the program holds
    K3 and K4 once per ViT block and K1 nine times as `istpu::` ops, one
    call of it launches them as often, and its scores are the eager
    model's (the same kernels in the same order)."""
    from image_segmentation_tpu_torch.serve import app
    from image_segmentation_tpu_torch.serve.export import export_model

    n = app.DEMO_VIT.num_layers
    want_ops = {"clip": {"fused_attention": n, "fused_mlp": n},
                "unet": {"fused_double_conv": 5, "fused_double_conv_cat": 4}}
    want_launches = {"clip": (n, n, 0), "unet": (0, 0, 9)}
    x = torch.rand(3, 64, 64, 3, generator=torch.Generator().manual_seed(2)).to(cuda)
    for name, model, tsize, _ in app.demo_model_specs(cuda):
        if name not in want_ops:
            continue
        program, meta = export_model(model, tsize, fast_transfer=False)
        assert meta["device_type"] == "cuda" and meta["compute_dtype"] == "bfloat16"
        ops = {}
        for node in program.graph.nodes:
            if node.op == "call_function" and str(node.target).startswith("istpu."):
                op = str(node.target).split(".")[1]
                ops[op] = ops.get(op, 0) + 1
        assert ops == want_ops[name]
        module = program.module()
        before = _launch_counts()
        with torch.inference_mode():
            got = module(x)
            torch.cuda.synchronize()
            assert tuple(a - b for a, b in zip(_launch_counts(), before)) == want_launches[name]
            _close(got, model(x).float())


def test_register_exported_on_the_card_launches_the_kernels(cuda, tmp_path):
    """The four demo families exported on the card and served through
    `register_exported`: each request launches K3/K4/K1 as the live path's
    first request does (the prompt program is monolithic, so every
    request runs its clip branch), and the masks agree with the live
    engine's on at least 0.99 of the pixels."""
    from image_segmentation_tpu_torch.serve import app
    from image_segmentation_tpu_torch.serve.engine import InferenceEngine
    from image_segmentation_tpu_torch.serve.export import export_registry

    n = app.DEMO_VIT.num_layers
    want = {"unet": (0, 0, 9), "autoencoder": (0, 0, 0), "clip": (n, n, 0),
            "prompt_model": (n, n, 9)}
    written = export_registry("", str(tmp_path), demo=True, device=cuda)
    aot = InferenceEngine(device=cuda)
    for path in written:
        aot.register_exported(path)
    live = _demo_families(cuda)
    img = np.random.default_rng(3).uniform(0, 1, (75, 100, 3)).astype(np.float32)
    pm = np.zeros((75, 100), np.float32)
    pm[30:50, 40:70] = 1.0
    for name, launches in want.items():
        prompt = pm if name == "prompt_model" else None
        for eng in (aot, live):
            before = _launch_counts()
            out = eng.segment(img, name, prompt)
            assert tuple(a - b for a, b in zip(_launch_counts(), before)) == launches, name
        agree = (aot.segment(img, name, prompt)["mask"] == out["mask"]).mean()
        assert agree >= 0.99, (name, agree)


# Data parallelism across processes on the card. Each test starts
# processes of this file (`python tests/test_torch_cuda.py WORKER RANK WORLD
# STORE OUT`) in a group on a `file://` store; each child has a 300 s
# timeout and its exit code is checked.


def _spawn(worker: str, world: int, tmp_path) -> list:
    import os
    import subprocess
    import sys
    import time

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), worker, str(r),
                               str(world), f"file://{tmp_path}/store", str(tmp_path)],
                              cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline, logs = time.monotonic() + 300, []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {worker} exited {p.returncode}:\n{log}"
    return [torch.load(os.path.join(str(tmp_path), f"{worker}.{r}.pt")) for r in range(world)]


def _sums_inputs():
    rng = np.random.default_rng(6)
    x = rng.normal(1.5, 2.0, (8, 16, 12, 10)).astype(np.float32)
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    logits = rng.normal(0, 2, (8, 16, 16, 4)).astype(np.float32)
    targets = np.concatenate([rng.integers(0, 2, (4, 16, 16)), rng.integers(1, 4, (4, 16, 16))])
    return x, g, logits, targets


def _bn_and_loss(x, g, logits, targets, device):
    """Train-mode BN (its input gradient under Σ g·y, its parameter
    gradients, its running statistics) and Dice+CE (its value and logits
    gradient), on `device` in f32."""
    from image_segmentation_tpu_torch.losses import DiceCELoss
    from image_segmentation_tpu_torch.models.layers import BatchNorm

    bn = BatchNorm(x.shape[1]).to(device).train()
    xs = torch.from_numpy(x).to(device).requires_grad_()
    (bn(xs) * torch.from_numpy(g).to(device)).sum().backward()
    lg = torch.from_numpy(logits).to(device).requires_grad_()
    loss = DiceCELoss(class_weights=(0.5, 1.0, 1.5, 2.0), ignore_index=3, smooth_dice=1.0)(
        lg, torch.from_numpy(targets).to(device))
    loss.backward()
    return {"dx": xs.grad.cpu(), "dweight": bn.weight.grad.cpu(), "dbias": bn.bias.grad.cpu(),
            "running_mean": bn.running_mean.cpu(), "running_var": bn.running_var.cpu(),
            "loss": loss.detach().cpu(), "dlogits": lg.grad.cpu()}


def w_gloo_sums(rank, world):
    import torch.distributed as dist

    rows = slice(rank * 8 // world, (rank + 1) * 8 // world)
    x, g, logits, targets = _sums_inputs()
    out = _bn_and_loss(x[rows], g[rows], logits[rows], targets[rows], torch.device("cuda"))
    return dict(out, backend=dist.get_backend())


def test_global_batchnorm_and_loss_sums_on_the_card_through_gloo(cuda, tmp_path):
    """Two processes sharing the card (gloo, CUDA tensors): the global BN
    and the loss's global sums equal one process's on the whole batch on
    the card, in f32 (sums in another order: 1e-5)."""
    res = _spawn("w_gloo_sums", 2, tmp_path)
    want = _bn_and_loss(*_sums_inputs(), cuda)
    assert all(r["backend"] == "gloo" for r in res)
    close = lambda a, b: torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)  # noqa: E731
    close(torch.cat([r["dx"] for r in res]), want["dx"])
    for k in ("dweight", "dbias"):  # each process's part; their sum is the whole
        close(sum(r[k] for r in res), want[k])
    for r in res:
        for k in ("running_mean", "running_var", "loss"):
            close(r[k], want[k])
    # each backward differentiates W·L (parallel/mesh.py)
    close(torch.cat([r["dlogits"] for r in res]) / 2, want["dlogits"])


def w_nccl_step(rank, world):
    """A world of one over NCCL: an all-reduce on the card, one train step
    of a base-16 UNet at 64 px, and the eval over the data axis (K1)."""
    import torch.distributed as dist

    from image_segmentation_tpu_torch.parallel.mesh import get_mesh

    t = torch.ones(4, device="cuda")
    dist.all_reduce(t)
    loss, conf, k1 = _small_step_and_eval(get_mesh("cuda"))
    return {"backend": dist.get_backend(), "sum": t.cpu(), "loss": loss, "conf": conf, "k1": k1}


def _small_step_and_eval(axis):
    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch.metrics import MetricsHistory
    from image_segmentation_tpu_torch.run import synthetic_materialized
    from image_segmentation_tpu_torch.train.loop import evaluate
    from image_segmentation_tpu_torch.train.state import TrainState
    from image_segmentation_tpu_torch.train.steps import train_step

    torch.backends.cudnn.deterministic = True  # the two runs compare bit for bit
    cfg = C.UNET_NOAUG
    model = C.build_model(cfg, "cuda", torch.Generator().manual_seed(0), base=16)
    st = TrainState(model, *C.build_optimizer(cfg, model))
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(8, 64, 64, 3, generator=g, device="cuda")
    y = torch.randint(0, 4, (8, 64, 64), generator=g, device="cuda")
    loss = float(train_step(st, C.build_loss(cfg), x, y, 2))
    val = synthetic_materialized(12, 64, seed=1, keep_orig_labels=True)
    agg = MetricsHistory(4, ignore_index=3)
    before = K1.LAUNCHES
    evaluate(st, val, loss_cfg=C.build_val_loss(cfg), agg=agg, verbose=False, batch_size=8,
             axis=axis)
    torch.backends.cudnn.deterministic = False
    return torch.tensor(loss), torch.from_numpy(agg.confusion.copy()), K1.LAUNCHES - before


def test_nccl_world_size_one_step_on_the_card(cuda, tmp_path):
    """A one-process NCCL group: the backend rule picks NCCL, an all-reduce
    runs, and the step and the eval over the data axis equal the same work
    with no group, bit for bit (nothing is reduced), K1 nine times per eval
    batch."""
    (res,) = _spawn("w_nccl_step", 1, tmp_path)
    loss, conf, k1 = _small_step_and_eval(None)
    assert res["backend"] == "nccl" and res["sum"].tolist() == [1.0] * 4
    assert res["k1"] == k1 == 9 * 2
    torch.testing.assert_close(res["loss"], loss, rtol=0, atol=0)
    assert torch.equal(res["conf"], conf)


def test_robustness_sweep_device_path_on_the_card_runs_k1(cuda):
    """The robustness sweep's device path (u8 transport, canvas confusion on
    the card) on a full-width UNet-64 at 256 px launches K1 nine times a
    batch and lies within 5e-3 of its host path (JAX's tolerance between
    the two, tests/test_ablations.py:127-131)."""
    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch.run import synthetic_materialized
    from image_segmentation_tpu_torch.studies.robustness import robustness_sweep
    from image_segmentation_tpu_torch.train.state import TrainState
    from image_segmentation_tpu_torch.train.steps import eval_forward

    model = C.build_model(C.UNET_NOAUG, cuda, torch.Generator().manual_seed(0))
    val = synthetic_materialized(6, 256, seed=3, keep_orig_labels=True)
    kw = dict(severities=[2, 7], families=["blur", "occlusion"], verbose=False, batch_size=4)
    host = robustness_sweep(lambda x: eval_forward(model, x).float(), val, device=cuda, **kw)
    before = K1.LAUNCHES
    dev = robustness_sweep(None, val, state=TrainState(model), **kw)
    assert K1.LAUNCHES - before == 9 * 2 * 2 * 2  # 9 a batch, 2 batches, 2 x 2 cells
    for k in host:
        np.testing.assert_allclose(dev[k], host[k], atol=5e-3, err_msg=k)


def test_confusion_formulations_agree_on_the_card(cuda):
    """The confusion probe's bincount, one-hot product and scatter-add on
    an eval-protocol canvas batch with 15% FILL: equal integer counts."""
    from image_segmentation_tpu_torch.probes import confusion_probe

    labels, preds, valid = confusion_probe.inputs(16, 512, 4, cuda)
    counts = {name: fn(labels, preds, valid, 4).cpu()
              for name, fn in confusion_probe.FORMULATIONS.items()}
    assert all(torch.equal(v, counts["bincount"]) for v in counts.values())
    assert int(counts["bincount"].sum()) == int(valid.sum())


def test_dts_up_conv_equals_the_transpose_conv_in_bf16(cuda):
    """step_variants' dts: the 1×1 conv + pixel_shuffle on relabelled
    weights against the transpose conv, bf16 on the card, within two bf16
    steps of the output's largest magnitude (cuDNN sums in another order)."""
    from image_segmentation_tpu_torch.models.layers import UpConv
    from image_segmentation_tpu_torch.probes.step_variants import DtsUpConv

    up = UpConv(1024, 512)
    up.init_weights(torch.Generator().manual_seed(1))
    up = up.to(cuda)
    x = torch.randn(8, 1024, 16, 16, generator=torch.Generator().manual_seed(2)).to(
        cuda, torch.bfloat16, memory_format=torch.channels_last)
    with torch.no_grad():
        _close(DtsUpConv(up)(x), up(x))


def test_backward_anatomy_buckets_add_up_to_the_trace(cuda):
    """backward_anatomy's buckets on a base-8 UNet step (bf16, 4 x 64²)
    account for the trace's device time within 2%."""
    from torch.profiler import record_function

    from image_segmentation_tpu_torch.losses import DiceCELoss
    from image_segmentation_tpu_torch.models.unet import UNet
    from image_segmentation_tpu_torch.probes import backward_anatomy as BA
    from image_segmentation_tpu_torch.train.state import TrainState, make_adamw
    from image_segmentation_tpu_torch.train.steps import train_step

    model = UNet(base=8, dtype=torch.bfloat16).init_weights(torch.Generator().manual_seed(0))
    model = model.to(cuda, memory_format=torch.channels_last)
    state = TrainState(model, make_adamw(model.parameters())[0])
    g = torch.Generator().manual_seed(0)
    x, y = torch.rand(4, 64, 64, 3, generator=g).to(cuda), torch.randint(0, 4, (4, 64, 64)).to(cuda)
    loss = DiceCELoss(ignore_index=3)

    def scoped(lg, t):
        with record_function(BA.LOSS_SCOPE):
            return loss(lg, t)

    train_step(state, scoped, x, y)
    torch.cuda.synchronize()
    with BA.module_scopes(model):
        prof = BA.whole_trace(lambda: [train_step(state, scoped, x, y) for _ in range(2)], cuda,
                              record_shapes=True)
    res = BA.anatomy(model, prof, cuda, 2, per_conv=True, dtype=torch.bfloat16)
    assert abs(res["attributed_share"] - 1.0) <= 0.02, res
    for k in ("fwd/conv", "fwd/bn", "bwd/conv", "bwd/bn", "loss", "optimizer/update"):
        assert res["buckets_ms_per_step"][k] > 0, k
    assert {r["kind"] for r in res["per_conv"]} == {"fwd", "dgrad", "wgrad", "bias"}


if __name__ == "__main__":
    import os
    import sys

    from image_segmentation_tpu_torch.parallel.multihost import initialize_multihost

    name, rank, world, store, out = sys.argv[1:]
    initialize_multihost(store, int(world), int(rank), "cuda")
    result = {"w_gloo_sums": w_gloo_sums, "w_nccl_step": w_nccl_step}[name](int(rank),
                                                                             int(world))
    torch.save(result, os.path.join(out, f"{name}.{rank}.pt"))
    torch.distributed.destroy_process_group()
