"""K4: fused ViT MLP, x + fc2(quickGELU(fc1(LayerNorm(x)))).

Replaces image_segmentation_tpu/ops/pallas/mlp.py:fused_mlp (the Pallas
kernel at `_fused_mlp_impl`). The CUDA kernel is csrc/mlp.cu; its header
says what bounds it on an H100 and how the design answers that.
`mlp_reference` is the same function in plain PyTorch with the kernel's
cast points (mlp.py:75-88): LayerNorm in f32 → cast to x's dtype → fc1
with f32 accumulation + f32 bias → quick-GELU in f32 → cast → fc2 with
f32 accumulation + f32 bias → cast → residual add in x's dtype.

Weights use the nn.Linear layout: w1 is (F, H), w2 is (H, F).
`fused_mlp` takes the plain version only for tensors on the CPU. On a
CUDA tensor it launches the kernel or raises; the kernel has no backward,
so under grad mode an argument that requires grad is refused. While
torch.export traces, it emits `mlp_op` (`istpu::fused_mlp`) instead,
whose CUDA implementation is the same launcher.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from image_segmentation_tpu_torch.ops.kernels import _build

# Launches of the CUDA kernel since the last reset (the plain version on
# the CPU does not count).
LAUNCHES = 0

HIDDEN_SIZES = (128, 256, 384, 512, 640, 768)
TOKEN_TILE = 64  # tokens per tile, the M of wgmma (csrc/mlp.cu kTM)
OUT_TILE = 128  # output columns per tile: fc1's F, fc2's H (kTN)
K_CHUNK = 64  # reduction columns per pipeline stage (kTK)


def mlp_reference(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-5):
    """Plain PyTorch x + fc2(quickGELU(fc1(LN(x)))) with the kernel's casts."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    h = (xf - mu) * torch.rsqrt(var + eps)
    h = (h * ln_w.float() + ln_b.float()).to(x.dtype)
    h = h.float() @ w1.float().t() + b1.float()
    h = (h * torch.sigmoid(1.702 * h)).to(x.dtype)
    y = h.float() @ w2.float().t() + b2.float()
    return x + y.to(x.dtype)


def _check_cuda_args(x, ln_w, ln_b, w1, b1, w2, b2) -> None:
    hdim = x.shape[-1]
    fdim = w1.shape[0]
    if hdim not in HIDDEN_SIZES or fdim <= 0 or fdim % K_CHUNK:
        raise ValueError(
            f"the CUDA kernel takes H in {HIDDEN_SIZES} and F a multiple of "
            f"{K_CHUNK}, got H={hdim} F={fdim}")
    shapes = {"ln_w": (hdim,), "ln_b": (hdim,), "w1": (fdim, hdim),
              "b1": (fdim,), "w2": (hdim, fdim), "b2": (hdim,)}
    dtypes = {"x": torch.bfloat16, "w1": torch.bfloat16, "w2": torch.bfloat16,
              "ln_w": torch.float32, "ln_b": torch.float32,
              "b1": torch.float32, "b2": torch.float32}
    args = {"x": x, "ln_w": ln_w, "ln_b": ln_b, "w1": w1, "b1": b1,
            "w2": w2, "b2": b2}
    for name, t in args.items():
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shapes[name]}")
        if t.dtype != dtypes[name]:
            raise TypeError(f"the CUDA kernel takes {name} as {dtypes[name]}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    _build.refuse_grad("fused_mlp", *args.values())


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@dataclasses.dataclass(frozen=True)
class MlpPlan:
    """How csrc/mlp.cu cuts one call. fc1: token tiles x `runs` blocks,
    each over `tiles_per_run` F tiles of OUT_TILE. fc2: token tiles x
    H / OUT_TILE x `splits` blocks, each over `chunks_per_split` chunks of
    F of K_CHUNK. Scratch: the bf16 intermediate G, and f32 partials of
    fc2 when F is split."""

    token_tiles: int
    runs: int
    tiles_per_run: int
    splits: int
    chunks_per_split: int
    g_shape: tuple
    partial_shape: Optional[tuple]


def mlp_plan(tokens: int, hdim: int, fdim: int, sms: int) -> MlpPlan:
    """The cut for `tokens` rows on a card with `sms` SMs.

    fc1 blocks hold their LayerNorm tile resident (one block an SM): the
    run length is the one with the fewest waves x tiles per block, the
    longer on a tie (fewer LayerNorm recomputations). fc2 splits F only
    when its output tiles are too few to cover the SMs, to about two
    blocks for every three SMs: more splits cost more in f32 partials and
    their reduction than they gain in parallel loads (a sweep of the
    split count on an H100 at 197 and 394 tokens)."""
    tt = -(-tokens // TOKEN_TILE)
    f_tiles = -(-fdim // OUT_TILE)
    best = None
    for per in range(1, f_tiles + 1):
        runs = -(-f_tiles // per)
        cost = -(-tt * runs // sms) * per
        if best is None or cost <= best[0]:
            best = (cost, per, runs)
    _, per, runs = best
    k_chunks = fdim // K_CHUNK
    out_tiles = tt * (hdim // OUT_TILE)
    want = max(1, min(k_chunks, -(-2 * sms // (3 * out_tiles))))
    chunks = -(-k_chunks // want)
    splits = -(-k_chunks // chunks)
    return MlpPlan(tt, runs, per, splits, chunks, (tokens, fdim),
                   (splits, tokens, hdim) if splits > 1 else None)


def _launch(x, ln_w, ln_b, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    """The kernel on CUDA tensors: checks, the plan, one launch, the count."""
    _check_cuda_args(x, ln_w, ln_b, w1, b1, w2, b2)
    hdim, fdim = x.shape[-1], w1.shape[0]
    m = x.numel() // hdim
    out = torch.empty_like(x)
    if m == 0:
        return out
    lib = _build.load()
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    plan = mlp_plan(m, hdim, fdim, _sm_count(dev))
    g = torch.empty(plan.g_shape, dtype=torch.bfloat16, device=x.device)
    partial = (None if plan.partial_shape is None else
               torch.empty(plan.partial_shape, dtype=torch.float32, device=x.device))
    rc = lib.istpu_mlp_bf16(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), g.data_ptr(),
        None if partial is None else partial.data_ptr(), out.data_ptr(), m, hdim, fdim,
        plan.runs, plan.tiles_per_run, plan.splits, plan.chunks_per_split, float(eps), dev,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "fused_mlp launch")
    global LAUNCHES
    LAUNCHES += 1
    return out


# K4 as a torch op, for torch.export: the plain version on the CPU, the
# launcher on CUDA, and the output's shape and dtype while tracing.
mlp_op = torch.library.custom_op(
    "istpu::fused_mlp", _launch, mutates_args=(), device_types="cuda",
    schema="(Tensor x, Tensor ln_w, Tensor ln_b, Tensor w1, Tensor b1, Tensor w2, "
           "Tensor b2, float eps) -> Tensor")
mlp_op.register_kernel("cpu", mlp_reference)
mlp_op.register_fake(lambda x, *_: x.new_empty(x.shape))


def fused_mlp(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-5):
    """x: (..., H); returns x + MLP(LN(x)) in x's dtype."""
    if _build.tracing():
        _build.refuse_grad("fused_mlp", x, ln_w, ln_b, w1, b1, w2, b2)
        return mlp_op(x, ln_w, ln_b, w1, b1, w2, b2, float(eps))
    if x.device.type == "cpu":
        return mlp_reference(x, ln_w, ln_b, w1, b1, w2, b2, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp runs on cpu or cuda, not {x.device}")
    return _launch(x, ln_w, ln_b, w1, b1, w2, b2, eps)
