"""K4: fused ViT MLP, x + fc2(GELU(fc1(LayerNorm(x)))).

Replaces image_segmentation_tpu/ops/pallas/mlp.py:fused_mlp (the Pallas
kernel at `_fused_mlp_impl`). The CUDA kernel is csrc/mlp.cu; its header
says what bounds it on an H100 and how the design answers that.
`mlp_reference` is the same function in plain PyTorch with the kernel's
cast points (mlp.py:75-88): LayerNorm in f32 → cast to x's dtype → fc1
with f32 accumulation + f32 bias → GELU in f32 → cast → fc2 with
f32 accumulation + f32 bias → cast → residual add in x's dtype.

`activation` picks the GELU: "quick_gelu" (h·sigmoid(1.702 h), CLIP's,
the default, which every ClipUNet call takes) or "gelu" (the exact
0.5 h (1 + erf(h/√2)), Segment Anything's image encoder,
models/sam.py); the CUDA kernel compiles its fc1 epilogue once for each
(`ACTIVATIONS` gives the number the C entry point takes).

The kernel has two designs, picked by `mlp_plan` from what the call shows
(its token count and width, never the model or the activation): v2 for
few tokens (ClipUNet's requests and batches, and always the TP entry) at
the widths in HIDDEN_SIZES, and v3 at the widths in MANY_TOKEN_HIDDEN: a
LayerNorm pass, then fc1 and fc2 as persistent warp-specialised GEMMs
over bands of 128 tokens (csrc/mlp.cu's header says why and what bounds
each). v3 runs from MANY_TOKENS tokens on at a width both build (768:
SAM's encoder at 32,768 tokens a micro-batch of 8), and at every token
count at a width only v3 builds: SAM 2's Hiera-B+ at 112, 224, 448 and
896 (models/hiera.py), whose K (fc1's H) need not be a multiple of
K_CHUNK nor whose N (fc2's H, fc1's F) of OUT_TILE. Each design has its
plan (`MlpPlan`, `ManyTokenPlan`) and its C entry point. At 768 the two
give the same bits; `MANY_TOKEN_LAUNCHES` counts the calls that ran v3,
which `LAUNCHES` counts too.

Weights use the nn.Linear layout: w1 is (F, H), w2 is (H, F); the kernel
takes the widths `kernel_takes` admits. `fused_mlp` routes as every
kernel entry does (`_build.kernel_entry`): the plain version on the CPU,
the kernel on a CUDA tensor (an argument that requires grad is refused
under grad mode), and `mlp_op` (`istpu::fused_mlp`) while torch.export
traces.

`fused_mlp_partial(x, ln_w, ln_b, w1, b1, w2)` is K4's tensor-parallel
entry: fc2(quickGELU(fc1(LN(x)))) as f32 (tokens, H), with neither the fc2
bias nor the residual, for a rank that holds F/T of fc1's outputs and of
fc2's inputs (parallel/tp.py). The partial sums of the model group are
all-reduced in f32 before `x + (Σ + b2)` is rounded once, as K4 rounds it;
a bf16 output with the residual in it would lose the bits that matter.
On a card it is the same source's fc1 stage and fc2 stage, whose f32
partials (one per split of F, reduced in split order) are the output, with
no bias + residual epilogue. Its plain version is `mlp_partial_reference`,
its count `PARTIAL_LAUNCHES`; it has no op.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from image_segmentation_tpu_torch.ops.kernels import _build

# Launches of the CUDA kernel since the last reset (the plain version on
# the CPU does not count), of its tensor-parallel entry, and of those
# LAUNCHES that ran v3, the many-token design.
LAUNCHES = 0
PARTIAL_LAUNCHES = 0
MANY_TOKEN_LAUNCHES = 0

# v2's widths (fc1's A tile resident, fc2's output in 128-wide tiles), the
# TP entry's too
HIDDEN_SIZES = (128, 256, 384, 512, 640, 768)
# the GELUs of the fc1 epilogue, as csrc/mlp.cu numbers them (`Act`)
ACTIVATIONS = {"quick_gelu": 0, "gelu": 1}
TOKEN_TILE = 64  # tokens per tile, the M of wgmma (csrc/mlp.cu kTM)
OUT_TILE = 128  # output columns per tile: fc1's F, fc2's H (kTN)
K_CHUNK = 64  # reduction columns per pipeline stage (kTK)
# v3's widths, as csrc/mlp.cu's run_mlp_many builds its LayerNorm pass:
# SAM ViT-B's 768 and SAM 2 Hiera-B+'s four stages. At a width v2 builds
# too (768), v3 runs from MANY_TOKENS tokens on: the smallest token count
# of a sweep on an H100 at H 768, F 3,072 with both GELUs from which v3 is
# at least as fast as v2 both on the device and from Python (PERF.md §6).
# Below it the callers are ClipUNet's serving batches, where v3's extra
# launch and tensor maps cost more host time than its kernels save. The
# widths v2 does not build run v3 at every token count.
MANY_TOKENS = 3152
MANY_TOKEN_HIDDEN = (112, 224, 448, 768, 896)


def _gelu_stage(x, ln_w, ln_b, w1, b1, eps: float, activation: str = "quick_gelu"):
    """G = GELU(fc1(LN(x))) rounded to x's dtype, with the kernel's casts."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    h = (xf - mu) * torch.rsqrt(var + eps)
    h = (h * ln_w.float() + ln_b.float()).to(x.dtype)
    h = h.float() @ w1.float().t() + b1.float()
    if activation == "gelu":
        return torch.nn.functional.gelu(h).to(x.dtype)
    if activation != "quick_gelu":
        raise ValueError(f"activation {activation!r}; known: {sorted(ACTIVATIONS)}")
    return (h * torch.sigmoid(1.702 * h)).to(x.dtype)


def mlp_reference(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-5,
                  activation: str = "quick_gelu"):
    """Plain PyTorch x + fc2(GELU(fc1(LN(x)))) with the kernel's casts."""
    y = (_gelu_stage(x, ln_w, ln_b, w1, b1, eps, activation).float() @ w2.float().t()
         + b2.float())
    return x + y.to(x.dtype)


def mlp_partial_reference(x, ln_w, ln_b, w1, b1, w2, eps: float = 1e-5):
    """Plain PyTorch fc2(quickGELU(fc1(LN(x)))) as f32, no fc2 bias, no residual."""
    return _gelu_stage(x, ln_w, ln_b, w1, b1, eps).float() @ w2.float().t()


def kernel_takes(hdim: int, fdim: int) -> bool:
    """Whether the CUDA kernel takes an MLP of width H `hdim` and hidden
    width F `fdim` (fc1's outputs; a rank's share of them in the TP entry):
    the rule a model reads before it calls `fused_mlp` on a card."""
    return hdim in HIDDEN_SIZES + MANY_TOKEN_HIDDEN and fdim > 0 and fdim % K_CHUNK == 0


def _check_cuda_args(op: str, x, ln_w, ln_b, w1, b1, w2, b2=None) -> None:
    hdim = x.shape[-1]
    fdim = w1.shape[0]
    if not kernel_takes(hdim, fdim):
        raise ValueError(
            f"the CUDA kernel takes H in {tuple(sorted(set(HIDDEN_SIZES + MANY_TOKEN_HIDDEN)))} "
            f"and F a multiple of {K_CHUNK}, got H={hdim} F={fdim}")
    if b2 is None and hdim not in HIDDEN_SIZES:  # the TP entry runs v2 alone
        raise ValueError(f"the CUDA kernel's TP entry takes H in {HIDDEN_SIZES}, got H={hdim}")
    shapes = {"ln_w": (hdim,), "ln_b": (hdim,), "w1": (fdim, hdim),
              "b1": (fdim,), "w2": (hdim, fdim), "b2": (hdim,)}
    args = {"x": x, "ln_w": ln_w, "ln_b": ln_b, "w1": w1, "b1": b1, "w2": w2}
    if b2 is not None:
        args["b2"] = b2
    _build.check_operands(args, shapes, ("ln_w", "ln_b", "b1", "b2"))
    _build.refuse_grad(op, *args.values())


@dataclasses.dataclass(frozen=True)
class MlpPlan:
    """How csrc/mlp.cu's v2 cuts one call. fc1: token tiles x `runs`
    blocks, each over `tiles_per_run` F tiles of OUT_TILE. fc2: token
    tiles x H / OUT_TILE x `splits` blocks, each over `chunks_per_split`
    chunks of F of K_CHUNK. Scratch: the bf16 intermediate G, and f32
    partials of fc2 when F is split."""

    token_tiles: int
    runs: int
    tiles_per_run: int
    splits: int
    chunks_per_split: int
    g_shape: tuple
    partial_shape: Optional[tuple]


@dataclasses.dataclass(frozen=True)
class ManyTokenPlan:
    """v3, the many-token design: the LayerNorm pass into the `ln_shape`
    scratch, then persistent fc1 (into G, `g_shape`) and fc2 over bands of
    128 tokens, one block an SM, which csrc/mlp.cu cuts itself."""

    g_shape: tuple
    ln_shape: tuple


def mlp_plan(tokens: int, hdim: int, fdim: int, sms: int, tp: bool = False):
    """The cut for `tokens` rows on a card with `sms` SMs: a ManyTokenPlan
    (v3) at a width in MANY_TOKEN_HIDDEN, from MANY_TOKENS tokens on where
    v2 builds the width too and at every count where it does not, except
    for the tensor-parallel entry (`tp`), which always runs v2; otherwise
    an MlpPlan (v2).

    v2's fc1 blocks hold their LayerNorm tile resident (one block an SM):
    the run length is the one with the fewest waves x tiles per block, the
    longer on a tie (fewer LayerNorm recomputations). fc2 splits F only
    when its output tiles are too few to cover the SMs, to about two
    blocks for every three SMs: more splits cost more in f32 partials and
    their reduction than they gain in parallel loads (a sweep of the
    split count on an H100 at 197 and 394 tokens)."""
    if (not tp and hdim in MANY_TOKEN_HIDDEN
            and (tokens >= MANY_TOKENS or hdim not in HIDDEN_SIZES)):
        return ManyTokenPlan((tokens, fdim), (tokens, hdim))
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


def _launch(x, ln_w, ln_b, w1, b1, w2, b2, eps: float,
            activation: str = "quick_gelu") -> torch.Tensor:
    """The kernel on CUDA tensors: checks, the plan, the C entry point of
    the plan's design, the counts. With `b2` None it is the TP entry: the
    f32 partial, no bias, no residual (quick GELU only)."""
    entry = "fused_mlp" if b2 is not None else "fused_mlp_partial"
    if activation not in ACTIVATIONS or (b2 is None and activation != "quick_gelu"):
        raise ValueError(f"{entry} takes activation in {sorted(ACTIVATIONS)} (the TP entry "
                         f"quick_gelu alone), got {activation!r}")
    _check_cuda_args(entry, x, ln_w, ln_b, w1, b1, w2, b2)
    hdim, fdim = x.shape[-1], w1.shape[0]
    m = x.numel() // hdim
    out = (torch.empty_like(x) if b2 is not None else
           torch.empty(x.shape, dtype=torch.float32, device=x.device))
    if m == 0:
        return out
    lib = _build.load()
    dev, stream = _build.device_and_stream(x)
    sms = _build.sm_count(dev)
    plan = mlp_plan(m, hdim, fdim, sms, tp=b2 is None)
    g = torch.empty(plan.g_shape, dtype=torch.bfloat16, device=x.device)
    ptrs = [t.data_ptr() for t in (x, ln_w, ln_b, w1, b1, w2)]
    global LAUNCHES, PARTIAL_LAUNCHES, MANY_TOKEN_LAUNCHES
    if isinstance(plan, ManyTokenPlan):
        xn = torch.empty(plan.ln_shape, dtype=torch.bfloat16, device=x.device)
        rc = lib.istpu_mlp_many_bf16(*ptrs, b2.data_ptr(), xn.data_ptr(), g.data_ptr(),
                                     out.data_ptr(), m, hdim, fdim, sms, float(eps),
                                     ACTIVATIONS[activation], dev, stream)
    else:
        partial = (None if plan.partial_shape is None else
                   torch.empty(plan.partial_shape, dtype=torch.float32, device=x.device))
        v2 = (g.data_ptr(), None if partial is None else partial.data_ptr(), out.data_ptr(),
              m, hdim, fdim, plan.runs, plan.tiles_per_run, plan.splits,
              plan.chunks_per_split, float(eps))
        if b2 is None:
            rc = lib.istpu_mlp_partial_bf16(*ptrs, *v2, dev, stream)
            _build.check(rc, f"{entry} launch")
            PARTIAL_LAUNCHES += 1
            return out
        rc = lib.istpu_mlp_bf16(*ptrs, b2.data_ptr(), *v2, ACTIVATIONS[activation], dev, stream)
    _build.check(rc, f"{entry} launch")
    LAUNCHES += 1
    if isinstance(plan, ManyTokenPlan):
        MANY_TOKEN_LAUNCHES += 1
    return out


mlp_op, _route = _build.kernel_entry(
    "fused_mlp", __name__, mlp_reference,
    schema="(Tensor x, Tensor ln_w, Tensor ln_b, Tensor w1, Tensor b1, Tensor w2, "
           "Tensor b2, float eps, str activation=\"quick_gelu\") -> Tensor",
    fake=lambda x, *_: x.new_empty(x.shape), launcher=_launch)
_, _route_partial = _build.kernel_entry(
    "fused_mlp_partial", __name__, mlp_partial_reference,
    launch_args=lambda x, ln_w, ln_b, w1, b1, w2, eps: (x, ln_w, ln_b, w1, b1, w2, None, eps))


def fused_mlp(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-5,
              activation: str = "quick_gelu"):
    """x: (..., H); returns x + MLP(LN(x)) in x's dtype, the MLP's GELU
    being `activation` (module docstring)."""
    return _route(x, ln_w, ln_b, w1, b1, w2, b2, float(eps), activation)


def fused_mlp_partial(x, ln_w, ln_b, w1, b1, w2, eps: float = 1e-5):
    """x: (..., H); returns fc2(quickGELU(fc1(LN(x)))) as f32 (..., H), with no
    fc2 bias and no residual: one model rank's share of a row-parallel fc2
    (module docstring). F (w1's rows) a multiple of K_CHUNK on a card."""
    return _route_partial(x, ln_w, ln_b, w1, b1, w2, eps)
