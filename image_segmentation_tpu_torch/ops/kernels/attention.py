"""K3: fused multi-head attention, softmax(QKᵀ/√D)·V on (B, S, H, D).

Replaces image_segmentation_tpu/ops/pallas/attention.py:fused_attention
(the Pallas kernel at `_fused_attention_impl`). The CUDA kernel is
csrc/attention.cu; its header says what bounds it on an H100 and how
the design answers that. `attention_reference` is the same function in
plain PyTorch with the kernel's cast points:

  logits = (q·k) in f32, then × 1/√D;  softmax in f32;
  probabilities cast to v's dtype;  P·V accumulated in f32;  out in q's dtype.

`fused_attention` takes the plain version only for tensors on the CPU.
On a CUDA tensor it launches the kernel (bf16, D = 64) or raises; the
kernel has no backward, so under grad mode an argument that requires
grad is refused. While torch.export traces, it emits `attention_op`
(`istpu::fused_attention`) instead, whose CUDA implementation is the same
launcher.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from image_segmentation_tpu_torch.ops.kernels import _build

# Launches of the CUDA kernel since the last reset (the plain version on
# the CPU does not count).
LAUNCHES = 0

HEAD_DIM = 64
Q_TILE = 64  # query rows per block (csrc/attention.cu kQTile)
KEY_CHUNK = 64  # keys per QKᵀ product (kKChunk)
MAX_SEQ = 256  # keys a block holds in shared memory and registers (4 chunks)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch softmax(QKᵀ/√D)·V for (B, S, H, D) tensors."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)


def _check_cuda_args(q, k, v) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"fused_attention wants equal (B, S, H, D) shapes, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernel takes bfloat16; {name} is {t.dtype}")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"{name} needs a contiguous last dim, 16-byte aligned rows "
                f"and strides that are multiples of 8; got strides {t.stride()}")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head dim {HEAD_DIM}, got {q.shape[-1]}")
    _build.refuse_grad("fused_attention", q, k, v)


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """How csrc/attention.cu cuts one call: a block per (query tile, head,
    batch), every block holding all keys padded to `chunks` × KEY_CHUNK
    (the padding reads as zeros and is masked to -inf). The wrapper passes
    the grid's query tiles, `chunks` and `smem_bytes` to the C entry
    point, which launches with them and refuses a plan that does not
    cover S."""

    grid: tuple
    chunks: int
    padded_keys: int
    smem_bytes: int


def attention_plan(b: int, s: int, h: int) -> AttentionPlan:
    """The cut for (B, S, H, 64); raises past MAX_SEQ tokens."""
    if not 1 <= s <= MAX_SEQ:
        raise ValueError(f"the CUDA kernel takes 1 to {MAX_SEQ} tokens, got {s}")
    chunks = -(-s // KEY_CHUNK)
    tile_bytes = Q_TILE * HEAD_DIM * 2
    # 1024 bytes of alignment slack, Q, K and V, two mbarriers
    smem = 1024 + tile_bytes * (1 + 2 * chunks) + 16
    return AttentionPlan((-(-s // Q_TILE), h, b), chunks, chunks * KEY_CHUNK, smem)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors: checks, the plan, one launch, the count."""
    _check_cuda_args(q, k, v)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    plan = attention_plan(b, s, h)  # raises past MAX_SEQ
    lib = _build.load()
    dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
    rc = lib.istpu_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], plan.grid[0], plan.chunks,
        plan.smem_bytes, dev, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "fused_attention launch")
    global LAUNCHES
    LAUNCHES += 1
    return out


# K3 as a torch op, for torch.export: the plain version on the CPU, the
# launcher on CUDA, and the output's shape and dtype while tracing.
attention_op = torch.library.custom_op(
    "istpu::fused_attention", _launch, mutates_args=(), device_types="cuda",
    schema="(Tensor q, Tensor k, Tensor v) -> Tensor")
attention_op.register_kernel("cpu", attention_reference)
attention_op.register_fake(lambda q, k, v: q.new_empty(q.shape))


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(QKᵀ/√D)·V for (B, S, H, D); returns (B, S, H, D) in q's dtype."""
    if _build.tracing():
        _build.refuse_grad("fused_attention", q, k, v)
        return attention_op(q, k, v)
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cpu or cuda, not {q.device}")
    return _launch(q, k, v)
