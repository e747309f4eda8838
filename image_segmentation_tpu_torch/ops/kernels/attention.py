"""K3: fused multi-head attention, softmax(QKᵀ/√D)·V on (B, S, H, D).

Replaces image_segmentation_tpu/ops/pallas/attention.py:fused_attention
(the Pallas kernel at `_fused_attention_impl`). The CUDA kernel is
csrc/attention.cu; its header says what bounds it on an H100 and how
the design answers that. `attention_reference` is the same function in
plain PyTorch with the kernel's cast points:

  logits = (q·k) in f32, then × 1/√D;  softmax in f32;
  probabilities cast to v's dtype;  P·V accumulated in f32;  out in q's dtype.

`fused_attention` routes as every kernel entry does (`_build.kernel_entry`):
the plain version on the CPU, the kernel on a CUDA tensor (bf16, D = 64;
an argument that requires grad is refused under grad mode), and
`attention_op` (`istpu::fused_attention`) while torch.export traces.
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
    _build.check_heads("fused_attention", HEAD_DIM, q, k, v)
    _build.refuse_grad("fused_attention", q, k, v)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    plan = attention_plan(b, s, h)  # raises past MAX_SEQ
    rc = _build.load().istpu_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], plan.grid[0], plan.chunks,
        plan.smem_bytes, *_build.device_and_stream(q),
    )
    _build.check(rc, "fused_attention launch")
    global LAUNCHES
    LAUNCHES += 1
    return out


attention_op, _route = _build.kernel_entry(
    "fused_attention", __name__, attention_reference,
    schema="(Tensor q, Tensor k, Tensor v) -> Tensor",
    fake=lambda q, k, v: q.new_empty(q.shape), launcher=_launch)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(QKᵀ/√D)·V for (B, S, H, D); returns (B, S, H, D) in q's dtype."""
    return _route(q, k, v)
