"""K5: attention with decomposed relative positions, Segment Anything's
image-encoder attention, on (B, S, H, D) with S = h·w:

  out = softmax(q·kᵀ·D^-½ + rel_h[kh] + rel_w[kw])·v,

where key (kh, kw) of the h × w map gets rel_h[b, head, (i, j), kh] +
rel_w[b, head, (i, j), kw], made from the unscaled q and the block's
learned tables Rh (2h − 1, D) and Rw (2w − 1, D):
rel_h[.., (i, j), kh] = q(i, j)·Rh[i − kh + h − 1] and rel_w[.., (i, j), kw]
= q(i, j)·Rw[j − kw + w − 1]. Materialised, the term is S² numbers a head
(805 MB a 1024 px image in float32 at a global block); no (S, S) tensor
is written. The JAX package has
no such kernel: its encoders are CLIP's, whose attention is K3; this one
was added for models/sam.py, whose 8 windowed blocks attend inside
14 × 14 windows (S 196) and whose 4 global blocks over 64 × 64 tokens
(S 4,096): K3 holds at most 256 keys and adds no term.

The CUDA kernel is csrc/relpos_attention.cu; its header says what bounds
it on an H100 (at micro-batch 8 a global call is bound by the tensor
cores, 0.42 ms; a windowed call by the bytes, 0.072 ms) and how the
design answers that: flash attention over key tiles of 64, a block per
192 or 128 queries of one (image, head), the terms made in the block from its
own queries and the tables, in one of two modes (`relpos_plan`): row
tiles where the map is 64 wide (the global blocks: a key tile is one key
row), small maps where both sides are at most 32 (the 14 × 14 windows).

`relpos_attention_reference` is the same function in plain PyTorch
(the terms and the (S, S) logits materialised), with the kernel's cast
points: the terms from q and the tables in q's dtype, summed in f32 and
rounded to q's dtype; logits = (q·k) in f32, × D^-½, + rel_h + rel_w in
f32; softmax in f32; probabilities cast to v's dtype; P·V accumulated in
f32; out in q's dtype. `relpos_attention` routes as every kernel entry
does (`_build.kernel_entry`): the plain version on the CPU, the kernel on
a CUDA tensor (bf16, D = 64; an argument that requires grad is refused
under grad mode), and `relpos_attention_op` (`istpu::relpos_attention`)
while torch.export traces.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from image_segmentation_tpu_torch.ops.kernels import _build

# Launches of the kernel since the last reset (the plain version on the
# CPU does not count).
LAUNCHES = 0

HEAD_DIM = 64
WARPGROUP_Q = 64  # queries a consumer warpgroup (csrc/relpos_attention.cu kTile)
KEY_TILE = 64  # keys a tile (kTile)
STAGES = 3  # K and V tiles in flight (kStages)
ROW_SIDE = 64  # w of the row-tile mode (kRowSide)
MAX_SIDE = 32  # largest h and w of the small-map mode (kMaxSide)
# consumer warpgroups a block, by mode: row tiles, small maps
# (kRowConsumers, kSmallConsumers)
ROW_WARPGROUPS = 3
SMALL_WARPGROUPS = 2


def rel_index(size: int, device) -> torch.Tensor:
    """(size, size) rows of a (2·size − 1, D) table: i − k + size − 1 (a
    query and its keys on one side of the map, as SAM's encoder has them)."""
    i = torch.arange(size, device=device)
    return i[:, None] - i[None, :] + (size - 1)


def map_sides(s: int, rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor) -> tuple:
    """(h, w) of the map the tables (2h − 1, D) and (2w − 1, D) are for;
    raises unless h·w is the S of the call."""
    h, w = (rel_pos_h.shape[0] + 1) // 2, (rel_pos_w.shape[0] + 1) // 2
    if (rel_pos_h.dim() != 2 or rel_pos_w.dim() != 2 or rel_pos_h.shape[0] != 2 * h - 1
            or rel_pos_w.shape[0] != 2 * w - 1 or h * w != s):
        raise ValueError(f"tables {tuple(rel_pos_h.shape)} and {tuple(rel_pos_w.shape)} are "
                         f"not those of an h x w map of {s} tokens")
    return h, w


def relpos_attention_reference(q, k, v, rel_pos_h, rel_pos_w) -> torch.Tensor:
    """Plain PyTorch softmax(QKᵀ/√D + rel_h + rel_w)·V for (B, S, H, D)
    q, k, v and the (2h − 1, D), (2w − 1, D) tables; the terms and the
    (S, S) logits are materialised."""
    b, s, nh, d = q.shape
    h, w = map_sides(s, rel_pos_h, rel_pos_w)
    q5 = q.float().reshape(b, h, w, nh, d)
    r_h = rel_pos_h.to(q.dtype).float()[rel_index(h, q.device)]  # (h, kh, D)
    r_w = rel_pos_w.to(q.dtype).float()[rel_index(w, q.device)]  # (w, kw, D)
    rel_h = torch.einsum("bijnc,ikc->bnijk", q5, r_h).to(q.dtype).float()
    rel_w = torch.einsum("bijnc,jkc->bnijk", q5, r_w).to(q.dtype).float()
    bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(b, nh, s, s)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(d))
    probs = torch.softmax(logits + bias, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)


def _check_cuda_args(q, k, v, rel_pos_h, rel_pos_w) -> None:
    _build.check_heads("relpos_attention", HEAD_DIM, q, k, v, ("rel_pos_h", rel_pos_h),
                       ("rel_pos_w", rel_pos_w))
    map_sides(q.shape[1], rel_pos_h, rel_pos_w)
    for name, t in (("rel_pos_h", rel_pos_h), ("rel_pos_w", rel_pos_w)):
        if t.shape[-1] != HEAD_DIM or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"({t.shape[0]}, {HEAD_DIM}) table")
    _build.refuse_grad("relpos_attention", q, k, v, rel_pos_h, rel_pos_w)


@dataclasses.dataclass(frozen=True)
class RelposPlan:
    """How csrc/relpos_attention.cu cuts one call: a block per (`warpgroups`
    × WARPGROUP_Q queries, head, image), keys in tiles of KEY_TILE;
    `row_tiles` where a key tile is one key row of the map (w = ROW_SIDE),
    small maps otherwise. The wrapper passes the mode, the warpgroups, the
    grid's query tiles and `smem_bytes` to the C entry point, which
    launches with them and refuses a plan that does not cover the call."""

    row_tiles: bool
    warpgroups: int
    grid: tuple
    smem_bytes: int


def relpos_plan(b: int, s: int, nh: int, h: int, w: int) -> RelposPlan:
    """The cut for (B, S, H, 64) over an h × w map; raises for a map that
    is neither 64 wide with at most 64 rows nor at most 32 × 32."""
    if w == ROW_SIDE and 1 <= h <= ROW_SIDE:
        row_tiles, groups = True, ROW_WARPGROUPS
    elif 1 <= h <= MAX_SIDE and 1 <= w <= MAX_SIDE:
        row_tiles, groups = False, SMALL_WARPGROUPS
    else:
        raise ValueError(f"the kernel takes maps {ROW_SIDE} wide with at most {ROW_SIDE} rows, "
                         f"or at most {MAX_SIDE} x {MAX_SIDE}; got {h} x {w}")
    tile_bytes = KEY_TILE * HEAD_DIM * 2
    # 1024 bytes of alignment slack; Q, the K and V stages, two tiles a
    # warpgroup of tables and terms; the small maps' key table; mbarriers
    smem = (1024 + tile_bytes * (3 * groups + 2 * STAGES) + 4 * MAX_SIDE * MAX_SIDE
            + 8 * (2 * STAGES + 1))
    return RelposPlan(row_tiles, groups, (-(-s // (groups * WARPGROUP_Q)), nh, b), smem)


def _launch(q, k, v, rel_pos_h, rel_pos_w) -> torch.Tensor:
    """The kernel on CUDA tensors: checks, the plan, one launch, the count."""
    _check_cuda_args(q, k, v, rel_pos_h, rel_pos_w)
    b, s, nh, d = q.shape
    out = torch.empty((b, s, nh, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    h, w = map_sides(s, rel_pos_h, rel_pos_w)
    plan = relpos_plan(b, s, nh, h, w)  # raises for a map the kernel does not take
    rc = _build.load().istpu_relpos_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_pos_h.data_ptr(), rel_pos_w.data_ptr(),
        out.data_ptr(), b, s, nh, d, h, w, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(plan.row_tiles), plan.warpgroups, plan.grid[0], plan.smem_bytes,
        *_build.device_and_stream(q),
    )
    _build.check(rc, "relpos_attention launch")
    global LAUNCHES
    LAUNCHES += 1
    return out


relpos_attention_op, _route = _build.kernel_entry(
    "relpos_attention", __name__, relpos_attention_reference,
    schema="(Tensor q, Tensor k, Tensor v, Tensor rel_pos_h, Tensor rel_pos_w) -> Tensor",
    fake=lambda q, *_: q.new_empty(q.shape), launcher=_launch)


def relpos_attention(q, k, v, rel_pos_h, rel_pos_w) -> torch.Tensor:
    """softmax(QKᵀ/√D + rel_h + rel_w)·V for (B, S, H, D) q, k, v over an
    h × w map whose tables are rel_pos_h (2h − 1, D) and rel_pos_w
    (2w − 1, D) in q's dtype; returns (B, S, H, D) in q's dtype."""
    return _route(q, k, v, rel_pos_h, rel_pos_w)
