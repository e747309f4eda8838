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

`window_relpos_attention` is the small-map mode addressed in place: q, k
and v are the unpadded h × w map itself (SAM's windowed blocks: the qkv
projection's (B, 64, 64, 3, H, 64) output, unbound), and the kernel finds
each ws × ws window there, one window row a TMA box (`window_plan`): a
block takes two tiles of one window's real query rows, so an (image,
head) of the 64 × 64 map in windows of 14 needs 41 blocks where the
70 × 70 padded map's 25 windows took 50; the keys are the window's ws²
positions, those inside the map read where they lie, those in the pad
(past the map's last row or column) taking `bias_k` and `bias_v`, the k
and v rows the qkv projection gives a zero token, which is what SAM's
zero pad after norm1 feeds it; the output is written once for each real
query, at its map position. It computes the partitioned call on the
padded map (its keys meet the online softmax in other tiles, so the two
agree to rounding) without the pad, partition, unpartition and crop
copies around it. Its plain version, `window_relpos_attention_reference`,
is those copies around `relpos_attention_reference`.

Without tables (SAM 2's Hiera, models/hiera.py): `attention_no_tables`
and `window_attention_no_tables` are the same two calls with no relative
terms, softmax(q·kᵀ·D^-½)·v, at head dim 56 (NO_TABLE_HEAD_DIM) on a
card: the partitioned call in the row-tile mode alone (Hiera's global
64 × 64 maps) and the window map (its windows of 8, 14 and 7 on the
unpadded 256², 64² and 32² maps). The kernel reads the rows of 56 into
its 64-wide tiles, the last 8 columns zeros, and writes 56 a row; it
loads no table and makes no term.

`relpos_attention_reference` is the same function in plain PyTorch
(the terms and the (S, S) logits materialised), with the kernel's cast
points: the terms from q and the tables in q's dtype, summed in f32 and
rounded to q's dtype; logits = (q·k) in f32, × D^-½, + rel_h + rel_w in
f32; softmax in f32; probabilities cast to v's dtype; P·V accumulated in
f32; out in q's dtype. `relpos_attention` routes as every kernel entry
does (`_build.kernel_entry`): the plain version on the CPU, the kernel on
a CUDA tensor (bf16, D = 64; an argument that requires grad is refused
under grad mode), and `relpos_attention_op` (`istpu::relpos_attention`)
while torch.export traces; `window_relpos_attention` likewise, with
`window_relpos_attention_op` (`istpu::window_relpos_attention`), and the
two no-table entries with `attention_no_tables_op` and
`window_attention_no_tables_op`, whose plain versions are the same
function without the terms. Every entry counts in LAUNCHES, the window
entries in WINDOW_MAP_LAUNCHES too.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from image_segmentation_tpu_torch.ops.kernels import _build

# Launches of the kernel since the last reset (the plain versions on the
# CPU do not count): every call, and those of the window map alone.
LAUNCHES = 0
WINDOW_MAP_LAUNCHES = 0

HEAD_DIM = 64  # with tables; the tiles' columns
NO_TABLE_HEAD_DIM = 56  # without (csrc/relpos_attention.cu kPlainHeadDim)
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


def _attend(q, k, v, bias=None) -> torch.Tensor:
    """softmax(q·kᵀ in f32 × D^-½ (+ bias))·v with the kernel's cast points,
    the (S, S) logits materialised; (B, S, H, D) in and out."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(d))
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)


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
    return _attend(q, k, v, (rel_h[..., :, None] + rel_w[..., None, :]).reshape(b, nh, s, s))


def attention_no_tables_reference(q, k, v, h: int, w: int) -> torch.Tensor:
    """Plain PyTorch softmax(QKᵀ/√D)·V for (B, S, H, D) q, k, v over an
    h × w map of S tokens (h·w = S), with the kernel's cast points."""
    if h * w != q.shape[1]:
        raise ValueError(f"an {h} x {w} map is not {q.shape[1]} tokens")
    return _attend(q, k, v)


def window_partition(x: torch.Tensor, ws: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) → (B·nh·nw, ws, ws, C) windows of the map zero-padded to
    multiples of ws, and the padded (Hp, Wp)."""
    b, h, w, c = x.shape
    pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.view(b, hp // ws, ws, wp // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(windows: torch.Tensor, ws: int, pad_hw: Tuple[int, int],
                       hw: Tuple[int, int]) -> torch.Tensor:
    """The inverse of `window_partition`, cropped back to (H, W)."""
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // ws // ws)
    x = windows.view(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w, :].contiguous() if (hp > h or wp > w) else x


def _in_windows(q, k, v, bias_k, bias_v, window: int, attend) -> torch.Tensor:
    """`attend` on (B', window², H, D) q, k, v in each window × window window
    of the (B, h, w, H, D) map padded to multiples of `window`: q with
    zeros, k and v with the (H, D) rows bias_k and bias_v; (B, h, w, H, D)
    out, the padded queries' rows cropped."""
    b, h, w, nh, d = q.shape
    hp, wp = -(-h // window) * window, -(-w // window) * window

    def windows(t, fill):
        full = (t.new_zeros(()) if fill is None else fill.to(t.dtype)).expand(
            b, hp, wp, nh, d).clone()
        full[:, :h, :w] = t
        return window_partition(full.reshape(b, hp, wp, nh * d), window)[0].reshape(
            -1, window * window, nh, d)

    out = attend(windows(q, None), windows(k, bias_k), windows(v, bias_v))
    out = window_unpartition(out.reshape(-1, window, window, nh * d), window, (hp, wp), (h, w))
    return out.reshape(b, h, w, nh, d)


def window_relpos_attention_reference(q, k, v, bias_k, bias_v, rel_pos_h, rel_pos_w,
                                      window: int) -> torch.Tensor:
    """`relpos_attention_reference` in each window × window window of the
    (B, h, w, H, D) map q, k, v padded to multiples of `window` (`_in_windows`)."""
    return _in_windows(q, k, v, bias_k, bias_v, window,
                       lambda *qkv: relpos_attention_reference(*qkv, rel_pos_h, rel_pos_w))


def window_attention_no_tables_reference(q, k, v, bias_k, bias_v, window: int) -> torch.Tensor:
    """`attention_no_tables_reference` in each window × window window of the
    (B, h, w, H, D) map q, k, v padded to multiples of `window` (`_in_windows`)."""
    return _in_windows(q, k, v, bias_k, bias_v, window,
                       lambda *qkv: attention_no_tables_reference(*qkv, window, window))


def _check_rows(head_dim: int, **rows) -> None:
    """Raise unless each (name → tensor) is a contiguous, 16-byte aligned
    table of rows of `head_dim`, which the kernel reads row by row."""
    for name, t in rows.items():
        if t.shape[-1] != head_dim or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"({t.shape[0]}, {head_dim}) table")


def _check_cuda_args(q, k, v, rel_pos_h, rel_pos_w, sides=None) -> None:
    """With tables: D = HEAD_DIM and tables of the map; without (None):
    D = NO_TABLE_HEAD_DIM and `sides` (h, w) a map of S tokens."""
    if rel_pos_h is None or rel_pos_w is None:
        if rel_pos_h is not rel_pos_w:
            raise ValueError("relpos_attention takes both tables or neither")
        _build.check_heads("attention_no_tables", NO_TABLE_HEAD_DIM, q, k, v)
        if sides[0] * sides[1] != q.shape[1]:
            raise ValueError(f"an {sides[0]} x {sides[1]} map is not {q.shape[1]} tokens")
        _build.refuse_grad("attention_no_tables", q, k, v)
        return
    _build.check_heads("relpos_attention", HEAD_DIM, q, k, v, ("rel_pos_h", rel_pos_h),
                       ("rel_pos_w", rel_pos_w))
    map_sides(q.shape[1], rel_pos_h, rel_pos_w)
    _check_rows(HEAD_DIM, rel_pos_h=rel_pos_h, rel_pos_w=rel_pos_w)
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


def _smem_bytes(groups: int, tables: bool) -> int:
    """1024 bytes of alignment slack; Q, the K and V stages, with tables two
    tiles a warpgroup of tables and terms; the small maps' key table; the
    mbarriers (csrc/relpos_attention.cu smem_bytes)."""
    tile_bytes = KEY_TILE * HEAD_DIM * 2
    return (1024 + tile_bytes * ((3 if tables else 1) * groups + 2 * STAGES)
            + 4 * MAX_SIDE * MAX_SIDE + 8 * (3 * STAGES + 1))


def relpos_plan(b: int, s: int, nh: int, h: int, w: int, tables: bool = True) -> RelposPlan:
    """The cut for (B, S, H, D) over an h × w map; raises for a map that
    is neither 64 wide with at most 64 rows nor, with tables, at most
    32 × 32 (without tables the row-tile mode alone is built)."""
    if w == ROW_SIDE and 1 <= h <= ROW_SIDE:
        row_tiles, groups = True, ROW_WARPGROUPS
    elif tables and 1 <= h <= MAX_SIDE and 1 <= w <= MAX_SIDE:
        row_tiles, groups = False, SMALL_WARPGROUPS
    elif tables:
        raise ValueError(f"the kernel takes maps {ROW_SIDE} wide with at most {ROW_SIDE} rows, "
                         f"or at most {MAX_SIDE} x {MAX_SIDE}; got {h} x {w}")
    else:
        raise ValueError(f"without tables the kernel takes maps {ROW_SIDE} wide with at most "
                         f"{ROW_SIDE} rows (its row-tile mode); got {h} x {w}")
    return RelposPlan(row_tiles, groups, (-(-s // (groups * WARPGROUP_Q)), nh, b),
                      _smem_bytes(groups, tables))


def slot_pitch(cols: int) -> int:
    """Slots a window row of `cols` keys or queries takes in a 64-row tile
    (csrc/relpos_attention.cu slot_pitch): 8, 16 or 32."""
    return 8 if cols <= 8 else 16 if cols <= 16 else 32


def window_query_tiles(h: int, w: int, ws: int) -> int:
    """Blocks of one (image, head) of an h × w map in ws × ws windows: each
    window's real rows (those inside the map), SMALL_WARPGROUPS tiles of
    KEY_TILE // slot_pitch(real width) rows a block
    (csrc/relpos_attention.cu window_map_blocks)."""
    sides = lambda n: [min(ws, n - i) for i in range(0, n, ws)]  # noqa: E731
    rows = lambda rw: SMALL_WARPGROUPS * (KEY_TILE // slot_pitch(rw))  # noqa: E731
    return sum(-(-rh // rows(rw)) for rh in sides(h) for rw in sides(w))


def window_plan(b: int, h: int, w: int, nh: int, ws: int, tables: bool = True) -> RelposPlan:
    """The cut of a window-map call over (B, h, w, H, D): the small-map
    mode's warpgroups and shared memory for one ws × ws window, and
    `window_query_tiles` blocks an (image, head)."""
    if not 1 <= ws <= MAX_SIDE:
        raise ValueError(f"the kernel takes windows of at most {MAX_SIDE} x {MAX_SIDE}; got {ws}")
    return RelposPlan(False, SMALL_WARPGROUPS, (window_query_tiles(h, w, ws), nh, b),
                      _smem_bytes(SMALL_WARPGROUPS, tables))


def _check_window_args(q, k, v, bias_k, bias_v, rel_pos_h, rel_pos_w) -> None:
    """As `_check_cuda_args`, for (B, h, w, H, D) maps whose (h, w) merge
    into one token stride (a view, or a refusal: never a copy), (H, D)
    bias rows and a window's two (2·ws − 1, D) tables, D = HEAD_DIM; or no
    tables (None) and D = NO_TABLE_HEAD_DIM."""
    tables = rel_pos_h is not None and rel_pos_w is not None
    if not tables and rel_pos_h is not rel_pos_w:
        raise ValueError("window_relpos_attention takes both tables or neither")
    op = "window_relpos_attention" if tables else "window_attention_no_tables"
    if q.dim() != 5:
        raise ValueError(f"{op} wants (B, h, w, H, D) maps, got {tuple(q.shape)}")
    b, h, w, nh, d = q.shape
    heads = [t.view(b, h * w, nh, d) for t in (q, k, v)]
    named = (("rel_pos_h", rel_pos_h), ("rel_pos_w", rel_pos_w)) if tables else ()
    _build.check_heads(op, HEAD_DIM if tables else NO_TABLE_HEAD_DIM, *heads, ("bias_k", bias_k),
                       ("bias_v", bias_v), *named)
    if bias_k.shape != (nh, d) or bias_v.shape != (nh, d):
        raise ValueError(f"bias_k and bias_v must be ({nh}, {d}), got {tuple(bias_k.shape)} "
                         f"and {tuple(bias_v.shape)}")
    if tables and (rel_pos_w.shape[0] != rel_pos_h.shape[0] or rel_pos_h.shape[0] % 2 == 0):
        raise ValueError(f"tables {tuple(rel_pos_h.shape)} and {tuple(rel_pos_w.shape)} are "
                         f"not those of a square window")
    _check_rows(d, bias_k=bias_k, bias_v=bias_v, **dict(named))
    _build.refuse_grad(op, q, k, v, bias_k, bias_v, *(t for _, t in named))


def _ptr(t):
    """A tensor's address, or None (a null pointer) for an absent table."""
    return None if t is None else t.data_ptr()


def _launch(q, k, v, rel_pos_h, rel_pos_w, bias_k=None, bias_v=None,
            sides=None) -> torch.Tensor:
    """The kernel on CUDA tensors: checks, the plan, one launch, the count.
    With `bias_k` and `bias_v` q, k and v are a (B, h, w, H, D) map
    attended in windows (`window_relpos_attention`). Without tables (both
    None) `sides` is the (h, w) of the map, or of a window."""
    if bias_k is not None:
        return _launch_window(q, k, v, rel_pos_h, rel_pos_w, bias_k, bias_v, sides)
    _check_cuda_args(q, k, v, rel_pos_h, rel_pos_w, sides)
    b, s, nh, d = q.shape
    out = torch.empty((b, s, nh, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    tables = rel_pos_h is not None
    h, w = map_sides(s, rel_pos_h, rel_pos_w) if tables else sides
    plan = relpos_plan(b, s, nh, h, w, tables)  # raises for a map the kernel does not take
    rc = _build.load().istpu_relpos_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(rel_pos_h), _ptr(rel_pos_w),
        out.data_ptr(), b, s, nh, d, h, w, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(plan.row_tiles), plan.warpgroups, plan.grid[0], plan.smem_bytes,
        *_build.device_and_stream(q),
    )
    _build.check(rc, "relpos_attention launch")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _launch_window(q, k, v, rel_pos_h, rel_pos_w, bias_k, bias_v, sides) -> torch.Tensor:
    _check_window_args(q, k, v, bias_k, bias_v, rel_pos_h, rel_pos_w)
    b, h, w, nh, d = q.shape
    out = torch.empty((b, h, w, nh, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    tables = rel_pos_h is not None
    ws = (rel_pos_h.shape[0] + 1) // 2 if tables else sides[0]
    plan = window_plan(b, h, w, nh, ws, tables)
    # (batch, token, head) strides; a map row is w tokens (the view checked above)
    strides = [s for t in (q, k, v) for s in (t.stride(0), t.stride(2), t.stride(3))]
    rc = _build.load().istpu_relpos_window_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_k.data_ptr(), bias_v.data_ptr(),
        _ptr(rel_pos_h), _ptr(rel_pos_w), out.data_ptr(), b, h, w, nh, d, ws,
        *strides, plan.grid[0], plan.smem_bytes, *_build.device_and_stream(q))
    _build.check(rc, "window_relpos_attention launch")
    global LAUNCHES, WINDOW_MAP_LAUNCHES
    LAUNCHES += 1
    WINDOW_MAP_LAUNCHES += 1
    return out


relpos_attention_op, _route = _build.kernel_entry(
    "relpos_attention", __name__, relpos_attention_reference,
    schema="(Tensor q, Tensor k, Tensor v, Tensor rel_pos_h, Tensor rel_pos_w) -> Tensor",
    fake=lambda q, *_: q.new_empty(q.shape), launcher=_launch)
window_relpos_attention_op, _route_window = _build.kernel_entry(
    "window_relpos_attention", __name__, window_relpos_attention_reference,
    schema="(Tensor q, Tensor k, Tensor v, Tensor bias_k, Tensor bias_v, Tensor rel_pos_h, "
           "Tensor rel_pos_w, int window) -> Tensor",
    fake=lambda q, *_: q.new_empty(q.shape),
    launcher=lambda q, k, v, bk, bv, rh, rw, window: _launch(q, k, v, rh, rw, bk, bv),
    launch_args=lambda q, k, v, bk, bv, rh, rw, window: (q, k, v, rh, rw, bk, bv))
attention_no_tables_op, _route_no_tables = _build.kernel_entry(
    "attention_no_tables", __name__, attention_no_tables_reference,
    schema="(Tensor q, Tensor k, Tensor v, int h, int w) -> Tensor",
    fake=lambda q, *_: q.new_empty(q.shape),
    launcher=lambda q, k, v, h, w: _launch(q, k, v, None, None, sides=(h, w)),
    launch_args=lambda q, k, v, h, w: (q, k, v, None, None, None, None, (h, w)))
window_attention_no_tables_op, _route_window_no_tables = _build.kernel_entry(
    "window_attention_no_tables", __name__, window_attention_no_tables_reference,
    schema="(Tensor q, Tensor k, Tensor v, Tensor bias_k, Tensor bias_v, int window) -> Tensor",
    fake=lambda q, *_: q.new_empty(q.shape),
    launcher=lambda q, k, v, bk, bv, window: _launch(q, k, v, None, None, bk, bv,
                                                     (window, window)),
    launch_args=lambda q, k, v, bk, bv, window: (q, k, v, None, None, bk, bv, (window, window)))


def relpos_attention(q, k, v, rel_pos_h, rel_pos_w) -> torch.Tensor:
    """softmax(QKᵀ/√D + rel_h + rel_w)·V for (B, S, H, D) q, k, v over an
    h × w map whose tables are rel_pos_h (2h − 1, D) and rel_pos_w
    (2w − 1, D) in q's dtype; returns (B, S, H, D) in q's dtype."""
    return _route(q, k, v, rel_pos_h, rel_pos_w)


def window_relpos_attention(q, k, v, bias_k, bias_v, rel_pos_h, rel_pos_w,
                            window: int) -> torch.Tensor:
    """softmax(QKᵀ/√D + rel_h + rel_w)·V inside each window × window window
    of the (B, h, w, H, D) map q, k, v (strided views of one qkv projection
    are read in place), the map padded to multiples of `window` with keys
    and values bias_k and bias_v (H, D), as a zero token gets them; the
    tables are the window's, (2·window − 1, D), in q's dtype. Returns the
    map's (B, h, w, H, D) in q's dtype (module docstring)."""
    if rel_pos_h.shape[0] != 2 * window - 1 or rel_pos_w.shape[0] != 2 * window - 1:
        raise ValueError(f"tables {tuple(rel_pos_h.shape)} and {tuple(rel_pos_w.shape)} are not "
                         f"those of a {window} x {window} window")
    return _route_window(q, k, v, bias_k, bias_v, rel_pos_h, rel_pos_w, window)


def attention_no_tables(q, k, v, h: int, w: int) -> torch.Tensor:
    """softmax(QKᵀ/√D)·V for (B, S, H, D) q, k, v over an h × w map of S
    tokens, K5 without tables: on a card D = 56 and a map 64 wide (the
    row-tile mode); returns (B, S, H, D) in q's dtype."""
    return _route_no_tables(q, k, v, h, w)


def window_attention_no_tables(q, k, v, bias_k, bias_v, window: int) -> torch.Tensor:
    """softmax(QKᵀ/√D)·V inside each window × window window of the
    (B, h, w, H, D) map q, k, v, padded to multiples of `window` with keys
    and values bias_k and bias_v (H, D), as `window_relpos_attention` with
    no tables: on a card D = 56. Returns (B, h, w, H, D) in q's dtype."""
    return _route_window_no_tables(q, k, v, bias_k, bias_v, window)
