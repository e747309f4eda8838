"""Hiera, SAM 2's image trunk, and its FPN neck: the image encoder of
SAM 2.1 Hiera-B+ (models/sam2.py).

No JAX counterpart. This is Ryali et al., "Hiera" (2023), as SAM 2 builds
it (Ravi et al., "SAM 2", 2024): `sam2/modeling/backbones/hieradet.py`
`Hiera` and `image_encoder.py` `FpnNeck`, with their parameter names, so
that a converted checkpoint would load by name.

  * The trunk: a 7 × 7, stride-4 patch conv (padding 3) to a (H/4, W/4)
    map; + a position embedding, the (14, 14) `pos_embed` interpolated
    bicubically to the map plus the (8, 8) `pos_embed_window` tiled over
    it; then `sum(stages)` pre-norm blocks in four stages. Each stage
    after the first opens with a pooled-query block: it attends in the
    previous stage's window, max-pools q 2 × 2 inside each window (k and
    v are not pooled), takes the new width (× dim_mul) and heads
    (× head_mul), and its shortcut is maxpool(Linear(dim → dim_out)(norm1
    x)); its output is unpartitioned at half the window and cropped to
    the pooled map. The other blocks attend in the stage's window
    (`window_spec`) but the global ones (`global_att_blocks`), which
    attend over the whole map. Attention is softmax(q·kᵀ·d^-½)·v with no
    relative positions; windows are those of the map zero-padded after
    norm1 to multiples of the window, so a pad token's k and v are the
    qkv bias. MLP: Linear, exact GELU, Linear, ratio 4. LayerNorm eps
    1e-6. The four stages' last outputs are the trunk's four levels.
  * The neck: a 1 × 1 conv to `d_model` of each level (`convs[0]` takes
    the coarsest), the top-down path from the coarsest level, adding the
    nearest ×2 upsampling of the level below at `fpn_top_down_levels`
    only, and `scalp` coarsest levels dropped. SAM 2's neck also makes a
    sine position encoding a level, which the image predictor never
    reads; it is not built.

At Hiera-B+ (embed_dim 112, heads 2, stages (2, 3, 16, 3)) every head is
56 wide: widths 112 → 224 → 448 → 896 with heads 2 → 4 → 8 → 16 over the
256² → 128² → 64² → 32² maps of a 1024 px image, blocks 2, 5 and 21
pooled, blocks 12, 16 and 20 global.

Paths. With `use_kernels` the attention of 19 of the 24 blocks runs K5
without tables (ops/kernels/relpos_attention.py): the global blocks
`attention_no_tables` on the whole map's q, k, v, and the windowed blocks
in windows of 8, 14 and 7 `window_attention_no_tables` on the unpadded
map, the pad keys being the qkv bias rows (no pad, partition,
unpartition or crop copies). Blocks whose windows hold at most
SMALL_WINDOW_KEYS keys (Hiera-B+'s two windows of 4) and the three
pooled-query blocks run torch's `scaled_dot_product_attention` on the
partitioned windows, on either path. Without `use_kernels` the K5 blocks
pad, partition and run K5's plain versions. Each block's second half,
x + fc2(GELU(fc1(LN2(x)))), is one call of K4 with the exact GELU
(`fused_mlp(..., activation="gelu")`, v3 at every width 112 to 896:
`mlp.kernel_takes`) with `use_kernels`, and its plain version
(`mlp_reference`, the kernel's cast points: LayerNorm affine and both
biases in f32) without; norm1 stays torch's LayerNorm.

Counts (`utils.profiling.count`), one per block call on either path:
`sam.window_attention` (the K5 windowed blocks), `sam.global_attention`,
`sam.plain_window_attention` (the small windows on SDPA) and
`sam.pooled_attention`; `sam.window_pad_tokens` adds the pad tokens each
windowed block attends over as keys (the stage-3 and stage-4 maps, 64²
in windows of 14 and 32² in windows of 7, and block 21's 64² in windows
of 14). Spans: `sam.hiera_stage1` to `sam.hiera_stage4` around each
stage's blocks and `sam.neck` around the neck.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from image_segmentation_tpu_torch.models.clip_vit import linear
from image_segmentation_tpu_torch.ops.kernels.mlp import fused_mlp, kernel_takes, mlp_reference
from image_segmentation_tpu_torch.ops.kernels.relpos_attention import (
    attention_no_tables,
    attention_no_tables_reference,
    window_attention_no_tables,
    window_partition,
    window_unpartition,
)
from image_segmentation_tpu_torch.utils import profiling

# Windows of at most this many keys run SDPA on either path: a block of
# K5's window map takes two tiles of a window's real query rows, at least
# 8 rows of 8 slots each, which a 4 × 4 window fills a quarter of.
SMALL_WINDOW_KEYS = 16


@dataclasses.dataclass(frozen=True)
class HieraConfig:
    """`hieradet.Hiera`'s and `FpnNeck`'s arguments; the defaults are SAM
    2.1 Hiera-B+ (`sam2.1_hiera_b+.yaml` and hieradet's own defaults)."""

    embed_dim: int = 112
    num_heads: int = 2
    stages: Tuple[int, ...] = (2, 3, 16, 3)
    q_pool: int = 3
    q_stride: int = 2
    dim_mul: float = 2.0
    head_mul: float = 2.0
    window_pos_embed_bkg_spatial_size: Tuple[int, int] = (14, 14)
    window_spec: Tuple[int, ...] = (8, 4, 14, 7)
    global_att_blocks: Tuple[int, ...] = (12, 16, 20)
    mlp_ratio: float = 4.0
    eps: float = 1e-6
    patch_kernel: int = 7
    patch_stride: int = 4
    patch_padding: int = 3
    d_model: int = 256
    fpn_top_down_levels: Tuple[int, ...] = (2, 3)
    scalp: int = 1

    @property
    def stage_ends(self) -> List[int]:
        return [sum(self.stages[:i]) - 1 for i in range(1, len(self.stages) + 1)]

    def blocks(self) -> List[dict]:
        """Each block's dim, dim_out, heads, window (0 global), whether it
        pools q and its stage (1-based), as hieradet's constructor makes
        them: a pooled block takes the previous stage's window and the new
        stage's width and heads."""
        ends = self.stage_ends
        pooled = [e + 1 for e in ends[:-1]][:self.q_pool]
        dim, heads, stage, out = self.embed_dim, self.num_heads, 1, []
        for i in range(sum(self.stages)):
            dim_out, window = dim, self.window_spec[stage - 1]
            if i in self.global_att_blocks:
                window = 0
            if i - 1 in ends:
                dim_out, heads = int(dim * self.dim_mul), int(heads * self.head_mul)
                stage += 1
            out.append(dict(dim=dim, dim_out=dim_out, heads=heads, window=window,
                            pool=i in pooled, stage=stage))
            dim = dim_out
        return out

    @property
    def channel_list(self) -> List[int]:
        """The levels' widths, coarsest first (`backbone_channel_list`)."""
        blocks = self.blocks()
        return [blocks[i]["dim_out"] for i in self.stage_ends[::-1]]

    def level_stride(self, level: int) -> int:
        """Pixels a token of trunk level `level` (0 finest) spans."""
        return self.patch_stride * self.q_stride ** min(level, self.q_pool)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm in x's dtype, the scale and shift rounded to it: torch
    keeps the statistics and the affine in f32 and rounds once, so a bf16
    map is read and written once (its f32 copies took a third of the
    step's device time at the 65,536 tokens of stage 1)."""
    return F.layer_norm(x, ln.normalized_shape, ln.weight.to(x.dtype), ln.bias.to(x.dtype),
                        ln.eps)


def _max_pool(x: torch.Tensor, stride: int) -> torch.Tensor:
    """hieradet's `do_pool`: a (B, H, W, C) map max-pooled stride × stride
    (floor at odd sides)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), stride, stride).permute(0, 2, 3, 1)


def _pad_tokens(n: int, h: int, w: int, ws: int) -> int:
    return n * (-(-h // ws) * -(-w // ws) * ws * ws - h * w)


class MultiScaleAttention(nn.Module):
    """qkv → heads → softmax(q·kᵀ·d^-½)·v → proj over (B', h, w, dim)
    windows or maps; `pool` max-pools q stride × stride first."""

    def __init__(self, dim: int, dim_out: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim_out)
        self.proj = nn.Linear(dim_out, dim_out)

    def _qkv(self, x: torch.Tensor) -> torch.Tensor:
        """(B, h, w, 3, heads, d) views of one projection."""
        b, h, w, _ = x.shape
        return linear(x, self.qkv).view(b, h, w, 3, self.num_heads, -1)

    def forward(self, x: torch.Tensor, pool: int = 0, sdpa: bool = True) -> torch.Tensor:
        """Attention within each of the (B', h, w, dim) windows or maps `x`:
        torch's SDPA, or K5's plain version without tables."""
        b, h, w, _ = x.shape
        q, k, v = self._qkv(x).flatten(1, 2).unbind(2)
        if pool:
            q = _max_pool(q.reshape(b, h, w, -1), pool)
            h, w = q.shape[1:3]
            q = q.reshape(b, h * w, self.num_heads, -1)
        if sdpa:
            out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                 v.transpose(1, 2)).transpose(1, 2)
        else:
            out = attention_no_tables_reference(q, k, v, h, w)
        return linear(out.reshape(b, h, w, -1), self.proj)

    def global_kernel(self, x: torch.Tensor) -> torch.Tensor:
        """`forward` over the whole (B, h, w, dim) map by K5 without tables."""
        b, h, w, _ = x.shape
        q, k, v = self._qkv(x).flatten(1, 2).unbind(2)
        out = attention_no_tables(q, k, v, h, w)
        return linear(out.reshape(b, h, w, -1), self.proj)

    def window_kernel(self, x: torch.Tensor, ws: int) -> torch.Tensor:
        """`forward` in each ws × ws window of the (B, h, w, dim) map
        zero-padded to multiples of ws, cropped back, by K5's window map
        without tables on the unpadded map: a pad token's k and v are the
        qkv bias's rows."""
        b, h, w, _ = x.shape
        q, k, v = self._qkv(x).unbind(3)
        bias = self.qkv.bias.to(x.dtype).view(3, self.num_heads, -1)
        out = window_attention_no_tables(q, k, v, bias[1], bias[2], ws)
        return linear(out.reshape(b, h, w, -1), self.proj)


class MultiScaleBlock(nn.Module):
    """shortcut + attn(LN1(x)) (pooled, windowed or global), then
    x + MLP(LN2(x)) with the exact GELU (module docstring)."""

    def __init__(self, dim: int, dim_out: int, heads: int, window: int, pool: bool,
                 cfg: HieraConfig, use_kernels: bool):
        super().__init__()
        self.window, self.stride = window, cfg.q_stride if pool else 0
        self.norm1 = nn.LayerNorm(dim, eps=cfg.eps)
        self.attn = MultiScaleAttention(dim, dim_out, heads)
        self.norm2 = nn.LayerNorm(dim_out, eps=cfg.eps)
        self.mlp = nn.Module()
        hidden = int(dim_out * cfg.mlp_ratio)
        self.mlp.layers = nn.ModuleList([nn.Linear(dim_out, hidden), nn.Linear(hidden, dim_out)])
        if dim != dim_out:
            self.proj = nn.Linear(dim, dim_out)
        small = 0 < window and window * window <= SMALL_WINDOW_KEYS
        self.kind = ("pooled" if pool else "global" if not window
                     else "plain_window" if small else "window")
        self.use_kernels = use_kernels
        self.k4_takes = kernel_takes(dim_out, hidden)

    def _attend(self, x: torch.Tensor) -> torch.Tensor:
        """The attention half on the LayerNorm'd map, shortcut not added."""
        n, h, w, _ = x.shape
        ws, kind = self.window, self.kind
        profiling.count(f"sam.{kind}_attention")
        if ws:
            profiling.count("sam.window_pad_tokens", _pad_tokens(n, h, w, ws))
        if kind == "global":
            return self.attn.global_kernel(x) if self.use_kernels else self.attn(x, sdpa=False)
        if kind == "window" and self.use_kernels:
            return self.attn.window_kernel(x, ws)
        y, pad_hw = window_partition(x, ws)
        y = self.attn(y, self.stride, sdpa=kind != "window")
        if self.stride:  # the pooled map's windows of ws / stride
            ws //= self.stride
            h, w = h // self.stride, w // self.stride
            pad_hw = (-(-h // ws) * ws, -(-w // ws) * ws)
        return window_unpartition(y, ws, pad_hw, (h, w))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = layer_norm(x, self.norm1)
        shortcut = x
        if hasattr(self, "proj"):  # a new width: the projected norm1 map, pooled with q
            shortcut = linear(y, self.proj)
            shortcut = _max_pool(shortcut, self.stride) if self.stride else shortcut
        x = shortcut + self._attend(y)
        ln, (fc1, fc2) = self.norm2, self.mlp.layers
        run = fused_mlp if self.use_kernels and self.k4_takes else mlp_reference
        return run(x, ln.weight, ln.bias, fc1.weight.to(x.dtype), fc1.bias,
                   fc2.weight.to(x.dtype), fc2.bias, ln.eps, activation="gelu")


class Hiera(nn.Module):
    """NHWC normalised pixels in the compute dtype → the four stages'
    (N, H_i, W_i, C_i) outputs, finest first."""

    def __init__(self, cfg: HieraConfig, use_kernels: bool):
        super().__init__()
        self.cfg = cfg
        c = cfg.embed_dim
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, c, cfg.patch_kernel, stride=cfg.patch_stride,
                                          padding=cfg.patch_padding)
        self.pos_embed = nn.Parameter(torch.zeros(1, c, *cfg.window_pos_embed_bkg_spatial_size))
        ws0 = cfg.window_spec[0]
        self.pos_embed_window = nn.Parameter(torch.zeros(1, c, ws0, ws0))
        specs = cfg.blocks()
        self.stages = [spec["stage"] for spec in specs]
        self.blocks = nn.ModuleList(
            MultiScaleBlock(s["dim"], s["dim_out"], s["heads"], s["window"], s["pool"], cfg,
                            use_kernels) for s in specs)

    def pos_embed_at(self, h: int, w: int) -> torch.Tensor:
        """(1, h, w, C): `pos_embed` bicubic to (h, w) + `pos_embed_window`
        tiled over it, in float32."""
        pos = F.interpolate(self.pos_embed.float(), size=(h, w), mode="bicubic")
        win = self.pos_embed_window.float()
        pos = pos + win.tile([1, 1, h // win.shape[2], w // win.shape[3]])
        return pos.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        proj = self.patch_embed.proj
        x = F.conv2d(x.permute(0, 3, 1, 2), proj.weight.to(x.dtype), proj.bias.to(x.dtype),
                     stride=self.cfg.patch_stride, padding=self.cfg.patch_padding)
        x = x.permute(0, 2, 3, 1)
        x = x + self.pos_embed_at(*x.shape[1:3]).to(x.dtype)
        levels, ends = [], set(self.cfg.stage_ends)
        for stage in range(1, len(self.cfg.stages) + 1):
            with profiling.span(f"sam.hiera_stage{stage}"):
                for i, block in enumerate(self.blocks):
                    if self.stages[i] == stage:
                        x = block(x)
                        if i in ends:
                            levels.append(x)
        return levels


class FpnNeck(nn.Module):
    """The trunk's levels (finest first, NHWC) → the kept levels (NCHW views
    of NHWC tensors, finest first) at `d_model` channels."""

    def __init__(self, cfg: HieraConfig):
        super().__init__()
        self.cfg = cfg
        self.convs = nn.ModuleList()
        for dim in cfg.channel_list:
            conv = nn.Sequential()
            conv.add_module("conv", nn.Conv2d(dim, cfg.d_model, 1))
            self.convs.append(conv)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        n = len(self.convs) - 1
        out, prev = [None] * len(xs), None
        for i in range(n, -1, -1):
            conv = self.convs[n - i].conv
            lateral = F.linear(xs[i], conv.weight.flatten(1).to(xs[i].dtype),
                               conv.bias.to(xs[i].dtype))
            if i in self.cfg.fpn_top_down_levels and prev is not None:
                up = F.interpolate(prev.permute(0, 3, 1, 2), scale_factor=2.0, mode="nearest")
                prev = lateral + up.permute(0, 2, 3, 1)
            else:
                prev = lateral
            out[i] = prev
        kept = out[:len(out) - self.cfg.scalp] if self.cfg.scalp else out
        return [t.permute(0, 3, 1, 2) for t in kept]


class ImageEncoder(nn.Module):
    """SAM 2's `ImageEncoder`: trunk then neck; NHWC normalised pixels →
    the kept levels, NCHW, finest first."""

    def __init__(self, cfg: HieraConfig, use_kernels: bool):
        super().__init__()
        self.trunk = Hiera(cfg, use_kernels)
        self.neck = FpnNeck(cfg)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        levels = self.trunk(x)
        with profiling.span("sam.neck"):
            return self.neck(levels)
