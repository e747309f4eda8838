"""K2: the UNet's down and up blocks around K1 (inference mode), NHWC.

Counterpart of image_segmentation_tpu/ops/pallas/blocks.py:
  down block = 2×2 max pool → fused double conv;
  up block   = 2×2 stride-2 transpose conv + bias → concat [skip, up] →
               fused double conv.
The pool and the transpose conv are torch ops, as the JAX package leaves
them to XLA, and the double conv is K1, which counts the launches. The
up block's concat is not a torch op on a card: `fused_double_conv_cat`
reads the skip's channels and then the up's in K1's load stage, skip
FIRST (blocks.py:71, reference unet/unet.py:63); on the CPU its plain
version concatenates.

Transpose-conv weights are in torch's ConvTranspose2d layout
(Cin, Cout, 2, 2), already flipped from flax's by models/convert.py.

Under spatial partitioning (`spatial`, a `parallel.sp.SpatialAxis`) each
block takes this shard's rows: the pool and the transpose conv are
row-local (even shard heights), and K1 runs on the slab with K1's
asymmetric 2-row halo (`haloed`), the up block's skip and up both haloed,
then crops back to the shard's rows.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from image_segmentation_tpu_torch.ops.kernels.double_conv import (
    fused_double_conv,
    fused_double_conv_cat,
)
from image_segmentation_tpu_torch.parallel import sp

# Rows K1 takes from each neighbouring shard: its two 3×3 convs' reach.
K1_HALO = 2


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)  # NHWC → NCHW view (channels_last memory)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """NHWC 2×2 stride-2 max pool (VALID)."""
    return _nhwc(F.max_pool2d(_nchw(x), 2))


def transpose_conv_2x2(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor | None = None) -> torch.Tensor:
    """NHWC transpose conv, kernel 2 stride 2, in x's dtype; exactly 2H × 2W."""
    b = None if bias is None else bias.to(x.dtype)
    return _nhwc(F.conv_transpose2d(_nchw(x), weight.to(x.dtype), b, stride=2))


def haloed(k1, xs, args, spatial=None) -> torch.Tensor:
    """`k1(*xs, *args)`, a double conv of NHWC inputs of one height, on this
    shard's rows: each of `xs` with K1's asymmetric halo (none at the
    image's edges, where K1's zero padding acts), the result cropped to
    the shard's rows. `k1` itself without `spatial`."""
    if spatial is None:
        return k1(*xs, *args)
    slabs = [sp.halo_exchange(x, K1_HALO, spatial, dim=1) for x in xs]
    _, top, bottom = slabs[0]
    y = k1(*(s.contiguous() for s, _, _ in slabs), *args)
    return sp.crop_rows(y, top, bottom, dim=1).contiguous()


def fused_down_block(x, w1, scale1, bias1, w2, scale2, bias2, spatial=None) -> torch.Tensor:
    """max pool 2×2, then the fused double conv (reference Down block)."""
    return haloed(fused_double_conv, [max_pool_2x2(x)], (w1, scale1, bias1, w2, scale2, bias2),
                  spatial)


def fused_up_block(skip, x, up_weight, up_bias, w1, scale1, bias1, w2, scale2,
                   bias2, spatial=None) -> torch.Tensor:
    """transpose conv ×2 (halving channels), then the fused double conv of
    concat [skip, up] (reference Up block)."""
    up = transpose_conv_2x2(x, up_weight, up_bias)
    return haloed(fused_double_conv_cat, [skip, up], (w1, scale1, bias1, w2, scale2, bias2),
                  spatial)
