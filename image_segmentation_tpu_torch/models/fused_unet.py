"""The UNet inference forward through K1 and K2.

Counterpart of image_segmentation_tpu/models/fused_unet.py
(fused_unet_forward, :38-112): BatchNorm is folded into a per-channel
scale and bias for each DoubleConv (`fold_bn`, f32), and the stem, the 4
down blocks and the 4 up blocks each run one fused double conv, nine in
all, in the UNet's compute dtype (bf16 on CUDA), with the folded scale
and bias in f32. The 1×1 head is computed outside the kernel, as in the
JAX package: an f32 product of the compute-dtype operands plus the f32
bias, giving f32 logits. Folding and casting happen per call, as in JAX.
Inference only: training BN needs live batch statistics. Under spatial
partitioning (`unet.spatial`) x is this shard's rows and every K1 runs on
a haloed slab (ops/kernels/blocks.py `haloed`); the 1×1 head is row-local.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from image_segmentation_tpu_torch.ops.kernels.blocks import (
    fused_down_block,
    fused_up_block,
    haloed,
)
from image_segmentation_tpu_torch.ops.kernels.double_conv import fold_bn, fused_double_conv

if TYPE_CHECKING:
    from image_segmentation_tpu_torch.models.layers import DoubleConv
    from image_segmentation_tpu_torch.models.unet import UNet


def _dc_args(dc: "DoubleConv", dtype: torch.dtype) -> tuple:
    """DoubleConv → (w1, scale1, bias1, w2, scale2, bias2): HWIO weights
    in `dtype`, folded scale and bias in f32."""
    out = []
    for cbr in (dc.conv1, dc.conv2):
        bn = cbr.bn
        scale, bias = fold_bn(cbr.conv.bias, bn.running_mean, bn.running_var, bn.weight,
                              bn.bias)
        w = cbr.conv.weight.permute(2, 3, 1, 0)  # OIHW → HWIO, one cast-and-copy
        out += [w.to(dtype, memory_format=torch.contiguous_format), scale, bias]
    return tuple(out)


def fused_unet_forward(unet: "UNet", x: torch.Tensor) -> torch.Tensor:
    """x (N, H, W, Cin) → f32 logits (N, H, W, classes), both NHWC. K1's
    wrapper pads a stem of Cin = 3 or 4 to 8 channels."""
    dt, spatial = unet.dtype, unet.spatial
    feats = [haloed(fused_double_conv, [x.to(dt).contiguous()], _dc_args(unet.down1, dt),
                    spatial)]
    for down in (unet.down2, unet.down3, unet.down4, unet.down5):
        feats.append(fused_down_block(feats[-1], *_dc_args(down.conv, dt), spatial=spatial))
    v = feats[-1]
    for up, skip in zip((unet.up1, unet.up2, unet.up3, unet.up4), reversed(feats[:-1])):
        v = fused_up_block(skip, v, up.up.up.weight, up.up.up.bias, *_dc_args(up.conv, dt),
                           spatial=spatial)
    head = unet.output
    w = head.weight.to(dt).float().flatten(1)  # (classes, C)
    return v.float() @ w.t() + head.bias.float()
