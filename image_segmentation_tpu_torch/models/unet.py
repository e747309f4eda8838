"""U-Net (reference unet/unet.py:67-105).

Counterpart of image_segmentation_tpu/models/unet.py: a 5-level encoder
(the stem is a DoubleConv, levels 2-5 max pool + DoubleConv) with
channels base·{1, 2, 4, 8, 16}, 4 up blocks (transpose conv halving the
channels, concat [skip, up], DoubleConv) and a 1×1 head to `num_classes`
logits. `base=64` is the reference's 64→1024 schedule (~31 M parameters
at 3 in, 4 out). Submodules take the reference's top-level names
(`down1`..`down5`, `up1`..`up4`, `output`). `in_channels` is the input
width, which flax infers: 3 for an image, 4 for the prompt model's
selection network (image + heatmap, models/prompt.py:71-73).

Input: NHWC float in [0, 1]; output: NHWC float32 logits. The module
path runs conv → BN → ReLU layer by layer (cuDNN on a card), in `dtype`
with float32 parameters, as flax does; in train mode its BatchNorms use
and update the batch statistics. With `use_kernels`, an eval-mode
forward without autograd (under `no_grad` or `inference_mode`) is
`fused_unet_forward` instead: K1 nine times with BN folded from the
current running statistics. K1 has no backward and folds eval-mode BN,
so a train-mode forward, or one that records gradients, always takes
the module path.

Under spatial partitioning (`parallel.sp.partition_model`, which sets
`spatial`) the forward takes this rank's block of rows of H, a multiple
of 16, and both paths exchange halos at every 3×3 conv (parallel/sp.py).
"""
from __future__ import annotations

import torch
from torch import nn

from image_segmentation_tpu_torch.models.fused_unet import fused_unet_forward
from image_segmentation_tpu_torch.models.layers import (
    DoubleConv,
    Down,
    Up,
    conv1x1,
    init_conv1x1_,
)
from image_segmentation_tpu_torch.parallel import sp


class UNet(nn.Module):
    spatial = None  # the SP axis (parallel/sp.py), or None

    def __init__(self, num_classes: int = 4, base: int = 64,
                 dtype: torch.dtype = torch.float32, use_kernels: bool = False,
                 in_channels: int = 3):
        super().__init__()
        self.dtype = dtype
        self.use_kernels = use_kernels
        b = base
        self.down1 = DoubleConv(in_channels, b)
        self.down2 = Down(b, 2 * b)
        self.down3 = Down(2 * b, 4 * b)
        self.down4 = Down(4 * b, 8 * b)
        self.down5 = Down(8 * b, 16 * b)
        self.up1 = Up(16 * b, 8 * b)
        self.up2 = Up(8 * b, 4 * b)
        self.up3 = Up(4 * b, 2 * b)
        self.up4 = Up(2 * b, b)
        self.output = nn.Conv2d(b, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sp.local_height_check(x.shape[1], self.spatial)
        if self.use_kernels and not self.training and not torch.is_grad_enabled():
            return fused_unet_forward(self, x)
        with sp.partitioned(self.spatial):
            return self._module_forward(x)

    def _module_forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.down1(x.to(self.dtype).permute(0, 3, 1, 2))  # channels_last NCHW
        x2 = self.down2(x1)
        x3 = self.down3(x2)
        x4 = self.down4(x3)
        y = self.up1(x4, self.down5(x4))
        y = self.up2(x3, y)
        y = self.up3(x2, y)
        y = self.up4(x1, y)
        return conv1x1(y, self.output).float().permute(0, 2, 3, 1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "UNet":
        """Random init with the JAX package's distributions, from `generator`:
        Kaiming-uniform over fan_in for every conv and transpose conv, zero
        biases, BN at scale 1, shift 0, running stats 0 and 1."""
        for m in (self.down1, self.down2, self.down3, self.down4, self.down5,
                  self.up1, self.up2, self.up3, self.up4):
            m.init_weights(generator)
        init_conv1x1_(self.output, generator)
        return self
