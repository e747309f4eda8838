"""ClipUNet: frozen CLIP ViT encoder + U-Net-style decoder with skips.

Counterpart of image_segmentation_tpu/models/clip_unet.py (ClipUNet and
its decoder, `_apply_decoder`): bottleneck = final block output on the
(G, G) grid; skips = hidden states at `skip_indices`, consumed
deepest-first; 1×1 init conv, then per block a ×2 transpose conv halving
channels, a 1×1 projection of the skip, a linear resize of the skip to
the upsampled grid (jax.image.resize's triangle weights), concat and a
bias-free double conv; a 1×1 head gives float32 logits.

The input and the logits are NHWC, as in the JAX package; inside, the
decoder runs NCHW tensors in channels_last memory, which is the same
bytes. The ViT is `vision_model`, so its keys are HF CLIPVisionModel's.
The no-skip and decoder-only variants come later.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from image_segmentation_tpu_torch.models.clip_vit import (
    ClipViT,
    ClipViTConfig,
    tokens_to_grid,
)
from image_segmentation_tpu_torch.models.layers import (
    ConvBNRelu,
    UpConv,
    conv1x1,
    init_conv1x1_,
)
from image_segmentation_tpu_torch.ops.geometry import _triangle_weight_matrix_np


def resize_linear(x: torch.Tensor, out_hw: Sequence[int]) -> torch.Tensor:
    """jax.image.resize(method='linear') of an NCHW tensor, as two
    contractions with the triangle-weight matrices (antialias on, the
    jax default; it only matters when shrinking)."""
    def weights(n_in, n_out):
        w = _triangle_weight_matrix_np(int(n_in), int(n_out), True)
        return torch.from_numpy(w).to(dtype=x.dtype, device=x.device)

    wy = weights(x.shape[2], out_hw[0])
    wx = weights(x.shape[3], out_hw[1])
    return torch.einsum("oh,nchw,pw->ncop", wy, x, wx)


class ClipDecoderBlock(nn.Module):
    """Up ×2 (channels → in/2), project + resize the skip (→ in/2), concat,
    bias-free double conv → out."""

    def __init__(self, in_channels: int, out_channels: int, skip_channels: int):
        super().__init__()
        half = in_channels // 2
        self.up = UpConv(in_channels, half)
        self.skip_proj = nn.Conv2d(skip_channels, half, 1)
        self.conv1 = ConvBNRelu(2 * half, out_channels, use_bias=False)
        self.conv2 = ConvBNRelu(out_channels, out_channels, use_bias=False)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = self.up(x)
        skip = conv1x1(skip, self.skip_proj)
        if skip.shape[2:] != up.shape[2:]:
            skip = resize_linear(skip, up.shape[2:])
        x = torch.cat([up, skip], dim=1)
        return self.conv2(self.conv1(x))

    def init_weights(self, generator: torch.Generator) -> None:
        self.up.init_weights(generator)
        init_conv1x1_(self.skip_proj, generator)
        self.conv1.init_weights(generator)
        self.conv2.init_weights(generator)


class ClipUNet(nn.Module):
    """forward(x (N, S, S, 3) float in [0, 1]) → logits (N, S, S, classes) f32.

    `dtype` is the compute dtype (parameters stay float32); `use_kernels`
    routes the ViT through K3/K4 (see clip_vit.py)."""

    def __init__(
        self,
        num_classes: int = 4,
        decoder_channels: Sequence[int] = (1024, 512, 256, 128, 64),
        skip_indices: Sequence[int] = (3, 5, 7, 9),
        vit: ClipViTConfig = ClipViTConfig(),
        dtype: torch.dtype = torch.float32,
        use_kernels: bool = False,
    ):
        super().__init__()
        self.vit = vit
        self.dtype = dtype
        self.skip_indices = tuple(sorted(skip_indices))
        ch = list(decoder_channels)
        # zip(blocks, reversed(skips)) truncates, as in the reference
        n_blocks = min(len(ch) - 1, len(self.skip_indices))
        self.vision_model = ClipViT(vit, use_kernels)
        self.init_conv = nn.Conv2d(vit.hidden_size, ch[0], 1)
        self.dec = nn.ModuleList(
            ClipDecoderBlock(ch[i], ch[i + 1], vit.hidden_size) for i in range(n_blocks))
        self.head = nn.Conv2d(ch[n_blocks], num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.vit.grid_size
        last, hidden = self.vision_model(x.to(self.dtype))
        grid = lambda t: tokens_to_grid(t, g).permute(0, 3, 1, 2)  # channels_last NCHW
        skips = [grid(hidden[i]) for i in self.skip_indices]
        y = conv1x1(grid(last), self.init_conv)
        for block, skip in zip(self.dec, reversed(skips)):
            y = block(y, skip)
        logits = conv1x1(y, self.head).float()
        return logits.permute(0, 2, 3, 1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ClipUNet":
        """Random init with the JAX package's distributions, from `generator`."""
        self.vision_model.init_weights(generator)
        init_conv1x1_(self.init_conv, generator)
        for block in self.dec:
            block.init_weights(generator)
        init_conv1x1_(self.head, generator)
        return self
