"""The two autoencoders: stage 1 reconstruction, stage 2 segmentation.

Counterpart of image_segmentation_tpu/models/autoencoder.py
(`EncoderBlock`, `AEEncoder`, `DecoderBlockNoSkips`,
`DecoderBlockWithSkips`, `ReconstructionAutoencoder`,
`SegmentationAutoencoder`; reference autoencoder/autoencoder.py:6-200,
271-305). `SegmentationAutoencoder`: a 3-block encoder of bias-free [conv3×3 → BN → ReLU]×2 with
channels base·{1, 2, 4}, each block returning its max-pooled output and
its pre-pool activation as a skip; a decoder of 3 blocks (transpose conv
×2, centre crop of the skip when the sizes differ, concat [up, skip],
bias-free double conv) to 2b, b, b channels; a 1×1 head to `num_classes`
float32 logits. Submodules take the reference's names (`encoder.
encoderPart{1,2,3}`, `decoder.decoderBlock{1,2,3}`, `finalConv`).

`ReconstructionAutoencoder` has the same `AEEncoder` under the same
`encoder.` prefix, so the encoder keys of the two state dicts match and
stage 2 takes stage 1's encoder (`train.checkpoint.load_subtree`); its
decoder is three skip-free up blocks 4b → 2b → b → b (transpose conv ×2,
bias-free double conv), then a 3×3 head with bias (`decoderOut.0`, the
reference's name) and a sigmoid in float32.

The JAX package runs no Pallas kernel here, and neither does the port:
the convolutions are PyTorch's (cuDNN on a card), in `dtype` with
float32 parameters, as flax does. Input NHWC float in [0, 1], output NHWC
float32 (logits, or the reconstruction); inside, NCHW tensors in
channels_last memory.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from image_segmentation_tpu_torch.models.layers import (
    ConvBNRelu,
    UpConv,
    center_crop_to,
    conv1x1,
    conv_kernel_init_,
    init_conv1x1_,
)


class EncoderBlock(nn.Module):
    """[Conv3×3 bias-free → BN → ReLU]×2 → (max-pooled, pre-pool skip)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv1 = ConvBNRelu(in_features, features, use_bias=False)
        self.conv2 = ConvBNRelu(features, features, use_bias=False)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        skip = self.conv2(self.conv1(x))
        return F.max_pool2d(skip, 2), skip

    def init_weights(self, generator: torch.Generator) -> None:
        self.conv1.init_weights(generator)
        self.conv2.init_weights(generator)


class AEEncoder(nn.Module):
    """3 encoder blocks (b, 2b, 4b) → (bottleneck, skip3, skip2, skip1)."""

    def __init__(self, base: int = 64, in_channels: int = 3):
        super().__init__()
        b = base
        self.encoderPart1 = EncoderBlock(in_channels, b)
        self.encoderPart2 = EncoderBlock(b, 2 * b)
        self.encoderPart3 = EncoderBlock(2 * b, 4 * b)

    def forward(self, x: torch.Tensor):
        x1, skip1 = self.encoderPart1(x)
        x2, skip2 = self.encoderPart2(x1)
        bottleneck, skip3 = self.encoderPart3(x2)
        return bottleneck, skip3, skip2, skip1

    def init_weights(self, generator: torch.Generator) -> None:
        for block in (self.encoderPart1, self.encoderPart2, self.encoderPart3):
            block.init_weights(generator)


class DecoderBlockWithSkips(nn.Module):
    """Transpose conv ×2 to `features`, centre-crop the skip to match,
    concat [up, skip], bias-free double conv."""

    def __init__(self, in_features: int, skip_features: int, features: int):
        super().__init__()
        self.up = UpConv(in_features, features)
        self.conv1 = ConvBNRelu(features + skip_features, features, use_bias=False)
        self.conv2 = ConvBNRelu(features, features, use_bias=False)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = self.up(x)
        if skip.shape[2:] != up.shape[2:]:
            skip = center_crop_to(skip, up.shape[2:])
        return self.conv2(self.conv1(torch.cat([up, skip], dim=1)))

    def init_weights(self, generator: torch.Generator) -> None:
        self.up.init_weights(generator)
        self.conv1.init_weights(generator)
        self.conv2.init_weights(generator)


class AEDecoder(nn.Module):
    def __init__(self, base: int):
        super().__init__()
        b = base
        self.decoderBlock1 = DecoderBlockWithSkips(4 * b, 4 * b, 2 * b)
        self.decoderBlock2 = DecoderBlockWithSkips(2 * b, 2 * b, b)
        self.decoderBlock3 = DecoderBlockWithSkips(b, b, b)

    def forward(self, bottleneck, skip3, skip2, skip1) -> torch.Tensor:
        y = self.decoderBlock1(bottleneck, skip3)
        y = self.decoderBlock2(y, skip2)
        return self.decoderBlock3(y, skip1)

    def init_weights(self, generator: torch.Generator) -> None:
        for block in (self.decoderBlock1, self.decoderBlock2, self.decoderBlock3):
            block.init_weights(generator)


class DecoderBlockNoSkips(nn.Module):
    """Transpose conv ×2 to `features`, then a bias-free double conv; no
    concat (reference autoencoder/autoencoder.py:117-146)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.up = UpConv(in_features, features)
        self.conv1 = ConvBNRelu(features, features, use_bias=False)
        self.conv2 = ConvBNRelu(features, features, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(self.up(x)))

    def init_weights(self, generator: torch.Generator) -> None:
        self.up.init_weights(generator)
        self.conv1.init_weights(generator)
        self.conv2.init_weights(generator)


class AEDecoderNoSkips(nn.Module):
    def __init__(self, base: int):
        super().__init__()
        b = base
        self.decoderBlock1 = DecoderBlockNoSkips(4 * b, 2 * b)
        self.decoderBlock2 = DecoderBlockNoSkips(2 * b, b)
        self.decoderBlock3 = DecoderBlockNoSkips(b, b)

    def forward(self, bottleneck: torch.Tensor) -> torch.Tensor:
        return self.decoderBlock3(self.decoderBlock2(self.decoderBlock1(bottleneck)))

    def init_weights(self, generator: torch.Generator) -> None:
        for block in (self.decoderBlock1, self.decoderBlock2, self.decoderBlock3):
            block.init_weights(generator)


class ReconstructionAutoencoder(nn.Module):
    """forward(x (N, H, W, 3) float in [0, 1]) → the reconstruction
    (N, H, W, dout) f32 in (0, 1), for H and W multiples of 8."""

    def __init__(self, dout: int = 3, base: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder = AEEncoder(base)
        self.decoder = AEDecoderNoSkips(base)
        self.decoderOut = nn.Sequential(nn.Conv2d(base, dout, 3, padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bottleneck, *_ = self.encoder(x.to(self.dtype).permute(0, 3, 1, 2))
        y = self.decoder(bottleneck)
        head = self.decoderOut[0]
        y = F.conv2d(y, head.weight.to(y.dtype), head.bias.to(y.dtype), padding=1)
        return torch.sigmoid(y.float()).permute(0, 2, 3, 1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ReconstructionAutoencoder":
        """Random init with the JAX package's distributions, from `generator`."""
        self.encoder.init_weights(generator)
        self.decoder.init_weights(generator)
        head = self.decoderOut[0]
        conv_kernel_init_(head.weight, head.weight[0].numel(), generator)
        nn.init.zeros_(head.bias)
        return self


class SegmentationAutoencoder(nn.Module):
    """forward(x (N, H, W, 3) float in [0, 1]) → logits (N, H', W',
    classes) f32, with H' = H when H is a multiple of 8 (else the decoder
    crops: 60 px gives 56)."""

    def __init__(self, num_classes: int = 4, base: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder = AEEncoder(base)
        self.decoder = AEDecoder(base)
        self.finalConv = nn.Conv2d(base, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.encoder(x.to(self.dtype).permute(0, 3, 1, 2))  # channels_last NCHW
        y = self.decoder(*feats)
        return conv1x1(y, self.finalConv).float().permute(0, 2, 3, 1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "SegmentationAutoencoder":
        """Random init with the JAX package's distributions, from `generator`:
        Kaiming-uniform over fan_in, zero biases, BN at 1 and 0."""
        self.encoder.init_weights(generator)
        self.decoder.init_weights(generator)
        init_conv1x1_(self.finalConv, generator)
        return self
