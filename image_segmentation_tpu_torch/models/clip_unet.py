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

Three modules share one decoder (`_add_decoder`, `_apply_decoder`, as
JAX's `_apply_decoder` :87-117 is shared), so its names — `init_conv`,
`dec.i`, `head` — are the same in all three and a state dict moves
between them unchanged:
  * `ClipUNet`, the ViT and the decoder with skips;
  * `ClipUNetNoSkips` (JAX :184), the ablation: each block a ×2 transpose
    conv keeping channels and a double conv, no skips;
  * `ClipUNetDecoderOnly` (JAX :151), the decoder on packed features
    (N, 1 + S, G, G, H), NHWC: the bottleneck first, then the skips in
    ascending layer order (train/feature_cache.py). `ClipUNet.decoder_only()`
    builds one that shares the ClipUNet's own decoder modules, so training
    it trains the ClipUNet.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

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


class ClipDecoderBlockNoSkip(nn.Module):
    """Up ×2 keeping channels, then a bias-free double conv → out (JAX
    clip_unet.py:71-84)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.up = UpConv(in_channels, in_channels)
        self.conv1 = ConvBNRelu(in_channels, out_channels, use_bias=False)
        self.conv2 = ConvBNRelu(out_channels, out_channels, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(self.up(x)))

    def init_weights(self, generator: torch.Generator) -> None:
        self.up.init_weights(generator)
        self.conv1.init_weights(generator)
        self.conv2.init_weights(generator)


def _add_decoder(module: nn.Module, hidden: int, decoder_channels: Sequence[int],
                 num_classes: int, num_skips: Optional[int]) -> None:
    """Register `init_conv`, `dec` and `head` on `module`; `num_skips=None`
    builds the no-skip blocks. zip(blocks, reversed(skips)) truncates, as
    in the reference, so there are min(len(ch) - 1, num_skips) skip blocks."""
    ch = list(decoder_channels)
    module.init_conv = nn.Conv2d(hidden, ch[0], 1)
    if num_skips is None:
        n_blocks = len(ch) - 1
        module.dec = nn.ModuleList(
            ClipDecoderBlockNoSkip(ch[i], ch[i + 1]) for i in range(n_blocks))
    else:
        n_blocks = min(len(ch) - 1, num_skips)
        module.dec = nn.ModuleList(
            ClipDecoderBlock(ch[i], ch[i + 1], hidden) for i in range(n_blocks))
    module.head = nn.Conv2d(ch[n_blocks], num_classes, 1)


def _init_decoder(module: nn.Module, generator: torch.Generator) -> None:
    init_conv1x1_(module.init_conv, generator)
    for block in module.dec:
        block.init_weights(generator)
    init_conv1x1_(module.head, generator)


def _apply_decoder(module: nn.Module, bottleneck: torch.Tensor,
                   skips: Optional[List[torch.Tensor]]) -> torch.Tensor:
    """(N, G, G, H) grids in the compute dtype → f32 logits, NHWC. Each grid
    is made contiguous first, so the in-line and the cached-feature paths
    hand the convolutions the same layout."""
    nchw = lambda t: t.contiguous().permute(0, 3, 1, 2)  # channels_last NCHW  # noqa: E731
    y = conv1x1(nchw(bottleneck), module.init_conv)
    if skips is None:
        for block in module.dec:
            y = block(y)
    else:  # deepest skip first
        for block, skip in zip(module.dec, reversed(skips)):
            y = block(y, nchw(skip))
    return conv1x1(y, module.head).float().permute(0, 2, 3, 1)


def _encoder_context(frozen: bool):
    return torch.no_grad() if frozen else contextlib.nullcontext()


class ClipUNet(nn.Module):
    """forward(x (N, S, S, 3) float in [0, 1]) → logits (N, S, S, classes) f32.

    `dtype` is the compute dtype (parameters stay float32); `use_kernels`
    routes the ViT through K3/K4 (see clip_vit.py). With `freeze_encoder`
    (the JAX default, clip_unet.py:141-143, where the bottleneck and every
    skip go through stop_gradient) the ViT runs under `torch.no_grad()`:
    its outputs carry no gradient, it records no graph, and K3/K4, which
    have no backward, stay usable in a train step."""

    def __init__(
        self,
        num_classes: int = 4,
        decoder_channels: Sequence[int] = (1024, 512, 256, 128, 64),
        skip_indices: Sequence[int] = (3, 5, 7, 9),
        vit: ClipViTConfig = ClipViTConfig(),
        dtype: torch.dtype = torch.float32,
        use_kernels: bool = False,
        freeze_encoder: bool = True,
    ):
        super().__init__()
        self.vit = vit
        self.dtype = dtype
        self.freeze_encoder = freeze_encoder
        self.skip_indices = tuple(sorted(skip_indices))
        self.vision_model = ClipViT(vit, use_kernels)
        _add_decoder(self, vit.hidden_size, decoder_channels, num_classes,
                     len(self.skip_indices))

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The ViT's bottleneck and skips as (N, G, G, H) grids in the compute
        dtype, with no gradient when the encoder is frozen."""
        g = self.vit.grid_size
        with _encoder_context(self.freeze_encoder):
            last, hidden = self.vision_model(x.to(self.dtype))
        return (tokens_to_grid(last, g),
                [tokens_to_grid(hidden[i], g) for i in self.skip_indices])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _apply_decoder(self, *self.encode(x))

    def decoder_only(self) -> "ClipUNetDecoderOnly":
        """A ClipUNetDecoderOnly whose modules are this model's own decoder
        modules: the same parameters and BatchNorm statistics."""
        return ClipUNetDecoderOnly(num_skips=len(self.skip_indices), dtype=self.dtype,
                                   share=self)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ClipUNet":
        """Random init with the JAX package's distributions, from `generator`."""
        self.vision_model.init_weights(generator)
        _init_decoder(self, generator)
        return self


class ClipUNetNoSkips(nn.Module):
    """The ablation (JAX clip_unet.py:184-207): the ViT's last hidden state
    alone through no-skip blocks. Same call and freezing as ClipUNet."""

    def __init__(
        self,
        num_classes: int = 4,
        decoder_channels: Sequence[int] = (1024, 512, 256, 128, 64),
        vit: ClipViTConfig = ClipViTConfig(),
        dtype: torch.dtype = torch.float32,
        use_kernels: bool = False,
        freeze_encoder: bool = True,
    ):
        super().__init__()
        self.vit = vit
        self.dtype = dtype
        self.freeze_encoder = freeze_encoder
        self.vision_model = ClipViT(vit, use_kernels)
        _add_decoder(self, vit.hidden_size, decoder_channels, num_classes, None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with _encoder_context(self.freeze_encoder):
            last, _ = self.vision_model(x.to(self.dtype))
        return _apply_decoder(self, tokens_to_grid(last, self.vit.grid_size), None)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ClipUNetNoSkips":
        self.vision_model.init_weights(generator)
        _init_decoder(self, generator)
        return self


class ClipUNetDecoderOnly(nn.Module):
    """forward(feats (N, 1 + num_skips, G, G, H), float) → logits (N, S, S,
    classes) f32: the ClipUNet's decoder on precomputed ViT features (JAX
    clip_unet.py:151-181), cast to `dtype`. With `share=` a ClipUNet, its
    `init_conv`, `dec` and `head` are used as they are instead of new ones."""

    def __init__(
        self,
        num_classes: int = 4,
        decoder_channels: Sequence[int] = (1024, 512, 256, 128, 64),
        num_skips: int = 4,
        hidden_size: int = 768,
        dtype: torch.dtype = torch.float32,
        share: Optional[ClipUNet] = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.num_skips = num_skips
        if share is None:
            _add_decoder(self, hidden_size, decoder_channels, num_classes, num_skips)
        else:
            self.init_conv, self.dec, self.head = share.init_conv, share.dec, share.head

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        feats = feats.to(self.dtype)
        return _apply_decoder(self, feats[:, 0],
                              [feats[:, 1 + i] for i in range(self.num_skips)])
