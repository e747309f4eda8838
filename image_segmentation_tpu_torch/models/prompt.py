"""Prompt-based interactive segmentation model.

Counterpart of image_segmentation_tpu/models/prompt.py (PromptModel,
:34-85; reference prompt_based/prompt.py:6-56). Two branches:
  * `clip`, a ClipUNet whose softmax gives 4-class probabilities (K3 and
    K4 on a card);
  * `mask`, the "selection network": a UNet over concat(image, heatmap),
    4 channels in and 1 out (K1 on a card), whose sigmoid gives the
    point-selection mask.

The output is a 4-channel PROBABILITY map (not logits), NHWC float32:
  ch0 'deactivated' = 1 − mask
  ch1 bg            = mask·p(bg) + mask·p(boundary)
  ch2 cat           = mask·p(cat)
  ch3 dog           = mask·p(dog)
The softmax, the sigmoid and this channel algebra run in float32 whatever
the branches' compute dtype.

Freezing follows the JAX model (prompt.py:36,46-68): the clip branch is
always built with `freeze_encoder=True`, so its ViT never trains; with
`freeze_clip` (the default) the whole branch runs under `torch.no_grad()`
and its logits carry no gradient (JAX's stop_gradient). It runs in the
caller's mode either way, so in training its decoder BatchNorms use batch
statistics and update their running ones, as JAX's `train` flag does.

`head` is everything after the clip branch, so the serving engine can run
the clip branch once per image and the head once per click
(`InferenceEngine.register_prompt_composed`).
"""
from __future__ import annotations

import contextlib
from typing import Sequence

import torch
from torch import nn

from image_segmentation_tpu_torch.models.clip_unet import ClipUNet
from image_segmentation_tpu_torch.models.clip_vit import ClipViTConfig
from image_segmentation_tpu_torch.models.unet import UNet


class PromptModel(nn.Module):
    """forward(x (N, S, S, 3), heatmap (N, S, S, 1), both float in [0, 1])
    → probabilities (N, S, S, 4) float32."""

    def __init__(
        self,
        num_classes: int = 4,
        vit: ClipViTConfig = ClipViTConfig(),
        skip_indices: Sequence[int] = (3, 5, 7, 9),
        decoder_channels: Sequence[int] = (1024, 512, 256, 128, 64),
        unet_base: int = 64,
        dtype: torch.dtype = torch.float32,
        use_kernels: bool = False,
        freeze_clip: bool = True,
    ):
        super().__init__()
        self.dtype = dtype
        self.freeze_clip = freeze_clip
        self.clip = ClipUNet(num_classes=num_classes, decoder_channels=decoder_channels,
                             skip_indices=skip_indices, vit=vit, dtype=dtype,
                             use_kernels=use_kernels, freeze_encoder=True)
        self.mask = UNet(num_classes=1, base=unet_base, dtype=dtype,
                         use_kernels=use_kernels, in_channels=4)

    def head(self, x: torch.Tensor, heatmap: torch.Tensor,
             clip_logits: torch.Tensor) -> torch.Tensor:
        """The selection network and the float32 probability algebra, given
        the clip branch's logits."""
        clip_prob = torch.softmax(clip_logits.float(), dim=-1)
        mask_logit = self.mask(torch.cat([x, heatmap], dim=-1))
        mask_prob = torch.sigmoid(mask_logit.float())  # (N, S, S, 1)
        selected = mask_prob * clip_prob
        return torch.cat([1.0 - mask_prob,
                          selected[..., 0:1] + selected[..., 3:4],
                          selected[..., 1:3]], dim=-1)

    def forward(self, x: torch.Tensor, heatmap: torch.Tensor) -> torch.Tensor:
        with torch.no_grad() if self.freeze_clip else contextlib.nullcontext():
            clip_logits = self.clip(x)
        return self.head(x, heatmap, clip_logits)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "PromptModel":
        """Random init with the JAX package's distributions, from `generator`."""
        self.clip.init_weights(generator)
        self.mask.init_weights(generator)
        return self
