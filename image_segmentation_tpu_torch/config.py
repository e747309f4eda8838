"""Experiment config and model construction for the port's slices.

Counterpart of image_segmentation_tpu/config.py, holding what the
serving slices read: the `clipunet`, `unet_noaug`, `autoencoder` and
`prompt` configs and their branches of `build_model`. On an accelerator
the JAX package runs them in bfloat16 (config.py:60,117-146); the port
does the same on CUDA — bfloat16 compute, float32 parameters, and the
hand-written kernels (K3 and K4 for the clip family and the prompt
model's clip branch, K1 for the UNet and the prompt model's selection
UNet; the autoencoder reaches no kernel, in JAX or here) — and runs
float32 with the plain versions on the CPU.
"""
from __future__ import annotations

import dataclasses

import torch

from image_segmentation_tpu_torch import NUM_CLASSES
from image_segmentation_tpu_torch.models.autoencoder import SegmentationAutoencoder
from image_segmentation_tpu_torch.models.clip_unet import ClipUNet
from image_segmentation_tpu_torch.models.prompt import PromptModel
from image_segmentation_tpu_torch.models.unet import UNet


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """The fields the serving slice reads; training fields come with the
    training slices."""

    name: str
    model: str
    target_size: int = 256
    num_classes: int = NUM_CLASSES
    use_kernels: bool = True  # hand-written CUDA kernels; ignored on CPU


UNET_NOAUG = ExperimentConfig(name="unet_noaug", model="unet", target_size=256)
AUTOENCODER = ExperimentConfig(name="autoencoder", model="autoencoder", target_size=256)
CLIPUNET = ExperimentConfig(name="clipunet", model="clipunet", target_size=224)
PROMPT = ExperimentConfig(name="prompt", model="prompt", target_size=224)

# model name → (class, whether it reaches a hand-written kernel)
MODELS = {"unet": (UNet, True), "autoencoder": (SegmentationAutoencoder, False),
          "clipunet": (ClipUNet, True), "prompt": (PromptModel, True)}


def build_model(cfg: ExperimentConfig, device, generator: torch.Generator,
                **overrides) -> torch.nn.Module:
    """The config's model, randomly initialised from `generator` (a CPU
    generator), in eval mode on `device`. `overrides` (keyword arguments of
    the model: `base` for the UNet and the autoencoder; `vit`,
    `skip_indices`, ... for the ClipUNet; those and `unet_base` for the
    prompt model) cut the model to size for tests and the demo."""
    device = torch.device(device)
    on_cuda = device.type == "cuda"
    if cfg.model not in MODELS:
        raise ValueError(f"model {cfg.model!r} is not ported yet")
    cls, has_kernels = MODELS[cfg.model]
    kwargs = dict(num_classes=cfg.num_classes,
                  dtype=torch.bfloat16 if on_cuda else torch.float32)
    if has_kernels:
        kwargs["use_kernels"] = cfg.use_kernels and on_cuda
    model = cls(**kwargs, **overrides)
    model.init_weights(generator)
    return model.to(device=device, memory_format=torch.channels_last).eval()
