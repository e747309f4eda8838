"""Experiment config and model construction for the port's slices.

Counterpart of image_segmentation_tpu/config.py, holding what the
serving slices read: the `clipunet` and `unet_noaug` configs and their
branches of `build_model`. On an accelerator the JAX package runs both
in bfloat16 (config.py:60,117-133); the port does the same on CUDA —
bfloat16 compute, float32 parameters, and the hand-written kernels (K3
and K4 for the clip family, K1 for the UNet) — and runs float32 with the
plain versions on the CPU.
"""
from __future__ import annotations

import dataclasses

import torch

from image_segmentation_tpu_torch import NUM_CLASSES
from image_segmentation_tpu_torch.models.clip_unet import ClipUNet
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
CLIPUNET = ExperimentConfig(name="clipunet", model="clipunet", target_size=224)

MODELS = {"unet": UNet, "clipunet": ClipUNet}


def build_model(cfg: ExperimentConfig, device, generator: torch.Generator,
                **overrides) -> torch.nn.Module:
    """The config's model, randomly initialised from `generator` (a CPU
    generator), in eval mode on `device`. `overrides` (keyword arguments of
    the model: `base` for the UNet; `vit`, `skip_indices`, ... for the
    ClipUNet) cut the model to size for tests and the demo."""
    device = torch.device(device)
    on_cuda = device.type == "cuda"
    dtype = torch.bfloat16 if on_cuda else torch.float32
    if cfg.model not in MODELS:
        raise ValueError(f"model {cfg.model!r} is not ported yet")
    model = MODELS[cfg.model](
        num_classes=cfg.num_classes, dtype=dtype,
        use_kernels=cfg.use_kernels and on_cuda, **overrides,
    )
    model.init_weights(generator)
    return model.to(device=device, memory_format=torch.channels_last).eval()
