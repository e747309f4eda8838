"""Experiment configs, model construction, and the training recipe.

Counterpart of image_segmentation_tpu/config.py: its seven configs
(`unet_noaug`, `unet_aug`, `recon_ae`, `autoencoder`, `clipunet`,
`clipunet_noskips`, `prompt`), `build_model`, and the
training half (`ExperimentConfig`'s training fields, config.py:30-66;
`build_loss`, `build_optimizer`, `build_lr_schedule`). On an accelerator
the JAX package runs its models in bfloat16 (config.py:60,117-146); the
port does the same on CUDA — bfloat16 compute, float32 parameters, and
the hand-written kernels (K3 and K4 for the clip family and the prompt
model's clip branch, K1 for the UNet's eval forward and the prompt
model's selection UNet; the two autoencoders reach no kernel, in JAX or
here) — and runs float32 with the plain versions on the CPU. BatchNorm
statistics and the losses stay float32 everywhere.

The reference's recipe (notebooks, cell 0): FullWeight class weights,
Dice + CE with train smooth 1 and no ignore index, AdamW lr 1e-3 wd
0.01, micro-batch 8 accumulated to an effective batch of 64, no LR
scheduler. The port trains all seven through run.py: `unet_noaug`,
`unet_aug` (online or offline augmentation), the two-stage autoencoder
(`recon_ae`, then `autoencoder` with the encoder transferred and frozen),
`clipunet` and `clipunet_noskips` on a frozen ViT (in line, or as cached
features), and `prompt`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

from image_segmentation_tpu_torch import EVAL_IGNORE_INDEX, NUM_CLASSES
from image_segmentation_tpu_torch.losses import DiceCELoss, DiceNLLLoss
from image_segmentation_tpu_torch.models.autoencoder import (
    ReconstructionAutoencoder,
    SegmentationAutoencoder,
)
from image_segmentation_tpu_torch.models.clip_unet import ClipUNet, ClipUNetNoSkips
from image_segmentation_tpu_torch.models.prompt import PromptModel
from image_segmentation_tpu_torch.models.sam import SamViTB
from image_segmentation_tpu_torch.models.sam2 import Sam2HieraBPlus
from image_segmentation_tpu_torch.models.unet import UNet
from image_segmentation_tpu_torch.train.state import make_adamw, trainable_parameters

# FullWeight inverse-frequency class weights (reference unet.ipynb cell 0)
FULL_WEIGHTS = (0.2047, 1.0272, 1.2293, 1.5388)


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    model: str
    target_size: int = 256
    num_classes: int = NUM_CLASSES
    use_kernels: bool = True  # hand-written CUDA kernels; ignored on CPU
    eval_ignore_index: Optional[int] = EVAL_IGNORE_INDEX
    train_ignore_index: Optional[int] = None  # the boundary IS trained on
    class_weights: Optional[Tuple[float, ...]] = FULL_WEIGHTS
    dice_weight: float = 1.0
    ce_weight: float = 1.0
    # the train loss's Dice smooth; the val loss keeps 1e-5 (run.py)
    smooth_dice: float = 1.0
    learning_rate: float = 1e-3
    weight_decay: float = 0.01
    lr_schedule: Optional[str] = None  # None / "constant", or "cosine"
    warmup_steps: int = 0
    epochs: int = 100
    batch_size: int = 8  # the micro-batch
    effective_batch: int = 64  # accumulation = effective // batch
    augment: bool = False
    augment_online: bool = True  # on-device augmentation, else offline
    # freeze the pretrained encoder: the autoencoder's (run.py), the
    # ClipUNets' ViT, and the prompt model's whole clip branch
    freeze_encoder: bool = True
    seed: int = 0

    @property
    def accum_steps(self) -> int:
        return max(1, self.effective_batch // self.batch_size)


UNET_NOAUG = ExperimentConfig(name="unet_noaug", model="unet", target_size=256)
UNET_AUG = ExperimentConfig(name="unet_aug", model="unet", target_size=256, augment=True)
# stage 1: plain MSE reconstruction
RECON_AE = ExperimentConfig(name="recon_ae", model="recon", target_size=256,
                            class_weights=None)
AUTOENCODER = ExperimentConfig(name="autoencoder", model="autoencoder", target_size=256,
                               freeze_encoder=True)
CLIPUNET = ExperimentConfig(name="clipunet", model="clipunet", target_size=224)
CLIPUNET_NOSKIPS = ExperimentConfig(name="clipunet_noskips", model="clipunet_noskips",
                                    target_size=224)
# the reference prompt run's class weights are uniform (prompt.ipynb cell 0)
PROMPT = ExperimentConfig(name="prompt", model="prompt", target_size=224,
                          freeze_encoder=False, class_weights=None)

CONFIGS = {c.name: c for c in (UNET_NOAUG, UNET_AUG, RECON_AE, AUTOENCODER, CLIPUNET,
                               CLIPUNET_NOSKIPS, PROMPT)}

# model name → (class, whether it reaches a hand-written kernel). `sam_vitb`
# (Segment Anything's ViT-B, models/sam.py: K5 and K4 with the exact GELU in
# its frozen image encoder) and `sam2_hiera_bplus` (SAM 2.1 Hiera-B+,
# models/sam2.py: K5 without tables in its frozen Hiera trunk) have no
# experiment config of the reference's: they train in the benchmark's
# `train_clicks` cells (perfbench/), not run.py.
MODELS = {"unet": (UNet, True), "autoencoder": (SegmentationAutoencoder, False),
          "recon": (ReconstructionAutoencoder, False), "clipunet": (ClipUNet, True),
          "clipunet_noskips": (ClipUNetNoSkips, True), "prompt": (PromptModel, True),
          "sam_vitb": (SamViTB, True), "sam2_hiera_bplus": (Sam2HieraBPlus, True)}
# the models whose outputs are masks of a click, not class maps
CLICK_MODELS = ("sam_vitb", "sam2_hiera_bplus")


def build_model(cfg: ExperimentConfig, device, generator: torch.Generator,
                **overrides) -> torch.nn.Module:
    """The config's model, randomly initialised from `generator` (a CPU
    generator), in eval mode on `device`. `overrides` (keyword arguments of
    the model: `base` for the UNet and the autoencoder; `vit`,
    `skip_indices`, ... for the ClipUNet; those and `unet_base` for the
    prompt model; `sam`, a `models.sam.SamConfig`, for SAM; `sam2`, a
    `models.sam2.Sam2Config`, for SAM 2) cut the model to size for tests
    and the demo. The config's `freeze_encoder` goes to the ClipUNets as
    `freeze_encoder` and to the prompt model as `freeze_clip` (JAX
    config.py:127-146); SAM's and SAM 2's image encoders are always
    frozen."""
    device = torch.device(device)
    on_cuda = device.type == "cuda"
    if cfg.model not in MODELS:
        raise ValueError(f"model {cfg.model!r} is not ported yet")
    cls, has_kernels = MODELS[cfg.model]
    kwargs = dict(dtype=torch.bfloat16 if on_cuda else torch.float32)
    if cfg.model not in ("recon",) + CLICK_MODELS:  # reconstruction: the image; SAM: masks
        kwargs["num_classes"] = cfg.num_classes
    if has_kernels:
        kwargs["use_kernels"] = cfg.use_kernels and on_cuda
    if cfg.model in ("clipunet", "clipunet_noskips"):
        kwargs["freeze_encoder"] = cfg.freeze_encoder
    elif cfg.model == "prompt":
        kwargs["freeze_clip"] = cfg.freeze_encoder
    model = cls(**kwargs, **overrides)
    model.init_weights(generator)
    return model.to(device=device, memory_format=torch.channels_last).eval()


def build_loss(cfg: ExperimentConfig):
    """The train loss: Dice + NLL on probabilities for the prompt model,
    Dice + CE on logits otherwise."""
    kw = dict(dice_weight=cfg.dice_weight, class_weights=cfg.class_weights,
              ignore_index=cfg.train_ignore_index, smooth_dice=cfg.smooth_dice)
    if cfg.model == "prompt":
        return DiceNLLLoss(nll_weight=cfg.ce_weight, **kw)
    return DiceCELoss(ce_weight=cfg.ce_weight, **kw)


def build_val_loss(cfg: ExperimentConfig):
    """The reference's separate val loss: the eval ignore index and the
    default Dice smooth 1e-5 (notebooks cell 0; JAX run.py:388-399)."""
    return dataclasses.replace(build_loss(cfg), ignore_index=cfg.eval_ignore_index,
                               smooth_dice=1e-5)


def build_optimizer(cfg: ExperimentConfig, model: torch.nn.Module, total_steps: int = 0,
                    frozen_prefixes=()):
    """(AdamW, LambdaLR or None) over the model's trainable parameters."""
    return make_adamw(trainable_parameters(model, frozen_prefixes),
                      learning_rate=cfg.learning_rate, weight_decay=cfg.weight_decay,
                      schedule=build_lr_schedule(cfg, total_steps))


def build_lr_schedule(cfg: ExperimentConfig, total_steps: int
                      ) -> Optional[Callable[[int], float]]:
    """step → learning rate for cfg.lr_schedule, or None for a constant
    one. `total_steps` is the decay horizon in optimizer steps (after
    accumulation). "cosine" is optax.warmup_cosine_decay_schedule: linear
    warmup from 0 over warmup_steps, then cosine decay to 0 at total_steps."""
    if cfg.lr_schedule in (None, "constant"):
        return None
    if cfg.lr_schedule != "cosine":
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    if total_steps <= 0:
        raise ValueError("cosine schedule needs total_steps > 0")
    # the cosine leg (total - warmup steps) must be non-empty; short runs
    # can ask for more warmup than the whole run
    warmup = min(cfg.warmup_steps, max(0, total_steps - 1))
    peak = cfg.learning_rate
    init = 0.0 if warmup else peak

    def schedule(step: int) -> float:
        if step < warmup:
            return init + (peak - init) * step / warmup
        t = min(step - warmup, total_steps - warmup)
        return peak * 0.5 * (1 + math.cos(math.pi * t / (total_steps - warmup)))

    return schedule
