"""Combined losses: Dice+CE and Dice+NLL.

Counterpart of image_segmentation_tpu/losses/combos.py (:24-99),
replicating WeightedDiceCELoss and WeightedDiceNLLLoss (reference
utils/weighted_loss.py:102-166, :268-343): both pass `ignore_index` and
`class_weights` to each component. Frozen dataclasses that are plain
callables on torch tensors, hashable so that a configuration can key a
cache (train.fast_eval dispatches on their type).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from image_segmentation_tpu_torch.losses.cross_entropy import (
    cross_entropy_loss,
    log_with_eps,
    nll_loss,
)
from image_segmentation_tpu_torch.losses.dice import soft_dice_loss


@dataclasses.dataclass(frozen=True)
class DiceCELoss:
    dice_weight: float = 1.0
    ce_weight: float = 1.0
    ignore_index: Optional[int] = None
    class_weights: Optional[Tuple[float, ...]] = None
    smooth_dice: float = 1e-5

    def __call__(self, logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        d = soft_dice_loss(logits, targets, apply_softmax=True,
                           ignore_index=self.ignore_index,
                           class_weights=self.class_weights, smooth=self.smooth_dice)
        ce = cross_entropy_loss(logits, targets, class_weights=self.class_weights,
                                ignore_index=self.ignore_index)
        return self.dice_weight * d + self.ce_weight * ce


@dataclasses.dataclass(frozen=True)
class DiceNLLLoss:
    """For models that emit probabilities (the prompt model): Dice on the
    probabilities directly (apply_softmax=False), NLL on log(p + 1e-9).
    `nll_nonlin(probs)` must be finite in every class lane, since the NLL
    select is a one-hot contraction."""

    dice_weight: float = 1.0
    nll_weight: float = 1.0
    ignore_index: Optional[int] = None
    class_weights: Optional[Tuple[float, ...]] = None
    smooth_dice: float = 1e-5
    apply_softmax: bool = False
    nll_nonlin: Callable = log_with_eps

    def __call__(self, probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        d = soft_dice_loss(probs, targets, apply_softmax=self.apply_softmax,
                           ignore_index=self.ignore_index,
                           class_weights=self.class_weights, smooth=self.smooth_dice)
        n = nll_loss(probs, targets, class_weights=self.class_weights,
                     ignore_index=self.ignore_index, nonlin=self.nll_nonlin)
        return self.dice_weight * d + self.nll_weight * n

