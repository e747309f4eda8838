"""Losses on torch tensors (float32 math), and their float64 host mirrors."""
from image_segmentation_tpu_torch.losses.combos import DiceCELoss, DiceNLLLoss
from image_segmentation_tpu_torch.losses.cross_entropy import cross_entropy_loss, nll_loss
from image_segmentation_tpu_torch.losses.dice import soft_dice_loss
from image_segmentation_tpu_torch.losses.sam import SamLoss, sam_loss_terms

__all__ = [
    "soft_dice_loss",
    "cross_entropy_loss",
    "nll_loss",
    "DiceCELoss",
    "DiceNLLLoss",
    "SamLoss",
    "sam_loss_terms",
]
