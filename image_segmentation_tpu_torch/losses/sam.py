"""Segment Anything's training loss (Kirillov et al. 2023, §3 and §A).

No JAX counterpart (models/sam.py has none). For each image the model
gives three masks; each mask's loss is `focal_weight`·focal + Dice on its
logits against the binary target, and only the lowest of the three is
backpropagated (the choice is made per image and carries no gradient).
The IoU head is trained with the mean squared error between its three
predictions and the IoU of each mask (logits > 0) with the target, that
IoU detached. The paper gives the 20:1 ratio and not the focal loss's α
and γ; RetinaNet's 0.25 and 2 are taken (`perfbench/configs/
sam_vitb.json` lists them under `assumed`).

  focal = mean over pixels of α_t (1 − p_t)^γ · BCE(logit, t), p = σ(logit)
  dice  = 1 − (2 Σ p t + 1) / (Σ p + Σ t + 1)

The target is the not-background mask (cat, dog and boundary: label ids
1, 2 and 3) of the label map taken at the masks' resolution by nearest
sampling, label[stride·i, stride·j] with stride = label side / mask side.
Everything is computed in float32.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def mask_target(labels: torch.Tensor, side: int) -> torch.Tensor:
    """(N, S, S) class ids → (N, side, side) float not-background target."""
    stride = labels.shape[-1] // side
    return (labels[:, ::stride, ::stride][:, :side, :side] != 0).float()


def sam_loss_terms(masks: torch.Tensor, iou_pred: torch.Tensor, labels: torch.Tensor,
                   focal_weight: float = 20.0, alpha: float = 0.25, gamma: float = 2.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, the index of each image's lowest-loss mask) for masks (N, K,
    m, m) logits, iou_pred (N, K) and labels (N, S, S)."""
    x = masks.float()
    t = mask_target(labels, x.shape[-1])[:, None].expand_as(x)
    p = torch.sigmoid(x)
    ce = F.binary_cross_entropy_with_logits(x, t, reduction="none")
    p_t = p * t + (1 - p) * (1 - t)
    alpha_t = alpha * t + (1 - alpha) * (1 - t)
    focal = (alpha_t * (1 - p_t) ** gamma * ce).mean(dim=(2, 3))
    dice = 1 - (2 * (p * t).sum(dim=(2, 3)) + 1) / (p.sum(dim=(2, 3)) + t.sum(dim=(2, 3)) + 1)
    per_mask = focal_weight * focal + dice  # (N, K)
    choice = per_mask.detach().argmin(dim=1)
    mask_loss = per_mask.gather(1, choice[:, None]).mean()
    with torch.no_grad():
        pred = x > 0
        inter = (pred & (t > 0)).sum(dim=(2, 3)).float()
        union = (pred | (t > 0)).sum(dim=(2, 3)).float()
        iou = inter / union.clamp(min=1.0)
    return mask_loss + F.mse_loss(iou_pred.float(), iou), choice


class SamLoss:
    """loss_fn((masks, iou_pred), labels) for `train.steps.train_step`; the
    last call's per-image choice of mask is kept as `choice`."""

    def __init__(self, focal_weight: float = 20.0, alpha: float = 0.25, gamma: float = 2.0):
        self.focal_weight, self.alpha, self.gamma = focal_weight, alpha, gamma
        self.choice = None

    def __call__(self, out, labels: torch.Tensor) -> torch.Tensor:
        masks, iou_pred = out
        loss, self.choice = sam_loss_terms(masks, iou_pred, labels, self.focal_weight,
                                           self.alpha, self.gamma)
        return loss
