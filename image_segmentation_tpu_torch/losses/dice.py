"""Soft Dice loss with the reference's semantics, on torch tensors.

Counterpart of image_segmentation_tpu/losses/dice.py (soft_dice_loss,
:31-70): softmax over the class axis (optional), one-hot targets, per-class intersection / prediction sum
/ GT sum reduced over batch AND spatial dims together (a batch-aggregate
Dice), dice_c = (2·I_c + smooth) / max(P_c + G_c + smooth, 1e-8);
`ignore_index` drops that CLASS from the mean (it masks no pixels); an
optional class-weighted mean; returns −dice.

Inside a process group of more than one process (parallel/mesh.py) the
three per-class sums are summed over the processes before the division,
so every process holds the Dice of the global batch, as JAX's loss over
a mesh is.

Math in float32 whatever the logits' dtype. Layout: logits (N, H, W, C),
targets (N, H, W) integer; a target outside [0, C) one-hots to zeros, as
jax.nn.one_hot does.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch

from image_segmentation_tpu_torch.parallel.mesh import global_sums


def one_hot(targets: torch.Tensor, num_classes: int) -> torch.Tensor:
    """float32 one-hot of integer `targets` along a new last axis; rows of
    out-of-range targets are all zero (jax.nn.one_hot's semantics)."""
    classes = torch.arange(num_classes, device=targets.device)
    return (targets.unsqueeze(-1) == classes).float()


@functools.lru_cache(maxsize=64)
def class_vector(values: tuple, device: torch.device) -> torch.Tensor:
    """A float32 per-class vector on `device`, built once per value tuple
    and device, so that no loss call copies it from the host."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def keep_vector(num_classes: int, ignore_index: Optional[int],
                class_weights: Optional[Sequence[float]], device) -> torch.Tensor:
    """Per-class weights with the ignored class zeroed: the class weights,
    or ones."""
    w = [1.0] * num_classes if class_weights is None else [float(c) for c in class_weights]
    if ignore_index is not None and 0 <= ignore_index < num_classes:
        w[ignore_index] = 0.0
    return class_vector(tuple(w), torch.device(device))


def soft_dice_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    *,
    apply_softmax: bool = True,
    ignore_index: Optional[int] = None,
    class_weights: Optional[Sequence[float]] = None,
    smooth: float = 1e-5,
) -> torch.Tensor:
    num_classes = logits.shape[-1]
    x = logits.float()
    probs = torch.softmax(x, dim=-1) if apply_softmax else x
    onehot = one_hot(targets, num_classes)

    dims = tuple(range(probs.dim() - 1))
    intersect = (probs * onehot).sum(dims)
    sum_pred = probs.sum(dims)
    sum_gt = onehot.sum(dims)
    intersect, sum_pred, sum_gt = global_sums(intersect, sum_pred, sum_gt)
    dc = (2.0 * intersect + smooth) / torch.clamp(sum_pred + sum_gt + smooth, min=1e-8)

    w = keep_vector(num_classes, ignore_index, class_weights, logits.device)
    return -(dc * w).sum() / torch.clamp(w.sum(), min=1e-8)
