"""Host (numpy, float64) mirrors of the losses, for the host eval protocol.

Counterpart of image_segmentation_tpu/losses/host.py, copied: the
reference computes the validation loss per image at its native
resolution (utils/training.py:93-101), and these mirrors give that
number exactly; tests pin them to the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

from image_segmentation_tpu_torch.losses.cross_entropy import log_with_eps


def _softmax(x, axis=-1):
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def _dice_np(probs, targets, ignore_index, class_weights, smooth):
    num_classes = probs.shape[-1]
    onehot = np.eye(num_classes, dtype=np.float64)[targets]
    reduce_axes = tuple(range(probs.ndim - 1))
    intersect = (probs * onehot).sum(axis=reduce_axes)
    sum_pred = probs.sum(axis=reduce_axes)
    sum_gt = onehot.sum(axis=reduce_axes)
    dc = (2 * intersect + smooth) / np.maximum(sum_pred + sum_gt + smooth, 1e-8)
    valid = np.ones(num_classes, dtype=bool)
    if ignore_index is not None and 0 <= ignore_index < num_classes:
        valid[ignore_index] = False
    if class_weights is not None:
        w = np.asarray(class_weights, dtype=np.float64) * valid
        return -float((dc * w).sum() / max(w.sum(), 1e-8))
    return -float((dc * valid).sum() / max(valid.sum(), 1))


def _weighted_pixel_mean_np(pix, targets, class_weights, ignore_index, C):
    valid = np.ones(targets.shape, dtype=np.float64)
    if ignore_index is not None:
        valid[targets == ignore_index] = 0.0
    if class_weights is not None:
        w = np.asarray(class_weights, dtype=np.float64)
        pw = w[np.clip(targets, 0, C - 1)] * valid
    else:
        pw = valid
    return float((pix * pw).sum() / max(pw.sum(), 1e-12))


def dice_ce_loss_np(logits, targets, cfg) -> float:
    """Numpy mirror of losses.combos.DiceCELoss. logits (..., C) float,
    targets (...) int, cfg a DiceCELoss instance."""
    logits = np.asarray(logits, dtype=np.float64)
    targets = np.asarray(targets).astype(np.int64)
    C = logits.shape[-1]
    probs = _softmax(logits)
    d = _dice_np(probs, targets, cfg.ignore_index, cfg.class_weights, cfg.smooth_dice)
    logp = np.log(np.maximum(probs, 1e-300))
    pix = -np.take_along_axis(logp, targets[..., None].clip(0, C - 1), axis=-1)[..., 0]
    ce = _weighted_pixel_mean_np(pix, targets, cfg.class_weights, cfg.ignore_index, C)
    return cfg.dice_weight * d + cfg.ce_weight * ce


def dice_nll_loss_np(probs, targets, cfg) -> float:
    """Numpy mirror of losses.combos.DiceNLLLoss (probability inputs)."""
    probs = np.asarray(probs, dtype=np.float64)
    targets = np.asarray(targets).astype(np.int64)
    C = probs.shape[-1]
    p = _softmax(probs) if cfg.apply_softmax else probs
    d = _dice_np(p, targets, cfg.ignore_index, cfg.class_weights, cfg.smooth_dice)
    if cfg.nll_nonlin is log_with_eps:
        # float64 mirror of the default nonlin (log(x + 1e-9))
        logp = np.log(probs + 1e-9)
    else:
        # a custom nonlin: evaluate the loss's own callable (float32 torch,
        # so exact float64 parity holds only for the default)
        logp = cfg.nll_nonlin(torch.from_numpy(probs.astype(np.float32))).double().numpy()
    pix = -np.take_along_axis(logp, targets[..., None].clip(0, C - 1), axis=-1)[..., 0]
    n = _weighted_pixel_mean_np(pix, targets, cfg.class_weights, cfg.ignore_index, C)
    return cfg.dice_weight * d + cfg.nll_weight * n

