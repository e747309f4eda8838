"""Segmentation metrics: confusion counts and Dice / IoU / accuracy.

Counterpart of image_segmentation_tpu/metrics/confusion.py. The epoch's
accumulation reduces to a (C, C) confusion matrix, `conf[t, p]` = the
number of pixels of true class t predicted as p, counted on the device;
TP / FP / FN / TN are linear in it, so the epoch metrics equal the
reference's per-image boolean algebra (reference
utils/MetricsHistory.py:55-128). Macro means skip `ignore_index` (from
the mean, not from the pixels) and classes absent from both prediction
and ground truth.

The JAX package counts with a one-hot matmul in float32; here the counts
are int64 scatter-adds (exact at any size; no host sync, unlike
`torch.bincount` on CUDA). A label or prediction outside [0, C) drops
out of the counts, as a jax.nn.one_hot row of zeros does.
`MetricsHistory` is host numpy in float64, as in JAX.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def confusion_counts_per_image(preds: torch.Tensor, labels: torch.Tensor,
                               num_classes: int) -> torch.Tensor:
    """(B, ...) predictions × labels → (B, C, C) int64 counts per image."""
    c = num_classes
    preds, labels = preds.reshape(preds.shape[0], -1), labels.reshape(labels.shape[0], -1)
    ok = (labels >= 0) & (labels < c) & (preds >= 0) & (preds < c)
    idx = torch.where(ok, labels.long() * c + preds.long(), c * c)  # c·c = the drop bin
    counts = torch.zeros((idx.shape[0], c * c + 1), dtype=torch.int64, device=idx.device)
    counts.scatter_add_(1, idx, torch.ones_like(idx))
    return counts[:, : c * c].view(-1, c, c)


def confusion_counts(preds: torch.Tensor, labels: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """(...,) integer predictions × labels → (C, C) int64 confusion matrix."""
    return confusion_counts_per_image(preds.reshape(1, -1), labels.reshape(1, -1),
                                      num_classes)[0]


def counts_from_confusion(conf: np.ndarray):
    """(C, C) confusion → per-class (tp, fp, fn, tn) in the matrix's dtype."""
    conf = np.asarray(conf)
    tp = np.diag(conf).copy()
    fp = conf.sum(axis=0) - tp  # predicted c but true other
    fn = conf.sum(axis=1) - tp  # true c but predicted other
    tn = conf.sum() - tp - fp - fn
    return tp, fp, fn, tn


def metrics_from_counts(tp, fp, fn, tn, mask: Optional[np.ndarray] = None):
    """Per-class and macro Dice / IoU / accuracy with the reference's
    formulas (utils/MetricsHistory.py:106-113). A class absent from both
    prediction and ground truth gives nan per class; the macro means
    average the classes present (nanmean), over `mask`."""
    with np.errstate(divide="ignore", invalid="ignore"):
        per_class_iou = tp / (tp + fp + fn)
        per_class_dice = (2 * tp) / (2 * tp + fp + fn)
        per_class_acc = (tp + tn) / (tp + tn + fp + fn)
    if mask is None:
        mask = np.ones_like(tp, dtype=bool)

    def _present_mean(a):
        v = a[mask]
        v = v[np.isfinite(v)]
        return float(v.mean()) if v.size else float("nan")

    return {
        "per_class_iou": per_class_iou,
        "per_class_dice": per_class_dice,
        "per_class_acc": per_class_acc,
        "mean_iou": _present_mean(per_class_iou),
        "mean_dice": _present_mean(per_class_dice),
        "mean_acc": _present_mean(per_class_acc),
    }


class MetricsHistory:
    """Epoch-level metric accumulator with the reference class's API
    (reference utils/MetricsHistory.py:4-183), float64 on the host."""

    def __init__(self, num_classes: int, ignore_index: Optional[int] = None):
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.confusion = np.zeros((num_classes, num_classes), dtype=np.float64)

        self.epoch_mean_dice_history = []
        self.epoch_mean_iou_history = []
        self.epoch_mean_acc_history = []
        self.epoch_per_class_dice_history = []
        self.epoch_per_class_iou_history = []
        self.epoch_per_class_acc_history = []
        self.last_per_class_iou = None
        self.last_per_class_dice = None
        self.last_per_class_acc = None

        self.mask = np.ones(num_classes, dtype=bool)
        if ignore_index is not None and 0 <= ignore_index < num_classes:
            self.mask[ignore_index] = False

    def reset(self):
        self.confusion[:] = 0.0

    def accumulate(self, pred: np.ndarray, label: np.ndarray):
        """Accumulate one image: pred (H, W, C) scores or (H, W) hard ids;
        label (H, W) int."""
        pred = np.asarray(pred)
        if pred.ndim == 3:
            pred = pred.argmax(axis=-1)
        label = np.asarray(label).reshape(pred.shape)
        idx = label.astype(np.int64) * self.num_classes + pred.astype(np.int64)
        conf = np.bincount(
            idx.reshape(-1), minlength=self.num_classes**2
        ).reshape(self.num_classes, self.num_classes)
        self.confusion += conf

    def accumulate_confusion(self, conf) -> None:
        """Accumulate a pre-reduced (C, C) confusion matrix (numpy, or a
        tensor on any device)."""
        if isinstance(conf, torch.Tensor):
            conf = conf.cpu().numpy()
        self.confusion += np.asarray(conf, dtype=np.float64)

    def compute_epoch_metrics(self):
        tp, fp, fn, tn = counts_from_confusion(self.confusion)
        m = metrics_from_counts(tp, fp, fn, tn, self.mask)

        self.epoch_mean_iou_history.append(m["mean_iou"])
        self.epoch_mean_dice_history.append(m["mean_dice"])
        self.epoch_mean_acc_history.append(m["mean_acc"])
        self.epoch_per_class_iou_history.append(m["per_class_iou"])
        self.epoch_per_class_dice_history.append(m["per_class_dice"])
        self.epoch_per_class_acc_history.append(m["per_class_acc"])
        self.last_per_class_iou = m["per_class_iou"]
        self.last_per_class_dice = m["per_class_dice"]
        self.last_per_class_acc = m["per_class_acc"]
        return m["mean_dice"], m["mean_iou"], m["mean_acc"]

    # The reference's getters (utils/MetricsHistory.py:152-183)
    def get_ignore_index(self):
        return self.ignore_index

    def get_num_classes(self):
        return self.num_classes

    def get_mean_dice_history(self):
        return self.epoch_mean_dice_history

    def get_mean_iou_history(self):
        return self.epoch_mean_iou_history

    def get_mean_acc_history(self):
        return self.epoch_mean_acc_history

    def get_class_dice_history(self):
        return self.epoch_per_class_dice_history

    def get_class_iou_history(self):
        return self.epoch_per_class_iou_history

    def get_class_acc_history(self):
        return self.epoch_per_class_acc_history

    def get_last_per_class_dice(self):
        return self.last_per_class_dice

    def get_last_per_class_iou(self):
        return self.last_per_class_iou

    def get_last_per_class_acc(self):
        return self.last_per_class_acc
