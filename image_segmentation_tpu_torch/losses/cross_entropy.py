"""Weighted cross-entropy / NLL with torch.nn.CrossEntropyLoss's reduction.

Counterpart of image_segmentation_tpu/losses/cross_entropy.py (:22-75):

    sum_i w[y_i] · (−log softmax(x_i)[y_i])  /  sum_i w[y_i]

over pixels i with y_i != ignore_index: a weighted mean whose denominator
is the sum of the pixels' weights (reference utils/weighted_loss.py:
132-138). The class select and the weight lookup are one-hot
contractions, as in the JAX package. Inside a process group of more
than one process (parallel/mesh.py) the numerator and the denominator are
each summed over the processes before the division: the global batch's
weighted mean on every process. Math in float32; logits (..., C),
integer targets (...).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from image_segmentation_tpu_torch.losses.dice import class_vector, one_hot
from image_segmentation_tpu_torch.parallel.mesh import global_sums


def _nll_from_logp(logp, targets, weights, ignore_index, num_classes):
    """sum_i w[y_i]·(−logp_i[y_i]) / sum_i w[y_i]."""
    onehot = one_hot(targets, num_classes)
    pix = -(logp * onehot).sum(-1)
    if ignore_index is not None:
        valid = (targets != ignore_index).float()
    else:
        valid = torch.ones_like(pix)
    if weights is not None:
        w = class_vector(tuple(float(c) for c in weights), logp.device)
        pix_w = (onehot * w).sum(-1) * valid
    else:
        pix_w = valid
    num, den = global_sums((pix * pix_w).sum(), pix_w.sum())
    return num / torch.clamp(den, min=1e-12)


def cross_entropy_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    *,
    class_weights: Optional[Sequence[float]] = None,
    ignore_index: Optional[int] = None,
) -> torch.Tensor:
    num_classes = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    return _nll_from_logp(logp, targets, class_weights, ignore_index, num_classes)


def nll_loss(
    log_probs: torch.Tensor,
    targets: torch.Tensor,
    *,
    class_weights: Optional[Sequence[float]] = None,
    ignore_index: Optional[int] = None,
    nonlin: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """torch.nn.NLLLoss's reduction; `nonlin` converts the inputs first (the
    prompt model emits probabilities, so the prompt loss passes
    `log_with_eps`)."""
    num_classes = log_probs.shape[-1]
    x = log_probs.float()
    if nonlin is not None:
        x = nonlin(x)
    return _nll_from_logp(x, targets, class_weights, ignore_index, num_classes)


def log_with_eps(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """The prompt pipeline's probability → log-probability non-linearity."""
    return torch.log(x + eps)
