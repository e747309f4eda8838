"""The reference training step: weighted Dice + cross-entropy, micro-batches
accumulated into one AdamW update.

Loss (reference `utils/weighted_loss.py` WeightedDiceCELoss): the soft Dice
over the softmax, its per-class sums over batch and pixels together,
dice_c = (2 I_c + smooth) / max(P_c + G_c + smooth, 1e-8), class-weighted
mean, negated; plus the weighted cross-entropy sum_i w[y_i] (-log p_i[y_i])
over sum_i w[y_i]. A step runs `accum` micro-batches in order, each in
train mode, sums their gradients and divides by `accum`, then takes one
AdamW step (b1 0.9, b2 0.999, eps 1e-8, decoupled decay p <- p (1 - lr wd)
on the pre-update parameters).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch


def dice_ce_loss(logits: torch.Tensor, targets: torch.Tensor,
                 class_weights: Sequence[float], smooth: float) -> torch.Tensor:
    c = logits.shape[-1]
    w = torch.tensor(class_weights, dtype=torch.float64, device=logits.device).float()
    onehot = torch.nn.functional.one_hot(targets.long(), c).float()
    probs = torch.softmax(logits, -1)
    dims = tuple(range(logits.dim() - 1))
    inter, pred, gt = (probs * onehot).sum(dims), probs.sum(dims), onehot.sum(dims)
    dice = (2 * inter + smooth) / torch.clamp(pred + gt + smooth, min=1e-8)
    dice_loss = -(dice * w).sum() / w.sum()
    pix_w = w[targets.long()]
    nll = -(torch.log_softmax(logits, -1) * onehot).sum(-1)
    return dice_loss + (nll * pix_w).sum() / pix_w.sum()


class AdamW:
    """AdamW over a list of parameters, its moments in float32."""

    def __init__(self, params: List[torch.Tensor], lr: float, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params, self.lr, self.wd = params, lr, weight_decay
        self.b1, self.b2, self.eps, self.t = b1, b2, eps, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1 - self.lr * self.wd)
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            p.sub_(self.lr * (m / c1) / (torch.sqrt(v / c2) + self.eps))


def train_step(model: torch.nn.Module, opt: AdamW, images: torch.Tensor,
               labels: torch.Tensor, accum: int, class_weights, smooth: float):
    """One optimizer step; returns (each micro-batch's loss as a float, the
    gradients as the optimizer got them, name -> tensor)."""
    model.train()
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        p.grad = None
    micro = labels.shape[0] // accum
    losses = []
    for i in range(accum):
        rows = slice(i * micro, (i + 1) * micro)
        loss = dice_ce_loss(model(images[rows]), labels[rows], class_weights, smooth)
        loss.backward()
        losses.append(loss.item())
    grads = [p.grad / accum if p.grad is not None else torch.zeros_like(p) for p in params]
    opt.step(grads)
    return losses, dict(zip(names, grads))


def trainable(model: torch.nn.Module, frozen: Sequence[str]) -> Dict[str, torch.Tensor]:
    """The parameters not under a frozen prefix; the frozen ones stop their
    gradient."""
    out = {}
    for n, p in model.named_parameters():
        if any(n == f or n.startswith(f + ".") for f in frozen):
            p.requires_grad_(False)
        else:
            out[n] = p
    return out
