"""Train state: the model, its optimizer and LR schedule, and the step.

Counterpart of image_segmentation_tpu/train/state.py. JAX threads an
immutable pytree through a donated step; here the model's parameters and
BatchNorm statistics and the optimizer's moments update in place, so the
state is a small holder of the objects a step mutates, and of the CUDA
graphs its train step replays (`graphs`, train/graphs.py), which go with
it.

`make_adamw` matches `optax.adamw` (b1 0.9, b2 0.999, eps 1e-8, decay
on every trainable parameter, the decay scaled by the learning rate): in
torch.optim.AdamW the decoupled decay p ← p·(1 − lr·wd) uses the same
pre-update parameters as optax's `add_decayed_weights`. Frozen subtrees
(`subtree_mask`, state.py:80-91) are left out of the optimizer: they get
no update and no decay.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from image_segmentation_tpu_torch.train.graphs import MicroBatchGraphs


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: Optional[torch.optim.Optimizer] = None
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None
    step: int = 0  # optimizer steps taken
    # the CUDA graphs of the train step's micro-batches (train/graphs.py)
    graphs: MicroBatchGraphs = dataclasses.field(default_factory=MicroBatchGraphs,
                                                 repr=False, compare=False)


def trainable_parameters(model: nn.Module, frozen_prefixes: Sequence[str] = ()):
    """The parameters whose dotted name is not, and is not under, one of
    `frozen_prefixes` (e.g. 'encoder' for the autoencoder's encoder)."""
    frozen = lambda name: any(name == p or name.startswith(p + ".") for p in frozen_prefixes)
    return [p for name, p in model.named_parameters() if not frozen(name)]


def freeze_(model: nn.Module, frozen_prefixes: Sequence[str]) -> None:
    """Stop the gradient of every parameter under `frozen_prefixes` (JAX
    masks them out of the optimizer and stops their gradient). The modules
    keep the caller's train mode, so BatchNorm under a frozen prefix still
    updates its running statistics, as JAX's mutable batch_stats do."""
    trainable = {id(p) for p in trainable_parameters(model, frozen_prefixes)}
    for p in model.parameters():
        if id(p) not in trainable:
            p.requires_grad_(False)


def make_adamw(params, learning_rate: float = 1e-3, weight_decay: float = 0.01,
               schedule: Optional[Callable[[int], float]] = None
               ) -> Tuple[torch.optim.Optimizer, Optional[torch.optim.lr_scheduler.LambdaLR]]:
    """AdamW matching the reference recipe (AdamW lr 1e-3, wd 0.01) and
    optax.adamw. `schedule(step)` gives the learning rate of the step-th
    optimizer update (optax's count, from 0); it becomes a LambdaLR whose
    factor is schedule(step) / learning_rate. (A closure, so LambdaLR's
    state dict holds only plain data; resume rebuilds the schedule.)"""
    opt = torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    if schedule is None:
        return opt, None
    factor = lambda step: schedule(step) / learning_rate  # noqa: E731
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)
