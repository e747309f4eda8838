"""The train step with micro-batch gradient accumulation, the device-
resident train set, and the eval forward.

Counterpart of image_segmentation_tpu/train/steps.py (:58-120, :242-254)
and of the residency helpers of its train/loop.py (:447-503). The
reference (utils/training.py:18-64) steps the optimizer once per
`accumulation_steps` micro-batches with the mean gradient, and updates
the BatchNorm statistics per micro-batch. JAX scans the micro-batches
inside one jitted program; here they run in a Python loop, each forward
in train mode (batch statistics, running statistics updated in order)
and each backward adding into `.grad`. The gradient sum is divided by
the count once, as JAX divides its summed gradients.

The JAX whole-epoch trainer (`make_train_epoch`) uploads the train set
to the device once and gathers each step's batch there; `ResidentTrainSet`
does the same, in float32 when it fits the budget, else as uint8 images
(round to nearest of x·255) and uint8 labels, decoded per gathered batch
(`_resident_plan`, `_quantize_u8`, `_labels_u8`). Nothing per epoch
crosses the host link but the index matrix and the losses.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from image_segmentation_tpu_torch.train.state import TrainState


def quantize_u8(a: np.ndarray) -> np.ndarray:
    """[0, 1] floats → 0..255 uint8, round to nearest (JAX loop.py:447),
    in bounded slabs so no full-size float temporary is made."""
    a = np.asarray(a)
    if a.dtype == np.uint8:
        return a
    out = np.empty(a.shape, np.uint8)
    flat_in, flat_out = a.reshape(-1), out.reshape(-1)
    step = 1 << 24
    buf = np.empty(min(step, flat_in.size), np.float32)
    for i in range(0, flat_in.size, step):
        b = buf[: min(step, flat_in.size - i)]
        np.multiply(flat_in[i:i + b.size], 255.0, out=b)
        np.rint(b, out=b)
        np.clip(b, 0.0, 255.0, out=b)
        flat_out[i:i + b.size] = b
    return out


def labels_u8(labels: np.ndarray) -> np.ndarray:
    """Class-id labels → uint8 (ids 0..C-1, or sentinels ≤ 255)."""
    labels = np.asarray(labels)
    if labels.min() < 0 or labels.max() > 255:
        raise ValueError(f"labels outside uint8 range [{labels.min()}, {labels.max()}]")
    return labels.astype(np.uint8)


def resident_plan(f32_bytes: int, budget: int) -> Tuple[bool, bool]:
    """(fits, quantize): float32 residency when the set fits `budget`,
    uint8 (a quarter of the bytes) when only that fits (JAX `_resident_plan`
    with resident_dtype 'auto')."""
    if f32_bytes <= budget:
        return True, False
    return f32_bytes // 4 <= budget, True


class ResidentTrainSet:
    """A train set uploaded to `device` once; `batch(idx)` gathers a step
    batch there as (float32 NHWC images, int64 labels)."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, device, quantize: bool):
        self.quantize = quantize
        if quantize:
            images, labels = quantize_u8(images), labels_u8(labels)
        self.images = torch.from_numpy(np.ascontiguousarray(images)).to(device)
        self.labels = torch.from_numpy(np.ascontiguousarray(labels)).to(device)

    def batch(self, idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.images.index_select(0, idx)
        if self.quantize:
            x = x.float() * (1.0 / 255.0)
        return x, self.labels.index_select(0, idx).long()


def train_step(state: TrainState, loss_fn: Callable, images: torch.Tensor,
               targets: torch.Tensor, accum_steps: int = 1) -> torch.Tensor:
    """One optimizer step on a step batch of accum_steps × micro rows:
    micro-batch i is rows [i·micro, (i+1)·micro), as JAX's reshape takes
    them. Returns the mean of the micro-batches' losses, a 0-d f32 tensor
    on the device (no host sync)."""
    model, opt = state.model, state.optimizer
    model.train()
    opt.zero_grad(set_to_none=True)
    micro = images.shape[0] // accum_steps
    total = None
    for i in range(accum_steps):
        rows = slice(i * micro, (i + 1) * micro)
        loss = loss_fn(model(images[rows]), targets[rows])
        loss.backward()
        total = loss.detach() if total is None else total + loss.detach()
    if accum_steps > 1:
        grads = [p.grad for g in opt.param_groups for p in g["params"] if p.grad is not None]
        torch._foreach_div_(grads, float(accum_steps))
        total = total / accum_steps
    opt.step()
    if state.scheduler is not None:
        state.scheduler.step()
    state.step += 1
    return total


def eval_forward(model: torch.nn.Module, *inputs: torch.Tensor) -> torch.Tensor:
    """The inference forward (running-average BatchNorm, no autograd), the
    model's mode restored after. A UNet built with kernels runs K1 here on
    CUDA, folding the current weights on every call."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return model(*inputs)
    finally:
        model.train(was_training)
