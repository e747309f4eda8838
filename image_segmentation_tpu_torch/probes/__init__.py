"""Speed probes of the port, each runnable as
`python -m image_segmentation_tpu_torch.probes.<name>`. Counterparts of
the JAX repository's benchmarks/<name>.py:

  confusion_probe     benchmarks/confusion_probe.py: bincount against the
                      one-hot product (and the eval's own scatter-add) on
                      eval-protocol shapes
  eval_bench          benchmarks/eval_bench.py: original-resolution eval,
                      device protocol against host protocol
  serve_profile       benchmarks/serve_profile.py: one UNet request split
                      into stage, upload, forward, fetch, unstage
  profile_train_step  benchmarks/profile_train_step.py: the train step
                      split into forward, gradient, loss and optimizer
  step_variants       benchmarks/step_variants.py: controlled variants of
                      the train step, timed in interleaved turns
  backward_anatomy    benchmarks/backward_anatomy.py: the step's device
                      time by direction and module, per conv under
                      --per-conv
  reference_anchor    benchmarks/reference_anchor.py: the reference's own
                      training and serving schedules as anchors
  reference_recipe    the reference's torch UNet, loss and eval protocol
                      (the JAX repository keeps them in
                      benchmarks/reference_anchor.py and its tests)

They are probes, not the benchmark: none of them is a cell. Each takes
--device (the card by default; a card asked for and missing ends the run
with a message), prints JSON lines under the JAX probe's keys plus the
card's name and power limit and the TF32 settings it ran under, and
returns its results from `main(argv)`. Off the card they run at the JAX
probes' CPU sizes.

This module holds what they share: the card line, a hard sync,
`timed` (medians over synchronised steps with their spread) and
`interleaved` (the same for several functions in turns), and the
production UNet step's pieces (`production_step`).
"""
from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable, Dict, NamedTuple, Optional

import torch

from image_segmentation_tpu_torch.studies import cli_device, device_kind

__all__ = ["cli_device", "device_kind", "card_line", "tf32", "stamp", "sync", "Timing",
           "timed", "interleaved", "production_step"]


def card_line(device) -> Optional[str]:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them; None off a card."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[torch.cuda.current_device() if device.index is None else device.index]


def tf32() -> Dict[str, bool]:
    """The TF32 settings the run's convs and matmuls ran under."""
    return {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def stamp(row: dict, device) -> dict:
    """`row` with the device it ran on, the card line and the TF32 settings."""
    return {**row, "device": device_kind(device), "card": card_line(device), "tf32": tf32()}


def sync(device) -> None:
    """Wait for the device's queued work (a no-op off a card)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Timing(NamedTuple):
    """Milliseconds of one call: the median and the extremes over the steps."""
    ms: float
    min_ms: float
    max_ms: float
    steps: int

    def row(self, name: str) -> dict:
        return {f"{name}_ms": self.ms, f"{name}_spread_ms": [self.min_ms, self.max_ms]}


def _summary(times) -> Timing:
    ms = [1e3 * t for t in times]
    return Timing(statistics.median(ms), min(ms), max(ms), len(ms))


def _steps(fn: Callable[[], object], steps: int, device) -> list:
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append(time.perf_counter() - t0)
    return times


def timed(fn: Callable[[], object], steps: int, device, warmup: int = 1) -> Timing:
    """fn() `steps` times after `warmup` calls, each call timed on the host
    clock from its start to a hard sync of `device` after it, so a step's
    time holds its kernels and not only their enqueue."""
    for _ in range(warmup):
        fn()
    sync(device)
    return _summary(_steps(fn, steps, device))


def interleaved(fns: Dict[str, Callable[[], object]], steps: int, turns: int, device,
                warmup: int = 1) -> Dict[str, Timing]:
    """`timed` for several functions in interleaved turns: each turn runs
    `steps` calls of each in order, so a drift of the clock or of the
    host's load over the run falls on all of them alike."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    sync(device)
    times = {name: [] for name in fns}
    for _ in range(turns):
        for name, fn in fns.items():
            times[name] += _steps(fn, steps, device)
    return {name: _summary(t) for name, t in times.items()}


def production_step(device, batch: int = 128, size: int = 256, seed: int = 0):
    """The production UNet step's pieces at the probes' sizes: on a card
    batch × size² at UNet-64 in bf16, elsewhere 4 × 64² at base 8 in
    float32 (the JAX probes' CPU sizes). Returns (TrainState of a seeded
    UNet and AdamW at lr 1e-3, images, labels, DiceCELoss(ignore_index=3)),
    the batch drawn as the JAX probes draw it."""
    import numpy as np

    from image_segmentation_tpu_torch.losses import DiceCELoss
    from image_segmentation_tpu_torch.models.unet import UNet
    from image_segmentation_tpu_torch.train.state import TrainState, make_adamw

    device = torch.device(device)
    on_card = device.type == "cuda"
    b, s = (batch, size) if on_card else (4, 64)
    model = UNet(num_classes=4, base=64 if on_card else 8,
                 dtype=torch.bfloat16 if on_card else torch.float32)
    model.init_weights(torch.Generator().manual_seed(seed))
    model = model.to(device=device, memory_format=torch.channels_last)
    opt, _ = make_adamw(model.parameters(), learning_rate=1e-3)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0, 1, (b, s, s, 3)).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.integers(0, 4, (b, s, s))).to(device)
    return TrainState(model, opt), x, y, DiceCELoss(ignore_index=3)
