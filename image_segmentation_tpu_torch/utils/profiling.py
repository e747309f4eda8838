"""Tracing, NaN checks and step timing.

Counterpart of image_segmentation_tpu/utils/profiling.py:
  * `trace_context(logdir)` (:29): torch.profiler records the enclosed
    region (host ops, and the card's kernels where there is one) and
    writes one trace per process under `logdir` (a
    `*.pt.trace.json`, for TensorBoard's PyTorch profiler plugin or
    Perfetto), as JAX's writes a jax.profiler trace;
  * `enable_nan_checks()` (:44): JAX's `jax_debug_nans` raises at the op
    that makes a NaN. Here `train.steps.train_step` checks each
    micro-batch's loss and the step's summed gradients (after their sum
    over processes, so every process raises together) and raises
    `FloatingPointError` naming the step. Each check fetches a flag from
    the device, so it is off unless asked for;
  * `StepTimer` (:96): per-step wall-clock times past a warm-up, with the
    card synchronised at each edge when it times a CUDA device.

Not ported: `enable_compilation_cache` (an XLA cache; nothing here
compiles per program).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterable, List, Optional

import torch

# set by enable_nan_checks; read by train.steps.train_step at each step
NAN_CHECKS = False


@contextlib.contextmanager
def trace_context(logdir: Optional[str] = None):
    """Profile the enclosed region with torch.profiler and write its trace
    under `logdir` (a no-op if logdir is None)."""
    if logdir is None:
        yield
        return
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


def enable_nan_checks(enable: bool = True) -> None:
    global NAN_CHECKS
    NAN_CHECKS = enable


def check_finite(what: str, step: int, tensors: Iterable[torch.Tensor]) -> None:
    """Raise FloatingPointError if any of `tensors` holds a NaN or an
    infinity (`what` and the optimizer step name it)."""
    tensors = list(tensors)
    if tensors and not bool(torch.stack([torch.isfinite(t).all() for t in tensors]).all()):
        raise FloatingPointError(f"non-finite {what} at train step {step}")


class StepTimer:
    """Per-step wall-clock timing with warm-up exclusion. With a CUDA
    `device`, each edge synchronises it, so a step's time includes its
    kernels and not only their enqueue."""

    def __init__(self, warmup_steps: int = 2, device=None):
        self.warmup_steps = warmup_steps
        self.times: List[float] = []
        self._t0: Optional[float] = None
        self._count = 0
        device = None if device is None else torch.device(device)
        self._cuda = device if device is not None and device.type == "cuda" else None

    def _sync(self) -> None:
        if self._cuda is not None:
            torch.cuda.synchronize(self._cuda)

    def start(self) -> None:
        self._sync()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is None:
            return
        self._sync()
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self._count += 1
        if self._count > self.warmup_steps:
            self.times.append(dt)

    @contextlib.contextmanager
    def step(self):
        self.start()
        try:
            yield
        finally:
            self.stop()

    @property
    def mean_s(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")

    def images_per_sec(self, batch_size: int) -> float:
        m = self.mean_s
        return batch_size / m if m == m and m > 0 else float("nan")

    def summary(self, batch_size: Optional[int] = None) -> str:
        s = f"{len(self.times)} steps, mean {self.mean_s * 1e3:.2f} ms"
        if batch_size:
            s += f", {self.images_per_sec(batch_size):.1f} img/s"
        return s
