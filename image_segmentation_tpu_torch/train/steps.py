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
and heatmaps (round to nearest of x·255; both lie in [0, 1]) and uint8
labels, decoded per gathered batch (`_resident_plan`, `_quantize_u8`,
`_labels_u8`). Packed ViT features are never quantised (`resident_plan`
with `quantizable=False`). Nothing per epoch crosses the host link but
the index matrix and the losses. In reconstruction mode (`labels=None`,
JAX loop.py:1085-1092) one image buffer is input and target, so under
uint8 residency both are decoded from it and stay equal.

A set that fits the budget in no allowed dtype stays in host memory
(`StreamedTrainSet`, JAX's per-batch path, loop.py:505-520 and
:877-897): each step batch is gathered on the host under the same
shuffle and streamed to the device (`stream_rows`: gathered on a worker
thread into pinned memory and copied on a side stream, two batches
ahead), as float32.

A prompt set's batch is ((images, heatmaps), labels), and `train_step`
applies `model(images, heatmaps)` to each micro-batch (JAX
steps.py:75-79).

On a card, one process, the micro-batches replay CUDA graphs of the
model's train-mode forward and of its backward (train/graphs.py: captured
at a micro-batch shape's first step, held on `state.graphs`), so that
the host enqueues two graphs a micro-batch instead of hundreds of ops;
the loss, its backward, the NaN checks and the update stay eager, and the
summed gradients reach `.grad` after the loop. Everything else (the CPU,
a process group, SP, TP, a hook a replay would skip) runs the eager loop
below; `graphs.eager_reasons` and `graphs.model_signature` decide.

`train_step(augment_fn=...)` augments the whole step batch (micro ×
accum rows) before the micro-batch split, as JAX train/steps.py:228-231
does, with draws from the caller's `generator`.

Across processes (train/multihost_loop.py) each process steps on its
rows of the step batch (`local_step_rows`): its contiguous 1/W of every
micro-batch. Its BatchNorm statistics and its loss are those of the whole
micro-batch (global sums, parallel/mesh.py), so each micro-batch is JAX's
(steps.py:228-231), and the accumulated gradients are summed over the
processes once per step, before the division. (JAX's own multi-process
layout gives each process a contiguous block of the whole step batch and
lets XLA reshard it for the micro-batch split.)

On a (data, model) mesh (parallel/mesh.py) the rows split over the data
axis only (`local_step_rows` takes the mesh's data size and rank): the
ranks of a model group hold the same rows. A model whose encoder is
tensor-parallel (parallel/tp.py) has its split parameters' gradients
summed over the data group alone and divided by the data size; every other
gradient is summed over the world and divided by its size, as before
(parallel/mesh.py gives both derivations). Under spatial partitioning
(parallel/sp.py) the caller hands `train_step` its block of H of its rows;
nothing here changes, since every parameter is replicated and the halo
exchange is its own adjoint.

`train_step` opens a span at each phase (`utils.profiling.span`), so
that the host's time a step splits by phase. They record only while
`utils.profiling.SPANS` holds a log (`record_spans()`, `trace_context`);
off, they cost a read of that global each. Their times are on
`time.perf_counter`, the host clock the benchmark's device trace is
mapped onto, and all spans of one call carry its `state.step`:
  * `train.step`: the whole call, augmentation included; its self time
    is `zero_grad`, the micro-batch slicing, the loop and the NaN checks
    of the losses;
  * `train.capture`: a new micro-batch shape's graphs warmed up and
    captured (train/graphs.py), in the step that first meets the shape;
  * `train.forward` (micro-batch i): `model(...)`, train-mode BatchNorm
    and its running statistics included; under graphs, the micro-batch
    copied in and the forward graph replayed;
  * `train.loss` (i): `loss_fn(...)`;
  * `train.backward` (i): `loss.backward()`, the autograd engine's
    enqueue, which the caller waits for; under graphs, the loss's
    backward and the backward graph's replay;
  * `train.update`: the gradients collected (under graphs, handed from
    the graphs' buffers to `.grad`), summed over processes and divided,
    their NaN check, `opt.step()` and `scheduler.step()`.
Each micro-batch is counted (`utils.profiling.count`) as replayed
(`train.replays`) or eager (`train.eager_micro_batches`), and each
capture as `train.captures`.
"""
from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from image_segmentation_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    DataAxis,
    all_reduce_,
    world_size,
)
from image_segmentation_tpu_torch.train.state import TrainState
from image_segmentation_tpu_torch.utils import profiling


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


# step batches a streamed train set gathers and copies ahead of the one in use
STREAM_LOOKAHEAD = 2


def resident_plan(f32_bytes: int, budget: int, quantizable: bool = True) -> str:
    """How a train set of `f32_bytes` (float32) lives against the device
    `budget` (JAX `_resident_plan('auto', ...)`): 'float32' on the device
    when it fits, else 'uint8' (a quarter of the bytes) when that fits,
    else 'stream' from host memory (JAX's use_device_epoch=False). A set
    that is not `quantizable` (ViT features, which uint8 in [0, 1] would
    destroy) is float32 or streamed, never uint8."""
    if f32_bytes <= budget:
        return "float32"
    if quantizable and f32_bytes // 4 <= budget:
        return "uint8"
    return "stream"


def stream_rows(arrays: Sequence[np.ndarray], rows: Iterable[np.ndarray],
                device) -> Iterator[Tuple[torch.Tensor, ...]]:
    """For each index vector of `rows`, (a[idx] for a in arrays) on
    `device`, streamed from host memory (JAX `_stream_batches`). A worker
    thread gathers each batch (into pinned host memory for a CUDA device)
    and, on CUDA, copies it on a side stream, `STREAM_LOOKAHEAD` batches
    ahead of the one the caller holds, so the gather and the copy overlap
    the caller's step. The caller's stream waits on the copy's event, and
    each tensor is recorded on that stream for the allocator."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    srcs = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    if cuda:
        compute, copy = torch.cuda.current_stream(device), torch.cuda.Stream(device)

    def put(idx):
        idx = torch.as_tensor(idx, dtype=torch.long)
        host = [torch.index_select(s, 0, idx, out=torch.empty(
            (len(idx),) + s.shape[1:], dtype=s.dtype, pin_memory=cuda)) for s in srcs]
        if not cuda:
            return [h.to(device) for h in host], None
        with torch.cuda.stream(copy):
            dev = [h.to(device, non_blocking=True) for h in host]
            done = torch.cuda.Event()
            done.record(copy)
        return dev, done

    def take(future):
        dev, done = future.result()
        if done is not None:
            compute.wait_event(done)
            for d in dev:
                d.record_stream(compute)
        return tuple(dev)

    pending = deque()
    with ThreadPoolExecutor(max_workers=1, thread_name_prefix="stream_rows") as pool:
        try:
            for idx in rows:
                pending.append(pool.submit(put, idx))
                if len(pending) > STREAM_LOOKAHEAD:
                    yield take(pending.popleft())
            while pending:
                yield take(pending.popleft())
        finally:
            for f in pending:
                f.cancel()


def _assemble(x: torch.Tensor, heatmaps: Optional[torch.Tensor],
              labels: Optional[torch.Tensor]):
    """A step batch: (images, labels), ((images, heatmaps), labels), or
    (images, images) in reconstruction mode."""
    if labels is None:
        return x, x
    return (x if heatmaps is None else (x, heatmaps)), labels.long()


class ResidentTrainSet:
    """A train set uploaded to `device` once; `batch(idx)` gathers a step
    batch there as (float32 NHWC images, int64 labels), with heatmaps as
    ((images, heatmaps), labels), or, with `labels=None`
    (reconstruction), as (images, the same images)."""

    def __init__(self, images: np.ndarray, labels: Optional[np.ndarray], device,
                 quantize: bool, heatmaps: Optional[np.ndarray] = None):
        self.quantize = quantize
        if quantize:
            images = quantize_u8(images)
            heatmaps = None if heatmaps is None else quantize_u8(heatmaps)
            labels = None if labels is None else labels_u8(labels)
        upload = lambda a: (None if a is None  # noqa: E731
                            else torch.from_numpy(np.ascontiguousarray(a)).to(device))
        self.images, self.heatmaps, self.labels = upload(images), upload(heatmaps), upload(labels)

    def _gather(self, a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        x = a.index_select(0, idx)
        return x.float() * (1.0 / 255.0) if self.quantize else x

    def batch(self, idx: torch.Tensor):
        return _assemble(
            self._gather(self.images, idx),
            None if self.heatmaps is None else self._gather(self.heatmaps, idx),
            None if self.labels is None else self.labels.index_select(0, idx))

    def batches(self, order: np.ndarray) -> Iterator[tuple]:
        """The step batches of an (nsteps, batch) index matrix."""
        idx = torch.from_numpy(order).to(self.images.device)
        for s in range(len(order)):
            yield self.batch(idx[s])


class StreamedTrainSet:
    """A train set that stays in host memory; `batches(order)` streams the
    step batches of an (nsteps, batch) index matrix to `device`
    (`stream_rows`), as float32 NHWC images (and heatmaps) and int64
    labels, the values `ResidentTrainSet` in float32 gives."""

    def __init__(self, images: np.ndarray, labels: Optional[np.ndarray], device,
                 heatmaps: Optional[np.ndarray] = None):
        self.device = torch.device(device)
        self.arrays = [a for a in (images, heatmaps, labels) if a is not None]
        self.has_heatmaps, self.has_labels = heatmaps is not None, labels is not None

    def batches(self, order: np.ndarray) -> Iterator[tuple]:
        for b in stream_rows(self.arrays, order, self.device):
            b = list(b)
            x = b.pop(0)
            heat = b.pop(0) if self.has_heatmaps else None
            yield _assemble(x, heat, b.pop(0) if self.has_labels else None)


def local_step_rows(step_batch: int, accum_steps: int, axis: DataAxis) -> np.ndarray:
    """The rows of a step batch (micro × accum_steps) this process trains
    on: for micro-batch i, rows [i·micro + rank·k, i·micro + (rank + 1)·k)
    with k = micro / W, in micro-batch order, so that `train_step`'s split
    of them into accum_steps parts gives each process its share of each
    micro-batch. W and rank are the data axis's: on a (data, model) mesh
    the ranks of a model group take the same rows. A micro-batch that does
    not divide over the data axis is refused (JAX would reshard it)."""
    micro = step_batch // accum_steps
    if micro % axis.size:
        raise ValueError(f"the micro-batch of {micro} rows does not divide over "
                         f"{axis.size} processes; pick a micro-batch that is a multiple of "
                         f"{axis.size}")
    k = micro // axis.size
    return (np.arange(accum_steps)[:, None] * micro + axis.rank * k
            + np.arange(k)).reshape(-1)


def train_step(state: TrainState, loss_fn: Callable,
               images: Union[torch.Tensor, Tuple[torch.Tensor, ...]],
               targets: torch.Tensor, accum_steps: int = 1,
               augment_fn: Optional[Callable] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One optimizer step on a step batch of accum_steps × micro rows:
    micro-batch i is rows [i·micro, (i+1)·micro), as JAX's reshape takes
    them. `images` is the model's input, or a tuple of its inputs (the
    prompt model's images and heatmaps), each cut the same way.
    `augment_fn(images, targets, generator)` first transforms the whole
    step batch. Returns the mean of the micro-batches' losses, a 0-d f32
    tensor on the device (no host sync). Inside a process group the batch
    is this process's rows (`local_step_rows`), the loss the global one,
    and the gradients are summed over the processes and divided by their
    number as well (parallel/mesh.py gives the derivation). Under
    `utils.profiling.enable_nan_checks()` a non-finite micro-batch loss or
    summed gradient raises FloatingPointError naming the step (its index
    from 0) before the optimizer moves. Under `utils.profiling.record_spans()`
    the call records its spans (the module docstring names them)."""
    with profiling.span("train.step", step=state.step):
        if augment_fn is not None:
            images, targets = augment_fn(images, targets, generator)
        inputs = images if isinstance(images, tuple) else (images,)
        model, opt = state.model, state.optimizer
        model.train()
        opt.zero_grad(set_to_none=True)
        micro = targets.shape[0] // accum_steps
        pair = state.graphs.for_step(model, tuple(x[:micro] for x in inputs))
        total = None
        for i in range(accum_steps):
            rows = slice(i * micro, (i + 1) * micro)
            xs, ys = tuple(x[rows] for x in inputs), targets[rows]
            with profiling.span("train.forward", micro=i):
                if pair is None:
                    out = model(*xs)
                    profiling.count("train.eager_micro_batches")
                else:
                    out = pair.forward(model, xs)
            with profiling.span("train.loss", micro=i):
                loss = loss_fn(out, ys)
            if profiling.NAN_CHECKS:
                profiling.check_finite(f"loss (micro-batch {i})", state.step, [loss])
            with profiling.span("train.backward", micro=i):
                loss.backward()
            total = loss.detach() if total is None else total + loss.detach()
        with profiling.span("train.update"):
            if pair is not None:
                pair.hand_grads()
            world = world_size()
            params = [p for g in opt.param_groups for p in g["params"] if p.grad is not None]
            grads = [p.grad for p in params if getattr(p, "tp_split_dim", None) is None]
            split = [p.grad for p in params if getattr(p, "tp_split_dim", None) is not None]
            if accum_steps * world > 1:
                all_reduce_(grads)
                torch._foreach_div_(grads, float(accum_steps * world))
                total = total / accum_steps
            if split:  # tensor-parallel shards: over the data group only (parallel/mesh.py)
                group, data_size, _ = model.tp_mesh.axis(DATA_AXIS)
                all_reduce_(split, group)
                torch._foreach_div_(split, float(accum_steps * data_size))
            grads += split
            if profiling.NAN_CHECKS:
                profiling.check_finite("gradient", state.step, grads)
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
