"""Tracing, spans inside the train step, and NaN checks.

Counterpart of image_segmentation_tpu/utils/profiling.py:
  * `trace_context(logdir)` (:29): torch.profiler records the enclosed
    region (host ops, and the card's kernels where there is one) and
    writes one trace per process under `logdir` (a
    `*.pt.trace.json`, for TensorBoard's PyTorch profiler plugin or
    Perfetto), as JAX's writes a jax.profiler trace. The program's spans
    are on for the region, so the trace shows the step's phases;
  * `enable_nan_checks()` (:44): JAX's `jax_debug_nans` raises at the op
    that makes a NaN. Here `train.steps.train_step` checks each
    micro-batch's loss and the step's summed gradients (after their sum
    over processes, so every process raises together) and raises
    `FloatingPointError` naming the step. Each check fetches a flag from
    the device, so it is off unless asked for.

Spans (no JAX counterpart: XLA's trace names the ops of one jitted step).
`SPANS` is the switch: None, or the `SpanLog` that `record_spans()` (or
`trace_context`) installed for its region. Each span site calls
`span(name, ...)` in a `with`; off, that reads the global and returns one
shared no-op context, with no allocation and no clock read. On, the span
takes its place in the log as it opens and its end as it closes: its
name, its start and end on `time.perf_counter` (the host clock onto which
the benchmark's `perfbench/tracing.py` `DeviceSlice` maps the device's
events by its marker kernel), the index of the span it was opened in on
the same thread, the optimizer step and the micro-batch, and the thread.
While a torch.profiler session records, a span also enters
`torch.profiler.record_function(name)`, so a trace shows the same names
beside the kernels, on the profiler's own clock. `train.steps.train_step`
is the one caller: `train.step` around the call, and inside it
`train.forward`, `train.loss` and `train.backward` per micro-batch and
`train.update` once; `train.capture` (train/graphs.py) where the step
captures a micro-batch shape's CUDA graphs. Where the micro-batches
replay graphs, `train.forward` times the forward graph's replay (and the
copy of the micro-batch into its static inputs) and `train.backward` the
loss's eager backward and the backward graph's replay: the host's enqueue
of the graphs, not of the model's ops.

Counts: `count(name)` adds to `SpanLog.counts` while spans are on and,
off, costs one read of `SPANS`, as a span does. The train step counts
`train.captures` (graph pairs captured), `train.replays` (micro-batches
replayed) and `train.eager_micro_batches` (micro-batches run eagerly);
models/sam.py counts its encoder's attention calls by kind and the padded
tokens its windows add, and opens `sam.image_encoder`,
`sam.prompt_encoder` and `sam.mask_decoder` spans in its forward.
models/sam2.py opens the same three; inside `sam.image_encoder`,
models/hiera.py opens `sam.hiera_stage1` to `sam.hiera_stage4` and
`sam.neck`, and counts its blocks' attention by kind
(`sam.window_attention` on K5's window map, `sam.global_attention`,
`sam.plain_window_attention` for the small windows on SDPA,
`sam.pooled_attention`) and `sam.window_pad_tokens`.

Not ported: `enable_compilation_cache` (an XLA cache; nothing here
compiles per program); `StepTimer` (:96; nothing read it, and a
`train.step` span times a step).
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Iterable, List, Optional

import torch

# set by enable_nan_checks; read by train.steps.train_step at each step
NAN_CHECKS = False
# set by record_spans; read at each span site
SPANS: Optional["SpanLog"] = None

_OFF = contextlib.nullcontext()


class Span:
    """One span of a `SpanLog`, and the context that records it. `parent`
    is the index in the log of the span it was opened in on its thread
    (None at the top); `step` is the optimizer step, given or taken from
    the parent; `micro` is the micro-batch index, where there is one."""

    __slots__ = ("name", "start", "end", "parent", "step", "micro", "thread", "_log", "_rf")

    def __init__(self, log: "SpanLog", name: str, micro: Optional[int], step: Optional[int]):
        self.name, self.micro, self.step, self._log = name, micro, step, log
        self.start = self.end = self.parent = self._rf = None
        self.thread = threading.get_ident()

    def __enter__(self) -> "Span":
        log = self._log
        stack = log._stack()
        if stack:
            self.parent = stack[-1]
            if self.step is None:
                self.step = log.spans[self.parent].step
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        with log._lock:
            stack.append(len(log.spans))
            log.spans.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter()
        self._log._stack().pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        return False


class SpanLog:
    """The spans of one region, in the order they opened, from every
    thread; each thread keeps its own stack of open spans; and the
    region's counts (`count`), by name."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counts: collections.Counter = collections.Counter()
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> List[int]:
        stack = getattr(self._local, "open", None)
        if stack is None:
            stack = self._local.open = []
        return stack


def span(name: str, micro: Optional[int] = None, step: Optional[int] = None):
    """A context that records one span into `SPANS`, or the shared no-op
    context when spans are off."""
    log = SPANS
    if log is None:
        return _OFF
    return Span(log, name, micro, step)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the count `name` of `SPANS`; nothing when spans are off."""
    log = SPANS
    if log is not None:
        with log._lock:
            log.counts[name] += n


@contextlib.contextmanager
def record_spans():
    """Turn spans on for the enclosed region: install a fresh `SpanLog`,
    yield it, and put back what was installed before."""
    global SPANS
    before, SPANS = SPANS, SpanLog()
    try:
        yield SPANS
    finally:
        SPANS = before


@contextlib.contextmanager
def trace_context(logdir: Optional[str] = None):
    """Profile the enclosed region with torch.profiler, spans on, and write
    its trace under `logdir` (a no-op if logdir is None)."""
    if logdir is None:
        yield
        return
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)), record_spans():
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
