"""Spans, counters and the device trace of a `--trace 1` run.

Spans are recorded from the benchmark's own wrappers around the calls into
each layer of the program, on the host's `perf_counter` clock, from every
thread. The device side comes from one torch.profiler session over a slice
of the window (`DeviceSlice`), recording device activity alone so that the
host runs as it does untraced: its Chrome trace gives every kernel, copy
and memset with its start and length; one marker kernel launched on an
idle card at a known `perf_counter` time puts the two clocks on one line
(where its record is lost, the slice's first work is taken to start at
the slice's start, which `start()` leaves idle). A kernel's
launches are recorded with their shapes by a wrapper of its launcher, so
that its bound can be computed per launch (`counts.py`).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# kernel -> (the names of its device functions, the one launched once a call)
KERNEL_NAMES = {
    "k1": (("conv3x3_kernel", "splitk_epilogue"), "conv3x3_kernel"),
    "k3": (("attention_kernel",), "attention_kernel"),
    "k4": (("mlp_fc1_kernel", "mlp_fc2_kernel", "mlp_reduce"), "mlp_fc1_kernel"),
}
# device functions of K1 per call: two convs
MAIN_PER_CALL = {"k1": 2, "k3": 1, "k4": 1}


class Spans:
    """Host spans (name, thread id, start, end) in perf_counter seconds, and
    counters; thread-safe. A disabled recorder records nothing."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.items: List[Tuple[str, int, float, float]] = []
        self.counters: Dict[str, float] = collections.Counter()
        self.launches: List[Tuple[str, float, float, float]] = []  # kernel, t, flops, bytes
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.items.append((name, threading.get_ident(), t0, t1))

    def count(self, name: str, n: float = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def launch(self, kernel: str, flops: float, nbytes: float) -> None:
        with self._lock:
            self.launches.append((kernel, time.perf_counter(), flops, nbytes))

    def durations(self, name: str) -> List[float]:
        return [e - s for n, _, s, e in self.items if n == name]


def wrap_kernel_launches(spans: Spans):
    """Record each K1, K3 and K4 call's operations and bytes, computed from
    its shapes, by wrapping the launcher each wrapper calls (`_launch`).
    Returns a function that puts the launchers back."""
    from image_segmentation_tpu_torch.ops.kernels import attention, double_conv, mlp

    from perfbench import counts

    def k1(xs, w1, *rest):
        n, h, w, _ = xs[0].shape
        return counts.k1_counts(n, h, w, sum(int(x.shape[-1]) for x in xs), int(w1.shape[-1]))

    def k3(q, *rest):
        return counts.k3_counts(*(int(d) for d in q.shape))

    def k4(x, ln_w, ln_b, w1, *rest):
        return counts.k4_counts(x.numel() // x.shape[-1], int(x.shape[-1]), int(w1.shape[0]))

    undo = []
    for mod, kernel, shape_counts in ((double_conv, "k1", k1), (attention, "k3", k3),
                                      (mlp, "k4", k4)):
        launch = getattr(mod, "_launch", None)
        if launch is None:
            continue

        def wrapped(*args, _launch=launch, _kernel=kernel, _counts=shape_counts, **kw):
            flops, nbytes = _counts(*args)
            spans.launch(_kernel, flops, nbytes)
            return _launch(*args, **kw)

        mod._launch = wrapped
        undo.append((mod, launch))

    def restore():
        for mod, launch in undo:
            mod._launch = launch

    return restore


@dataclasses.dataclass
class DeviceEvent:
    name: str
    cat: str
    start: float  # perf_counter seconds
    end: float


class DeviceSlice:
    """A torch.profiler session over a slice of the window: `start()` and
    `stop()` synchronise the device, so the slice holds the work enqueued
    between them; `finish()`, after the window, reads the trace."""

    def __init__(self, device):
        self.device = device
        self.events: List[DeviceEvent] = []
        self.t0 = self.t1 = None
        self._prof = None
        self.aligned_by_marker = True

    def prime(self) -> None:
        """One empty session shortly before `start()`, so that `start()`
        does not pay the tracer's first start (seconds)."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda._sleep(1000)
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        torch.cuda.synchronize(self.device)
        self._anchor = time.perf_counter()
        torch.cuda._sleep(1000)  # the marker: a spin kernel of about a microsecond
        torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        self._prof.stop()

    def finish(self) -> None:
        """Read the session's trace: every device event on the host's clock."""
        if self._prof is None:
            return
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.remove(path)
        self._prof = None
        events = [e for e in (trace["traceEvents"] if isinstance(trace, dict) else trace)
                  if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
        markers = [e for e in events if e["cat"] == "kernel" and "spin" in e["name"]]
        if markers:
            marker = min(markers, key=lambda e: float(e["ts"]))
            offset = self._anchor - float(marker["ts"]) * 1e-6
            events = [e for e in events if e is not marker]
        else:  # the marker's record was lost: the slice's first work starts at t0
            self.aligned_by_marker = False
            offset = self.t0 - min((float(e["ts"]) for e in events), default=0.0) * 1e-6
        self.events = [DeviceEvent(e["name"], e["cat"], float(e["ts"]) * 1e-6 + offset,
                                   (float(e["ts"]) + float(e.get("dur", 0))) * 1e-6 + offset)
                       for e in events]

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


def union(intervals) -> List[Tuple[float, float]]:
    """Merged, sorted, non-overlapping intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, t0: float, t1: float) -> List[Tuple[float, float]]:
    return [(max(s, t0), min(e, t1)) for s, e in intervals if e > t0 and s < t1]


def gaps(busy, t0: float, t1: float) -> List[Tuple[float, float]]:
    """The idle intervals of [t0, t1] between the merged busy ones."""
    out, at = [], t0
    for s, e in union(clip(busy, t0, t1)):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < t1:
        out.append((at, t1))
    return out


@dataclasses.dataclass
class Reading:
    """What a metric reader reads: the spans and counters, the device slice,
    and the cell's facts (FLOPs per image, images a step, steps and
    requests in the window and in the slice)."""

    spans: Spans
    slice: Optional[DeviceSlice]
    facts: Dict[str, float]

    def device_events(self, cats=DEVICE_CATS) -> List[DeviceEvent]:
        if self.slice is None:
            return []
        t0, t1 = self.slice.t0, self.slice.t1
        return [e for e in self.slice.events if e.cat in cats and e.end > t0 and e.start < t1]

    def busy_s(self, cats=DEVICE_CATS) -> float:
        t0, t1 = self.slice.t0, self.slice.t1
        return sum(e - s for s, e in union(clip(
            [(ev.start, ev.end) for ev in self.device_events(cats)], t0, t1)))

    def kernel_s(self, kernel: str) -> Tuple[float, int]:
        """(seconds of `kernel`'s device functions in the slice, the calls
        they make up, counted by its once-a-call function)."""
        names, main = KERNEL_NAMES[kernel]
        evs = [e for e in self.device_events(("kernel",))
               if any(e.name.startswith(n) or n in e.name for n in names)]
        calls = sum(1 for e in evs if main in e.name) / MAIN_PER_CALL[kernel]
        return sum(e.end - e.start for e in evs), calls

    def roofline_pct(self, kernel: str) -> Optional[float]:
        """Sum of the recorded calls' bounds over the kernel's device time,
        the bounds scaled to the calls the trace holds; None without both."""
        from perfbench import counts

        if self.slice is None:
            return None
        t0, t1 = self.slice.t0, self.slice.t1
        calls = [counts.bound_s(f, b)[0] for k, t, f, b in self.spans.launches
                 if k == kernel and t0 <= t < t1]
        seconds, seen = self.kernel_s(kernel)
        if not calls or not seen or seconds <= 0:
            return None
        return counts.percent(sum(calls) / len(calls) * seen, seconds)

    def label_at(self, t: float) -> str:
        """The innermost benchmark span open on the host at time t (the
        latest started, in any thread), or 'no span'."""
        best = None
        for name, _, s, e in self.spans.items:
            if s <= t < e and (best is None or s > best[1]):
                best = (name, s)
        return best[0] if best else "no span"

    def breakdown(self) -> dict:
        if self.slice is None:
            return {}
        by_name = collections.Counter()
        for e in self.device_events():
            by_name[e.name] += e.end - e.start
        by_label = collections.Counter()
        busy = [(e.start, e.end) for e in self.device_events()]
        for s, e in gaps(busy, self.slice.t0, self.slice.t1):
            by_label[self.label_at(0.5 * (s + e))] += e - s
        return {"device_ops": [[n, v] for n, v in by_name.most_common(10)],
                "idle_gaps": [[n, v] for n, v in by_label.most_common(10)]}
