"""An open loop of segmentation requests: photos arrive on a Poisson
schedule at a fixed rate and each is sent to `BatchingEngine.segment` on
its own thread (at most `clients` at once, as many server threads).
The end-to-end numbers are the median and the 95th percentile of every
request's latency, at a rate below the knee (the highest rate served
without a growing backlog, found by `sweep`).

The schedule's gaps and the photos' sizes are one fixed multiset drawn
from the mix's `base_seed`; the run's seed orders them and draws the
pixels, so every seed offers the same work in another order. A photo is
seeded 8-bit values over 255, as the HTTP app hands a decoded upload to
the engine. A request is timed from when it was due until its mask is
back; the generator's own lateness is recorded beside it. Requests still
in flight when the window closes are waited for (a minute at most) and
count with their whole latency; one that raises is failed and misses
every limit.

The check takes a sample of the requests, drawn from the seed, with the
largest photo in it, and holds what the served path produced for each
against the plain reference (`perfbench/reference/`, float32, TF32 off)
on the same photo: the staged canvas's scores as they came back from the
card (`score_err`: the largest difference over the reference's largest
score), and the served mask at the photo's size (`mask_off_share`, in
`compare_sample`). The reference stages, runs and unstages the photo
itself.

Traffic keys: rate_per_s, base_seed, sizes (a size mix below),
max_batch, max_wait_ms, clients, omp_threads (the host's OpenMP threads a
process, set by `run.py` before torch loads), check_requests,
warmup_requests, trace_from, trace_seconds.
"""
from __future__ import annotations

import concurrent.futures
import gc
import math
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import harness
from perfbench.reference import geometry as ref_geometry
from perfbench.reference import ops as ref_ops
from perfbench.tracing import DeviceSlice, Reading, Spans, wrap_kernel_launches

FAULTS = ("altered_answer",)
WAIT_AFTER_CLOSE_S = 60.0
MODEL_NAME = "model"


SIZE_MIXES = ("oxford_iiit_pet",)


def pet_sizes(n: int, rng: np.random.Generator, mix: dict) -> List[tuple]:
    """(h, w) of n photos of the mix's `mix`, the one size mix there is:
    Oxford-IIIT Pet-like (69% at the long side 500 and the short 250..400
    in either orientation, 30% at 150..500 each side, 1% at 600..1000).
    `scale` multiplies each range; it is a seam for the CPU tests, and no
    traffic file sets it."""
    if mix.get("mix") not in SIZE_MIXES:
        raise ValueError(f"size mix {mix.get('mix')!r}; known: {SIZE_MIXES}")
    k = mix.get("scale", 1.0)
    r = lambda a, b: int(rng.integers(max(1, int(a * k)), max(2, int(b * k))))  # noqa: E731
    out = []
    for _ in range(n):
        u = rng.uniform()
        if u < 0.01:
            h, w = r(600, 1000), r(600, 1000)
        elif u < 0.70:
            long, short = max(1, int(500 * k)), r(250, 400)
            h, w = (long, short) if rng.uniform() < 0.5 else (short, long)
        else:
            h, w = r(150, 500), r(150, 500)
        out.append((h, w))
    return out


class Schedule:
    """The run's requests: due times (s from the window's start), sizes and
    8-bit pixels."""

    def __init__(self, traffic: dict, seconds: float, seed: int, device):
        rate = float(traffic["rate_per_s"])
        n = max(1, int(round(rate * seconds)))
        base = np.random.default_rng(traffic["base_seed"])
        gaps = base.exponential(1.0 / rate, n)
        gaps *= seconds / gaps.sum()
        sizes = pet_sizes(n, base, traffic.get("sizes", {}))
        order = harness.np_rng(seed, harness.ORDER)
        self.due = np.cumsum(gaps[order.permutation(n)])
        self.sizes = [sizes[i] for i in order.permutation(n)]
        counts = [h * w * 3 for h, w in self.sizes]
        g = harness.torch_generator(seed, harness.DATA, device)
        flat = torch.randint(0, 256, (sum(counts),), generator=g, device=device,
                             dtype=torch.uint8).cpu().numpy()
        offs = np.concatenate([[0], np.cumsum(counts)])
        self.pixels = [flat[offs[i]:offs[i + 1]].reshape(h, w, 3)
                       for i, (h, w) in enumerate(self.sizes)]

    def __len__(self):
        return len(self.due)

    def photo(self, i: int) -> np.ndarray:
        """Request i's photo as the app decodes it: float32 in [0, 1]."""
        return self.pixels[i].astype(np.float32) / 255.0

    def sample(self, seed: int, k: int) -> List[int]:
        """k request indices drawn from the seed, the largest photo first."""
        largest = int(np.argmax([h * w for h, w in self.sizes]))
        rest = [i for i in harness.np_rng(seed, harness.SAMPLE).permutation(len(self))
                if i != largest]
        return [largest] + rest[:max(0, k - 1)]


class Served:
    """The engine, its batching front and the benchmark's wrappers: the
    sampled requests' scores as unstaging got them, and with tracing the
    stage / unstage / dispatch / fetch spans and counters."""

    def __init__(self, cell, seed: int, device, spans: Spans, fault: Optional[str]):
        from image_segmentation_tpu_torch.serve import batching
        from image_segmentation_tpu_torch.serve.engine import InferenceEngine

        cfg, tr = cell.cfg, cell.traffic
        self.spans, self.local, self.kept = spans, threading.local(), {}
        self.watch = set()
        weights = harness.make_weights(cell.builder, cfg, seed, device)
        model = harness.build(cell.builder, cfg, device, weights, "port")
        del weights
        self.engine = InferenceEngine(device)
        self.engine.register(MODEL_NAME, model, cfg["image_size"])
        self.batching = batching
        self._stage, self._unstage = batching.stage_request, batching.unstage_result
        batching.stage_request, batching.unstage_result = self.stage, self.unstage
        entry = self.engine.models[MODEL_NAME]
        dispatch, fetch = entry.dispatch, self.engine.fetch

        def counted_dispatch(*xs):
            with spans.span("dispatch"):
                spans.count("dispatch_calls")
                return dispatch(*xs)

        def counted_fetch(scores, ready):
            with spans.span("fetch"):
                host = fetch(scores, ready)
            if fault == "altered_answer":  # the class channels of the batch's first row turn
                host[0] = np.roll(host[0], 1, axis=-1)
            spans.count("rows_fetched", host.shape[0])
            spans.launch("rows", float(host.shape[0]), 0.0)
            return host

        self.restore = lambda: None
        if spans.enabled:
            entry.dispatch = counted_dispatch
            self.restore = wrap_kernel_launches(spans)
        if spans.enabled or fault:
            self.engine.fetch = counted_fetch
        self.front = batching.BatchingEngine(self.engine, max_batch=tr["max_batch"],
                                             max_wait_ms=tr["max_wait_ms"])

    def stage(self, *a, **k):
        with self.spans.span("stage"):
            return self._stage(*a, **k)

    def unstage(self, scores, meta, entry):
        rid = getattr(self.local, "rid", None)
        if rid in self.watch:
            self.kept[rid] = np.array(scores, copy=True)
        with self.spans.span("unstage"):
            return self._unstage(scores, meta, entry)

    def segment(self, rid: int, image: np.ndarray) -> np.ndarray:
        self.local.rid = rid
        with self.spans.span("segment"):
            return self.front.segment(image, MODEL_NAME)["mask"]

    def close(self) -> None:
        self.front.close()
        self.batching.stage_request, self.batching.unstage_result = self._stage, self._unstage
        self.restore()


def _warm(served: Served, cell, seed: int, device) -> None:
    """Every bucket of the batch, then a few requests of the mix's sizes one
    at a time, then a burst of max_batch at once."""
    served.front.warmup()
    tr = cell.traffic
    warm = Schedule(dict(tr, rate_per_s=tr["warmup_requests"]), 1.0, seed + 1, device)
    for i in range(len(warm)):
        served.segment(-1, warm.photo(i))
    with concurrent.futures.ThreadPoolExecutor(tr["max_batch"]) as pool:
        list(pool.map(lambda i: served.segment(-1, warm.photo(i)),
                      range(min(len(warm), tr["max_batch"]))))


def open_loop(served: Served, sched: Schedule, clients: int, trace_at=None):
    """Send every request on its schedule; returns (t0, the done time of
    each request that came back, each one's mask or exception, how late
    each send left against its due time)."""
    done: Dict[int, float] = {}
    results: Dict[int, object] = {}
    late = []

    def send(i, image):
        try:
            results[i] = served.segment(i, image)
        except Exception as e:  # a failed request: counted, never retried
            results[i] = e
        done[i] = time.perf_counter()

    pool = concurrent.futures.ThreadPoolExecutor(clients, thread_name_prefix="client")
    futures = []
    t0 = time.perf_counter() + 0.05
    try:
        for i in range(len(sched)):
            image = sched.photo(i)
            due = t0 + sched.due[i]
            if trace_at is not None:
                trace_at(due - t0)
            while True:
                wait = due - time.perf_counter()
                if wait <= 0:
                    break
                time.sleep(min(wait, 0.01))
            late.append(time.perf_counter() - due)
            futures.append(pool.submit(send, i, image))
        concurrent.futures.wait(futures, timeout=t0 + sched.due[-1] + WAIT_AFTER_CLOSE_S
                                - time.perf_counter())
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
    return t0, done, results, late


def _latencies(sched: Schedule, t0: float, done, results):
    lat, failed = [], 0
    for i in range(len(sched)):
        if i in done and not isinstance(results.get(i), Exception):
            lat.append(done[i] - (t0 + sched.due[i]))
        else:
            failed += 1
            lat.append(WAIT_AFTER_CLOSE_S)
    return np.asarray(lat), failed


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        fault: Optional[str] = None, window: bool = True) -> harness.Outcome:
    cfg, tr = cell.cfg, cell.traffic
    device = torch.device(device)
    cuda = device.type == "cuda"
    spans = Spans(trace)
    phases = {"start": time.perf_counter() - t_start}
    served = Served(cell, seed, device, spans, fault)
    phases["model"] = time.perf_counter() - t_start
    sched = Schedule(tr, seconds, seed, device)
    phases["schedule"] = time.perf_counter() - t_start
    sample = sched.sample(seed, tr["check_requests"])
    served.watch = set(sample)
    dslice = DeviceSlice(device) if trace else None
    try:
        _warm(served, cell, seed, device)
        phases["warm"] = time.perf_counter() - t_start
        if trace:
            dslice.prime()
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        spans.items.clear()
        spans.counters.clear()
        spans.launches.clear()
        setup_s = time.perf_counter() - t_start

        def trace_at(t):
            if t >= tr["trace_from"] * seconds and dslice.t0 is None:
                dslice.start()
            if dslice.t0 is not None and dslice.t1 is None and time.perf_counter() - \
                    dslice.t0 >= tr["trace_seconds"]:
                dslice.stop()

        t0, done, results, late = open_loop(served, sched, tr["clients"],
                                            trace_at if trace else None)
        if trace and dslice.t0 is not None and dslice.t1 is None:
            dslice.stop()
        memory = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    finally:
        served.close()
    if trace:
        dslice.finish()
    lat, failed = _latencies(sched, t0, done, results)
    masks = {i: results[i] for i in sample if isinstance(results.get(i), np.ndarray)}
    scores = dict(served.kept)
    del served
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    close = t0 + sched.due[-1]
    completed = sum(1 for i, t in done.items() if t <= close
                    and not isinstance(results.get(i), Exception))
    outcome = harness.Outcome(
        {"setup_s": setup_s, "serve_p50_ms": 1e3 * harness.percentile(lat, 50),
         "serve_p95_ms": 1e3 * harness.percentile(lat, 95)},
        len(sched), failed, [], memory)
    outcome.detail = {"setup_phases_s": phases, "served_per_s": completed / sched.due[-1],
                      "p50_ms": outcome.e2e["serve_p50_ms"], "p95_ms": outcome.e2e["serve_p95_ms"],
                      "p50_last_over_first_quarter": trend(lat),
                      "generator_late_p95_ms": 1e3 * harness.percentile(late, 95)}
    values = compare_sample(cell, seed, device, sched, sample, scores, masks, outcome.detail)
    outcome.checks = harness.checks_from(values, cfg["limits"].get("serve", {}))
    if trace:
        outcome.reading = Reading(spans, dslice, {
            "requests": len(sched) - failed,
            "forward_flops_per_image": cell.builder.forward_flops(cfg)})
    return outcome


def trend(lat: np.ndarray) -> float:
    """The median latency of the window's last quarter of requests over its
    first quarter's: about 1 where the backlog holds still."""
    q = max(1, len(lat) // 4)
    return float(np.median(lat[-q:]) / np.median(lat[:q]))


def reference_scores(cell, seed: int, device, photos: List[np.ndarray], ops=None,
                     block: int = 8) -> List[np.ndarray]:
    """The reference's canvas scores (T, T, C) for each photo, float64 on
    the host, run `block` photos at a time."""
    cfg = cell.cfg
    out = []
    with ref_ops.fp32_context(), torch.no_grad():
        weights = harness.make_weights(cell.builder, cfg, seed, device)
        model = harness.build(cell.builder, cfg, device, weights, "reference", ops)
        del weights
        for at in range(0, len(photos), block):
            canvases = np.stack([ref_geometry.stage(p.astype(np.float64), cfg["image_size"])
                                 for p in photos[at:at + block]])
            x = torch.from_numpy(canvases).float().to(device)
            out += list(model(x).double().cpu().numpy())
        del model
    return out


def gap_numbers(ref: np.ndarray, scores: np.ndarray, mask: np.ndarray, h: int, w: int):
    """(score_err, the mask's gaps at every pixel) of one request, over the
    reference's largest absolute score."""
    scale = float(np.abs(ref).max())
    restored = ref_geometry.unstage(ref, h, w)
    chosen = np.take_along_axis(restored, mask[..., None].astype(np.int64), -1)[..., 0]
    return float(np.abs(scores - ref).max()) / scale, (restored.max(-1) - chosen) / scale


def compare_sample(cell, seed, device, sched: Schedule, sample, scores, masks,
                   detail: Optional[dict] = None) -> Dict[str, float]:
    """The worst score_err over the sample, and `mask_off_share`: the share
    of the sample's pixels whose served class lies more than twice the
    score_err limit below the reference's best. Unstaging is a convex
    combination of canvas scores, so scores within the limit cannot move a
    pixel that far: a sound run reads 0, and the comparison is exact. The
    widest gap goes into `detail`. A sampled request with no answer reads
    as infinitely wrong."""
    margin = 2.0 * cell.cfg["limits"]["serve"]["score_err"]
    have = [i for i in sample if i in scores and i in masks]
    refs = reference_scores(cell, seed, device, [sched.photo(i) for i in have])
    score_err, off, pixels, widest = 0.0, 0, 0, 0.0
    for i, ref in zip(have, refs):
        h, w = sched.sizes[i]
        err, gaps = gap_numbers(ref, scores[i], masks[i], h, w)
        score_err = max(score_err, err)
        off, pixels = off + int((gaps > margin).sum()), pixels + gaps.size
        widest = max(widest, float(gaps.max()))
    if detail is not None:
        detail["mask_gap_widest"] = widest
    if len(have) < len(sample):
        return {"score_err": math.inf, "mask_off_share": math.inf}
    return {"score_err": score_err, "mask_off_share": off / pixels}


def control(cell, seed: int, device, seconds: float) -> Dict[str, float]:
    """The check's numbers with the reference in float8 in the program's
    place, on the run's sample: its canvas scores and the mask it would
    serve, the argmax of its scores at the photo's size."""
    sched = Schedule(cell.traffic, seconds, seed, device)
    sample = sched.sample(seed, cell.traffic["check_requests"])
    photos = [sched.photo(i) for i in sample]
    low = reference_scores(cell, seed, device, photos, ops=ref_ops.control_ops())
    scores, masks = {}, {}
    for i, s in zip(sample, low):
        h, w = sched.sizes[i]
        scores[i], masks[i] = s, ref_geometry.unstage(s, h, w).argmax(-1)
    detail = {}
    values = compare_sample(cell, seed, device, sched, sample, scores, masks, detail)
    return dict(values, detail=detail)


def sweep(cell, seed: int, rates: List[float], seconds: float, device) -> List[dict]:
    """A short open loop at each rate in one process: offered and completed
    requests/s, the backlog at the close (due but not done), p50 and p95,
    and the p50 of the last quarter of the window over the first's."""
    served = Served(cell, seed, device, Spans(False), None)
    rows = []
    try:
        _warm(served, cell, seed, torch.device(device))
        for k, rate in enumerate(rates):
            sched = Schedule(dict(cell.traffic, rate_per_s=rate), seconds, seed + k, device)
            t0, done, results, _ = open_loop(served, sched, cell.traffic["clients"])
            close = t0 + sched.due[-1]
            lat, failed = _latencies(sched, t0, done, results)
            rows.append({
                "rate_per_s": rate, "requests": len(sched), "failed": failed,
                "completed_per_s": sum(1 for t in done.values() if t <= close) / sched.due[-1],
                "backlog_at_close": sum(1 for i in range(len(sched))
                                        if done.get(i, math.inf) > close),
                "p50_ms": 1e3 * harness.percentile(lat, 50),
                "p95_ms": 1e3 * harness.percentile(lat, 95),
                "late_over_early_p50": trend(lat)})
            print(rows[-1], flush=True)
    finally:
        served.close()
    return rows
