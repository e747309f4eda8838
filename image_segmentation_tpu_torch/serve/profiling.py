"""Where the time goes when the port serves the four families.

Builds the four families at full width in one engine (seeded random
weights; on CUDA bf16 with the hand-written kernels), the prompt family
composed, as `chip_smoke.py` phase 7 does, and reads the serving layers'
metrics on a mixed load: requests round-robin over the families, a
distinct image each, a fixed box prompt for the prompt family.

  * host split of one request per family, one thread: staging, dispatch
    (the forward's enqueue, no synchronisation), fetch (waiting for the
    device and copying back), unstaging; medians in ms;
  * launches per request per family, under torch.profiler: kernel
    launches and copies the host issues, and the device time they take;
  * requests/s of the mixed load, served directly (`segment()`) and
    through a `BatchingEngine`, from one client and from many;
  * under torch.profiler, the batched load from many clients: device
    kernel and copy time against wall time (the device busy share), and
    the largest device items.

Each load runs REQUESTS requests, twice, from one client and from
CLIENTS clients. Run on a card (it refuses to run without one):
    python -m image_segmentation_tpu_torch.serve.profiling
Every line it prints names the card and its power limit.
"""
from __future__ import annotations

import concurrent.futures
import statistics
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from image_segmentation_tpu_torch.config import (
    AUTOENCODER,
    CLIPUNET,
    PROMPT,
    UNET_NOAUG,
    build_model,
)
from image_segmentation_tpu_torch.serve.app import register_families
from image_segmentation_tpu_torch.serve.batching import BatchingEngine
from image_segmentation_tpu_torch.serve.engine import (
    InferenceEngine,
    stage_request,
    unstage_result,
)
from image_segmentation_tpu_torch.serve.render import render_bbox

IMAGE_HW = (300, 400)
BOX = {"x": 150, "y": 100, "width": 120, "height": 90}
REQUESTS, CLIENTS, REPEATS = 64, 16, 2


def full_width_specs(device, seed: int = 0):
    """(name, model, target_size, needs_prompt) of the four families at
    their configs' full widths, each seeded from `seed`."""
    for name, cfg, needs_prompt in (("unet", UNET_NOAUG, False),
                                    ("autoencoder", AUTOENCODER, False),
                                    ("clip", CLIPUNET, False), ("prompt_model", PROMPT, True)):
        model = build_model(cfg, device, torch.Generator().manual_seed(seed))
        yield name, model, cfg.target_size, needs_prompt


class MixedLoad:
    """Request i goes to family i mod 4, with image i; the prompt family
    gets the fixed box. `take` hands out each request once, so no image is
    sent twice and the prompt family's score cache stays cold, as under
    uploads from many users."""

    def __init__(self, names, n_images: int, seed: int = 0):
        self.names = list(names)
        rng = np.random.default_rng(seed)
        self.images = rng.uniform(0, 1, (n_images, *IMAGE_HW, 3)).astype(np.float32)
        self.box = render_bbox(BOX, IMAGE_HW)
        self._next = 0

    def take(self, n: int) -> range:
        """The next n request indices."""
        start, self._next = self._next, self._next + n
        if self._next > len(self.images):
            raise ValueError(f"the load holds {len(self.images)} images; {self._next} taken")
        return range(start, self._next)

    def request(self, i: int):
        """(image, family, prompt heatmap or None) of request i."""
        name = self.names[i % len(self.names)]
        return self.images[i], name, self.box if name == "prompt_model" else None

    def staged(self, eng: InferenceEngine, i: int):
        """Request i staged for its family: (family, inputs, meta)."""
        image, name, prompt = self.request(i)
        return (name, *stage_request(image, eng.models[name], prompt, eng.fast_transfer))


def host_split(eng: InferenceEngine, load: MixedLoad, n: int = 10, skip: int = 2) -> dict:
    """name → median ms of (stage, dispatch, fetch, unstage) over the
    family's requests after the first `skip` of n, one at a time on this
    thread."""
    times = {name: [] for name in load.names}
    for i in load.take(len(load.names) * n):
        t0 = time.perf_counter()
        name, inputs, meta = load.staged(eng, i)
        t1 = time.perf_counter()
        scores, ready = eng.models[name].dispatch(*(a[None] for a in inputs))
        t2 = time.perf_counter()
        host = eng.fetch(scores, ready)
        t3 = time.perf_counter()
        unstage_result(host[0], meta, eng.models[name])
        times[name].append((t1 - t0, t2 - t1, t3 - t2, time.perf_counter() - t3))
    return {name: tuple(1e3 * statistics.median(col) for col in zip(*t[skip:]))
            for name, t in times.items()}


def requests_per_s(segment, load: MixedLoad, n_requests: int, clients: int) -> float:
    """Requests/s of the load's next `n_requests` requests sent through
    `segment(image, name, prompt)` by `clients` threads."""
    one = lambda i: segment(*load.request(i))
    indices = load.take(n_requests)
    t = time.perf_counter()
    if clients == 1:
        for i in indices:
            one(i)
    else:
        with concurrent.futures.ThreadPoolExecutor(clients) as ex:
            list(ex.map(one, indices))
    return n_requests / (time.perf_counter() - t)


def _device_rows(prof):
    return [e for e in prof.key_averages() if e.device_type.name == "CUDA"]


def launches_per_request(eng: InferenceEngine, load: MixedLoad, n: int = 4) -> dict:
    """name → (kernel launches, copies, device ms) per request of the
    device half (dispatch and fetch), one request at a time, staged
    beforehand, under torch.profiler."""
    staged = {name: [] for name in load.names}
    for i in load.take(len(load.names) * n):
        name, inputs, _ = load.staged(eng, i)
        staged[name].append(inputs)
    out = {}
    for name, requests in staged.items():
        entry = eng.models[name]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for inputs in requests:
                eng.fetch(*entry.dispatch(*(a[None] for a in inputs)))
        rows = prof.key_averages()
        count = lambda word: sum(e.count for e in rows if e.key.startswith("cu") and word in e.key)
        device_ms = sum(e.self_device_time_total for e in _device_rows(prof)) / 1e3
        out[name] = (count("LaunchKernel") / n, count("Memcpy") / n, device_ms / n)
    return out


def device_busy(be: BatchingEngine, load: MixedLoad, n_requests: int, clients: int,
                top: int = 8):
    """The batched load under torch.profiler: (requests/s, wall ms, device
    kernel and copy ms, the `top` largest device items as (name, ms, count))."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        rps = requests_per_s(be.segment, load, n_requests, clients)
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = sorted(_device_rows(prof), key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3
    items = [(e.key, e.self_device_time_total / 1e3, e.count) for e in rows[:top]]
    return rps, wall_ms, device_ms, items


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profiling reads the device: no CUDA device is available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)

    eng = InferenceEngine("cuda")
    register_families(eng, full_width_specs("cuda"))
    # every request its own image: host split and launches take 14 a family
    load = MixedLoad(eng.available(), 4 * 14 + REQUESTS * (4 * REPEATS + 1))
    be = BatchingEngine(eng, max_batch=8, max_wait_ms=3)
    try:
        be.warmup()
        for name, (st, dp, fe, un) in host_split(eng, load).items():
            print(f"[host] {name}: stage {st:.3f} ms, dispatch (enqueue) {dp:.3f} ms, "
                  f"fetch (wait + copy) {fe:.3f} ms, unstage {un:.3f} ms, median ({card})")
        for name, (k, c, dev) in launches_per_request(eng, load).items():
            print(f"[launches] {name}: {k:.1f} kernel launches, {c:.1f} copies, "
                  f"{dev:.3f} ms of device time per request ({card})")
        for rep in range(REPEATS):
            for label, seg, clients in (("direct", eng.segment, 1),
                                        ("direct", eng.segment, CLIENTS),
                                        ("batched", be.segment, 1),
                                        ("batched", be.segment, CLIENTS)):
                rps = requests_per_s(seg, load, REQUESTS, clients)
                print(f"[load] run {rep}: {label}, {clients} client(s), {REQUESTS} "
                      f"requests: {rps:.3f} requests/s ({card})")
        rps, wall, dev, items = device_busy(be, load, REQUESTS, CLIENTS)
        print(f"[busy] batched, {CLIENTS} clients under torch.profiler: {rps:.3f} "
              f"requests/s; device kernel + copy time {dev:.1f} ms in {wall:.1f} ms of wall, "
              f"busy {100 * dev / wall:.1f}% ({card})")
        for key, ms, count in items:
            print(f"[busy]   {key[:72]:72s} {ms:9.3f} ms x{count}")
    finally:
        be.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
