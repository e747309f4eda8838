"""Request micro-batching for serving.

Counterpart of image_segmentation_tpu/serve/batching.py, with the same
policy:
  * one FIFO queue per model, served round-robin by one worker thread;
  * a lone request dispatches at once; the window of `max_wait_ms` for
    stragglers applies only when more than one request is queued;
  * a batch is padded to the next power of two, capped at `max_batch`,
    by repeating its last item, and the padding is sliced off on the
    device before the copy back;
  * host staging (resize+pad) and unstaging (inverse geometry, argmax,
    colourise) run in the caller's thread; only the device half is
    serialised;
  * the worker hands each dispatched batch's fetch to a pool of 2
    threads and dispatches the next batch at once; `max_inflight` bounds
    the batches dispatched but not yet fetched.

The device half is the engine's (`ModelEntry.dispatch`,
`InferenceEngine.fetch`): on CUDA every dispatch runs on the engine's
compute stream, and each fetch waits on its own batch's event on a copy
stream, so one batch's copy back overlaps the next batch's forward.

Unlike the JAX code (batching.py:164), the fetch pool's `submit` sits
inside the `try`: a failed submit releases its `max_inflight` slot and
fails that batch's requests, and the worker goes on serving.
"""
from __future__ import annotations

import concurrent.futures
import threading
import time
from collections import defaultdict, deque
from typing import Dict, Optional

import numpy as np

from image_segmentation_tpu_torch.serve.engine import (
    InferenceEngine,
    stage_request,
    unstage_result,
)


class _Pending:
    __slots__ = ("inputs", "event", "scores", "error")

    def __init__(self, inputs):
        self.inputs = inputs  # tuple of (T, T, C) host arrays
        self.event = threading.Event()
        self.scores = None
        self.error = None


def _buckets(max_batch: int):
    """The power-of-two batch sizes below max_batch, then max_batch."""
    b = 1
    while b < max_batch:
        yield b
        b *= 2
    yield max_batch


class BatchingEngine:
    """Wraps an InferenceEngine with per-model request batching.
    Drop-in `segment()`; `close()` stops the worker."""

    def __init__(self, engine: InferenceEngine, max_batch: int = 8,
                 max_wait_ms: float = 5.0, max_inflight: int = 3):
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self._queues: Dict[str, deque] = defaultdict(deque)
        self._cv = threading.Condition()
        self._closed = False
        self._last_served: Optional[str] = None
        self._fetch_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="serve-fetch")
        self._inflight = threading.Semaphore(max_inflight)
        self._worker = threading.Thread(target=self._run, name="serve-batch", daemon=True)
        self._worker.start()

    # -- worker -------------------------------------------------------------

    def _run(self):
        while True:
            with self._cv:
                while not self._closed and not any(self._queues.values()):
                    self._cv.wait()
                if self._closed:
                    self._drain_locked()
                    return
                # round-robin: resuming at the first queue every time would
                # starve the other models under load on that one
                keys = list(self._queues.keys())
                if self._last_served in keys:
                    i = keys.index(self._last_served) + 1
                    keys = keys[i:] + keys[:i]
                name = next(m for m in keys if self._queues[m])
                self._last_served = name
                q = self._queues[name]
                if len(q) > 1:
                    # concurrency seen: give stragglers up to the window
                    deadline = time.monotonic() + self.max_wait_s
                    while len(q) < self.max_batch and not self._closed:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cv.wait(timeout=remaining)
                batch = [q.popleft() for _ in range(min(len(q), self.max_batch))]
            self._process(name, batch)

    def _drain_locked(self):
        """Fail every queued request on shutdown. Caller holds _cv."""
        for q in self._queues.values():
            while q:
                p = q.popleft()
                p.error = RuntimeError("BatchingEngine closed")
                p.event.set()

    def _process(self, name: str, batch):
        acquired = False
        try:
            entry = self.engine.models[name]
            bucket = next(b for b in _buckets(self.max_batch) if b >= len(batch))
            stacked = []
            for i in range(len(batch[0].inputs)):
                arrs = [p.inputs[i] for p in batch]
                arrs += [arrs[-1]] * (bucket - len(arrs))
                stacked.append(np.stack(arrs))
            self._inflight.acquire()
            acquired = True
            scores, ready = entry.dispatch(*stacked)
            self._fetch_pool.submit(self._fetch, scores[:len(batch)], ready, batch)
        except Exception as e:  # this batch fails; the worker serves the next
            if acquired:
                self._inflight.release()
            for p in batch:
                p.error = e
                p.event.set()

    def _fetch(self, scores, ready, batch):
        try:
            host = self.engine.fetch(scores, ready)
            for j, p in enumerate(batch):
                p.scores = host[j]
        except Exception as e:
            for p in batch:
                p.error = e
        finally:
            self._inflight.release()
            for p in batch:
                p.event.set()

    # -- API ----------------------------------------------------------------

    def warmup(self) -> None:
        """Run every bucket size of every registered model once, so no
        live request pays for first-use set-up (cuDNN plans, the
        allocator's pools, kernel builds)."""
        dt = np.uint8 if self.engine.fast_transfer else np.float32
        for entry in self.engine.models.values():
            t = entry.target_size
            for b in _buckets(self.max_batch):
                inputs = [np.zeros((b, t, t, 3), dt)]
                if entry.needs_prompt:
                    inputs.append(np.zeros((b, t, t, 1), dt))
                self.engine.fetch(*entry.dispatch(*inputs))

    def available(self):
        return self.engine.available()

    @property
    def models(self):
        return self.engine.models

    def segment(self, image: np.ndarray, model_name: str,
                prompt_mask: Optional[np.ndarray] = None, timeout: float = 60.0) -> dict:
        if model_name not in self.engine.models:
            raise KeyError(
                f"unknown model {model_name!r}; available: {self.available()}")
        entry = self.engine.models[model_name]
        inputs, meta = stage_request(image, entry, prompt_mask, self.engine.fast_transfer)
        pending = _Pending(inputs)
        with self._cv:
            if self._closed:
                raise RuntimeError("BatchingEngine is closed")
            self._queues[model_name].append(pending)
            self._cv.notify_all()
        if not pending.event.wait(timeout):
            raise TimeoutError("inference worker timed out")
        if pending.error is not None:
            raise pending.error
        return unstage_result(pending.scores, meta, entry)

    def close(self):
        """Stop the worker, fail what is queued and finish what is in
        flight. Safe to call twice."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout=5)
        self._fetch_pool.shutdown(wait=True)
