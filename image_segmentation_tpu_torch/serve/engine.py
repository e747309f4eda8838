"""Inference engine: a model registry over eval-mode forwards, one device.

Counterpart of image_segmentation_tpu/serve/engine.py (`quantize_uint8`,
`stage_request`, `unstage_result`, `_ScoreCache`, `InferenceEngine.
register` / `register_prompt_composed` / `available` / `segment`). A
request runs: host resize+pad (and the prompt heatmap for prompt models)
→ device forward → host inverse geometry → argmax → colourised mask. With
`fast_transfer` the staged inputs cross to the device as uint8 and the
scores come back as bfloat16 (the input is 8-bit at the source),
otherwise both cross as float32.

The device half is split in two, so that `serve/batching.py` can overlap
one batch's copy back with the next batch's forward:
  * `ModelEntry.dispatch(*host arrays)` copies the inputs in, runs the
    forward and returns `(scores, ready)`: the device scores and, on CUDA,
    an event recorded after the forward. It does not synchronise.
  * `InferenceEngine.fetch(scores, ready)` copies them out as float32.
On CUDA the engine owns one compute stream: every dispatch runs on it,
whatever thread calls it, so weights, activations and cached prompt
scores all live on one stream. Inputs cross from pinned memory with
`non_blocking` copies on that stream; a fetch copies into pinned memory
on a copy stream that waits on the forward's event. The engine serves on
the card unless built with device="cpu", where the same code runs
without streams.

`register_exported` serves a program of serve/export.py in place of a
live model. Single-device only; the mesh comes with a later slice.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from image_segmentation_tpu_torch.data.labels import COLOR_MAP, colorize_mask
from image_segmentation_tpu_torch.ops import geometry as G

SEG_CLASS_NAMES = ("background", "cat", "dog", "boundary")
PROMPT_CLASS_NAMES = ("deactivated", "background", "cat", "dog")


def quantize_uint8(arr: np.ndarray) -> np.ndarray:
    """THE uint8 quantisation of a [0, 1] float staging array."""
    return np.clip(np.round(arr * 255.0), 0, 255).astype(np.uint8)


def _pack_transfer(arr: np.ndarray, fast_transfer: bool) -> np.ndarray:
    return quantize_uint8(arr) if fast_transfer else arr.astype(np.float32)


def stage_request(image: np.ndarray, entry: "ModelEntry",
                  prompt_mask: Optional[np.ndarray], fast_transfer: bool):
    """Resize+pad `image` (and, for a prompt model, the prompt heatmap,
    zeros when there is none) to the model's target and pack them for
    transfer. Returns (tuple of (T, T, C) arrays, meta)."""
    t = entry.target_size
    staged, meta = G.resize_with_padding_np(
        image.astype(np.float32), t, method="linear", antialias=True)
    inputs = [_pack_transfer(staged, fast_transfer)]
    if entry.needs_prompt:
        pm = prompt_mask if prompt_mask is not None else np.zeros(image.shape[:2], np.float32)
        pm_staged, _ = G.resize_with_padding_np(
            pm[..., None].astype(np.float32), t, method="linear", antialias=True)
        inputs.append(_pack_transfer(pm_staged, fast_transfer))
    return tuple(inputs), meta


def unstage_result(scores: np.ndarray, meta: dict, entry: "ModelEntry") -> dict:
    """Validate the score shape, invert the geometry to the original
    resolution, argmax and colourise."""
    t = entry.target_size
    if scores.shape[:2] != (t, t):
        raise ValueError(
            f"model {entry.name!r} emitted {scores.shape[:2]} scores for "
            f"target_size {t} — registration mismatch")
    restored = G.invert_resize_padding_np(scores, meta, method="linear")
    mask = restored.argmax(axis=-1).astype(np.uint8)
    return {
        "mask": mask,
        "color_mask": colorize_mask(mask, COLOR_MAP),
        "class_names": list(entry.class_names),
    }


class _ScoreCache:
    """Thread-safe LRU of the prompt model's clip-branch logits, kept on
    the device and keyed by the staged image bytes. An interactive session
    (one image, many clicks) runs the clip branch once and the selection
    head per click."""

    def __init__(self, capacity: int = 16):
        self._d: "collections.OrderedDict" = collections.OrderedDict()
        self._lock = threading.Lock()
        self.capacity = capacity
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(arr: np.ndarray):
        return (arr.shape, str(arr.dtype),
                hashlib.blake2b(arr.tobytes(), digest_size=16).digest())

    def get(self, key) -> Optional[torch.Tensor]:
        with self._lock:
            v = self._d.get(key)
            if v is None:
                self.misses += 1
            else:
                self._d.move_to_end(key)
                self.hits += 1
            return v

    def put(self, key, value: torch.Tensor) -> None:
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)


# (device scores, event recorded after the forward on CUDA, else None)
Dispatched = Tuple[torch.Tensor, Optional["torch.cuda.Event"]]


@dataclasses.dataclass
class ModelEntry:
    name: str
    dispatch: Callable[..., Dispatched]  # host (N, T, T, C) arrays → device scores
    target_size: int
    class_names: tuple
    needs_prompt: bool = False
    score_cache: Optional[_ScoreCache] = None


class InferenceEngine:
    """Serves on `device`, the card unless the caller asks for the CPU;
    without a card the default raises rather than falling back."""

    def __init__(self, device="cuda", fast_transfer: bool = True):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"InferenceEngine(device={str(self.device)!r}): no CUDA device "
                               f"is available (pass device='cpu' to serve on the CPU)")
        self.fast_transfer = fast_transfer
        self.models: Dict[str, ModelEntry] = {}
        cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None

    # -- device half --------------------------------------------------------

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        """A staged host array → the device, in its own dtype. Call on the
        compute stream."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.stream is not None:
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        """A staged host array → float [0, 1] on the device (uint8 decodes
        there). Call on the compute stream."""
        t = self._upload(x)
        return t.float() / 255.0 if t.dtype == torch.uint8 else t.float()

    def _on_device(self, forward: Callable[[], torch.Tensor]) -> Dispatched:
        """Run `forward` on the compute stream in inference mode; cast its
        scores for transfer and record the event a fetch waits on."""
        stream = (torch.cuda.stream(self.stream) if self.stream is not None
                  else contextlib.nullcontext())
        with torch.inference_mode(), stream:
            scores = forward()
            scores = scores.to(torch.bfloat16) if self.fast_transfer else scores.float()
            ready = None
            if self.stream is not None:
                ready = torch.cuda.Event()
                ready.record(self.stream)
        return scores, ready

    def fetch(self, scores: torch.Tensor, ready) -> np.ndarray:
        """Device scores → host float32. On CUDA the copy runs on the copy
        stream once `ready` has fired, into pinned memory."""
        if self._copy_stream is None:
            return scores.float().numpy()
        host = torch.empty(scores.shape, dtype=scores.dtype, pin_memory=True)
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(ready)
            # the allocator must not hand these bytes to the compute stream
            # before the copy is done
            scores.record_stream(self._copy_stream)
            host.copy_(scores, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        done.synchronize()
        return host.float().numpy()

    # -- registry ----------------------------------------------------------

    def register(self, name: str, model: torch.nn.Module, target_size: int) -> None:
        """Register an eval-mode segmentation model (weights already on the
        engine's device) under `name`. Prompt models go through
        `register_prompt_composed`."""
        model.eval()

        def dispatch(x: np.ndarray) -> Dispatched:
            return self._on_device(lambda: model(self._to_device(x)))

        self.models[name] = ModelEntry(
            name=name, dispatch=dispatch, target_size=target_size,
            class_names=SEG_CLASS_NAMES)

    def register_prompt_composed(self, name: str, model: torch.nn.Module,
                                 target_size: int) -> None:
        """Register a PromptModel whose clip branch runs once per staged
        image and whose selection head runs per request.

        The JAX engine shares the clip family's compiled program, called
        with the prompt model's clip weights (`via=`, engine.py:301-391),
        and checks by parameter shapes alone that the two architectures
        agree (engine.py:357). PyTorch has no compiled program to share:
        the branch here is the prompt model's own `clip` submodule, so that
        check is moot. Its float32 logits stay on the device in a
        `_ScoreCache` keyed by the staged image bytes, and each request
        hands the cached tensor straight to `PromptModel.head` (the mask
        UNet and the float32 algebra), with no host round trip. The cache
        holds float32 logits under `fast_transfer` too: the JAX composed
        path softmaxes its bf16-cast transfer scores (engine.py:142), which
        the monolithic path does not."""
        model.eval()
        cache = _ScoreCache()

        def dispatch(x: np.ndarray, heatmap: np.ndarray) -> Dispatched:
            def forward():
                key = _ScoreCache.key(x)
                xd = self._to_device(x)
                logits = cache.get(key)
                if logits is None:
                    logits = model.clip(xd)
                    cache.put(key, logits)
                return model.head(xd, self._to_device(heatmap), logits)

            return self._on_device(forward)

        self.models[name] = ModelEntry(
            name=name, dispatch=dispatch, target_size=target_size,
            class_names=PROMPT_CLASS_NAMES, needs_prompt=True, score_cache=cache)

    def register_exported(self, path: str, name: Optional[str] = None) -> str:
        """Register a program of serve/export.py (JAX engine.py:393-419):
        the loaded program is the whole device forward, staged arrays in
        (its loader adapts uint8 and float to the contract it was exported
        with) and scores out, so no model code or checkpoint is involved,
        and its symbolic batch serves single requests and BatchingEngine
        buckets alike. The program must have been exported for this
        engine's device type. A prompt program is monolithic: the clip
        branch runs on every request (there is no score cache). Returns the
        registered name."""
        from image_segmentation_tpu_torch.serve.export import load_exported

        call, meta = load_exported(path, self.device)
        name = name or meta["name"]
        if name in self.models:
            print(f"[serve] note: exported program {path} replaces the registered "
                  f"model {name!r}")

        def dispatch(*xs: np.ndarray) -> Dispatched:
            return self._on_device(lambda: call(*(self._upload(x) for x in xs)))

        self.models[name] = ModelEntry(
            name=name, dispatch=dispatch, target_size=int(meta["target_size"]),
            class_names=tuple(meta["class_names"]), needs_prompt=bool(meta["needs_prompt"]))
        return name

    def available(self):
        return sorted(self.models.keys())

    def forward(self, model_name: str, *inputs: np.ndarray) -> np.ndarray:
        """Staged host arrays (N, T, T, C) → host float32 scores (N, T, T, classes)."""
        return self.fetch(*self.models[model_name].dispatch(*inputs))

    def segment(self, image: np.ndarray, model_name: str,
                prompt_mask: Optional[np.ndarray] = None) -> dict:
        """image: (H, W, 3) float in [0, 1]; prompt_mask: (H, W) float
        heatmap for prompt models (zeros when None). Returns 'mask' (H, W)
        uint8 class ids, 'color_mask' (H, W, 3) uint8 and 'class_names'."""
        if model_name not in self.models:
            raise KeyError(
                f"unknown model {model_name!r}; available: {self.available()}")
        entry = self.models[model_name]
        inputs, meta = stage_request(image, entry, prompt_mask, self.fast_transfer)
        scores = self.forward(model_name, *(x[None] for x in inputs))[0]
        return unstage_result(scores, meta, entry)
