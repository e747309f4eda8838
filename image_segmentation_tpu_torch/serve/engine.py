"""Inference engine: a model registry over eval-mode forwards, one device.

Counterpart of image_segmentation_tpu/serve/engine.py (`quantize_uint8`,
`make_serving_forward`, `stage_request`, `unstage_result`, and
`InferenceEngine.register` / `available` / `segment`). A request runs:
host resize+pad → device forward → host inverse geometry → argmax →
colourised mask. With `fast_transfer` the staged image crosses to the
device as uint8 and the scores come back as bfloat16 (the input is 8-bit
at the source), otherwise both cross as float32.

Single-device only; the mesh, AOT artifacts, micro-batching and the
composed prompt path come with later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from image_segmentation_tpu_torch.data.labels import COLOR_MAP, colorize_mask
from image_segmentation_tpu_torch.ops import geometry as G

SEG_CLASS_NAMES = ("background", "cat", "dog", "boundary")


def quantize_uint8(arr: np.ndarray) -> np.ndarray:
    """THE uint8 quantisation of a [0, 1] float staging array."""
    return np.clip(np.round(arr * 255.0), 0, 255).astype(np.uint8)


def make_serving_forward(model: torch.nn.Module, device,
                         fast_transfer: bool = True) -> Callable:
    """host (N, T, T, C) uint8 or float32 → host (N, T, T, classes) float32.

    uint8 inputs decode to [0, 1] float32 on the device; the scores cross
    back as bfloat16 under fast_transfer, else float32."""
    device = torch.device(device)

    @torch.inference_mode()
    def fwd(x: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(np.ascontiguousarray(x)).to(device, non_blocking=True)
        t = t.float() / 255.0 if t.dtype == torch.uint8 else t.float()
        out = model(t)
        out = out.to(torch.bfloat16) if fast_transfer else out.float()
        return out.cpu().float().numpy()

    return fwd


def _pack_transfer(arr: np.ndarray, fast_transfer: bool) -> np.ndarray:
    return quantize_uint8(arr) if fast_transfer else arr.astype(np.float32)


def stage_request(image: np.ndarray, target_size: int, fast_transfer: bool):
    """Resize+pad `image` to the model's target and pack it for transfer.
    Returns ((T, T, 3) array, meta)."""
    staged, meta = G.resize_with_padding_np(
        image.astype(np.float32), target_size, method="linear", antialias=True)
    return _pack_transfer(staged, fast_transfer), meta


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


@dataclasses.dataclass
class ModelEntry:
    name: str
    forward: Callable  # host (1, T, T, 3) → host (1, T, T, classes) float32
    target_size: int
    class_names: tuple


class InferenceEngine:
    def __init__(self, device="cpu", fast_transfer: bool = True):
        self.device = torch.device(device)
        self.fast_transfer = fast_transfer
        self.models: Dict[str, ModelEntry] = {}

    def register(self, name: str, model: torch.nn.Module, target_size: int,
                 class_names: Optional[tuple] = None) -> None:
        """Register an eval-mode model (weights already on the engine's
        device) under `name`."""
        model.eval()
        self.models[name] = ModelEntry(
            name=name,
            forward=make_serving_forward(model, self.device, self.fast_transfer),
            target_size=target_size,
            class_names=tuple(class_names or SEG_CLASS_NAMES),
        )

    def available(self):
        return sorted(self.models.keys())

    def segment(self, image: np.ndarray, model_name: str) -> dict:
        """image: (H, W, 3) float in [0, 1]. Returns 'mask' (H, W) uint8
        class ids, 'color_mask' (H, W, 3) uint8 and 'class_names'."""
        if model_name not in self.models:
            raise KeyError(
                f"unknown model {model_name!r}; available: {self.available()}")
        entry = self.models[model_name]
        staged, meta = stage_request(image, entry.target_size, self.fast_transfer)
        scores = entry.forward(staged[None])[0]
        return unstage_result(scores, meta, entry)
