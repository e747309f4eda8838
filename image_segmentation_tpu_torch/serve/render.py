"""Prompt rendering for interactive serving, on the host (numpy, scipy).

Counterpart of image_segmentation_tpu/serve/render.py (reference
segmentation_webapp/app.py:132-184). Each prompt type becomes a float
[0, 1] (H, W) heatmap at the original image's resolution, which the
prompt model takes beside the image:
  * points   — filled circles of radius 20, then a Gaussian blur of
               σ = 5 (`BLUR_RADIUS / 2`), normalised to a maximum of 1;
  * bbox     — a filled rectangle, clipped to the canvas;
  * scribble — a grayscale stroke image, binarised at 10/255 and
               nearest-resized to the image when its size differs;
  * text and unknown types — zeros (the reference returns an empty mask).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
from scipy.ndimage import gaussian_filter

from image_segmentation_tpu_torch.ops.geometry import resize_nearest_np

POINT_RADIUS = 20
BLUR_RADIUS = 10
SCRIBBLE_THRESHOLD = 10 / 255


def _filled_circle(mask: np.ndarray, cy: int, cx: int) -> None:
    h, w, r = *mask.shape, POINT_RADIUS
    y0, y1 = max(0, cy - r), min(h, cy + r + 1)
    x0, x1 = max(0, cx - r), min(w, cx + r + 1)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.ogrid[y0:y1, x0:x1]
    mask[y0:y1, x0:x1][(yy - cy) ** 2 + (xx - cx) ** 2 <= r**2] = 1.0


def render_points(points: Sequence[Dict], size: Tuple[int, int]) -> np.ndarray:
    """points: [{'x': .., 'y': ..}, ...] in original-image pixels."""
    mask = np.zeros(size, np.float32)
    for p in points:
        _filled_circle(mask, int(round(p["y"])), int(round(p["x"])))
    mask = gaussian_filter(mask, sigma=BLUR_RADIUS / 2.0)
    m = mask.max()
    if m > 0:
        mask = mask / m
    return np.clip(mask, 0.0, 1.0)


def render_bbox(bbox: Dict, size: Tuple[int, int]) -> np.ndarray:
    """bbox: {'x', 'y', 'width', 'height'} in original-image pixels. The
    extent runs from the raw origin and both edges are clipped to the
    canvas, so a box that starts off-canvas is cut, not shifted."""
    mask = np.zeros(size, np.float32)
    x0r, y0r = int(round(bbox["x"])), int(round(bbox["y"]))
    x1 = max(0, min(size[1], x0r + max(0, int(round(bbox["width"])))))
    y1 = max(0, min(size[0], y0r + max(0, int(round(bbox["height"])))))
    mask[max(0, y0r):y1, max(0, x0r):x1] = 1.0
    return mask


def render_scribble(scribble: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Binarise a grayscale (or RGB, averaged) scribble at 10 on the uint8
    scale."""
    s = np.asarray(scribble, np.float32)
    if s.ndim == 3:
        s = s.mean(axis=-1)
    if s.max() > 1.0:
        s = s / 255.0
    if s.shape != tuple(size):
        s = resize_nearest_np(s[..., None], size)[..., 0]
    return (s > SCRIBBLE_THRESHOLD).astype(np.float32)


def create_prompt_mask(prompt_type: str, prompt_data, size: Tuple[int, int]) -> np.ndarray:
    if prompt_type == "points":
        return render_points(prompt_data or [], size)
    if prompt_type == "bbox":
        return render_bbox(prompt_data, size)
    if prompt_type == "scribble":
        return render_scribble(prompt_data, size)
    return np.zeros(size, np.float32)
