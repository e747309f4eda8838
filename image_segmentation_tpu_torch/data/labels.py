"""Label semantics for serving: boundary remap and the webapp colour map.

On-disk labels are class-id PNGs (0 background, 1 cat, 2 dog, 255
boundary); the boundary sentinel maps to class 3. Counterpart of
image_segmentation_tpu/data/labels.py; the two agree bit for bit.
"""
from __future__ import annotations

import numpy as np

# Webapp colour map: 0→black, 1→red, 2→green, 3→blue
COLOR_MAP = np.array(
    [[0, 0, 0], [255, 0, 0], [0, 255, 0], [0, 0, 255]], dtype=np.uint8
)


def target_remap(label: np.ndarray, boundary_value: int = 255, to: int = 3):
    """Remap the boundary sentinel (255) to class id 3."""
    label = np.asarray(label)
    return np.where(label == boundary_value, to, label).astype(label.dtype)


def colorize_mask(mask: np.ndarray, color_map: np.ndarray = COLOR_MAP) -> np.ndarray:
    """HxW class ids → HxWx3 uint8 RGB."""
    mask = np.clip(np.asarray(mask), 0, len(color_map) - 1).astype(np.int64)
    return color_map[mask]
