"""Label semantics: boundary remap, the prompt task's ids and the webapp
colour map.

On-disk labels are class-id PNGs (0 background, 1 cat, 2 dog, 255
boundary); the boundary sentinel maps to class 3. Counterpart of
image_segmentation_tpu/data/labels.py; the two agree bit for bit.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

# Webapp colour map: 0→black, 1→red, 2→green, 3→blue
COLOR_MAP = np.array(
    [[0, 0, 0], [255, 0, 0], [0, 255, 0], [0, 0, 255]], dtype=np.uint8
)


def target_remap(label: np.ndarray, boundary_value: int = 255, to: int = 3):
    """Remap the boundary sentinel (255) to class id 3."""
    label = np.asarray(label)
    return np.where(label == boundary_value, to, label).astype(label.dtype)


def calculate_class_weights(labels: Sequence[np.ndarray], num_classes: int,
                            ignore_index: Optional[int] = None,
                            unimportant_class_indices: Optional[List[int]] = None,
                            normalize_target_sum: float = -1.0) -> np.ndarray:
    """Inverse-pixel-frequency class weights (JAX labels.py:53; reference
    utils/utils.py:117-198): pixels per class over `labels` (values clamped
    to [0, C-1], `ignore_index` pixels left out), weights 1/(freq + 1e-6);
    the MinWeight scheme sets the listed classes to the smallest weight;
    then the weights are scaled to sum to `normalize_target_sum`
    (num_classes when it is not positive). float32 (C,)."""
    counts = np.zeros(num_classes, dtype=np.float64)
    total = 0
    for label in labels:
        flat = np.asarray(label).reshape(-1).astype(np.int64)
        if ignore_index is not None:
            flat = flat[flat != ignore_index]
        flat = np.clip(flat, 0, num_classes - 1)
        if flat.size:
            counts += np.bincount(flat, minlength=num_classes).astype(np.float64)
            total += flat.size
    weights = 1.0 / (counts / max(total, 1) + 1e-6)
    for idx in unimportant_class_indices or ():
        weights[idx] = weights.min()
    target_sum = normalize_target_sum if normalize_target_sum > 0 else float(num_classes)
    return (weights / weights.sum() * target_sum).astype(np.float32)


def colorize_mask(mask: np.ndarray, color_map: np.ndarray = COLOR_MAP) -> np.ndarray:
    """HxW class ids → HxWx3 uint8 RGB."""
    mask = np.clip(np.asarray(mask), 0, len(color_map) - 1).astype(np.int64)
    return color_map[mask]


def remap_for_prompt_task(label: np.ndarray) -> np.ndarray:
    """Segmentation ids {0 bg, 1 cat, 2 dog, 255 boundary} → prompt-task ids
    {1 bg + boundary, 2 cat, 3 dog}, 0 kept for 'deactivated' (JAX
    labels.py:44; reference augmentation.ipynb cell 23: 255 → 3, 3 → 0,
    then + 1)."""
    label = target_remap(label)
    label = np.where(label == 3, 0, label)
    return (label + 1).astype(label.dtype)
