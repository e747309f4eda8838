"""Image channel rules shared by every decode path (numpy).

Counterpart of image_segmentation_tpu/data/dataset.py:normalize_image_channels.
The file datasets come with the training slices.
"""
from __future__ import annotations

import numpy as np


def normalize_image_channels(arr: np.ndarray) -> np.ndarray:
    """(H, W[, C]) → (H, W, 3): drop alpha (RGBA), drop alpha then
    replicate gray (LA), replicate gray (L)."""
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.shape[2] == 4:
        arr = arr[:, :, :3]
    if arr.shape[2] == 2:
        arr = arr[:, :, :1]
    if arr.shape[2] == 1:
        arr = np.repeat(arr, 3, axis=2)
    return arr
