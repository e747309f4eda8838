"""Datasets: directory-backed and in-memory image/label pairs (numpy).

Counterpart of image_segmentation_tpu/data/dataset.py
(`normalize_image_channels`, `list_stems`, `SegmentationDataset`,
`ArrayDataset`, `U8ArrayDataset`). Items are keyed by sorted file stems;
images decode to [0, 1] float, labels are raw class-id PNGs, and an
optional target_transform (the 255 → 3 boundary remap) applies to labels
(reference utils/dataset.py:6-103). The training path materialises a
dataset once into fixed-shape arrays (data/loader.py).

PIL is imported only when a file is decoded, and need not be installed:
without it PNG files decode with the port's codec (`data/png.py`), other
formats raise, and the in-memory datasets need neither.
"""
from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


def _decode_image(path: str) -> np.ndarray:
    """Decode to (H, W, C) uint8 (RGB kept as it is; palettes expanded)
    with `data/png.decode`: PIL, or where it is missing PNG files only."""
    from image_segmentation_tpu_torch.data import png

    with open(path, "rb") as f:
        raw = f.read()
    try:
        return png.decode(raw)
    except (ValueError, RuntimeError) as e:
        raise type(e)(f"{path}: {e}") from e


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


def list_stems(directory: str) -> List[str]:
    """Sorted extension-less file stems (reference utils/dataset.py:20)."""
    return sorted(os.path.splitext(f)[0] for f in os.listdir(directory))


class SegmentationDataset:
    """{img_dir}/{stem}.jpg + {label_dir}/{stem}.png
    (reference utils/dataset.py:6-51)."""

    def __init__(
        self,
        img_dir: str,
        label_dir: str,
        transform: Optional[Callable] = None,
        target_transform: Optional[Callable] = None,
        img_ext: str = ".jpg",
        label_ext: str = ".png",
    ):
        self.img_dir = img_dir
        self.label_dir = label_dir
        self.stems = list_stems(img_dir)
        self.transform = transform
        self.target_transform = target_transform
        self.img_ext = img_ext
        self.label_ext = label_ext

    def __len__(self) -> int:
        return len(self.stems)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        stem = self.stems[idx]
        img = _decode_image(os.path.join(self.img_dir, stem + self.img_ext))
        img = normalize_image_channels(img).astype(np.float32) / 255.0
        label = _decode_image(os.path.join(self.label_dir, stem + self.label_ext))
        label = label[:, :, 0].astype(np.int32)
        if self.transform:
            img = self.transform(img)
        if self.target_transform:
            label = self.target_transform(label)
        return img, label


class ArrayDataset:
    """In-memory dataset of pre-decoded items (synthetic data, tests):
    (img, label) or (img, heatmap, label) tuples of numpy arrays."""

    def __init__(self, items: Sequence[tuple]):
        self.items = list(items)

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int):
        return self.items[idx]

    def map_labels(self, fn) -> "ArrayDataset":
        """Apply `fn` to every item's label (the last tuple element) in
        place and return self: a remapped copy would double host memory."""
        self.items = [(*item[:-1], fn(np.asarray(item[-1]))) for item in self.items]
        return self


class U8ArrayDataset(ArrayDataset):
    """ArrayDataset storing [0, 1] float images (and heatmaps) quantised to
    uint8, dequantised on access: the sources are 8-bit, so this loses
    nothing the decode had not, and holds 4× less. Labels are stored as
    they are."""

    def __init__(self, items: Sequence[tuple]):
        super().__init__(
            (*(np.clip(np.round(np.asarray(a, np.float32) * 255.0),
                       0, 255).astype(np.uint8) for a in item[:-1]),
             item[-1])
            for item in items
        )

    def __getitem__(self, idx: int):
        item = self.items[idx]
        return (*(a.astype(np.float32) / 255.0 for a in item[:-1]), item[-1])
