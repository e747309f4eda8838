"""Prompt-triplet generation (reference utils/augmentation.ipynb cell 23).

The port's copy of image_segmentation_tpu/data/prompts.py (:24-104), in
numpy; with the same seed it gives the same triplets, bit for bit. For
each sample:
  * relabel {0 bg, 1 cat, 2 dog, 255 boundary} → {1 bg + boundary, 2 cat,
    3 dog}, 0 kept for 'deactivated' (`remap_for_prompt_task`);
  * repeatedly (at most `max_attempts` times) drop a Gaussian heatmap
    (σ = 3) at a uniformly random pixel and pick the class whose pixels
    carry the most heatmap mass;
  * once two distinct classes have won, emit two triplets (image, heatmap,
    target), the target keeping the winning class's pixels at its id and
    0 elsewhere;
  * skip samples with fewer than two target classes.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from image_segmentation_tpu_torch.data.dataset import ArrayDataset
from image_segmentation_tpu_torch.data.labels import remap_for_prompt_task


def create_gaussian_heatmap(size: Tuple[int, int], rng: np.random.Generator,
                            sigma: float = 3.0, center: Optional[Tuple[int, int]] = None
                            ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """exp(−d² / 2σ²) centred at a given or a random pixel."""
    h, w = size
    if center is None:
        center = (int(rng.integers(0, h)), int(rng.integers(0, w)))
    cy, cx = center
    yy, xx = np.indices((h, w))
    dist_sq = (xx - cx) ** 2 + (yy - cy) ** 2
    return np.exp(-dist_sq / (2.0 * sigma**2)).astype(np.float32), center


def select_dominant_class(heatmap: np.ndarray, remapped_mask: np.ndarray
                          ) -> Tuple[int, Dict[int, float]]:
    """The class (> 0) whose pixels carry the most heatmap mass; 0 if none."""
    scores: Dict[int, float] = {}
    for cls in np.unique(remapped_mask):
        if cls <= 0:
            continue
        scores[int(cls)] = float(heatmap[remapped_mask == cls].sum())
    if not scores or all(s < 1e-9 for s in scores.values()):
        return 0, scores
    return max(scores, key=scores.get), scores


def make_prompt_triplets_for_sample(img: np.ndarray, label: np.ndarray,
                                    rng: np.random.Generator, sigma: float = 3.0,
                                    max_attempts: int = 1000
                                    ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Two (image, heatmap (H, W, 1), target) triplets with distinct winning
    classes, or [] when the sample has fewer than two target classes or the
    attempts run out."""
    remapped = remap_for_prompt_task(label).astype(np.uint8)
    if (np.unique(remapped) > 0).sum() < 2:
        return []
    results, found, attempts = [], set(), 0
    while len(results) < 2 and attempts < max_attempts:
        attempts += 1
        heatmap, _ = create_gaussian_heatmap(remapped.shape, rng, sigma)
        cls, _ = select_dominant_class(heatmap, remapped)
        if cls > 0 and cls not in found:
            target = np.where(remapped == cls, cls, 0).astype(np.uint8)
            results.append((np.asarray(img, np.float32), heatmap[..., None],
                            target.astype(np.int32)))
            found.add(cls)
    return results if len(results) == 2 else []


def generate_prompt_dataset(dataset, seed: int = 0, sigma: float = 3.0,
                            max_attempts: int = 1000) -> ArrayDataset:
    """The triplets of every (image, label) item of `dataset`, whose labels
    may carry the raw 255 boundary sentinel (the remap happens here)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(len(dataset)):
        img, label = dataset[i]
        out.extend(make_prompt_triplets_for_sample(np.asarray(img), np.asarray(label), rng,
                                                   sigma, max_attempts))
    return ArrayDataset(out)
