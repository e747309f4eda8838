"""Offline augmentation materialiser (host-side, numpy).

Counterpart of image_segmentation_tpu/data/augment.py, a copy of its
numpy (the JAX module imports no JAX, but the port imports nothing of
that package): the reference's imgaug-based offline dataset expansion
(reference utils/augmentation.ipynb):
  * base: pad-to-square (centred, zero fill) + resize to 256
    (cell 1; image antialiased, label nearest);
  * 8 augmenters — rotation 45-315° fit-output (cell 3), centre/random
    square crop (cell 5), coarse dropout p=0.15 size 1/50 applied to
    image AND label with one shared mask (cell 7), grayscale (cell 9),
    per-channel Laplace noise scale U(0.1,0.3)·255 (cell 11), average
    blur k=12 (cell 13), linear contrast U(0.2,0.6) (cell 15);
  * two-image side-by-side merge preserving aspect ratio (cell 17/21:
    cat+dog / cat+cat / dog+dog pairs);
  * class-balancing selection toward 1:1 cat:dog with a majority
    augmentation factor of 1.5 (cell 19).

The same `np.random.default_rng(seed)` gives the same samples as the JAX
package. The blur here replicates the edge (`uniform_filter(mode=
"nearest")`) where the online blur of ops/augment.py zero-pads; each
copies its own JAX path. The augmented output is fixed 256², so it feeds
straight into data.loader.materialize.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from image_segmentation_tpu_torch.data.dataset import ArrayDataset, U8ArrayDataset
from image_segmentation_tpu_torch.ops.geometry import resize_linear_np, resize_nearest_np

Sample = Tuple[np.ndarray, np.ndarray]  # (img f32 [0,1] HxWx3, label int HxW)


# ---------------------------------------------------------------------------
# Base geometry
# ---------------------------------------------------------------------------


def pad_to_square_resize(
    img: np.ndarray, label: np.ndarray, size: int = 256
) -> Sample:
    """Centre-pad to square (zero fill) then resize to `size` (cell 1)."""
    h, w = img.shape[:2]
    side = max(h, w)
    py, px = (side - h) // 2, (side - w) // 2
    img_sq = np.zeros((side, side, 3), np.float32)
    img_sq[py : py + h, px : px + w] = img
    lab_sq = np.zeros((side, side), label.dtype)
    lab_sq[py : py + h, px : px + w] = label
    img_out = resize_linear_np(img_sq, (size, size), antialias=True).astype(
        np.float32
    )
    # exact=False: legacy floor mapping, matching cv2/imgaug INTER_NEAREST
    # (and this repo's own geometry parity path) rather than
    # nearest-exact half-pixel centres
    lab_out = resize_nearest_np(lab_sq[..., None], (size, size),
                                exact=False)[..., 0]
    return np.clip(img_out, 0.0, 1.0), lab_out


# ---------------------------------------------------------------------------
# Augmenters (original-resolution in, 256² out)
# ---------------------------------------------------------------------------


def _warp_affine_np(img: np.ndarray, A: np.ndarray, out_hw, method: str):
    """Output pixel (y, x) samples input at A @ (y, x, 1); fill 0."""
    oh, ow = out_hw
    yy, xx = np.mgrid[0:oh, 0:ow].astype(np.float64)
    sy = A[0, 0] * yy + A[0, 1] * xx + A[0, 2]
    sx = A[1, 0] * yy + A[1, 1] * xx + A[1, 2]
    h, w = img.shape[:2]
    if method == "nearest":
        yi = np.round(sy).astype(np.int64)
        xi = np.round(sx).astype(np.int64)
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        out = img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
        out[~valid] = 0
        return out
    y0 = np.floor(sy).astype(np.int64)
    x0 = np.floor(sx).astype(np.int64)
    fy = (sy - y0)[..., None]
    fx = (sx - x0)[..., None]

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        v = img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)].astype(np.float64)
        v[~valid] = 0
        return v

    out = (
        tap(y0, x0) * (1 - fy) * (1 - fx)
        + tap(y0, x0 + 1) * (1 - fy) * fx
        + tap(y0 + 1, x0) * fy * (1 - fx)
        + tap(y0 + 1, x0 + 1) * fy * fx
    )
    return out


def rotation_aug(img, label, rng, size=256) -> Sample:
    """Rotate U(45°,315°) about the centre with fit-output (canvas grows to
    hold the rotated image), then square-pad+resize (cell 3)."""
    angle = rng.uniform(45.0, 315.0)
    rad = np.deg2rad(angle)
    h, w = img.shape[:2]
    # fit-output canvas
    oh = int(np.ceil(abs(np.cos(rad)) * h + abs(np.sin(rad)) * w))
    ow = int(np.ceil(abs(np.sin(rad)) * h + abs(np.cos(rad)) * w))
    cin = np.array([(h - 1) / 2.0, (w - 1) / 2.0])
    cout = np.array([(oh - 1) / 2.0, (ow - 1) / 2.0])
    cos, sin = np.cos(rad), np.sin(rad)
    R_inv = np.array([[cos, sin], [-sin, cos]])  # inverse rotation
    t = cin - R_inv @ cout
    A = np.array(
        [[R_inv[0, 0], R_inv[0, 1], t[0]], [R_inv[1, 0], R_inv[1, 1], t[1]]]
    )
    img_r = _warp_affine_np(img, A, (oh, ow), "linear").astype(np.float32)
    lab_r = _warp_affine_np(label[..., None], A, (oh, ow), "nearest")[..., 0]
    return pad_to_square_resize(img_r, lab_r.astype(label.dtype), size)


def center_crop_aug(img, label, rng=None, size=256) -> Sample:
    """Crop the centred min-side square, resize (cell 5)."""
    h, w = img.shape[:2]
    side = min(h, w)
    oy, ox = (h - side) // 2, (w - side) // 2
    return pad_to_square_resize(
        img[oy : oy + side, ox : ox + side],
        label[oy : oy + side, ox : ox + side],
        size,
    )


def random_crop_aug(img, label, rng, size=256) -> Sample:
    """Crop a random min-side square, resize (cell 5)."""
    h, w = img.shape[:2]
    side = min(h, w)
    oy = rng.integers(0, h - side + 1)
    ox = rng.integers(0, w - side + 1)
    return pad_to_square_resize(
        img[oy : oy + side, ox : ox + side],
        label[oy : oy + side, ox : ox + side],
        size,
    )


def masking_aug(img, label, rng, size=256, p=0.15, size_percent=1 / 50) -> Sample:
    """Coarse dropout on image AND label with ONE shared mask (cell 7:
    both augmenters constructed with random_state=2)."""
    img, label = pad_to_square_resize(img, label, size)
    cells = max(1, int(round(size * size_percent)))
    keep = rng.random((cells, cells)) >= p
    mask = resize_nearest_np(keep[..., None].astype(np.float32), (size, size))[..., 0]
    return img * mask[..., None], (label * mask).astype(label.dtype)


def grayscale_aug(img, label, rng=None, size=256) -> Sample:
    img, label = pad_to_square_resize(img, label, size)
    luma = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    return np.repeat(luma[..., None], 3, axis=-1).astype(np.float32), label


def laplace_aug(img, label, rng, size=256, lo=0.1, hi=0.3) -> Sample:
    img, label = pad_to_square_resize(img, label, size)
    scale = rng.uniform(lo, hi)
    noise = rng.laplace(0.0, scale, img.shape).astype(np.float32)
    return np.clip(img + noise, 0.0, 1.0), label


def blur_aug(img, label, rng=None, size=256, k=12) -> Sample:
    from scipy.ndimage import uniform_filter

    img, label = pad_to_square_resize(img, label, size)
    blurred = uniform_filter(img, size=(k, k, 1), mode="nearest")
    return blurred.astype(np.float32), label


def contrast_aug(img, label, rng, size=256, lo=0.2, hi=0.6) -> Sample:
    img, label = pad_to_square_resize(img, label, size)
    alpha = rng.uniform(lo, hi)
    return np.clip(0.5 + alpha * (img - 0.5), 0.0, 1.0).astype(np.float32), label


AUGMENTERS: Dict[str, Callable] = {
    "rotation": rotation_aug,
    "center_crop": center_crop_aug,
    "random_crop": random_crop_aug,
    "masking": masking_aug,
    "grayscale": grayscale_aug,
    "laplace": laplace_aug,
    "blur": blur_aug,
    "contrast": contrast_aug,
}


# ---------------------------------------------------------------------------
# Two-image merge (cells 17 + 21)
# ---------------------------------------------------------------------------


def combine_images_preserve_aspect_ratio(
    img1: np.ndarray, img2: np.ndarray, size: int = 256, is_label: bool = False
) -> np.ndarray:
    """Place two images side by side on a size×size canvas, each scaled
    (aspect-preserving, nearest resample like the reference) to fit its
    half, vertically centred (cell 17)."""
    half = size // 2
    canvas_shape = (size, size) if is_label else (size, size, 3)
    canvas = np.zeros(canvas_shape, img1.dtype)
    for i, img in enumerate((img1, img2)):
        h, w = img.shape[:2]
        s = min(size / h, half / w)
        nh, nw = max(1, int(round(h * s))), max(1, int(round(w * s)))
        if is_label:
            r = resize_nearest_np(img[..., None], (nh, nw),
                                  exact=False)[..., 0]
        else:
            r = resize_nearest_np(img, (nh, nw), exact=False)
        oy = (size - nh) // 2
        ox = i * half + (half - nw) // 2
        canvas[oy : oy + nh, ox : ox + nw] = r
    return canvas


def generate_combinations(
    samples_a: Sequence[Sample],
    samples_b: Sequence[Sample],
    n: int,
    rng: np.random.Generator,
    size: int = 256,
) -> List[Sample]:
    """n random side-by-side merges of one sample from each pool
    (cell 21: cat+dog / cat+cat / dog+dog, 126 each)."""
    out = []
    for _ in range(n):
        i = rng.integers(0, len(samples_a))
        j = rng.integers(0, len(samples_b))
        img = combine_images_preserve_aspect_ratio(
            samples_a[i][0], samples_b[j][0], size, is_label=False
        )
        lab = combine_images_preserve_aspect_ratio(
            samples_a[i][1], samples_b[j][1], size, is_label=True
        )
        out.append((img.astype(np.float32), lab))
    return out


# ---------------------------------------------------------------------------
# Full offline expansion with class balancing (cell 19)
# ---------------------------------------------------------------------------


def _dominant_animal(label: np.ndarray) -> Optional[int]:
    """1 = cat, 2 = dog, None = neither present."""
    cats = int((label == 1).sum())
    dogs = int((label == 2).sum())
    if cats == 0 and dogs == 0:
        return None
    return 1 if cats >= dogs else 2


def generate_augmented_dataset(
    dataset,
    seed: int = 0,
    size: int = 256,
    majority_aug_factor: float = 1.5,
    include_base: bool = True,
    augmenter_names: Optional[Sequence[str]] = None,
) -> ArrayDataset:
    """Expand a (img, label) dataset with the 8 augmenters, balancing
    classes: every minority-class image receives all augmenters, while
    majority-class images receive a subset so that
    |majority| ≤ factor·|minority| after expansion (cell 19's
    majority_aug_factor=1.5 selection).

    Returns an in-memory U8ArrayDataset of fixed 256² samples
    (base + aug) — images stored quantized at the 8-bit source
    precision, dequantized to float [0,1] on access (4× less host RAM
    than float32 at the ~23k-sample full-Pet scale).
    """
    rng = np.random.default_rng(seed)
    names = list(augmenter_names or AUGMENTERS.keys())

    by_class: Dict[int, List[int]] = {1: [], 2: []}
    samples: List[Sample] = []
    for i in range(len(dataset)):
        img, label = dataset[i]
        samples.append((np.asarray(img, np.float32), np.asarray(label)))
        d = _dominant_animal(samples[-1][1])
        if d is not None:
            by_class[d].append(i)

    n_cat, n_dog = len(by_class[1]), len(by_class[2])
    minority = 1 if n_cat <= n_dog else 2
    majority = 2 if minority == 1 else 1
    # target: |majority|·(1+k_maj) ≈ factor · |minority|·(1+k_min)
    k_min = len(names)
    n_min, n_maj = len(by_class[minority]), max(1, len(by_class[majority]))
    k_maj = max(
        0,
        min(
            k_min,
            int(round(majority_aug_factor * n_min * (1 + k_min) / n_maj - 1)),
        ),
    )

    def produce():
        # one float sample in flight at a time: U8ArrayDataset quantizes
        # each yielded item immediately, so the ~9× expanded set costs
        # uint8 storage (±4.5 GB at full Pet scale) instead of float32
        # (~18 GB) during generation
        for img, label in samples:
            if include_base:
                yield pad_to_square_resize(img, label, size)
            d = _dominant_animal(label)
            chosen = names if d == minority or d is None else list(
                rng.permutation(names)[:k_maj]
            )
            for name in chosen:
                yield AUGMENTERS[name](img, label, rng, size)

    return U8ArrayDataset(produce())
