"""Aspect-preserving resize+pad geometry on the host (numpy, and the C++
resampler).

Counterpart of the host half of image_segmentation_tpu/ops/geometry.py:
  * forward: scale the longer side to `target`, keep the aspect ratio
    (bilinear for images, nearest for labels), centre with zero padding,
    and record {original_size, new_size, pad, scale};
  * inverse: crop the padding out and resize back to the original size
    (bilinear without antialias, i.e. F.interpolate align_corners=False).

The resampling weights are the triangle-kernel matrices of
jax.image.resize(method='linear') (`_triangle_weight_matrix_np`), which
the models' skip resize uses as well. Layout is HWC. The host functions
take the port's C++ resampler (ops/native.py) where it built, as JAX's
do, else numpy in float32: the two agree within 5e-6.

JAX's device half (`batched_resize_with_padding`, `compute_meta`,
`stage_image_np`) is not ported: no program of either package calls it,
only JAX's tests.

`ResizeMeta` holds a dataset's or a batch's metas as columns of arrays
(data/loader.py, train/fast_eval.py), as the JAX package's does.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple

import numpy as np


class ResizeMeta(NamedTuple):
    """Per-image geometry, each field an int32 array of shape (N,) (scale
    float32), or one image's scalars (reference utils/utils.py:43-48)."""

    orig_h: np.ndarray
    orig_w: np.ndarray
    new_h: np.ndarray
    new_w: np.ndarray
    pad_top: np.ndarray
    pad_left: np.ndarray
    scale: np.ndarray


def metas_to_list(metas: ResizeMeta) -> List[ResizeMeta]:
    """Split a batched ResizeMeta into one ResizeMeta of scalars per image."""
    n = int(np.asarray(metas.orig_h).shape[0])
    return [ResizeMeta(*(np.asarray(f)[i] for f in metas)) for i in range(n)]


def _native():
    """The C++ resampler (ops/native.py) where it builds, else None (a
    host without g++); a failed build raises. Same algorithm in float32
    as the numpy path (within 5e-6)."""
    from image_segmentation_tpu_torch.ops import native

    return native if native.available() else None


@functools.lru_cache(maxsize=4096)
def _triangle_weight_matrix_np(in_size: int, out_size: int, antialias: bool):
    """(out, in) separable linear-resize weights, half-pixel centres:
    triangle kernel, widened by 1/scale when antialiasing a downscale,
    edge weights renormalised over the in-bounds taps."""
    scale = out_size / in_size
    kernel_scale = max(1.0 / scale, 1.0) if antialias else 1.0
    sample = (np.arange(out_size) + 0.5) / scale - 0.5
    x = np.abs(sample[:, None] - np.arange(in_size)[None, :]) / kernel_scale
    weights = np.clip(1.0 - x, 0.0, 1.0)
    total = weights.sum(axis=1, keepdims=True)
    weights = np.where(total > 1e-7, weights / np.maximum(total, 1e-7), 0.0)
    return weights.astype(np.float64)


def resize_linear_np(img: np.ndarray, out_hw, antialias: bool = False,
                     dtype=np.float64):
    """Separable linear resize of an (H, W, C) array: two matmuls."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    in_h, in_w = img.shape[:2]
    wy = _triangle_weight_matrix_np(in_h, out_h, antialias).astype(dtype)
    wx = _triangle_weight_matrix_np(in_w, out_w, antialias).astype(dtype)
    tmp = (wy @ img.astype(dtype).reshape(in_h, -1)).reshape(out_h, in_w, -1)
    return np.einsum("ow,hwc->hoc", wx, tmp, optimize=True)


def resize_nearest_np(img: np.ndarray, out_hw, exact: bool = True):
    """Nearest resize of (H, W, C): half-pixel centres when `exact`,
    else the legacy floor(dst·in/out) of F.interpolate(mode='nearest')."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    in_h, in_w = img.shape[:2]
    off = 0.5 if exact else 0.0
    yi = np.floor((np.arange(out_h) + off) * in_h / out_h).astype(np.int64)
    xi = np.floor((np.arange(out_w) + off) * in_w / out_w).astype(np.int64)
    yi = np.clip(yi, 0, in_h - 1)
    xi = np.clip(xi, 0, in_w - 1)
    return img[yi[:, None], xi[None, :], ...]


def resize_with_padding_np(img: np.ndarray, target: int, method: str = "linear",
                           antialias: bool = True):
    """Forward geometry for one (H, W, C) image → ((T, T, C), meta).

    The short side never rounds below 1 pixel (e.g. 400×1 at 224)."""
    h, w = img.shape[:2]
    scale = min(target / h, target / w)
    new_h = max(1, int(round(h * scale)))
    new_w = max(1, int(round(w * scale)))
    pad_top = (target - new_h) // 2
    pad_left = (target - new_w) // 2
    native = _native()
    if method == "linear":
        if native is not None and img.ndim == 3:
            resized = native.resize_linear(img, (new_h, new_w), antialias=antialias)
        else:
            resized = resize_linear_np(img, (new_h, new_w), antialias=antialias,
                                       dtype=np.float32)
    elif method == "nearest":
        if native is not None and img.ndim == 3 and np.issubdtype(np.asarray(img).dtype,
                                                                  np.floating):
            resized = native.resize_nearest(img, (new_h, new_w), exact=False)
        else:
            resized = resize_nearest_np(img, (new_h, new_w), exact=False)
    else:
        raise ValueError(method)
    out = np.zeros((target, target) + img.shape[2:], dtype=resized.dtype)
    out[pad_top:pad_top + new_h, pad_left:pad_left + new_w] = resized
    meta = {
        "original_size": (h, w),
        "new_size": (new_h, new_w),
        "pad": (pad_left, pad_top, target - new_w - pad_left, target - new_h - pad_top),
        "scale": scale,
    }
    return out, meta


def invert_resize_padding_np(out_tt: np.ndarray, meta,
                             method: str = "linear") -> np.ndarray:
    """Inverse geometry: crop the padding, resize to the original size
    (float32 bilinear without antialias, or legacy nearest). `meta` is a
    dict from resize_with_padding_np or a ResizeMeta of scalars."""
    if isinstance(meta, ResizeMeta):
        pad_top, pad_left = int(meta.pad_top), int(meta.pad_left)
        new_h, new_w = int(meta.new_h), int(meta.new_w)
        orig_h, orig_w = int(meta.orig_h), int(meta.orig_w)
    else:
        pad_left, pad_top, _, _ = meta["pad"]
        new_h, new_w = meta["new_size"]
        orig_h, orig_w = meta["original_size"]
    native = _native()
    if native is not None and out_tt.ndim == 3:
        crop = (pad_top, pad_left, new_h, new_w)
        if method == "linear":
            return native.resize_linear(out_tt, (orig_h, orig_w), antialias=False, crop=crop)
        if method == "nearest":
            return native.resize_nearest(out_tt, (orig_h, orig_w), exact=False, crop=crop)
    crop = out_tt[pad_top:pad_top + new_h, pad_left:pad_left + new_w]
    if method == "linear":
        return resize_linear_np(crop, (orig_h, orig_w), antialias=False,
                                dtype=np.float32)
    if method == "nearest":
        return resize_nearest_np(crop, (orig_h, orig_w), exact=False)
    raise ValueError(method)
