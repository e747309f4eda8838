"""ctypes bindings for the port's C++ resampler (native/resample.cpp).

Counterpart of image_segmentation_tpu/ops/native.py, with the same
entry points and arithmetic. The library builds with g++ at first use
into build/torch_native/ (ops/_host_build.py). `available()` is False
only on a host without g++; a failed build raises with the compiler's
output. Each call releases the GIL (ctypes), so a Python thread pool
parallelises across images on top of the library's own OpenMP batch
entry point.
"""
from __future__ import annotations

import ctypes

import numpy as np

from image_segmentation_tpu_torch.ops._host_build import HostLibrary


def _declare(lib: ctypes.CDLL) -> None:
    fp = ctypes.POINTER(ctypes.c_float)
    lib.resample_linear.argtypes = [fp] + [ctypes.c_int] * 7 + [fp] + [ctypes.c_int] * 3
    lib.resample_linear.restype = None
    lib.resample_nearest.argtypes = lib.resample_linear.argtypes
    lib.resample_nearest.restype = None
    lib.resample_batch_linear.argtypes = [fp] + [ctypes.c_int] * 4 + [fp] + [ctypes.c_int] * 3
    lib.resample_batch_linear.restype = None


LIBRARY = HostLibrary("resample", ["resample.cpp"], _declare)


def available() -> bool:
    return LIBRARY.available()


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _check_crop(ih: int, iw: int, y0: int, x0: int, ch: int, cw: int) -> None:
    """Reject out-of-bounds crops BEFORE they reach C++ (a bad crop would
    be an out-of-bounds heap read there, not an IndexError)."""
    if y0 < 0 or x0 < 0 or ch <= 0 or cw <= 0 or y0 + ch > ih or x0 + cw > iw:
        raise ValueError(f"crop (y0={y0}, x0={x0}, h={ch}, w={cw}) outside image ({ih}, {iw})")


def _resample(entry: str, img: np.ndarray, out_hw, flag: bool, crop) -> np.ndarray:
    lib = LIBRARY.load()
    img = np.ascontiguousarray(img, dtype=np.float32)
    if img.ndim != 3:
        raise ValueError(f"expected (H, W, C), got shape {img.shape}")
    ih, iw, c = img.shape
    y0, x0, ch, cw = crop if crop is not None else (0, 0, ih, iw)
    _check_crop(ih, iw, y0, x0, ch, cw)
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if oh <= 0 or ow <= 0:
        raise ValueError(f"output size {(oh, ow)} must be positive")
    out = np.empty((oh, ow, c), np.float32)
    getattr(lib, entry)(_fp(img), ih, iw, c, y0, x0, ch, cw, _fp(out), oh, ow, int(flag))
    return out


def resize_linear(img: np.ndarray, out_hw, antialias: bool = False, crop=None) -> np.ndarray:
    """Native (crop+)resize of (H, W, C) float32. crop = (y0, x0, ch, cw)."""
    return _resample("resample_linear", img, out_hw, antialias, crop)


def resize_nearest(img: np.ndarray, out_hw, exact: bool = True, crop=None) -> np.ndarray:
    """Nearest (crop+)resize: half-pixel centres when `exact`, else the
    legacy floor(dst·in/out)."""
    return _resample("resample_nearest", img, out_hw, exact, crop)


def resize_batch_linear(imgs: np.ndarray, out_hw, antialias: bool = False) -> np.ndarray:
    """OpenMP-parallel resize of (N, H, W, C) float32 same-sized images."""
    lib = LIBRARY.load()
    imgs = np.ascontiguousarray(imgs, dtype=np.float32)
    if imgs.ndim != 4:
        raise ValueError(f"expected (N, H, W, C), got shape {imgs.shape}")
    n, ih, iw, c = imgs.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if oh <= 0 or ow <= 0:
        raise ValueError(f"output size {(oh, ow)} must be positive")
    out = np.empty((n, oh, ow, c), np.float32)
    lib.resample_batch_linear(_fp(imgs), n, ih, iw, c, _fp(out), oh, ow, int(antialias))
    return out
