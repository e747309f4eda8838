"""ctypes bindings for the port's C++ image codec + staging library
(native/imagecodec.cpp with native/resample.cpp, linked against libpng
and libjpeg).

Counterpart of image_segmentation_tpu/ops/native_codec.py, with the same
entry points, results and errors. The library builds with g++ at first
use into build/torch_native/ (ops/_host_build.py). `available()` is
False on a host without g++ or without libpng's or libjpeg's headers
(`unavailable_reason()` says which); then the callers decode with PIL or
the port's PNG codec (data/png.py `decode`) and stage with numpy. A
failed build on a host that has them raises with the compiler's output.
Every call releases the GIL (ctypes), so a Python thread pool
parallelises decode + resize across cores (data/native_pipeline.py).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from image_segmentation_tpu_torch.ops._host_build import HostLibrary

_ERRORS = {
    -1: "file unreadable",
    -2: "unsupported image format",
    -3: "decode error",
    -4: "buffer/dimension mismatch",
}

# default speculative orig-label capacity: above Oxford-Pet native
# resolutions (≤ ~500×500), so one decode suffices per file
_DEFAULT_ORIG_CAP = 768 * 768


class CodecError(RuntimeError):
    def __init__(self, rc: int, context: str):
        super().__init__(f"{context}: {_ERRORS.get(rc, f'error {rc}')}")
        self.rc = rc


def _declare(lib: ctypes.CDLL) -> None:
    ip, fp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
    i32p, u8p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8)
    c_int, c_long, c_char_p = ctypes.c_int, ctypes.c_long, ctypes.c_char_p
    for name, args in (
            ("codec_probe_file", [c_char_p, ip, ip, ip]),
            ("codec_probe_mem", [u8p, c_long, ip, ip, ip]),
            ("codec_decode_mem_u8", [u8p, c_long, u8p, c_int, c_int, c_int]),
            ("codec_load_image_f32", [c_char_p, c_int, c_int, fp, ip]),
            ("codec_load_label_i32", [c_char_p, c_int, i32p, ip, i32p, c_long]),
            ("codec_load_heatmap_f32", [c_char_p, c_int, c_int, fp, ip])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, c_int


LIBRARY = HostLibrary("imagecodec", ["imagecodec.cpp", "resample.cpp"], _declare,
                      libs=("png", "jpeg"), headers=("png.h", "jpeglib.h"))


def available() -> bool:
    return LIBRARY.available()


def unavailable_reason() -> Optional[str]:
    """Why `available()` is False (missing compiler or headers), else None."""
    return LIBRARY.unavailable_reason() if not available() else None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _meta_buf() -> np.ndarray:
    return np.zeros(6, np.int32)


def _meta_dict(m: np.ndarray, target: int) -> dict:
    h, w, nh, nw, pt, pl = (int(v) for v in m)
    return {
        "original_size": (h, w),
        "new_size": (nh, nw),
        "pad": (pl, pt, target - nw - pl, target - nh - pt),
        "scale": min(target / h, target / w),
    }


def _probe(lib, buf: np.ndarray, n: int) -> Tuple[int, int, int]:
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.codec_probe_mem(_ptr(buf, ctypes.c_uint8), n, h, w, c)
    if rc != 0:
        raise CodecError(rc, "probe bytes")
    return h.value, w.value, c.value


def probe(path: str) -> Tuple[int, int, int]:
    """(h, w, channels) of a PNG/JPEG file without a full decode."""
    lib = LIBRARY.load()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.codec_probe_file(path.encode(), h, w, c)
    if rc != 0:
        raise CodecError(rc, f"probe {path}")
    return h.value, w.value, c.value


def probe_bytes(data: bytes) -> Tuple[int, int, int]:
    """(h, w, channels) of in-memory PNG/JPEG bytes, from the header only
    (the cheap gate for format-dependent dispatch)."""
    return _probe(LIBRARY.load(), np.frombuffer(data, np.uint8), len(data))


def decode_bytes(data: bytes) -> np.ndarray:
    """Decode in-memory PNG/JPEG bytes to (H, W, C) uint8: C is 1 (gray),
    2 (gray + alpha), 3 (RGB; a palette expanded) or 4. 16-bit PNGs and
    CMYK JPEGs raise CodecError (PIL reads them)."""
    lib = LIBRARY.load()
    buf = np.frombuffer(data, np.uint8)
    h, w, c = _probe(lib, buf, len(data))
    out = np.empty((h, w, c), np.uint8)
    rc = lib.codec_decode_mem_u8(_ptr(buf, ctypes.c_uint8), len(data),
                                 _ptr(out, ctypes.c_uint8), h, w, c)
    if rc != 0:
        raise CodecError(rc, "decode bytes")
    return out


def load_image(path: str, target: int, antialias: bool = True):
    """Decode + resize_with_padding in one native call: ((T, T, 3) float32
    in [0, 1], meta dict), the contract of ops/geometry.py
    resize_with_padding_np (alpha dropped, gray replicated)."""
    lib = LIBRARY.load()
    out = np.empty((target, target, 3), np.float32)
    m = _meta_buf()
    rc = lib.codec_load_image_f32(path.encode(), target, int(antialias),
                                  _ptr(out, ctypes.c_float), _ptr(m, ctypes.c_int))
    if rc != 0:
        raise CodecError(rc, f"load image {path}")
    return out, _meta_dict(m, target)


def load_label(path: str, target: int, orig_hw: Optional[Tuple[int, int]] = None,
               want_orig: bool = False):
    """Decode a class-id label PNG (channel 0) + nearest resize_with_padding
    (the legacy floor index map): ((T, T) int32, meta dict), plus the
    (H, W) int32 native-resolution label when `orig_hw` (exact dims, e.g.
    from probe()) or `want_orig` (dims found by the decode itself, into a
    speculative buffer retried once at the exact size) is given."""
    lib = LIBRARY.load()
    out = np.empty((target, target), np.int32)
    m = _meta_buf()
    if orig_hw is not None:
        flat = np.empty(int(orig_hw[0]) * int(orig_hw[1]), np.int32)
    elif want_orig:
        flat = np.empty(_DEFAULT_ORIG_CAP, np.int32)
    else:
        flat = None

    def call(buf):
        return lib.codec_load_label_i32(
            path.encode(), target, _ptr(out, ctypes.c_int32), _ptr(m, ctypes.c_int),
            _ptr(buf, ctypes.c_int32) if buf is not None else None,
            buf.size if buf is not None else 0)

    rc = call(flat)
    if rc == -4 and flat is not None and m[0] > 0:
        # capacity miss: meta6 is valid (the C contract); retry exactly
        flat = np.empty(int(m[0]) * int(m[1]), np.int32)
        rc = call(flat)
    if rc != 0:
        raise CodecError(rc, f"load label {path}")
    meta = _meta_dict(m, target)
    if flat is not None:
        h, w = meta["original_size"]
        return out, meta, flat[: h * w].reshape(h, w).copy()
    return out, meta


def load_heatmap(path: str, target: int, antialias: bool = True):
    """Decode a 0-255 heatmap PNG (channel 0) + linear resize_with_padding:
    ((T, T, 1) float32 in [0, 1], meta dict)."""
    lib = LIBRARY.load()
    out = np.empty((target, target, 1), np.float32)
    m = _meta_buf()
    rc = lib.codec_load_heatmap_f32(path.encode(), target, int(antialias),
                                    _ptr(out, ctypes.c_float), _ptr(m, ctypes.c_int))
    if rc != 0:
        raise CodecError(rc, f"load heatmap {path}")
    return out, _meta_dict(m, target)
