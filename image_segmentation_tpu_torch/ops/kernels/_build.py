"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources compile with nvcc into one shared library with a plain C
interface, loaded with ctypes, at the first CUDA call (never at import,
so machines without nvcc import every module). The library lands in
`build/torch_kernels/` beside the package and is rebuilt when a source
is newer than it (the rule of image_segmentation_tpu/ops/native_codec.py).
A missing compiler or a failed build raises with the compiler's output:
there is no fallback for a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
LIB_PATH = os.path.join(BUILD_DIR, "libistpu_kernels.so")
SOURCES = ("attention.cu", "mlp.cu")
HEADERS = ("common.cuh",)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelBuildError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "cannot be built on this machine")
    return path


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(
        os.path.getmtime(os.path.join(CSRC_DIR, f)) > built
        for f in SOURCES + HEADERS
    )


def build() -> str:
    """Compile csrc/*.cu into LIB_PATH; returns nvcc's output (stderr).
    Writes to a temporary file first, so a concurrent loader never maps
    a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC_DIR, f) for f in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return proc.stderr


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.istpu_attention_bf16.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32,
                                         *([i64] * 9), i32, vp]
    lib.istpu_attention_bf16.restype = i32
    lib.istpu_attention_max_seq.argtypes = [i32, i32]
    lib.istpu_attention_max_seq.restype = i32
    lib.istpu_mlp_bf16.argtypes = [vp] * 9 + [i32] * 5 + [f32, i32, vp]
    lib.istpu_mlp_bf16.restype = i32
    lib.istpu_error_string.argtypes = [i32]
    lib.istpu_error_string.restype = ctypes.c_char_p


def load() -> ctypes.CDLL:
    """The kernel library, building it first if it is missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            lib = ctypes.CDLL(LIB_PATH)
            _declare(lib)
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = load().istpu_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
