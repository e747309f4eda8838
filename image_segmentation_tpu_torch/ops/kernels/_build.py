"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with its own nvcc, all started together, and the
objects link into one shared library with a plain C interface, loaded
with ctypes, at the first CUDA call (never at import,
so machines without nvcc import every module). The library lands in
`build/torch_kernels/` beside the package and is rebuilt when a source
is newer than it (the rule of image_segmentation_tpu/ops/native_codec.py).
A missing compiler or a failed build raises with the compiler's output:
there is no fallback for a CUDA tensor. Nor does a wrapper drop a
gradient: the kernels have no backward, so `refuse_grad` raises when one
would be asked for. While torch.export traces (`tracing`), the wrappers
emit each kernel as a `torch.library` op in the `istpu` namespace, whose
CUDA implementation is the same launcher, so an exported program
launches the same kernels.

The TMA tensor maps are encoded on the host by the driver's
cuTensorMapEncodeTiled, which csrc/hopper.cuh looks up at run time through
cudaGetDriverEntryPoint: the library links against the CUDA runtime only,
no -lcuda.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
LIB_PATH = os.path.join(BUILD_DIR, "libistpu_kernels.so")
SOURCES = ("attention.cu", "mlp.cu", "double_conv.cu", "relpos_attention.cu")
HEADERS = ("common.cuh", "hopper.cuh")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
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
    """Compile csrc/*.cu into LIB_PATH; returns nvcc's output (stderr),
    which holds ptxas's report (-v) of every kernel's registers, shared
    memory and spills. One nvcc per source runs in parallel, then one
    links the objects. Writes to a temporary file first, so a concurrent
    loader never maps a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        objs = [os.path.join(objdir, f + ".o") for f in SOURCES]
        procs = [
            (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                   text=True))
            for cmd in ([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj,
                         os.path.join(CSRC_DIR, f)]
                        for f, obj in zip(SOURCES, objs))
        ]
        results = [(cmd, p, p.communicate()[1]) for cmd, p in procs]
        for cmd, p, err in results:
            if p.returncode != 0:
                raise KernelBuildError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{err}")
        log = "".join(err for _, _, err in results)
        tmp = os.path.join(objdir, "lib.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, LIB_PATH)
    return log + proc.stderr


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.istpu_attention_bf16.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32,
                                         *([i64] * 9), i32, i32, i32, i32, vp]
    lib.istpu_attention_bf16.restype = i32
    lib.istpu_mlp_bf16.argtypes = [vp] * 10 + [i32] * 7 + [f32, i32, i32, vp]
    lib.istpu_mlp_bf16.restype = i32
    lib.istpu_mlp_partial_bf16.argtypes = [vp] * 9 + [i32] * 7 + [f32, i32, vp]
    lib.istpu_mlp_partial_bf16.restype = i32
    lib.istpu_mlp_many_bf16.argtypes = [vp] * 10 + [i32] * 4 + [f32, i32, i32, vp]
    lib.istpu_mlp_many_bf16.restype = i32
    lib.istpu_conv3x3_bf16.argtypes = [vp] * 7 + [i32] * 10 + [vp]
    lib.istpu_conv3x3_bf16.restype = i32
    lib.istpu_relpos_attention_bf16.argtypes = [vp] * 6 + [i32] * 6 + [i64] * 9 + [i32] * 5 + [vp]
    lib.istpu_relpos_attention_bf16.restype = i32
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


def refuse_grad(op: str, *tensors) -> None:
    """Raise if a kernel without a backward would drop a gradient: grad
    mode is on and an argument requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{op}: the CUDA kernel has no backward, and an argument requires grad; run "
            f"it under torch.no_grad() or torch.inference_mode(), or on a frozen module")


def tracing() -> bool:
    """True while torch.export (or torch.compile) traces the caller. The
    wrappers then emit their kernel as a torch op (`istpu::...`), which the
    graph can hold, instead of launching through ctypes on `data_ptr()`s,
    which a trace cannot follow; eager calls keep the direct path and pay
    no op dispatch."""
    return torch.compiler.is_compiling()


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = load().istpu_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
