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
would be asked for.

The seam every wrapper module shares is here too: `kernel_entry` registers
a kernel's `istpu::` torch op and routes its public function (the plain
version on the CPU, the module's `_launch` on CUDA, the op while
torch.export traces, so an exported program launches the same kernels);
`sm_count` and `device_and_stream` feed the launchers; `check_heads`
checks the attention kernels' strided heads; and the launch counters of
the modules in KERNEL_MODULES are read and credited through
`launch_counts`, `launches_since` and `add_launches`.

The TMA tensor maps are encoded on the host by the driver's
cuTensorMapEncodeTiled, which csrc/hopper.cuh looks up at run time through
cudaGetDriverEntryPoint: the library links against the CUDA runtime only,
no -lcuda.
"""
from __future__ import annotations

import ctypes
import functools
import importlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
from typing import Callable, Dict, Optional, Tuple

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
LIB_PATH = os.path.join(BUILD_DIR, "libistpu_kernels.so")
SOURCES = ("attention.cu", "mlp.cu", "double_conv.cu", "relpos_attention.cu")
HEADERS = ("common.cuh", "hopper.cuh")
# The wrapper modules beside this one. Each counts its CUDA calls in module
# integers named *LAUNCHES (the plain versions do not count).
KERNEL_MODULES = ("attention", "mlp", "double_conv", "relpos_attention")

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
    lib.istpu_relpos_window_bf16.argtypes = [vp] * 8 + [i32] * 6 + [i64] * 9 + [i32] * 3 + [vp]
    lib.istpu_relpos_window_bf16.restype = i32
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


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The SMs of a card, which the persistent kernels' plans share out."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def device_and_stream(t: torch.Tensor) -> Tuple[int, int]:
    """The device index and current stream handle on which to launch for a
    CUDA tensor: the two arguments every C entry point ends with."""
    dev = t.device.index if t.device.index is not None else torch.cuda.current_device()
    return dev, torch.cuda.current_stream(t.device).cuda_stream


def check_heads(op: str, head_dim: int, q, k, v, *others) -> None:
    """Raise unless q, k and v are equal (B, S, H, `head_dim`) bf16 tensors
    whose strides a TMA map can follow (the attention kernels read them in
    place, as slices of a fused projection), and `others`, (name, tensor)
    pairs, are bf16 on q's device too."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{op} wants equal (B, S, H, D) shapes, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-1] != head_dim:
        raise ValueError(f"{op}: the CUDA kernel takes head dim {head_dim}, got {q.shape[-1]}")
    heads = (("q", q), ("k", k), ("v", v))
    for name, t in heads + others:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernel takes bfloat16; {name} is {t.dtype}")
    for name, t in heads:
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"{name} needs a contiguous last dim, 16-byte aligned rows "
                f"and strides that are multiples of 8; got strides {t.stride()}")


def check_operands(args: Dict[str, torch.Tensor], shapes: Dict[str, tuple],
                   f32: Tuple[str, ...], layout: str = "") -> None:
    """Raise unless each of `args` (name → tensor) has its shape in `shapes`
    where one is given, is float32 if its name is in `f32` and bfloat16
    otherwise, lies on the first one's device, and is contiguous and
    16-byte aligned (`layout` says in the message what that means)."""
    first, x = next(iter(args.items()))
    for name, t in args.items():
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shapes[name]}")
        want = torch.float32 if name in f32 else torch.bfloat16
        if t.dtype != want:
            raise TypeError(f"the CUDA kernel takes {name} as {want}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, {first} on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned{layout}; "
                             f"got strides {t.stride()}")


def kernel_entry(name: str, module: str, reference: Callable, *, schema: Optional[str] = None,
                 fake: Optional[Callable] = None, launcher: Optional[Callable] = None,
                 launch_args: Callable = lambda *args: args):
    """`(op, route)` of one kernel entry. `op`, given a `schema`, is the torch
    op `istpu::<name>`: `reference` (the plain version) on the CPU,
    `launcher` on CUDA, `fake` for shapes while tracing. `route(*args)`, the
    public function's body, goes by the first argument's device: while
    torch.export traces, `refuse_grad` and the op (without an op, skipped);
    on the CPU, the plain version; on CUDA, `module`'s `_launch` on
    `launch_args(*args)`, looked up at each call so that a launcher swapped
    into the module (perfbench/tracing.py) sees every eager call; on any
    other device, a ValueError."""
    op = None
    if schema is not None:
        op = torch.library.custom_op(f"istpu::{name}", launcher, mutates_args=(),
                                     device_types="cuda", schema=schema)
        op.register_kernel("cpu", reference)
        op.register_fake(fake)

    def route(*args):
        if op is not None and tracing():
            refuse_grad(name, *(a for a in args if isinstance(a, torch.Tensor)))
            return op(*args)
        device = args[0].device
        if device.type == "cpu":
            return reference(*args)
        if device.type != "cuda":
            raise ValueError(f"{name} runs on cpu or cuda, not {device}")
        return sys.modules[module]._launch(*launch_args(*args))

    return op, route


def launch_counts() -> Dict[Tuple[str, str], int]:
    """Every launch counter of the port, by (module, counter name)."""
    mods = {m: importlib.import_module(f"{__package__}.{m}") for m in KERNEL_MODULES}
    return {(m, name): n for m, mod in mods.items() for name, n in vars(mod).items()
            if name.endswith("LAUNCHES")}


def launches_since(before: Dict[Tuple[str, str], int]) -> Dict[Tuple[str, str], int]:
    """What each counter gained since `before` (a `launch_counts()`), where
    it moved: the launches a stretch of code made."""
    return {key: n - before[key] for key, n in launch_counts().items() if n != before[key]}


def add_launches(delta: Dict[Tuple[str, str], int]) -> None:
    """Add `delta` (from `launches_since`) to the counters: what a CUDA
    graph's replay launched without calling a wrapper."""
    for (short, counter), n in delta.items():
        mod = sys.modules[f"{__package__}.{short}"]
        setattr(mod, counter, getattr(mod, counter) + n)
