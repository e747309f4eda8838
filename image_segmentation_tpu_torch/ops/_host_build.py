"""Build and load the port's host libraries (native/*.cpp) with g++.

The port's counterpart of the JAX package's `_build` in ops/native.py
and ops/native_codec.py, with three differences:
  * a library builds at its first use (never at import) into
    `build/torch_native/` beside the package, never beside its sources;
  * its file name carries the host (`host_key`): `-march=native` code
    may not run on another CPU, so a checkout that two machines share
    holds one library per (machine, CPU flags);
  * concurrent builds (pytest-xdist workers, threads) take an `fcntl`
    lock on the build directory, and each build writes a temporary file
    that `os.replace` puts in place, so no loader maps a half-written
    library.
A library is rebuilt when one of its sources is newer than it.

A library is unavailable (`Unavailable`, with the reason) only when what
it needs is absent: no g++, or a header it includes (libpng's and
libjpeg's for the codec). Any other failure to build or load it raises
`HostBuildError` with the compiler's output; it never turns into a quiet
switch to another path.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Callable, Optional, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(_PKG_DIR, "native")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_native")
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")


class HostBuildError(RuntimeError):
    pass


class Unavailable(RuntimeError):
    """What the library needs is not on this host (compiler or headers)."""


def host_key() -> str:
    """`<machine>-<hash of the CPU's flags>`: the hosts a -march=native
    library may run on."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((line for line in f if line.startswith("flags")), "")
    except OSError:
        pass
    return f"{platform.machine()}-{hashlib.sha1(flags.encode()).hexdigest()[:10]}"


def missing_prerequisites(headers: Sequence[str]) -> Optional[str]:
    """Why the library cannot be built here (no g++, or which headers the
    preprocessor does not find), or None."""
    if shutil.which("g++") is None:
        return "g++ not found on PATH"
    missing = [h for h in headers if subprocess.run(
        ["g++", "-E", "-x", "c++", "-", "-o", os.devnull], input=f"#include <{h}>\n",
        capture_output=True, text=True, timeout=60).returncode != 0]
    return f"headers not found: {', '.join(missing)}" if missing else None


class HostLibrary:
    """One shared library from `sources` (file names in native/), linked
    with `libs`, its entry points declared by `declare(lib)`."""

    def __init__(self, name: str, sources: Sequence[str], declare: Callable,
                 libs: Sequence[str] = (), headers: Sequence[str] = ()):
        self.name, self.declare = name, declare
        self.sources = tuple(os.path.join(NATIVE_DIR, s) for s in sources)
        self.libs, self.headers = tuple(libs), tuple(headers)
        self.path = os.path.join(BUILD_DIR, f"libistpu_{name}-{host_key()}.so")
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self._error: Optional[Exception] = None

    def _stale(self) -> bool:
        if not os.path.exists(self.path):
            return True
        built = os.path.getmtime(self.path)
        return any(os.path.getmtime(s) > built for s in self.sources)

    def _compile(self) -> float:
        """g++ into a temporary file, then os.replace; the caller holds
        the directory lock. Returns the seconds the compiler took."""
        why = missing_prerequisites(self.headers)
        if why is not None:
            raise Unavailable(f"host library {self.name}: {why}")
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
        os.close(fd)
        cmd = ["g++", *CXX_FLAGS, *self.sources, *(f"-l{l}" for l in self.libs), "-o", tmp]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise HostBuildError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                                     f"{proc.stderr}")
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return time.perf_counter() - t0

    def _locked(self, fn):
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                return fn()
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)

    def build(self) -> float:
        """Compile now, whether or not a current library exists (a process
        that has it loaded keeps its mapping). Returns the compile seconds."""
        return self._locked(self._compile)

    def load(self) -> ctypes.CDLL:
        """The library, built first if it is missing or stale. Raises
        `Unavailable` or `HostBuildError` (again on every call, without
        compiling again)."""
        with self._lock:
            if self._lib is None and self._error is None:
                try:
                    self._locked(lambda: self._stale() and self._compile())
                    lib = ctypes.CDLL(self.path)
                    self.declare(lib)
                    self._lib = lib
                except (Unavailable, HostBuildError) as e:
                    self._error = e
                except OSError as e:
                    self._error = HostBuildError(f"loading {self.path}: {e}")
            if self._error is not None:
                raise self._error
            return self._lib

    def available(self) -> bool:
        """True once loaded; False when the host lacks what it needs; any
        other failure raises."""
        try:
            self.load()
        except Unavailable:
            return False
        return True

    def unavailable_reason(self) -> Optional[str]:
        return str(self._error) if isinstance(self._error, Unavailable) else None
