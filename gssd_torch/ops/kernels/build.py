"""Build the port's CUDA sources with nvcc at first use and bind them
with ctypes.

Each ``gssd_torch/csrc/*.cu`` file has a plain C interface and compiles
on its own into ``gssd_torch/_build/<name>_<source hash>.so``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <so> <source>

A changed source, or a changed shared header (``csrc/*.cuh``), gets a
new hash and is rebuilt. ``build`` starts one
nvcc per missing library, all at once, and raises if any fails: there
is no fallback. It holds a lock on the build directory while it builds
(``gssd_torch.native.build.dir_lock``), so that processes starting at
once (the ranks of a data-parallel run) build each library once. The ptxas report (registers, shared memory, spills) is
kept beside each library as ``<so>.log``.

A ``CudaKernel`` owns one exported C function. The function takes
device pointers, sizes and a stream and returns the launch's CUDA error
code; ``launch`` raises on a non-zero code and otherwise adds one to
``launches``, the count a run reads to show which kernels it went
through.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence

from gssd_torch.native.build import dir_lock

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


class CudaKernel:
    """One C entry point of one ``csrc`` source, loaded on first launch."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._err = None

    @property
    def source_path(self) -> str:
        return os.path.join(CSRC, self.source)

    def library_path(self) -> str:
        h = hashlib.sha256()
        for path in [self.source_path] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
            with open(path, "rb") as f:
                h.update(f.read())
        digest = h.hexdigest()[:16]
        stem = os.path.splitext(self.source)[0]
        return os.path.join(BUILD_DIR, f"{stem}_{digest}.so")

    def _load(self):
        if self._fn is None:
            path = self.library_path()
            build([self])
            lib = ctypes.CDLL(path)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes + [ctypes.c_void_p]  # + stream
            fn.restype = ctypes.c_int
            err = getattr(lib, self.symbol + "_error")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib, self._fn, self._err = lib, fn, err
        return self._fn

    def query(self, name: str, *ints: int) -> int:
        """The library's host function ``<symbol>_<name>``: ints in, a
        long out (such as the scratch a launch at these sizes takes)."""
        self._load()
        fn = getattr(self._lib, f"{self.symbol}_{name}")
        fn.argtypes = [ctypes.c_int] * len(ints)
        fn.restype = ctypes.c_long
        return fn(*ints)

    def launch(self, stream: int, *args) -> None:
        """Call the kernel on ``stream`` (a cudaStream_t as int); raise
        if the launch was refused."""
        code = self._load()(*args, stream)
        if code != 0:
            raise RuntimeError(
                f"{self.symbol}: CUDA error {code} "
                f"({self._err(code).decode()})")
        self.launches += 1


def build(kernels: Iterable[CudaKernel]) -> Dict[str, float]:
    """Compile every missing library among ``kernels`` in parallel, one
    nvcc process per source. Returns {source: build seconds} for the
    libraries built now (already built ones are absent)."""
    kernels = list(kernels)
    with _LOCK:
        if all(os.path.exists(k.library_path()) for k in kernels):
            return {}
        with dir_lock(BUILD_DIR):
            return _build_missing(kernels)


def _build_missing(kernels: List[CudaKernel]) -> Dict[str, float]:
    """``build``'s work, under its locks."""
    todo: Dict[str, CudaKernel] = {}
    for k in kernels:
        if not os.path.exists(k.library_path()):
            todo.setdefault(k.library_path(), k)
    if not todo:
        return {}
    nvcc = _nvcc()
    procs: List = []
    t0 = time.perf_counter()
    for so, k in todo.items():
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, k.source_path]
        procs.append((so, tmp, k, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    times: Dict[str, float] = {}
    failed: Optional[str] = None
    for so, tmp, k, proc in procs:
        log, _ = proc.communicate()
        times[k.source] = time.perf_counter() - t0
        text = log.decode(errors="replace")
        if proc.returncode != 0:
            failed = failed or f"nvcc failed on {k.source}:\n{text}"
            continue
        with open(so + ".log", "w") as f:
            f.write(text)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError(failed)
    return times
