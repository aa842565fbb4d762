"""Build the port's host library with g++ at first use and bind it with
ctypes.

The C++ sources of this directory (``pixellink_cc.cpp``,
``eval_sweep.cpp``) compile together into one library,
``gssd_torch/_build/libgssd_native_<source hash>.so``:

    g++ -O2 -shared -fPIC -ffp-contract=off -std=c++17 -o <so> <sources>

No ``-march=native`` and no fast-math, and no product fused into a sum,
so that float arithmetic is numpy's. The compiler is ``$CXX``, else the
``g++`` on the PATH. The library is written under a temporary name and
moved into place, under a lock on the build directory (``dir_lock``),
so that processes starting at once (pytest-xdist workers, the ranks of
a data-parallel run) build it once. This module imports nothing of the
package, so that it can be loaded on its own. A failed build raises: the callers have
no fallback unless they ask for the numpy version by name.

A ``NativeFunction`` owns one exported C function; each call adds one to
its ``calls``, the count a run reads to show that it went through C++.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional, Sequence

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = ("pixellink_cc.cpp", "eval_sweep.cpp")
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-ffp-contract=off", "-std=c++17"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


@contextlib.contextmanager
def dir_lock(path: str):
    """Hold an exclusive ``flock`` on the directory ``path`` (made if
    missing) for the block: one process of any number at a time, with no
    lock file left behind; released when the block ends or the process
    dies."""
    os.makedirs(path, exist_ok=True)
    fd = os.open(path, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)


def compiler() -> str:
    """The C++ compiler: ``$CXX``, else ``g++`` on the PATH."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler: set CXX or put g++ on the PATH")
    return cxx


def compiler_version() -> str:
    """The first line of the compiler's ``--version``."""
    out = subprocess.run([compiler(), "--version"], capture_output=True, text=True, check=True)
    return out.stdout.splitlines()[0]


def library_path() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(_HERE, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libgssd_native_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless it is there; returns its path."""
    so = library_path()
    if os.path.exists(so):
        return so
    with dir_lock(BUILD_DIR):
        if os.path.exists(so):
            return so
        tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [compiler(), *CXX_FLAGS, "-o", tmp, *(os.path.join(_HERE, s) for s in SOURCES)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"native build failed ({' '.join(cmd)}):\n{res.stderr}")
        os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """The library, built at the first call and loaded once a process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = ctypes.CDLL(build())
        return _LIB


_P = ctypes.POINTER


class NativeFunction:
    """One C entry point of the library, bound at its first call."""

    def __init__(self, symbol: str, restype, argtypes: Sequence):
        self.symbol = symbol
        self.restype = restype
        self.argtypes = list(argtypes)
        self.calls = 0
        self._fn = None

    def __call__(self, *args):
        if self._fn is None:
            fn = getattr(load(), self.symbol)
            fn.restype, fn.argtypes = self.restype, self.argtypes
            self._fn = fn
        out = self._fn(*args)
        self.calls += 1
        return out


NATIVE: Dict[str, NativeFunction] = {
    "pixellink_components": NativeFunction(
        "pixellink_components", ctypes.c_int32,
        [_P(ctypes.c_uint8), _P(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
         _P(ctypes.c_int32)]),
    "pixellink_boxes": NativeFunction(
        "pixellink_boxes", ctypes.c_int32,
        [_P(ctypes.c_int32), _P(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
         ctypes.c_double, ctypes.c_double, _P(ctypes.c_double), _P(ctypes.c_double)]),
    "eval_sweep": NativeFunction(
        "eval_sweep", None,
        [_P(ctypes.c_double), ctypes.c_int64, _P(ctypes.c_int64), ctypes.c_int64,
         _P(ctypes.c_double), ctypes.c_double, ctypes.c_int32, _P(ctypes.c_uint8),
         _P(ctypes.c_uint8)]),
}


IMPLS = ("native", "numpy")


def check_impl(impl: str) -> None:
    """A caller's choice between the C++ function ("native") and its numpy
    plain version ("numpy")."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r}: one of {IMPLS}")


def ptr(a, ctype):
    """A ctypes pointer to the data of the contiguous array ``a``."""
    return a.ctypes.data_as(_P(ctype))
