"""Build and load the port's host-side native library.

The C++ sources of this directory (``dsd.cpp``, ``maxclique.cpp``,
``plyio.cpp``: the port's own copies of the JAX package's
``clipper_tpu/native/``, same code and C interface) are compiled by one
``g++`` into one shared library under ``build/clipper_tpu_torch/`` (listed
in .gitignore) at first use, and again whenever a source is newer than the
library, then loaded with ``ctypes`` with every entry point's signature
declared.

A failed build raises: no caller has another path to fall back to. Test
workers may load at the same time, so the check and the build run under an
exclusive file lock beside the library, and the compiler writes a
temporary name that ``os.replace`` moves into place.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from clipper_tpu_torch._kernels import BUILD_DIR

SRC_DIR = Path(__file__).resolve().parent
SOURCES = ("dsd.cpp", "maxclique.cpp", "plyio.cpp")
LIB = BUILD_DIR / "libclipper_native.so"
_LOCK_FILE = BUILD_DIR / "libclipper_native.lock"
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-march=native",
          "-pthread"]

_i64p = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "dsd_solve": (ctypes.c_double, [
        ctypes.c_int64, ctypes.c_int64, _i64p,
        ctypes.POINTER(ctypes.c_double), _i64p, _i64p]),
    "mc_solve": (ctypes.c_int64, [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.c_double, ctypes.c_int64, _i64p]),
    "mc_core_numbers": (ctypes.c_int64, [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8), _i64p]),
    "clipper_ply_vertex_count": (ctypes.c_longlong, [ctypes.c_char_p]),
    "clipper_ply_read_xyz": (ctypes.c_int, [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_longlong]),
}

_THREAD_LOCK = threading.Lock()
_CACHED: Optional[ctypes.CDLL] = None


def needs_build(lib: Path = LIB) -> bool:
    """True when ``lib`` is missing or older than any source."""
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any((SRC_DIR / s).stat().st_mtime > built for s in SOURCES)


def build(lib: Path = LIB) -> Path:
    """Compile every source into ``lib``; raises RuntimeError with the
    compiler's output when it fails."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, *(str(SRC_DIR / s) for s in SOURCES), "-o",
           str(tmp)]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"native build: g++ not found ({e})") from e
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed (g++ exit {out.returncode})"
                           f":\n{out.stderr}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The native library, built first when :func:`needs_build` says so."""
    global _CACHED
    with _THREAD_LOCK:
        if _CACHED is None:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with open(_LOCK_FILE, "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                try:
                    if needs_build():
                        build()
                    so = ctypes.CDLL(str(LIB))
                finally:
                    fcntl.flock(lock, fcntl.LOCK_UN)
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.restype, fn.argtypes = restype, argtypes
            _CACHED = so
        return _CACHED
