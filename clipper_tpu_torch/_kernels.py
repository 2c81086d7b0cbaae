"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file (with the ``csrc/*.cuh`` headers it includes) is
compiled at first use by its own ``nvcc`` into a shared library with a
plain C interface under ``build/clipper_tpu_torch/``
(listed in .gitignore) and loaded with ``ctypes``. Every C entry point
launches on the caller's stream and returns ``cudaGetLastError()``;
:func:`check` raises on a non-zero code. ``LAUNCHES`` counts kernel launches
per wrapper, so a run can show which kernels its main path went through.

Nothing here runs at import time: the CPU tests import every module, on
hosts that may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "clipper_tpu_torch"
CUDA_BIN = "/usr/local/cuda/bin"     # the toolkit's default install

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_COMMON = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v"]
# per-source extra flags: the build kernels must not contract a*b+c into
# FMAs, which would change the roundings that decide their int8 codes
SOURCES: Dict[str, list] = {
    "tri_matvec": [],
    "tri_build": ["--fmad=false"],
    "sym_rows_matvec": [],
    "stored_build": ["--fmad=false"],
    "pattern_matvec": [],
    "sym_tiles_matvec": [],
    "affinity_build": ["--fmad=false"],
    "tri_build_fused": ["--fmad=false"],
    "tri_tiles_matvec": [],
    "build_probe": ["--fmad=false"],
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_D = ctypes.c_double
# a build kernel's score: kind, its four parameters, affinityeps
_SCORE = [_I, _D, _D, _D, _D, _D]
# the capacity kernels' storage view (pointer, rows, columns), unit plan
# (entries, units, fslots, units, red_off, red_slots, slots), U, out and
# workspace; then K, nt, t, raw
_UNITS = [_P, _LL, _LL, _P, _P, _P, _I, _P, _P, _I, _P, _P, _P]
_SIGNATURES = {
    "tri_matvec_int8": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _LL, _F, _P],
    "tri_matvec_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _LL, _P],
    "tri_matvec_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _LL, _P],
    "tri_matvec_f64": [_P, _P, _P, _P, _I, _I, _I, _I, _LL, _P],
    "tri_build_int8": [_P, _P, _P, _P, _P, _I, _I, _I, _LL, *_SCORE, _P],
    "tri_build_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _LL, *_SCORE, _P],
    "tri_build_fused_int8": [_P, _P, _P, _P, _P, _I, _I, _I, _LL, *_SCORE,
                             _P],
    "tri_build_fused_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _LL, *_SCORE,
                             _P],
    "affinity_build_f32": [_P, _P, _P, _P, _P, _I, *_SCORE, _P],
    "affinity_build_f64": [_P, _P, _P, _P, _P, _I, *_SCORE, _P],
    "tri_tiles_matvec_int8": [_P, _P, _P, _P, _I, _I, _I, _F, _P],
    "tri_tiles_matvec_bf16": [_P, _P, _P, _P, _I, _I, _I, _P],
    "tri_tiles_matvec_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
    "tri_tiles_matvec_f64": [_P, _P, _P, _P, _I, _I, _I, _P],
    "sym_rows_matvec_int8": [*_UNITS, _I, _I, _I, _I, _F, _P],
    "sym_rows_matvec_bf16": [*_UNITS, _I, _I, _I, _I, _P],
    "sym_rows_matvec_f32": [_P, _P, _P, _I, _I, _I, _I, _LL, _LL, _I, _P],
    "sym_rows_matvec_f64": [_P, _P, _P, _I, _I, _I, _I, _LL, _LL, _I, _P],
    "sym_tiles_matvec_int8": [*_UNITS, _I, _I, _I, _I, _F, _P],
    "sym_tiles_matvec_bf16": [*_UNITS, _I, _I, _I, _I, _P],
    "sym_tiles_matvec_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "sym_tiles_matvec_f64": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "stored_build_int8": [_P, _P, _P, _P, _P, _I, _I, *_SCORE, _P],
    "stored_build_bf16": [_P, _P, _P, _P, _P, _I, _I, *_SCORE, _P],
    "pattern_matvec_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
    "pattern_matvec_bf16": [_P, _P, _P, _P, _I, _I, _I, _P],
    "build_probe_int8": [_I, _P, _P, _P, _P, _P, _I, _I, _D, _D, _D, _P],
}

# the capacity matvecs' second kernel (the fixed-order reduction of their
# int8 / bf16 unit pass), counted under its own key
REDUCTIONS: Dict[str, str] = {"sym_rows_matvec": "sym_rows_reduce",
                              "sym_tiles_matvec": "sym_tiles_reduce"}
LAUNCHES: Dict[str, int] = {name: 0 for name in (*SOURCES,
                                                 *REDUCTIONS.values())}
BUILD_LOG: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or shutil.which("nvcc", path=CUDA_BIN)
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           f"toolkit (on PATH or in {CUDA_BIN})")
    return nvcc


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    flags = " ".join(_ARCH + _COMMON + SOURCES[name]).encode()
    digest = hashlib.sha1(src + headers + flags).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all() -> float:
    """Compile every source that has no up-to-date library, one nvcc per
    source, all started together. Returns the wall seconds taken."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, extra in SOURCES.items():
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_ARCH, *_COMMON, *extra, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        BUILD_LOG[name] = log
        if p.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {p.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    if name not in _LIBS:
        if not _target(name).exists():
            build_all()
        so = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in _SIGNATURES.items():
            if hasattr(so, fn):
                getattr(so, fn).argtypes = argtypes
                getattr(so, fn).restype = ctypes.c_int
        _LIBS[name] = so
    return _LIBS[name]


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {code}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
