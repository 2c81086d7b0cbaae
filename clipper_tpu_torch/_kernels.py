"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file (with the ``csrc/*.cuh`` headers it includes) is
compiled at first use by its own ``nvcc`` into a shared library with a
plain C interface under ``build/clipper_tpu_torch/``
(listed in .gitignore) and loaded with ``ctypes``. Every C entry point
launches on the caller's stream and returns ``cudaGetLastError()``;
:func:`check` raises on a non-zero code. ``LAUNCHES`` counts kernel launches
per wrapper, so a run can show which kernels its main path went through.

An invariant's own device score (invariants.DeviceScore) gets a library
of its own, compiled at first use from a ``.cu`` that :func:`user_source`
writes around the score's source (csrc/user_score.cuh): the build
kernels 2, 8, 4 and 6 over that score, their launches counted under
``route_key(kernel, "user")``.

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
from typing import Dict, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "clipper_tpu_torch"
CUDA_BIN = "/usr/local/cuda/bin"     # the toolkit's default install

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_COMMON = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v"]
# per-source extra flags: the build kernels must not contract a*b+c into
# FMAs, which would change the roundings that decide their int8 codes;
# nor the dense PGA kernel, whose elementwise steps round as the host
# loop's separate operations do
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
    "pga_dense": ["--fmad=false"],
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_D = ctypes.c_double
_IP = ctypes.POINTER(ctypes.c_int)   # a route the entry reports (ROUTES)
# a build kernel's score: kind, its four parameters, affinityeps
_SCORE = [_I, _D, _D, _D, _D, _D]
# the capacity kernels' storage view (pointer, rows, columns), unit plan
# (entries, units, fslots, units, red_off, red_slots, slots), U, out and
# workspace; then K, nt, t, raw
_UNITS = [_P, _LL, _LL, _P, _P, _P, _I, _P, _P, _I, _P, _P, _P]
# their CUDA-core route's storage (pointer, row length), plan (entries,
# units, fslots, units, the unit's rows, red_off, red_slots, slots), U,
# out and workspace; then K, nt, t, raw
_CORE = [_P, _LL, _P, _P, _P, _I, _I, _P, _P, _I, _P, _P, _P]
_SIGNATURES = {
    "tri_matvec_int8": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _LL, _F, _P,
                        _IP],
    "tri_matvec_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _LL, _P, _IP],
    "tri_matvec_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _LL, _P],
    "tri_matvec_f64": [_P, _P, _P, _P, _I, _I, _I, _I, _LL, _P],
    "tri_build_int8": [_P, _P, _P, _P, _P, _I, _I, _I, _LL, *_SCORE, _P],
    "tri_build_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _LL, *_SCORE, _P],
    "tri_build_fused_int8": [_P, _P, _P, _P, _P, _I, _I, _I, _LL, *_SCORE,
                             _P],
    "tri_build_fused_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _LL, *_SCORE,
                             _P],
    "tri_build_fused_whole": [_I, _I, _I],
    "affinity_build_f32": [_P, _P, _P, _P, _P, _I, *_SCORE, _P],
    "affinity_build_f64": [_P, _P, _P, _P, _P, _I, *_SCORE, _P],
    "tri_tiles_matvec_int8": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _IP],
    "tri_tiles_matvec_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _IP],
    "tri_tiles_matvec_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
    "tri_tiles_matvec_f64": [_P, _P, _P, _P, _I, _I, _I, _P],
    "sym_rows_matvec_int8": [*_UNITS, _I, _I, _I, _I, _F, _P],
    "sym_rows_matvec_bf16": [*_UNITS, _I, _I, _I, _I, _P],
    "sym_rows_matvec_sub_int8": [*_UNITS[:10], _P, _I, *_UNITS[10:], _I, _I,
                                 _I, _I, _F, _P],
    "sym_rows_matvec_sub_bf16": [*_UNITS[:10], _P, _I, *_UNITS[10:], _I, _I,
                                 _I, _I, _P],
    "sym_rows_matvec_core_int8": [*_CORE, _I, _I, _I, _I, _F, _P],
    "sym_rows_matvec_core_bf16": [*_CORE, _I, _I, _I, _I, _P],
    "sym_rows_matvec_core_f32": [*_CORE, _I, _I, _I, _I, _P],
    "sym_rows_matvec_core_f64": [*_CORE, _I, _I, _I, _I, _P],
    "sym_tiles_matvec_int8": [*_UNITS, _I, _I, _I, _I, _F, _P],
    "sym_tiles_matvec_bf16": [*_UNITS, _I, _I, _I, _I, _P],
    "sym_tiles_matvec_sub_int8": [*_UNITS[:10], _P, _I, *_UNITS[10:], _I,
                                  _I, _I, _I, _F, _P],
    "sym_tiles_matvec_sub_bf16": [*_UNITS[:10], _P, _I, *_UNITS[10:], _I,
                                  _I, _I, _I, _P],
    "sym_tiles_matvec_core_int8": [*_CORE, _I, _I, _I, _I, _F, _P],
    "sym_tiles_matvec_core_bf16": [*_CORE, _I, _I, _I, _I, _P],
    "sym_tiles_matvec_core_f32": [*_CORE, _I, _I, _I, _I, _P],
    "sym_tiles_matvec_core_f64": [*_CORE, _I, _I, _I, _I, _P],
    "stored_build_int8": [_P, _P, _P, _P, _P, _I, _I, *_SCORE, _P],
    "stored_build_bf16": [_P, _P, _P, _P, _P, _I, _I, *_SCORE, _P],
    "pattern_matvec_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
    "pattern_matvec_bf16": [_P, _P, _P, _P, _I, _I, _I, _P],
    "build_probe_int8": [_I, _P, _P, _P, _P, _P, _I, _I, _D, _D, _D, _P],
    # M, C, u0, Md, vec, part, u, F, ints; m, grid, maxoliters,
    # maxiniters, maxlsiters; beta, eps, tol_u, tol_F, the two floors;
    # rescale_u0, fuse_md, stall_outers; the stream
    **{f"pga_dense_{n}": [*[_P] * 9, *[_I] * 5, *[_D] * 6, _I, _I, _I, _P]
       for n in ("f32", "f64")},
    "pga_dense_grid": [_I, _I, _IP, _IP],
}
# a device score's library: the entries of the build kernels it takes,
# each with the built-in entry's arguments
USER_KERNELS = ("tri_build", "tri_build_fused", "stored_build",
                "affinity_build")
# the flags of a device score's library beside _ARCH and _COMMON (the
# build kernels' own: no FMA contraction)
_USER_FLAGS = ["--fmad=false"]

# the capacity matvecs' second kernel (the fixed-order reduction of their
# int8 / bf16 unit pass), counted under its own key
REDUCTIONS: Dict[str, str] = {"sym_rows_matvec": "sym_rows_reduce",
                              "sym_tiles_matvec": "sym_tiles_reduce"}
# the routes an entry with a route argument reports, by its value
# (csrc/tri_matvec_mma.cuh: kRouteMma, kRouteCore, kRouteSuper)
ROUTES = ("mma", "core", "super")
# the routes of the kernels that have more than one, beside each
# kernel's primary routes ("mma", "units", "float"): the matvecs' int8 /
# bf16 CUDA-core route ("core") and kernels 1 and 9's super-tiles
# ("super"; ops/flattri.matvec_route, ops/symstore.matvec_route), and the
# builds over an invariant's own device score ("user")
ROUTED: Dict[str, Tuple[str, ...]] = {
    "tri_matvec": ("core", "super"), "tri_tiles_matvec": ("core", "super"),
    "sym_rows_matvec": ("core",), "sym_tiles_matvec": ("core",),
    # the build kernels over a device score's library
    **{k: ("user",) for k in USER_KERNELS}}
_PRIMARY = ("mma", "units", "float")


def route_key(kernel: str, route: str) -> str:
    """The ``LAUNCHES`` key of a launch of ``kernel`` by ``route``:
    ``kernel`` for its primary routes ("mma", "units", "float"),
    ``f"{kernel}_{route}"`` for the others (``ROUTED``)."""
    return kernel if route in _PRIMARY else f"{kernel}_{route}"


LAUNCHES: Dict[str, int] = {name: 0 for name in (
    *SOURCES, *REDUCTIONS.values(),
    *(route_key(k, r) for k, rs in ROUTED.items() for r in rs))}
BUILD_LOG: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_USER_LIBS: Dict[tuple, ctypes.CDLL] = {}


def call_routed(fn, what: str, *args) -> str:
    """Call the C entry ``fn`` on ``args`` and its route argument, check
    its code and return the route it took (``ROUTES``)."""
    route = ctypes.c_int(-1)
    check(fn(*args, ctypes.byref(route)), what)
    return ROUTES[route.value]


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


def _compile(jobs: Dict[str, Tuple[list, Path, Path]]) -> None:
    """Run the nvcc commands of ``jobs`` (name -> (command writing tmp,
    tmp, out)) all at once and rename each tmp to its out (processes that
    build one library at once each get a whole one); raise with the log
    of every one that failed."""
    procs = {name: (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out) for name, (cmd, tmp, out) in jobs.items()}
    failed = []
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        BUILD_LOG[name] = log
        if p.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"--- {name} (nvcc exit {p.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def build_all(scores=()) -> float:
    """Compile every source that has no up-to-date library, and the
    library of each device score in ``scores`` that has none
    (:func:`user_lib`), one nvcc per library, all started together.
    Returns the wall seconds taken."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, extra in SOURCES.items():
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        jobs[name] = ([_nvcc(), *_ARCH, *_COMMON, *extra, "-o", str(tmp),
                       str(CSRC / f"{name}.cu")], tmp, out)
    for score in scores:
        if not user_target(score).exists():
            jobs.update([_user_job(score)])
    _compile(jobs)
    return time.perf_counter() - t0


def _load(path: Path) -> ctypes.CDLL:
    so = ctypes.CDLL(str(path))
    for fn, argtypes in _SIGNATURES.items():
        if hasattr(so, fn):
            getattr(so, fn).argtypes = argtypes
            getattr(so, fn).restype = ctypes.c_int
    return so


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    if name not in _LIBS:
        if not _target(name).exists():
            build_all()
        _LIBS[name] = _load(_target(name))
    return _LIBS[name]


# the entries of a device score's library, around the launch templates
# of the four builds (csrc/tri_build.cuh, tri_build_fused.cuh,
# stored_pair_build.cuh, affinity_build.cuh): (the built-in entry's
# name, its arguments before the score's, the launch call)
_TRI_ARGS = ("const void* P1, const void* P2, const void* A, "
             "const void* m_trues, void* out, int W, int m, int t, "
             "long long S")
_USER_ENTRIES = (
    *((f"tri_build_{n}", _TRI_ARGS,
       f"tri_build_run<{T}, UserScore<float>>(p, P1, P2, A, m_trues, out, "
       "W, m, t, S, affeps, stream)") for n, T in (("int8", "int8_t"),
                                                   ("bf16", "__nv_bfloat16"))),
    *((f"tri_build_fused_{n}", _TRI_ARGS,
       f"tri_build_fused_run<{T}, UserScore<float>>(p, P1, P2, A, m_trues, "
       "out, W, m, t, S, affeps, stream)")
      for n, T in (("int8", "int8_t"), ("bf16", "__nv_bfloat16"))),
    *((f"stored_build_{n}", "const void* P1, const void* P2, const void* A, "
       "const void* m_trues, void* out, int W, int m",
       f"stored_build_run<{T}, UserScore<float>>(p, P1, P2, A, m_trues, "
       "out, W, m, affeps, (cudaStream_t)stream)")
      for n, T in (("int8", "int8_t"), ("bf16", "__nv_bfloat16"))),
    *((f"affinity_build_{n}", "const void* P1, const void* P2, "
       "const void* A, void* M, void* C, int m",
       f"affinity_build_run<{T}, UserScore>(p, P1, P2, A, M, C, m, affeps, "
       "stream)") for n, T in (("f32", "float"), ("f64", "double"))),
)
_SIGNATURES.update({f"user_{name}": _SIGNATURES[name]
                    for name, _, _ in _USER_ENTRIES})


def record_bytes(score) -> int:
    """Bytes of one row's endpoint record in the pair body of kernels 2, 8
    and 6 in f32 (csrc/tri_pair_build.cuh: Ends) for a score
    (invariants.device_score): 64 for the point-normal score's split
    record (kind 1), else 2 d + 2 values (set 1's, set 2's, the two ids)
    padded to 16 bytes: 32 for the Euclidean score."""
    if score.kind == 1:
        return 64
    return -(-(2 * score.d + 2) // 4) * 16


def user_source(score) -> str:
    """The ``.cu`` of a device score's library (invariants.DeviceScore):
    csrc/user_score.cuh, the score's source, the four builds' launch
    templates and the entries ``user_<entry>`` of the built-in entries
    of kernels 2, 8, 4 and 6 (USER_KERNELS), which take the score's kind
    (invariants.USER_KIND) only. It checks the score's D and its record's
    bytes (:func:`record_bytes`) as it compiles."""
    entries = "\n".join(
        f"int user_{name}({args}, int kind, double p0, double p1, "
        "double p2, double p3, double affeps, void* stream) {\n"
        "  const double p[4] = {p0, p1, p2, p3};\n"
        "  if (kind != kUserKind) return (int)cudaErrorInvalidValue;\n"
        f"  return {call};\n}}\n"
        for name, args, call in _USER_ENTRIES)
    return (
        "// The build kernels 2, 8, 4 and 6 over one invariant's device\n"
        "// score (csrc/user_score.cuh), written by\n"
        "// clipper_tpu_torch._kernels.user_source.\n\n"
        "#include <cuda_bf16.h>\n#include <cuda_runtime.h>\n"
        "#include <stdint.h>\n\n#include \"user_score.cuh\"\n\n"
        "// --- the invariant's source ---\n"
        f"{score.source.rstrip()}\n"
        "// --- end of the invariant's source ---\n\n"
        "#include \"affinity_build.cuh\"\n"
        "#include \"stored_pair_build.cuh\"\n"
        "#include \"tri_build.cuh\"\n"
        "#include \"tri_build_fused.cuh\"\n\n"
        f"static_assert(Score<float>::D == {int(score.d)}, "
        "\"the device score's d\");\n"
        "static_assert(Ends<UserScore<float>>::kVals * sizeof(float) == "
        f"{record_bytes(score)}, \"the record _kernels.record_bytes "
        "gives\");\n\n"
        f"extern \"C\" {{\n\n{entries}\n}}  // extern \"C\"\n")


def _user_flags() -> list:
    return _ARCH + _COMMON + _USER_FLAGS


def user_target(score) -> Path:
    """The library of a device score under BUILD_DIR, keyed by the SHA-1
    of its ``.cu`` text, the headers and the flags (as :func:`_target`)."""
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(user_source(score).encode() + headers + " ".join(
        _user_flags()).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libuser_score-{digest}.so"


def user_command(score, out: Path) -> list:
    """nvcc's command for a device score's library into ``out``: the
    build kernels' flags, csrc/ on the include path."""
    cu = user_target(score).with_suffix(".cu")
    return [_nvcc(), *_user_flags(), "-I", str(CSRC), "-o", str(out),
            str(cu)]


def _user_job(score):
    """(name, (nvcc's command, tmp, out)) of a device score's library:
    its ``.cu`` written beside it first."""
    out = user_target(score)
    cu = out.with_suffix(".cu")
    tmp_cu = cu.with_suffix(f".{os.getpid()}.cu.tmp")
    tmp_cu.write_text(user_source(score))
    os.replace(tmp_cu, cu)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    return out.stem, (user_command(score, tmp), tmp, out)


def build_user(score) -> Optional[float]:
    """Compile a device score's library where it is not on disk. Returns
    nvcc's wall seconds, or None where the library was on disk (no nvcc
    ran). Raises with nvcc's log where it fails: nothing falls back to
    the plain build."""
    if user_target(score).exists():
        return None
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    _compile(dict([_user_job(score)]))
    return time.perf_counter() - t0


def user_lib(score) -> ctypes.CDLL:
    """The loaded library of a device score, built first if needed; later
    calls find it by the score itself (its key reads every header: ~2 ms,
    more than a launch)."""
    if score not in _USER_LIBS:
        build_user(score)
        _USER_LIBS[score] = _load(user_target(score))
    return _USER_LIBS[score]


def score_entry(kernel: str, suffix: str, score):
    """(the C entry, its LAUNCHES key) of build ``kernel`` (USER_KERNELS)
    for storage or value type ``suffix`` and a score
    (invariants.device_score): the built-in library's
    ``<kernel>_<suffix>``, counted under ``kernel``, or a device score's
    ``user_<kernel>_<suffix>``, counted under ``route_key(kernel,
    "user")``."""
    if getattr(score, "source", None) is None:
        return getattr(lib(kernel), f"{kernel}_{suffix}"), kernel
    return (getattr(user_lib(score), f"user_{kernel}_{suffix}"),
            route_key(kernel, "user"))


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {code}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
