"""The port's kernels beside their builds from another checkout, on the card.

Builds csrc/tri_matvec.cu (kernel 1's float kinds),
csrc/tri_tiles_matvec.cu (kernel 9), the capacity matvecs'
sym_rows_matvec.cu (kernel 3) and sym_tiles_matvec.cu (kernel 7), and the
build kernels' sources, csrc/tri_build.cu (kernel 2), tri_build_fused.cu
(kernel 8), stored_build.cu (kernel 4), affinity_build.cu (kernel 6) and
build_probe.cu (kernel 10), from the sources of another checkout of the
repo at DIR (for example the parent commit unpacked with ``git
archive``) into build/clipper_tpu_torch/probe/parent_ab/, with the
package's flags, and times each beside the package's own build in one
process, in turns (parent, change, change, parent; each the mean of its
two turns), through the C entry points (no wrapper), which both trees
must share (but for the route argument, which an older checkout's
entries may lack: ``tri_matvec_probe.bind``):

- kernel 9 at B=128 and B=512 lanes, one probe a lane, int8 and bf16
  storage, on the tile-major form of P=512 random problems (m=1024,
  t=256, 10% of pairs kept): the parent's ms, the change's, kernel 1 at
  K=1 on the flat form of the same content, one ``torch.bmm`` over the
  dense bf16 [M; C] and the bound; whether the change's output is
  bit-equal to kernel 1's at K=1, and its max distance to the parent's;
- kernels 1 and 9 over f32 and f64 storage at t = 64, 100, 128 and 256
  (kernel 1 at K=16, kernel 9 at one probe a lane; B=128 distinct lanes
  of P=128 random problems, m=1024, 1000 at t=100): the parent's ms, the
  change's, the bound, ``torch.bmm`` over the dense [M; C] in the
  storage's type, whether the outputs are bit-equal and their max
  distance;
- kernels 1 and 9 in int8 and bf16 at every route (``route_rows``): t =
  16, 32, 48, 64, 100 (the routes "super" and "core") and 128, 384, 512
  ("mma") on phase 2's shapes of ``chip_smoke.py`` (W=16 bunny problems
  at m = t (2048 // t), rho=0.9, built by kernel 2; B=128 lanes, kernel 1
  at K=16, kernel 9 at one probe), and kernel 1 at the tri pool's
  ``tri_tile=64`` (the W=512, m=1024 main-path problems, B=128 distinct
  lanes, K=16): the parent's ms, the change's, the route each took, the
  bound, ``torch.bmm`` over the dense bf16 [M; C], the outputs' largest
  difference relative to their largest value (held to 1e-4 where the
  route changed, to bit equality where it did not), and kernel 9's bit
  equality with kernel 1 at K=1;
- kernels 3 and 7 in int8 at t=128 and t=256, K=16 and K=1, on one bunny
  problem at m=65,536 (rho=0.95, numpy default_rng(0); rows at G=32),
  with this tree's plan and workspace: the parent's ms, the change's, the
  bound and whether the outputs are bit-equal;
- kernels 3 and 7 where the other checkout's capacity matvecs ran a
  thread an output column (``capacity_tile_rows``): int8 at t=64
  (m=65,536) and t=100 (m=65,600), K=16 and 1, and the f32 / f64 kinds
  at t=128 (m=16,384, K=16), that checkout's kernel against this tree's
  route, with the speedup and the outputs' largest difference; and at
  t=100 (int8) and the f32 / f64 shapes, the library call beside them
  (``capacity_library_rows``: torch.matmul over the dense [M; C], K=16);
- kernels 2, 8 and 4 on the W=512, m=1024 problems of ``chip_smoke.py``'s
  main path (the bunny at rho=0.9 and the point-normal scans, both from
  numpy default_rng(0)), int8 and bf16 storage (kernels 2 and 8 at
  t=256): the parent's ms, the change's, the bound, whether the two
  outputs are byte-equal (and kernel 8's to kernel 2's), beside each
  problem set's survivor shares (``harness.gate_shares``: the shares of
  distinct pairs whose gate passes, whose tail runs, and, point-normal,
  that pass both gates);
- kernel 6 on one point-normal problem at m=5000 (rho=0.8) and one bunny
  problem at m=1024, f32 and f64, through the C entry (``chip_smoke.py``
  phase 6's ``entry_ms``), beside its bound;
- kernel 10's five variants on the build probe's inputs (B=512, m=1024),
  and the change's ``full`` beside kernel 4 (whose kernel it runs) on
  them, in turns, with whether the two are byte-equal.

- the tri pool end to end (``pool_rows``): ``make_pool_pipeline(
  layout="tri", tri_tile=t)`` at t = 64, 256, 512 on chip_smoke.py's
  W=512, m=1024 int8 main path, the other checkout's and this tree's in
  one process each, in turns (parent, change, change, parent, change,
  parent, parent, change): problems/s, each process's mean ms, and the
  tri kernels' launches of one call by key. ``--pool`` runs
  these rows alone.

Kernel 1 is compared first, by ``tri_matvec_probe.main(["--parent",
DIR])`` (its ablations and the parent's build, bit equality at its four
shapes). Run on a machine with the card:

    python -m clipper_tpu_torch.bench.parent_ab DIR [--pool]

It prints the card's name and power limit first and returns its rows.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np

from clipper_tpu_torch import _kernels
from clipper_tpu_torch.bench.tri_matvec_probe import bind, route_arg

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 67e12       # f64 products on the tensor cores (DMMA)
F64_SIMT_FLOPS = 34e12  # other f64 work, outside the tensor cores
BF16_FLOPS = 989e12
# kernels 1 and 9's tiles in route_rows, and the bar of a changed route:
# |change - parent| / max |parent|
ROUTE_TILES = (16, 32, 48, 64, 100, 128, 384, 512)
ROUTE_TOL = 1e-4
# f32 operations a pair of each score (chip_smoke.py's counts)
OPS_PER_PAIR = {"euclidean": 30, "pointnormal": 56}
# the sources built from the other checkout, and their entry points
_SOURCES = {
    "tri_matvec": ("tri_matvec_int8", "tri_matvec_bf16", "tri_matvec_f32",
                   "tri_matvec_f64"),
    "tri_tiles_matvec": ("tri_tiles_matvec_int8", "tri_tiles_matvec_bf16",
                         "tri_tiles_matvec_f32", "tri_tiles_matvec_f64"),
    "sym_rows_matvec": ("sym_rows_matvec_int8", "sym_rows_matvec_core_int8",
                        "sym_rows_matvec_f32", "sym_rows_matvec_f64"),
    "sym_tiles_matvec": ("sym_tiles_matvec_int8",
                         "sym_tiles_matvec_core_int8", "sym_tiles_matvec_f32",
                         "sym_tiles_matvec_f64"),
    "tri_build": ("tri_build_int8", "tri_build_bf16"),
    "tri_build_fused": ("tri_build_fused_int8", "tri_build_fused_bf16"),
    "stored_build": ("stored_build_int8", "stored_build_bf16"),
    "affinity_build": ("affinity_build_f32", "affinity_build_f64"),
    "build_probe": ("build_probe_int8",),
}


_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# the capacity matvecs' entries in a checkout before their CUDA-core route
# took the unit plan (a thread an output column, the walk from the closed
# form or tile_walks): recognised by their first arguments
_ROWS_WALK = [_P, _P, _P, _I, _I, _I, _I, _LL, _LL, _I]
_TILES_WALK = [_P, _P, _P, _P, _P, _I, _I, _I, _I]
_WALK_ENTRIES = {
    "sym_rows_matvec_core_int8": (
        "core_int8(const void* chunks, const void* U", [*_ROWS_WALK, _F, _P]),
    "sym_tiles_matvec_core_int8": (
        "core_int8(const void* tiles, const void* walks",
        [*_TILES_WALK, _F, _P]),
    "sym_rows_matvec_f32": ("matvec_f32(const void* chunks, const void* U",
                            [*_ROWS_WALK, _P]),
    "sym_rows_matvec_f64": ("matvec_f64(const void* chunks, const void* U",
                            [*_ROWS_WALK, _P]),
    "sym_tiles_matvec_f32": ("matvec_f32(const void* tiles, const void* walks",
                             [*_TILES_WALK, _P]),
    "sym_tiles_matvec_f64": ("matvec_f64(const void* tiles, const void* walks",
                             [*_TILES_WALK, _P]),
}


def build_parent(parent: str) -> Dict[str, ctypes.CDLL]:
    """Compile the other checkout's sources of ``_SOURCES``, one nvcc
    each, all started together; returns the loaded libraries, their entry
    points typed as this tree's."""
    csrc = Path(parent) / "clipper_tpu_torch" / "csrc"
    if not all((csrc / f"{cu}.cu").exists() for cu in _SOURCES):
        raise SystemExit(f"parent_ab: {csrc} lacks {sorted(_SOURCES)}")
    d = _kernels.BUILD_DIR / "probe" / "parent_ab"
    d.mkdir(parents=True, exist_ok=True)
    for p in csrc.glob("*.cu*"):
        (d / p.name).write_bytes(p.read_bytes())
    procs = {cu: subprocess.Popen(
        [_kernels._nvcc(), *_kernels._ARCH, *_kernels._COMMON,
         *_kernels.SOURCES[cu], "-o", str(d / f"lib{cu}.so"),
         str(d / f"{cu}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for cu in _SOURCES}
    libs = {}
    for cu, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"parent_ab: the parent's {cu} failed to "
                               f"build:\n{log}")
        lib = ctypes.CDLL(os.path.abspath(d / f"lib{cu}.so"))
        cu_src = (d / f"{cu}.cu").read_text()
        for fn in _SOURCES[cu]:
            if fn in _WALK_ENTRIES:
                if _WALK_ENTRIES[fn][0] in cu_src:
                    getattr(lib, fn).argtypes = _WALK_ENTRIES[fn][1]
                    getattr(lib, fn).restype = ctypes.c_int
                    lib.walk_core = True
            else:
                bind(lib, fn, cu_src)
        libs[cu] = lib
    return libs


def in_turns(parent, change, dev, reps):
    """(parent ms, change ms): parent, change, change, parent, each the
    mean of its two turns."""
    from clipper_tpu_torch.bench.harness import time_ms
    p0 = time_ms(parent, dev, reps)
    c0 = time_ms(change, dev, reps)
    c1 = time_ms(change, dev, reps)
    p1 = time_ms(parent, dev, reps)
    return (p0 + p1) / 2, (c0 + c1) / 2


def compare(label, parent, change, outs, dev, reps):
    """Run the parent's and the change's launch once each, check that
    they return 0 and whether their outputs (outs: a dict of "parent"
    and "change" tensor tuples) are byte-equal, then time them in turns.
    Returns (parent ms, change ms, equal)."""
    import torch
    _kernels.check(parent(), f"parent_ab {label} parent")
    _kernels.check(change(), f"parent_ab {label} change")
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b)
                for a, b in zip(outs["parent"], outs["change"]))
    p_ms, c_ms = in_turns(parent, change, dev, reps)
    return p_ms, c_ms, equal


def build_bound(out_bytes, W, m, d, kind):
    """The larger of a build's bytes (its output and its inputs) over the
    memory rate and its operations over the m (m - 1) / 2 distinct pairs
    a problem over the f32 peak, in ms."""
    n_bytes = out_bytes + 2 * W * m * d * 4 + W * m * 2 * 4 + W * 4
    n_ops = W * (m * (m - 1) // 2) * OPS_PER_PAIR[kind]
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS) * 1e3


def tiles_rows(parent_lib, dev) -> list:
    """Kernel 9, parent against change, beside kernel 1 at K=1."""
    import torch

    from clipper_tpu_torch.bench.harness import time_ms
    from clipper_tpu_torch.ops import flattri

    t, nt, P = 256, 4, 512
    m, T = t * nt, nt * (nt + 1) // 2
    S = flattri.tri_ncols(nt, t)
    gen = torch.Generator(device=dev).manual_seed(0)
    content = torch.rand(P, 2 * t, S, generator=gen, device=dev)
    content = torch.where(content > 0.9, content, 0.0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    k9 = _kernels.lib("tri_tiles_matvec")
    k1 = _kernels.lib("tri_matvec")
    rows = []
    for storage in (torch.int8, torch.bfloat16):
        flat = ((content * 127).round().to(torch.int8)
                if storage == torch.int8 else content.to(storage))
        tiles = flat.view(P, 2 * t, T, t).permute(0, 2, 1, 3).contiguous()
        int8 = storage == torch.int8
        for B in (128, 512):
            idx = torch.randperm(P, generator=gen, device=dev)[:B].to(
                torch.int32)
            U = torch.rand(B, m, generator=gen, device=dev).bfloat16()
            outs = {k: torch.empty(B, 2 * m, device=dev)
                    for k in ("parent", "change", "k1")}
            ptr = (tiles.data_ptr(), idx.data_ptr(), U.data_ptr())
            f9, f1 = (("tri_tiles_matvec_int8", "tri_matvec_int8") if int8
                      else ("tri_tiles_matvec_bf16", "tri_matvec_bf16"))
            sc = (1 / 127,) if int8 else ()

            def parent():
                return getattr(parent_lib, f9)(
                    *ptr, outs["parent"].data_ptr(), P, B, nt, t, *sc,
                    stream, *route_arg(parent_lib, f9))

            def change():
                return getattr(k9, f9)(
                    *ptr, outs["change"].data_ptr(), P, B, nt, t, *sc,
                    stream, *route_arg(k9, f9))

            def kernel1():
                return getattr(k1, f1)(
                    flat.data_ptr(), idx.data_ptr(), U.data_ptr(),
                    outs["k1"].data_ptr(), P, B, 1, nt, t, S, *sc, stream,
                    *route_arg(k1, f1))
            for name, fn in (("parent", parent), ("change", change),
                             ("kernel 1", kernel1)):
                _kernels.check(fn(), f"parent_ab kernel 9 {name}")
            torch.cuda.synchronize()
            p_ms, c_ms = in_turns(parent, change, dev, 50)
            dense = flattri.dense_stacked(flat[idx.long()], nt).to(
                torch.bfloat16)
            Ub = U[..., None]
            lib_ms = time_ms(lambda: torch.bmm(dense, Ub), dev, 20)
            del dense
            n_bytes = (B * T * 2 * t * t * tiles.element_size() + B * m * 2
                       + B * 2 * m * 4 + B * 4)
            n_ops = 2 * B * 2 * t * t * (2 * T - nt)
            row = dict(
                kernel="tri_tiles_matvec", storage=str(storage).split(".")[-1],
                B=B, parent_ms=p_ms, ms=c_ms,
                k1_ms=time_ms(kernel1, dev, 50), library_ms=lib_ms,
                bound_ms=max(n_bytes / HBM_BYTES_PER_S,
                             n_ops / BF16_FLOPS) * 1e3,
                equal_to_k1=bool(torch.equal(outs["change"], outs["k1"])),
                max_diff_parent=float((outs["change"] - outs["parent"])
                                      .abs().max()))
            rows.append(row)
            print(f"kernel 9 {row['storage']} B={B} one probe: parent "
                  f"{p_ms:.4f} ms, change {c_ms:.4f} ms, kernel 1 K=1 "
                  f"{row['k1_ms']:.4f} ms, bmm over dense bf16 [M; C] "
                  f"{lib_ms:.4f} ms, bound {row['bound_ms']:.4f} ms (bytes);"
                  f" bit-equal to kernel 1 K=1: {row['equal_to_k1']}, max "
                  f"|change - parent| {row['max_diff_parent']:.3e}",
                  flush=True)
        del tiles, flat
    return rows


def float_rows(libs, dev, P: int = 128, B: int = 128,
               m: int = 1024) -> list:
    """Kernels 1 and 9 over f32 and f64 storage at t = 64, 100, 128 and
    256 (m = t (m // t)), parent against change, through their C entries:
    kernel 1 at K=16, kernel 9 at one probe a lane, B distinct lanes of P
    random problems (10% of pairs kept), beside the bound (each lane's
    triangle, u and the output moved once; 2 K flops a stored element and
    direction at the f32 or f64 peak) and one torch.bmm over the lanes'
    dense [M; C] in the storage's type (TF32 off), the library call
    computing the same function."""
    import torch

    from clipper_tpu_torch.bench.harness import time_ms
    from clipper_tpu_torch.ops import flattri

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False

    gen = torch.Generator(device=dev).manual_seed(3)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = []
    m0 = m
    for t in (64, 100, 128, 256):
        nt = m0 // t
        m = nt * t
        S = flattri.tri_ncols(nt, t)
        T = nt * (nt + 1) // 2
        content = torch.rand(P, 2 * t, S, generator=gen, device=dev)
        content = torch.where(content > 0.9, content, 0.0)
        idx = torch.randperm(P, generator=gen, device=dev)[:B].to(
            torch.int32)
        for dtype, kind, peak in ((torch.float32, "f32", F32_FLOPS),
                                  (torch.float64, "f64", F64_FLOPS)):
            flat = content.to(dtype)
            tiles = flat.view(P, 2 * t, T, t).permute(0, 2, 1, 3).contiguous()
            dense = flattri.dense_stacked(flat[idx.long()], nt)
            for kernel, store, K in (("tri_matvec", flat, 16),
                                     ("tri_tiles_matvec", tiles, 1)):
                one = kernel == "tri_tiles_matvec"
                lead = (B,) if one else (B, K)
                U = torch.rand(*lead, m, generator=gen, device=dev,
                               dtype=dtype)
                outs = {side: (torch.empty(*lead, 2 * m, device=dev,
                                           dtype=dtype),)
                        for side in ("parent", "change")}
                shape = (B, nt, t) if one else (B, K, nt, t, S)
                fn = f"{kernel}_{kind}"

                def call(lib, side):
                    f = getattr(lib, fn)
                    ptrs = (store.data_ptr(), idx.data_ptr(), U.data_ptr(),
                            outs[side][0].data_ptr())
                    return lambda: f(*ptrs, *shape, stream)

                p_ms, c_ms, equal = compare(
                    f"{fn} t={t}", call(libs[kernel], "parent"),
                    call(_kernels.lib(kernel), "change"), outs, dev, 20)
                item = store.element_size()
                n_bytes = (B * 2 * t * S + B * K * m + B * K * 2 * m) * item
                n_ops = 2 * K * B * (2 * t * S + 2 * t * t * (T - nt))
                bound = max(n_bytes / HBM_BYTES_PER_S, n_ops / peak) * 1e3
                diff = float((outs["change"][0] - outs["parent"][0]).abs()
                             .max())
                Ut = U.view(B, -1, m).transpose(1, 2).contiguous()
                lib = time_ms(lambda: torch.bmm(dense, Ut), dev, 10)
                # kernel 9's warp-row kernel (t = 128, 256) is unchanged
                same = one and t in (128, 256)
                rel = diff / float(outs["parent"][0].abs().max())
                row = dict(kernel=kernel, storage=kind,
                           shape=f"m={m}, t={t}, B={B}, K={K}",
                           parent_ms=p_ms, change_ms=c_ms, bound_ms=bound,
                           library_ms=lib, equal_to_parent=equal,
                           max_diff_parent=diff,
                           held=equal if same else rel <= ROUTE_TOL)
                print(f"{fn} m={m} t={t} B={B} K={K}: parent {p_ms:.4f} "
                      f"ms, change {c_ms:.4f} ms (in turns), bound "
                      f"{bound:.4f} ms, torch.bmm over the dense {kind} "
                      f"[M; C] {lib:.4f} ms; bit-equal to the parent's: "
                      f"{equal}, max |change - parent| {diff:.3e}",
                      flush=True)
                rows.append(row)
            del flat, tiles, dense
    torch.backends.cuda.matmul.allow_tf32 = tf32
    return rows


def _tri_call(lib, fn, tri, idx, U, out, P, B, K, nt, t, stream):
    """A launch of kernel 1's (``tri_matvec_*``) or kernel 9's
    (``tri_tiles_matvec_*``) int8 / bf16 entry of ``lib``, and a place
    for the route it reports (where it takes one)."""
    from clipper_tpu_torch.ops import flattri
    route = ctypes.c_int(-1)
    takes = getattr(lib, fn).argtypes[-1] is _kernels._IP
    sc = (1 / 127,) if fn.endswith("int8") else ()
    if fn.startswith("tri_tiles"):
        args = (P, B, nt, t, *sc, stream)
    else:
        args = (P, B, K, nt, t, flattri.tri_ncols(nt, t), *sc, stream)

    def call():
        return getattr(lib, fn)(tri.data_ptr(), idx.data_ptr(),
                                U.data_ptr(), out.data_ptr(), *args,
                                *((ctypes.byref(route),) if takes else ()))
    return call, route


def route_rows(libs, dev) -> list:
    """Kernels 1 and 9 in int8 and bf16 at ROUTE_TILES on phase 2's shapes
    and kernel 1 at the tri pool's tri_tile=64, parent against change (see
    the module's docstring). A changed route is held to ROUTE_TOL of the
    parent's output, an unchanged one to bit equality; rows that miss
    carry ``held=False``."""
    import torch

    from clipper_tpu_torch.bench import harness
    from clipper_tpu_torch.bench.harness import time_ms
    from clipper_tpu_torch.ops import flattri

    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(17)
    rows = []
    cases = [("phase 2", t) for t in ROUTE_TILES] + [("pool", 64)]
    data = {"phase 2": stored_inputs("euclidean", 16, 2048, dev)}
    for shape, t in cases:
        if shape not in data:
            data[shape] = stored_inputs("euclidean", 512, 1024, dev)
        P1, P2, A = data[shape]
        W, M = A.shape[:2]
        m = t * (M // t)
        nt = m // t
        S = flattri.tri_ncols(nt, t)
        T = nt * (nt + 1) // 2
        mts = torch.full((W,), m, dtype=torch.int32, device=dev)
        B = 128
        if W > B:
            idx = torch.randperm(W, generator=gen, device=dev)[:B]
        else:
            idx = torch.randint(0, W, (B,), generator=gen, device=dev)
        idx = idx.to(torch.int32)
        for storage, kind in ((torch.int8, "int8"),
                              (torch.bfloat16, "bf16")):
            tri = flattri.build_tri_cuda(
                harness.default_invariant(), P1[:, :m].contiguous(),
                P2[:, :m].contiguous(),
                A[:, :m].contiguous(), mts, t=t, storage_dtype=storage)
            tiles = tri.view(W, 2 * t, T, t).permute(0, 2, 1, 3).contiguous()
            dense = flattri.dense_stacked(tri[idx.long()], nt).to(
                torch.bfloat16)
            kernels = [("tri_matvec", 16)]
            if shape == "phase 2":
                kernels.append(("tri_tiles_matvec", 1))
            U16 = torch.rand(B, 16, m, generator=gen, device=dev)
            U16 = (U16 / torch.linalg.vector_norm(U16, dim=-1, keepdim=True)
                   ).bfloat16()
            k1_out = None
            for kernel, K in kernels:
                U = U16[:, :K].contiguous()
                store = tri if kernel == "tri_matvec" else tiles
                fn = f"{kernel}_{kind}"
                outs = {side: torch.empty(B, K, 2 * m, device=dev)
                        for side in ("parent", "change")}
                par, _ = _tri_call(libs[kernel], fn, store, idx, U,
                                   outs["parent"], W, B, K, nt, t, stream)
                chg, route = _tri_call(_kernels.lib(kernel), fn, store, idx,
                                       U, outs["change"], W, B, K, nt, t,
                                       stream)
                p_ms, c_ms, equal = compare(
                    f"{fn} t={t}", par, chg,
                    {k: (v,) for k, v in outs.items()}, dev, 10)
                taken = _kernels.ROUTES[route.value]
                ref = outs["parent"]
                rel = float((outs["change"] - ref).abs().max()
                            / ref.abs().max())
                changed = taken != "mma"
                held = rel <= ROUTE_TOL if changed else equal
                Ut = U.view(B, K, m).transpose(1, 2).contiguous()
                lib_ms = time_ms(lambda: torch.bmm(dense, Ut), dev, 10)
                # each distinct problem's triangle read once
                n_bytes = (int(idx.unique().numel()) * 2 * t * S
                           * tri.element_size() + B * K * m * 2
                           + B * K * 2 * m * 4)
                n_ops = 2 * K * B * (2 * t * S + 2 * t * t * (T - nt))
                row = dict(kernel=kernel, storage=kind, route=taken,
                           shape=f"{shape}: W={W}, m={m}, t={t}, B={B}, "
                           f"K={K}", parent_ms=p_ms, change_ms=c_ms,
                           bound_ms=max(n_bytes / HBM_BYTES_PER_S,
                                        n_ops / BF16_FLOPS) * 1e3,
                           library_ms=lib_ms, equal_to_parent=equal,
                           rel_diff_parent=rel, held=held)
                if kernel == "tri_matvec":
                    k1 = torch.empty(B, 1, 2 * m, device=dev)
                    one, _ = _tri_call(_kernels.lib(kernel), fn, tri, idx,
                                       U[:, :1].contiguous(), k1, W, B, 1,
                                       nt, t, stream)
                    _kernels.check(one(), "parent_ab kernel 1 K=1")
                    k1_out = k1
                else:
                    row["equal_to_k1"] = bool(torch.equal(outs["change"],
                                                          k1_out))
                    row["held"] = held and row["equal_to_k1"]
                rows.append(row)
                print(f"{fn} ({row['shape']}, route {taken}): parent "
                      f"{p_ms:.4f} ms, change {c_ms:.4f} ms (in turns), "
                      f"bound {row['bound_ms']:.4f} ms, torch.bmm over the "
                      f"dense bf16 [M; C] {lib_ms:.4f} ms; bit-equal to the "
                      f"parent's: {equal}, max |change - parent| / max "
                      f"|parent| {rel:.3e}" + (
                          f", bit-equal to kernel 1 K=1: {row['equal_to_k1']}"
                          if "equal_to_k1" in row else "")
                      + ("" if row["held"] else " -- NOT HELD"), flush=True)
            del tri, tiles, dense
    return rows


def capacity_rows(libs, dev, m: int = 65536, t: int = 128,
                  G: int = 32) -> list:
    """Kernels 3 and 7, parent against change, through their C entries on
    one bunny problem's int8 storage (this tree's plan and workspace for
    both)."""
    import torch

    from clipper_tpu_torch.bench import harness
    from clipper_tpu_torch.ops import symstore
    from clipper_tpu_torch.ops.affinity import gather_endpoints

    pcd0 = harness.load_bunny()
    pcd1, A, _ = harness.make_problem(pcd0, m, 0.95,
                                      np.random.default_rng(0))
    At = torch.as_tensor(A.astype(np.int32), device=dev)
    P1, P2 = gather_endpoints(
        torch.as_tensor(pcd0, dtype=torch.float32, device=dev),
        torch.as_tensor(pcd1, dtype=torch.float32, device=dev), At)
    inv = harness.default_invariant()
    nt = m // t
    T = nt * (nt + 1) // 2
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = []
    for name in ("sym_rows_matvec", "sym_tiles_matvec"):
        if name == "sym_rows_matvec":
            store = symstore.build_symchunks(inv, P1, P2, At, m, tile=t, G=G)
            plan = symstore.rows_device_plan(store, nt)
            view = (store.shape[0] * 2 * t, G * t)
        else:
            store = symstore.build_symtiles(inv, P1, P2, At, m, tile=t)
            plan = symstore.tiles_device_plan(store, nt)
            view = (store.shape[0] * 2 * t, t)
        for K in (16, 1):
            U = torch.rand(K, m, generator=gen, device=dev)
            U = (U / torch.linalg.vector_norm(U, dim=-1, keepdim=True)).to(
                torch.bfloat16).contiguous()
            ws = plan.workspace(K)
            outs = {side: (torch.empty(K, 2 * m, device=dev),)
                    for side in ("parent", "change")}
            stream = _kernels.stream_ptr(dev)

            def call(fn, side):
                return lambda: fn(store.data_ptr(), *view, *plan.args(),
                                  U.data_ptr(), outs[side][0].data_ptr(),
                                  ws.data_ptr(), K, nt, t, 0, 1 / 127,
                                  stream)

            fn = f"{name}_int8"
            p_ms, c_ms, equal = compare(
                f"{name} K={K}", call(getattr(libs[name], fn), "parent"),
                call(getattr(_kernels.lib(name), fn), "change"), outs, dev,
                20)
            n_bytes = T * 2 * t * t + K * m * 2 + K * 2 * m * 4
            bound = max(n_bytes / HBM_BYTES_PER_S,
                        2 * K * 2 * t * t * (2 * T - nt) / BF16_FLOPS) * 1e3
            row = dict(kernel=name, storage="int8", shape=f"m={m}, t={t}, "
                       f"K={K}", parent_ms=p_ms, change_ms=c_ms,
                       bound_ms=bound, equal_to_parent=equal)
            print(f"{name} int8 m={m} t={t} K={K}: parent {p_ms:.4f} ms, "
                  f"change {c_ms:.4f} ms (in turns), bound {bound:.4f} ms; "
                  f"output bit-equal to the parent's: {equal}", flush=True)
            rows.append(row)
        del store, plan
        torch.cuda.empty_cache()
    return rows


def _capacity_store(name: str, m: int, t: int, G: int, dev, dtype=None):
    """One bunny problem's capacity storage at m, t (rho=0.95, numpy
    default_rng(0); rows at G), int8 unless ``dtype``: (storage, nt, its
    row length in elements)."""
    import torch

    from clipper_tpu_torch.bench import harness
    from clipper_tpu_torch.ops import symstore
    from clipper_tpu_torch.ops.affinity import gather_endpoints

    dtype = dtype or torch.int8
    fdt = torch.float64 if dtype == torch.float64 else torch.float32
    pcd0 = harness.load_bunny()
    pcd1, A, _ = harness.make_problem(pcd0, m, 0.95,
                                      np.random.default_rng(0))
    At = torch.as_tensor(A.astype(np.int32), device=dev)
    P1, P2 = gather_endpoints(torch.as_tensor(pcd0, dtype=fdt, device=dev),
                              torch.as_tensor(pcd1, dtype=fdt, device=dev),
                              At)
    inv = harness.default_invariant()
    if name == "sym_rows_matvec":
        store = symstore.build_symchunks(inv, P1, P2, At, m, tile=t, G=G,
                                         storage_dtype=dtype)
        return store, m // t, G * t
    return symstore.build_symtiles(inv, P1, P2, At, m, tile=t,
                                   storage_dtype=dtype), m // t, t


def tile_walks(nt: int, rows, cols):
    """Each output block's walk over a tile list, as the older checkouts'
    thread-an-output-column kernels take it: (walks (E, 2), offsets
    (nt + 1,)), int32. Block j's entries walks[offsets[j]:offsets[j + 1]]
    are the forward tiles of row j, then the transposed tiles of column j
    (r != c), each in increasing k, as (k, 2 ub + tr) with ub the block of
    u the tile contracts and tr = 1 for a transposed application. Inert
    slots are in no walk."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    k = np.arange(len(rows))
    real = rows < nt
    off = real & (rows != cols)
    block = np.concatenate([rows[real], cols[off]])
    tr = np.concatenate([np.zeros(real.sum(), np.int64),
                         np.ones(off.sum(), np.int64)])
    kk = np.concatenate([k[real], k[off]])
    ub = np.concatenate([cols[real], rows[off]])
    order = np.lexsort((kk, tr, block))
    walks = np.stack([kk[order], 2 * ub[order] + tr[order]], 1)
    offsets = np.searchsorted(block[order], np.arange(nt + 1))
    return walks.astype(np.int32), offsets.astype(np.int32)


def _walk_call(lib, name: str, kind: str, store, nt: int, t: int, G: int,
               U, out, stream, scale: float):
    """A launch of the parent's thread-an-output-column kernel of ``kind``
    ("core_int8", "f32", "f64") over all K rows of U: the rows layout's in
    launches of 16 (its wrapper's split), the tile list's in one, over
    tile_walks."""
    import torch

    from clipper_tpu_torch.ops import symstore

    fn = getattr(lib, f"{name}_{kind}")
    K = U.shape[0]
    tail = (scale,) if kind == "core_int8" else ()
    if name == "sym_tiles_matvec":
        walks, offsets = (torch.as_tensor(a, device=store.device).contiguous()
                          for a in tile_walks(nt,
                                              *symstore.tile_coords(nt)))
        return lambda: fn(store.data_ptr(), walks.data_ptr(),
                          offsets.data_ptr(), U.data_ptr(), out.data_ptr(),
                          K, nt, t, 0, *tail, stream)

    def call():
        code = 0
        for k0 in range(0, K, 16):
            k1 = min(K, k0 + 16)
            code = code or fn(store.data_ptr(), U[k0:k1].data_ptr(),
                              out[k0:k1].data_ptr(), k1 - k0, nt, t, G, 0,
                              store.shape[0], 0, *tail, stream)
        return code
    return call


def capacity_tile_rows(libs, dev) -> list:
    """Kernels 3 and 7 at the tiles whose route this tree redesigned,
    against the parent's CUDA-core kernel (a thread an output column),
    through their C entries, in turns: int8 at t=64 (m=65,536, the unit
    kernel over super-tiles here) and t=100 (m=65,600, the CUDA-core
    kernel of csrc/sym_core.cuh here), K=16 and 1; then the f32 and f64
    storage kinds at t=128 (m=16,384, K=16), whose kernel here is that
    CUDA-core kernel in f64. Each row: the parent's ms, the change's, the
    bound and the outputs' largest difference."""
    import torch

    from clipper_tpu_torch.ops import symstore

    stream = _kernels.stream_ptr(dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = []
    cases = [(t, m, torch.int8, K) for t, m in ((64, 65536), (100, 65600))
             for K in (16, 1)]
    cases += [(128, 16384, dt, 16) for dt in (torch.float32, torch.float64)]
    for name in ("sym_rows_matvec", "sym_tiles_matvec"):
        parent_lib = libs[name]
        if not getattr(parent_lib, "walk_core", False):
            print(f"{name}: the other checkout's CUDA-core entry takes the "
                  "unit plan already; tile rows skipped", flush=True)
            continue
        lib = _kernels.lib(name)
        built = None
        for t, m, dtype, K in cases:
            key = (t, m, dtype)
            if built is None or built[0] != key:
                built = None
                torch.cuda.empty_cache()
                store, nt, ld = _capacity_store(name, m, t, 32, dev, dtype)
                plan = (symstore.rows_device_plan(store, nt)
                        if name == "sym_rows_matvec"
                        else symstore.tiles_device_plan(store, nt))
                built = (key, store, nt, ld, plan)
            _, store, nt, ld, plan = built
            route = symstore.matvec_route(t, dtype)
            U = torch.rand(K, m, generator=gen, device=dev)
            U = U / torch.linalg.vector_norm(U, dim=-1, keepdim=True)
            Uc, scale = symstore._operand(dtype, U)
            Uc = Uc.contiguous()
            outs = {side: (torch.empty(K, 2 * m, device=dev),)
                    for side in ("parent", "change")}
            kind = "core_int8" if dtype == torch.int8 else (
                "f32" if dtype == torch.float32 else "f64")
            parent = _walk_call(parent_lib, name, kind, store, nt, t,
                                32, Uc, outs["parent"][0], stream, scale)
            ws = plan.workspace(min(K, 16))

            def change():
                code = 0
                for k0 in range(0, K, 16):
                    k1 = min(K, k0 + 16)
                    code = code or symstore._launch(
                        lib, name, route, store, t, ld, plan, Uc[k0:k1],
                        outs["change"][0][k0:k1], ws, k1 - k0, nt, False,
                        scale)
                return code
            reps = 20 if dtype == torch.int8 and t == 64 else 5
            p_ms, c_ms, equal = compare(f"{name} t={t} K={K}", parent,
                                        change, outs, dev, reps)
            T = nt * (nt + 1) // 2
            item = store.element_size()
            n_bytes = T * 2 * t * t * item + K * m * Uc.element_size() \
                + K * 2 * m * 4
            peak = BF16_FLOPS if dtype == torch.int8 else (
                F32_FLOPS if dtype == torch.float32 else F64_FLOPS)
            if dtype == torch.int8 and route == "core":
                peak = F32_FLOPS
            bound = max(n_bytes / HBM_BYTES_PER_S,
                        2 * K * 2 * t * t * (2 * T - nt) / peak) * 1e3
            diff = float((outs["change"][0] - outs["parent"][0]).abs().max())
            kind_name = {torch.int8: "int8", torch.float32: "f32",
                         torch.float64: "f64"}[dtype]
            row = dict(kernel=name, storage=kind_name,
                       shape=f"m={m}, t={t}, K={K}", route=route,
                       parent_ms=p_ms, change_ms=c_ms, bound_ms=bound,
                       speedup=p_ms / c_ms, max_diff_parent=diff)
            print(f"{name} {kind_name} m={m} t={t} K={K} (route {route}): "
                  f"parent {p_ms:.4f} ms, change {c_ms:.4f} ms (in turns, "
                  f"{p_ms / c_ms:.2f}x), bound {bound:.4f} ms; max |change "
                  f"- parent| {diff:.3e}", flush=True)
            rows.append(row)
        del built
        torch.cuda.empty_cache()
    return rows


def _dense_tiles(tiles, nt: int, dtype):
    """Tile-list storage (T, 2t, t) -> the dense stacked (2m, m) [M; C] in
    dtype, both triangles (row block r's tiles: its diagonal tile r, then
    its strictly upper run; ops/symstore.tile_coords)."""
    import torch
    T, two_t, t = tiles.shape
    m = nt * t
    D = torch.zeros(2 * m, m, dtype=dtype, device=tiles.device)
    k = nt
    for r in range(nt):
        seg = torch.cat([tiles[r:r + 1], tiles[k:k + nt - r - 1]])
        k += nt - r - 1
        seg = seg.permute(1, 0, 2).reshape(two_t, -1).to(dtype)
        for h in range(2):
            half = seg[h * t:(h + 1) * t]
            D[h * m + r * t:h * m + (r + 1) * t, r * t:] = half
            D[h * m + (r + 1) * t:h * m + m, r * t:(r + 1) * t] = \
                half[:, t:].T
    return D


def capacity_library_rows(dev) -> list:
    """The library call beside kernels 3 and 7 at the shapes of
    ``capacity_tile_rows``: one torch.matmul of the capacity problem's
    dense [M; C] (2m, m) by the K=16 candidates, int8 codes as bf16 at
    t=100 (m=65,600), f32 and f64 at t=128 (m=16,384), TF32 off."""
    import torch

    from clipper_tpu_torch.bench.harness import time_ms

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for t, m, dtype, ddt in ((100, 65600, torch.int8, torch.bfloat16),
                             (128, 16384, torch.float32, torch.float32),
                             (128, 16384, torch.float64, torch.float64)):
        store, nt, _ = _capacity_store("sym_tiles_matvec", m, t, 32, dev,
                                       dtype)
        D = _dense_tiles(store, nt, ddt)
        del store
        Ut = torch.rand(m, 16, generator=gen, device=dev).to(ddt)
        ms = time_ms(lambda: torch.matmul(D, Ut), dev, 5)
        kind = {torch.int8: "int8", torch.float32: "f32",
                torch.float64: "f64"}[dtype]
        rows.append(dict(kernel="sym_rows_matvec, sym_tiles_matvec",
                         storage=kind, shape=f"m={m}, t={t}, K=16",
                         library_ms=ms))
        print(f"kernels 3 and 7 {kind} m={m} t={t} K=16: torch.matmul over "
              f"the dense {str(ddt).split('.')[-1]} [M; C] {ms:.4f} ms",
              flush=True)
        del D, Ut
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = tf32
    return rows


def stored_inputs(kind: str, W: int, m: int, dev):
    """chip_smoke.py's main-path problems: (P1, P2, A) gathered on the
    card, bunny (kind "euclidean") or point-normal scans, rho=0.9, numpy
    default_rng(0)."""
    import torch

    from clipper_tpu_torch.bench import harness
    from clipper_tpu_torch.ops.affinity import gather_endpoints
    rng = np.random.default_rng(0)
    if kind == "euclidean":
        pcd0 = harness.load_bunny()
        probs = [harness.make_problem(pcd0, m, 0.9, rng) for _ in range(W)]
        D1 = torch.as_tensor(pcd0.astype(np.float32), device=dev)
        D2 = np.stack([p[0] for p in probs]).astype(np.float32)
        A = np.stack([p[1] for p in probs]).astype(np.int32)
    else:
        probs = [harness.make_pointnormal_problem(rng, n=2000, m=m, rho=0.9)
                 for _ in range(W)]
        D1 = torch.as_tensor(np.stack([p[0] for p in probs]).astype(
            np.float32), device=dev)
        D2 = np.stack([p[1] for p in probs]).astype(np.float32)
        A = np.stack([p[2] for p in probs]).astype(np.int32)
    At = torch.as_tensor(A, device=dev)
    P1, P2 = gather_endpoints(D1, torch.as_tensor(D2, device=dev), At)
    return P1.contiguous(), P2.contiguous(), At


def build_rows(libs, dev, W: int = 512, m: int = 1024,
               t: int = 256) -> list:
    """Kernels 2, 8 and 4, parent against change, on the main path's
    problems, each problem set's survivor shares beside them."""
    import torch

    from clipper_tpu_torch.bench import harness
    from clipper_tpu_torch.invariants import kernel_score
    from clipper_tpu_torch.ops import flattri

    stream = torch.cuda.current_stream(dev).cuda_stream
    mts = torch.full((W,), m, dtype=torch.int32, device=dev)
    nt = m // t
    S = flattri.tri_ncols(nt, t)
    rows = []
    for kind, inv in (("euclidean", harness.default_invariant()),
                      ("pointnormal", harness.pointnormal_invariant())):
        P1, P2, A = stored_inputs(kind, W, m, dev)
        shares = harness.gate_shares(inv, P1, P2, A, mts)
        print(f"{kind} W={W} m={m} survivor shares of the distinct"
              f" pairs: " + ", ".join(f"{k} {v:.4f}"
                                      for k, v in shares.items()),
              flush=True)
        code, d, params = kernel_score(inv)
        args = (P1.data_ptr(), P2.data_ptr(), A.data_ptr(), mts.data_ptr())
        for storage in (torch.int8, torch.bfloat16):
            sname = "int8" if storage == torch.int8 else "bf16"
            kernel2 = None
            for cu, shape, extra in (
                    ("tri_build", (W, 2 * t, S), (t, S)),
                    ("tri_build_fused", (W, 2 * t, S), (t, S)),
                    ("stored_build", (W, 2 * m, m), ())):
                fn = f"{cu}_{sname}"
                mine = _kernels.lib(cu)
                outs = {k: (torch.empty(shape, dtype=storage, device=dev),)
                        for k in ("parent", "change")}

                def launch(lib, out):
                    return getattr(lib, fn)(*args, out.data_ptr(), W, m,
                                            *extra, code, *params, 1e-4,
                                            stream)
                p_ms, c_ms, equal = compare(
                    f"{cu} {kind} {sname}",
                    lambda: launch(libs[cu], outs["parent"][0]),
                    lambda: launch(mine, outs["change"][0]), outs, dev, 10)
                row = dict(kernel=cu, kind=kind, storage=sname, W=W, m=m,
                           parent_ms=p_ms, ms=c_ms,
                           bound_ms=build_bound(
                               outs["change"][0].numel() * storage.itemsize,
                               W, m, d, kind),
                           equal_to_parent=equal, shares=shares)
                note = ""
                if cu == "tri_build":
                    kernel2 = outs["change"][0]
                elif cu == "tri_build_fused":
                    row["equal_to_tri_build"] = bool(torch.equal(
                        outs["change"][0], kernel2))
                    note = (f"; byte-equal to kernel 2: "
                            f"{row['equal_to_tri_build']}")
                rows.append(row)
                print(f"{cu} {kind} {sname} W={W} m={m}: parent "
                      f"{p_ms:.4f} ms, change {c_ms:.4f} ms, bound "
                      f"{row['bound_ms']:.4f} ms; output byte-equal to the "
                      f"parent's: {equal}{note}", flush=True)
                del outs
            del kernel2
            torch.cuda.empty_cache()
    return rows


def affinity_rows(parent_lib, dev) -> list:
    """Kernel 6, parent against change: chip_smoke.py phase 6's two
    problems (point-normal m=5000 at rho=0.8, the first bunny problem at
    m=1024), f32 and f64, beside the bound (M and C written once, the
    endpoints read once; the operations over the type's peak)."""
    import torch

    from clipper_tpu_torch.bench import harness
    from clipper_tpu_torch.invariants import kernel_score
    from clipper_tpu_torch.ops.affinity import gather_endpoints

    stream = torch.cuda.current_stream(dev).cuda_stream
    D1, D2, A, _ = harness.make_pointnormal_problem(
        np.random.default_rng(0), n=2000, m=5000, rho=0.8)
    At = torch.as_tensor(A, dtype=torch.int32, device=dev)
    B1, B2, BA = stored_inputs("euclidean", 1, 1024, dev)
    rows = []
    for dtype in (torch.float32, torch.float64):
        name = "f32" if dtype == torch.float32 else "f64"
        pn = gather_endpoints(torch.as_tensor(D1, dtype=dtype, device=dev),
                              torch.as_tensor(D2, dtype=dtype, device=dev),
                              At) + (At,)
        for kind, inv, (P1, P2, A) in (
                ("pointnormal", harness.pointnormal_invariant(), pn),
                ("euclidean", harness.default_invariant(),
                 (B1[0].to(dtype), B2[0].to(dtype), BA[0]))):
            code, d, params = kernel_score(inv)
            m = P1.shape[0]
            outs = {k: tuple(torch.empty(m, m, dtype=dtype, device=dev)
                             for _ in range(2))
                    for k in ("parent", "change")}
            fn = f"affinity_build_{name}"

            def launch(lib, out):
                return getattr(lib, fn)(
                    P1.data_ptr(), P2.data_ptr(), A.data_ptr(),
                    out[0].data_ptr(), out[1].data_ptr(), m, code, *params,
                    1e-4, stream)
            p_ms, c_ms, equal = compare(
                f"affinity_build {kind} {name}",
                lambda: launch(parent_lib, outs["parent"]),
                lambda: launch(_kernels.lib("affinity_build"),
                               outs["change"]), outs, dev, 10)
            n_bytes = 2 * m * m * dtype.itemsize + 2 * m * d * \
                dtype.itemsize + m * 2 * 4
            n_ops = (m * (m - 1) // 2) * OPS_PER_PAIR[kind]
            peak = F32_FLOPS if dtype == torch.float32 else F64_SIMT_FLOPS
            rows.append(dict(kernel="affinity_build", kind=kind, m=m,
                             dtype=name, parent_ms=p_ms, ms=c_ms,
                             bound_ms=max(n_bytes / HBM_BYTES_PER_S,
                                          n_ops / peak) * 1e3,
                             equal_to_parent=equal))
            print(f"affinity_build {kind} m={m} {name}: parent {p_ms:.4f} "
                  f"ms, change {c_ms:.4f} ms, bound "
                  f"{rows[-1]['bound_ms']:.4f} ms; M and C byte-equal to "
                  f"the parent's: {equal}", flush=True)
            del outs
        del pn
        torch.cuda.empty_cache()
    return rows


def probe_rows(parent_lib, dev, B: int = 512, m: int = 1024) -> list:
    """Kernel 10's five variants, parent against change, on the probe's
    inputs."""
    import torch

    from clipper_tpu_torch.bench import build_probe, harness
    from clipper_tpu_torch.invariants import kernel_score

    stream = torch.cuda.current_stream(dev).cuda_stream
    P1, P2, A = (torch.as_tensor(x, device=dev)
                 for x in build_probe.make_inputs(B, m))
    mts = torch.full((B,), m, dtype=torch.int32, device=dev)
    rows = []
    for v, variant in enumerate(build_probe.VARIANTS):
        outs = {k: (torch.empty(B, 2 * m, m, dtype=torch.int8, device=dev),)
                for k in ("parent", "change")}

        def launch(lib, out):
            return lib.build_probe_int8(
                v, P1.data_ptr(), P2.data_ptr(), A.data_ptr(),
                mts.data_ptr(), out.data_ptr(), B, m, build_probe.SIGMA,
                build_probe.EPS, build_probe.AFFEPS, stream)
        p_ms, c_ms, equal = compare(
            f"build_probe {variant}",
            lambda: launch(parent_lib, outs["parent"][0]),
            lambda: launch(_kernels.lib("build_probe"), outs["change"][0]),
            outs, dev, 10)
        rows.append(dict(kernel="build_probe", variant=variant, B=B, m=m,
                         parent_ms=p_ms, ms=c_ms, equal_to_parent=equal))
        print(f"build_probe {variant} B={B} m={m}: parent {p_ms:.4f} ms, "
              f"change {c_ms:.4f} ms; byte-equal to the parent's: {equal}",
              flush=True)
        del outs
    # the change's full beside kernel 4 on the same inputs, in turns
    # (kernel 4, full, full, kernel 4), and whether the two are byte-equal
    inv = harness.default_invariant()
    code, _, params = kernel_score(inv)
    outs = {k: (torch.empty(B, 2 * m, m, dtype=torch.int8, device=dev),)
            for k in ("parent", "change")}
    k4, full, equal = compare(
        "build_probe full against kernel 4",
        lambda: _kernels.lib("stored_build").stored_build_int8(
            P1.data_ptr(), P2.data_ptr(), A.data_ptr(), mts.data_ptr(),
            outs["parent"][0].data_ptr(), B, m, code, *params,
            build_probe.AFFEPS, stream),
        lambda: _kernels.lib("build_probe").build_probe_int8(
            0, P1.data_ptr(), P2.data_ptr(), A.data_ptr(), mts.data_ptr(),
            outs["change"][0].data_ptr(), B, m, build_probe.SIGMA,
            build_probe.EPS, build_probe.AFFEPS, stream), outs, dev, 10)
    rows.append(dict(kernel="build_probe", variant="full", B=B, m=m,
                     kernel4_ms=k4, ms=full, equal_to_kernel4=equal))
    print(f"build_probe full B={B} m={m}: {full:.4f} ms beside kernel 4's "
          f"{k4:.4f} ms ({full / k4:.3f}x); byte-equal to kernel 4: {equal}",
          flush=True)
    return rows


# one checkout's tri pool (chip_smoke.py's main path: W=512 bunny
# problems at m=1024, int8 storage) at each tile of argv[3], in turns
# within the process, after one counted warm-up call a tile; prints its
# wall seconds a call and the tri kernels' launches as one JSON line
_POOL_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from clipper_tpu_torch import _kernels
from clipper_tpu_torch.bench import harness
inv = harness.default_invariant()
dev = torch.device("cuda")
data = cs.make_problems(cs.W_MAIN, seed=0)
reps = int(sys.argv[2])
tiles = [int(x) for x in sys.argv[3].split(",")]

def run(t):
    return cs.run_pipeline(inv, data, dev, cs.W_MAIN, storage=torch.int8,
                           tri_tile=t)

out = {}
for t in tiles:
    _kernels.reset_launches()
    run(t)
    torch.cuda.synchronize()
    out[t] = dict(secs=[], launches={k: v for k, v in _kernels.LAUNCHES.items()
                                     if v and k.startswith("tri_")})
for _ in range(reps):
    for t in tiles:
        t0 = time.perf_counter()
        run(t)
        torch.cuda.synchronize()
        out[t]["secs"].append(time.perf_counter() - t0)
print("POOL " + json.dumps(out), flush=True)
"""
POOL_TILES = (64, 256, 512)


def _pool_turn(root: Path, reps: int, tiles) -> dict:
    """One process of _POOL_CHILD in checkout ``root``."""
    res = subprocess.run(
        [sys.executable, "-c", _POOL_CHILD, str(root), str(reps),
         ",".join(str(t) for t in tiles)], cwd=root, capture_output=True,
        text=True, timeout=900)
    if res.returncode != 0:
        raise SystemExit(f"parent_ab: the tri pool in {root} failed:\n"
                         + res.stderr[-4000:])
    line = [x for x in res.stdout.splitlines() if x.startswith("POOL ")][-1]
    return {int(t): v for t, v in json.loads(line[5:]).items()}


def pool_rows(parent: str, reps: int = 3, tiles=POOL_TILES) -> list:
    """The tri pool end to end (``make_pool_pipeline(layout="tri",
    tri_tile=t)`` on chip_smoke.py's W=512, m=1024 int8 main path),
    the other checkout's against this tree's, one process each, in turns
    (parent, change, change, parent, change, parent, parent, change):
    problems/s from the mean of each tree's 4 reps calls a tile, each
    process's mean ms beside it, and each tree's tri kernel launches of
    one call by key."""
    roots = {"parent": Path(parent).resolve(),
             "change": Path(__file__).resolve().parents[2]}
    order = ("parent", "change", "change", "parent", "change", "parent",
             "parent", "change")
    secs = {who: {t: [] for t in tiles} for who in roots}
    turns = {who: {t: [] for t in tiles} for who in roots}
    launches = {}
    for who in order:
        got = _pool_turn(roots[who], reps, tiles)
        for t in tiles:
            secs[who][t] += got[t]["secs"]
            turns[who][t].append(
                sum(got[t]["secs"]) / len(got[t]["secs"]) * 1e3)
            launches[(who, t)] = got[t]["launches"]
    W = 512
    rows = []
    for t in tiles:
        p_s = sum(secs["parent"][t]) / len(secs["parent"][t])
        c_s = sum(secs["change"][t]) / len(secs["change"][t])
        rows.append(dict(kernel="tri_pool", storage="int8",
                         shape=f"W={W}, m=1024, tri_tile={t}",
                         parent_per_s=W / p_s, per_s=W / c_s,
                         parent_ms=p_s * 1e3, ms=c_s * 1e3,
                         parent_turn_ms=turns["parent"][t],
                         turn_ms=turns["change"][t],
                         parent_launches=launches[("parent", t)],
                         launches=launches[("change", t)]))
        print(f"parent_ab tri pool int8 tri_tile={t}: parent "
              f"{W / p_s:.1f} problems/s ({p_s * 1e3:.1f} ms a call; "
              f"turns {', '.join(f'{x:.1f}' for x in turns['parent'][t])}),"
              f" change {W / c_s:.1f} ({c_s * 1e3:.1f} ms; turns "
              f"{', '.join(f'{x:.1f}' for x in turns['change'][t])}; "
              f"{len(secs['change'][t])} calls each); launches parent "
              f"{launches[('parent', t)]}, change "
              f"{launches[('change', t)]}", flush=True)
    return rows


def main(argv: List[str] = None) -> list:
    import torch

    from clipper_tpu_torch.bench import harness, tri_matvec_probe

    argv = sys.argv[1:] if argv is None else argv
    pool_only = "--pool" in argv
    argv = [a for a in argv if a != "--pool"]
    if len(argv) != 1:
        raise SystemExit("usage: python -m clipper_tpu_torch.bench.parent_ab"
                         " DIR [--pool]")
    if not torch.cuda.is_available():
        raise SystemExit("parent_ab needs a CUDA device")
    dev = torch.device("cuda")
    if pool_only:
        print(f"parent_ab on {harness.device_name(dev)}", flush=True)
        return pool_rows(argv[0])
    print("kernel 1 against the parent (tri_matvec_probe --parent):",
          flush=True)
    rows = [dict(kernel="tri_matvec", **r)
            for r in tri_matvec_probe.main(["--parent", argv[0]])]
    _kernels.build_all()
    libs = build_parent(argv[0])
    rows += tiles_rows(libs["tri_tiles_matvec"], dev)
    rows += route_rows(libs, dev)
    rows += float_rows(libs, dev)
    for t in (128, 256):
        rows += capacity_rows(libs, dev, t=t)
    rows += capacity_tile_rows(libs, dev)
    rows += capacity_library_rows(dev)
    rows += build_rows(libs, dev)
    rows += affinity_rows(libs["affinity_build"], dev)
    rows += probe_rows(libs["build_probe"], dev)
    rows += pool_rows(argv[0])
    held = [r["equal_to_parent"] for r in rows if "equal_to_parent" in r]
    print(f"parent_ab on {harness.device_name(dev)}: {len(rows)} rows, "
          f"outputs byte-equal to the parent's in {sum(held)} of "
          f"{len(held)}", flush=True)
    missed = [f"{r['kernel']} {r['storage']} {r['shape']}" for r in rows
              if r.get("held") is False]
    if missed:
        raise SystemExit("parent_ab: outputs not held to the parent's: "
                         + "; ".join(missed))
    return rows


if __name__ == "__main__":
    main()
