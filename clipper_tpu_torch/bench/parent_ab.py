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
- kernels 1 and 9 over f32 and f64 storage at t=128 and 256 (kernel 1
  at K=16, kernel 9 at one probe a lane; B=128 distinct lanes of P=128
  random problems, m=1024): the parent's ms, the change's, the bound,
  ``torch.bmm`` over the dense [M; C] in the storage's type, whether the
  outputs are bit-equal and their max distance;
- kernels 3 and 7 in int8 at t=128 and t=256, K=16 and K=1, on one bunny
  problem at m=65,536 (rho=0.95, numpy default_rng(0); rows at G=32),
  with this tree's plan and workspace: the parent's ms, the change's, the
  bound and whether the outputs are bit-equal;
- kernels 3 and 7 where the other checkout's capacity matvecs ran a
  thread an output column (``capacity_tile_rows``): int8 at t=64
  (m=65,536) and t=100 (m=65,600), K=16 and 1, and the f32 / f64 kinds
  at t=128 (m=16,384, K=16), that checkout's kernel against this tree's
  route, with the speedup and the outputs' largest difference;
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

Kernel 1 is compared first, by ``tri_matvec_probe.main(["--parent",
DIR])`` (its ablations and the parent's build, bit equality at its four
shapes). Run on a machine with the card:

    python -m clipper_tpu_torch.bench.parent_ab DIR

It prints the card's name and power limit first and returns its rows.
"""

from __future__ import annotations

import ctypes
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
F64_FLOPS = 34e12     # f64 outside the tensor cores (data sheet)
BF16_FLOPS = 989e12
# f32 operations a pair of each score (chip_smoke.py's counts)
OPS_PER_PAIR = {"euclidean": 30, "pointnormal": 56}
# the sources built from the other checkout, and their entry points
_SOURCES = {
    "tri_matvec": ("tri_matvec_f32", "tri_matvec_f64"),
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
    """Kernels 1 and 9 over f32 and f64 storage at t=128 and 256, parent
    against change, through their C entries: kernel 1 at K=16, kernel 9 at
    one probe a lane, B distinct lanes of P random problems (10% of pairs
    kept), beside the bound (each lane's triangle, u and the output moved
    once; 2 K flops a stored element and direction at the f32 or f64
    peak) and one torch.bmm over the lanes' dense [M; C] in the storage's
    type (TF32 off), the library call computing the same function."""
    import torch

    from clipper_tpu_torch.bench.harness import time_ms
    from clipper_tpu_torch.ops import flattri

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False

    gen = torch.Generator(device=dev).manual_seed(3)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = []
    for t in (128, 256):
        nt = m // t
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
                row = dict(kernel=kernel, storage=kind,
                           shape=f"m={m}, t={t}, B={B}, K={K}",
                           parent_ms=p_ms, change_ms=c_ms, bound_ms=bound,
                           library_ms=lib, equal_to_parent=equal,
                           max_diff_parent=diff)
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
            peak = F32_FLOPS if dtype == torch.float32 else F64_FLOPS
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


def main(argv: List[str] = None) -> list:
    import torch

    from clipper_tpu_torch.bench import harness, tri_matvec_probe

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        raise SystemExit("usage: python -m clipper_tpu_torch.bench.parent_ab"
                         " DIR")
    if not torch.cuda.is_available():
        raise SystemExit("parent_ab needs a CUDA device")
    dev = torch.device("cuda")
    print("kernel 1 against the parent (tri_matvec_probe --parent):",
          flush=True)
    rows = [dict(kernel="tri_matvec", **r)
            for r in tri_matvec_probe.main(["--parent", argv[0]])]
    _kernels.build_all()
    libs = build_parent(argv[0])
    rows += tiles_rows(libs["tri_tiles_matvec"], dev)
    rows += float_rows(libs, dev)
    for t in (128, 256):
        rows += capacity_rows(libs, dev, t=t)
    rows += capacity_tile_rows(libs, dev)
    rows += build_rows(libs, dev)
    rows += affinity_rows(libs["affinity_build"], dev)
    rows += probe_rows(libs["build_probe"], dev)
    held = [r["equal_to_parent"] for r in rows if "equal_to_parent" in r]
    print(f"parent_ab on {harness.device_name(dev)}: {len(rows)} rows, "
          f"outputs byte-equal to the parent's in {sum(held)} of "
          f"{len(held)}", flush=True)
    return rows


if __name__ == "__main__":
    main()
