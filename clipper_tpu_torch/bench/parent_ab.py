"""The port's kernels beside their builds from another checkout, on the card.

Builds csrc/tri_tiles_matvec.cu (kernel 9) and the build kernels'
sources, csrc/tri_build.cu (kernel 2), tri_build_fused.cu (kernel 8),
stored_build.cu (kernel 4), affinity_build.cu (kernel 6) and
build_probe.cu (kernel 10), from the sources of another checkout of the
repo at DIR (for example the parent commit unpacked with ``git
archive``) into build/clipper_tpu_torch/probe/parent_ab/, with the
package's flags, and times each beside the package's own build in one
process, in turns (parent, change, change, parent; each the mean of its
two turns), through the C entry points (no wrapper), which both trees
must share:

- kernel 9 at B=128 and B=512 lanes, one probe a lane, int8 and bf16
  storage, on the tile-major form of P=512 random problems (m=1024,
  t=256, 10% of pairs kept): the parent's ms, the change's, kernel 1 at
  K=1 on the flat form of the same content, one ``torch.bmm`` over the
  dense bf16 [M; C] and the bound; whether the change's output is
  bit-equal to kernel 1's at K=1, and its max distance to the parent's;
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

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12     # f64 outside the tensor cores (data sheet)
BF16_FLOPS = 989e12
# f32 operations a pair of each score (chip_smoke.py's counts)
OPS_PER_PAIR = {"euclidean": 30, "pointnormal": 56}
# the sources built from the other checkout, and their entry points
_SOURCES = {
    "tri_tiles_matvec": ("tri_tiles_matvec_int8", "tri_tiles_matvec_bf16"),
    "tri_build": ("tri_build_int8", "tri_build_bf16"),
    "tri_build_fused": ("tri_build_fused_int8", "tri_build_fused_bf16"),
    "stored_build": ("stored_build_int8", "stored_build_bf16"),
    "affinity_build": ("affinity_build_f32", "affinity_build_f64"),
    "build_probe": ("build_probe_int8",),
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
        for fn in _SOURCES[cu]:
            getattr(lib, fn).argtypes = _kernels._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
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
            if int8:
                def parent():
                    return parent_lib.tri_tiles_matvec_int8(
                        *ptr, outs["parent"].data_ptr(), P, B, nt, t,
                        1 / 127, stream)

                def change():
                    return k9.tri_tiles_matvec_int8(
                        *ptr, outs["change"].data_ptr(), P, B, nt, t,
                        1 / 127, stream)

                def kernel1():
                    return k1.tri_matvec_int8(
                        flat.data_ptr(), idx.data_ptr(), U.data_ptr(),
                        outs["k1"].data_ptr(), P, B, 1, nt, t, S, 1 / 127,
                        stream)
            else:
                def parent():
                    return parent_lib.tri_tiles_matvec_bf16(
                        *ptr, outs["parent"].data_ptr(), P, B, nt, t,
                        stream)

                def change():
                    return k9.tri_tiles_matvec_bf16(
                        *ptr, outs["change"].data_ptr(), P, B, nt, t,
                        stream)

                def kernel1():
                    return k1.tri_matvec_bf16(
                        flat.data_ptr(), idx.data_ptr(), U.data_ptr(),
                        outs["k1"].data_ptr(), P, B, 1, nt, t, S, stream)
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
