"""Ablations of the tri pool matvec (kernel 1, csrc/tri_matvec.cu) on the
card: where its time goes.

Each variant is the kernel's body (csrc/tri_matvec_mma.cuh, which kernel 9
shares) with one part switched off by a text edit, compiled into
csrc/tri_matvec.cu by its own nvcc under
build/clipper_tpu_torch/probe/tri_matvec/<variant>/ and timed through its
C entry point (no wrapper) at the main path's shapes: m=1024, t=256,
P=512 stored problems of random content (10% of pairs kept), B=128 lanes
at K=16 and B=512 at K=1, int8 and bf16 storage.

- ``full``: the kernel as the package builds it;
- ``nocompute``: the consumer warps wait for every panel, release it and
  write their (zero) sums, but take no fragment and run no mma: the data
  movement alone (panels, u slots, the output's raw sums);
- ``noforward`` / ``notransposed``: one of the two products left out.

The variants' outputs are wrong by design; only their times mean
anything. Run on a machine with the card:

    python -m clipper_tpu_torch.bench.tri_matvec_probe [--parent DIR]
    python -m clipper_tpu_torch.bench.tri_matvec_probe --routes

``--routes`` probes kernel 1's two other routes the same way, on random
content (10% of pairs kept), B=128 lanes at K=16: the "super" route
(tri_super_kernel in csrc/tri_matvec_mma.cuh) at t=16 and 64 on W=16
problems of m=2048 (phase 2's shape in chip_smoke.py: 8 lanes a
problem) and at t=64 on W=512 of m=1024 (the tri pool's, distinct lanes),
int8 and bf16, with the variants ``nocompute``, ``noforward`` and
``nou`` (no u block copied: data movement of the stored tiles alone);
the "core" / "float" route (csrc/tri_matvec_core.cuh) at t=100 on W=16
problems of m=2000 (int8, bf16) and at t=128 on W=128 of m=1024 (f32,
f64), with ``nocompute``, ``nocopy`` (no block staged) and ``noreduce``
(no partial sums added).

It prints the card's name and power limit, then one line per storage and
shape with each variant's ms beside the bound. ``--parent DIR`` adds the
variant ``parent``: the kernel built from the sources of another checkout
of the repo at DIR (for example an earlier commit unpacked with ``git
archive``), timed beside the others, and it prints whether the kernel's
output equals the parent's bit for bit at every shape.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

from clipper_tpu_torch import _kernels

_HEADER = "tri_matvec_mma.cuh"
_FORWARD = "if ((warp >> 2) == (p & 1)) {"
_TRANSPOSED = ("        if (!diag) {\n#pragma unroll\n"
               "          for (int f = 0; f < F; ++f) {")
VARIANTS = ("full", "nocompute", "noforward", "notransposed")


def _edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"probe edit: {old!r} is not in the kernel's "
                           "source; update the probe's edits")
    return src.replace(old, new, 1)


def variant_sources() -> Dict[str, str]:
    """The text of every variant's kernel body (csrc/tri_matvec_mma.cuh)."""
    src = (_kernels.CSRC / _HEADER).read_text()
    no_fwd = _edit(src, _FORWARD, "if (false) {")
    no_tr = _edit(src, _TRANSPOSED, _TRANSPOSED.replace("!diag", "false"))
    return {"full": src, "nocompute": _edit(no_fwd, _TRANSPOSED,
                                            _TRANSPOSED.replace("!diag",
                                                                "false")),
            "noforward": no_fwd, "notransposed": no_tr}


def bind(lib: ctypes.CDLL, fn: str, cu_src: str) -> None:
    """Type lib's C entry ``fn`` as this tree's, less its last argument,
    the route it reports, where the source it was built from (``cu_src``,
    an older checkout's) has none."""
    sig = _kernels._SIGNATURES[fn]
    if sig[-1] is _kernels._IP and "int* route" not in cu_src:
        sig = sig[:-1]
    getattr(lib, fn).argtypes = sig
    getattr(lib, fn).restype = ctypes.c_int


def route_arg(lib: ctypes.CDLL, fn: str) -> tuple:
    """The route argument of lib's entry ``fn`` where it takes one (a
    place for the route, unread), else nothing."""
    takes = getattr(lib, fn).argtypes[-1] is _kernels._IP
    return (ctypes.byref(ctypes.c_int()),) if takes else ()


def build_edited(probe: str, cu: str, edited: Dict[str, Dict[str, str]],
                 fns) -> Dict[str, ctypes.CDLL]:
    """Compile csrc/<cu>.cu once for each variant, in its own copy of csrc/
    (build/clipper_tpu_torch/probe/<probe>/<variant>/) where the variant's
    edited files (file name -> text) replace the package's, with the
    package's flags for <cu>: one nvcc per variant, all started together.
    Returns the loaded libraries with their C entry points ``fns``
    bound."""
    out_dir = _kernels.BUILD_DIR / "probe" / probe
    procs = {}
    for name, files in edited.items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        for h in _kernels.CSRC.glob("*.cu*"):
            (d / h.name).write_bytes(h.read_bytes())
        for fname, text in files.items():
            (d / fname).write_text(text)
        cmd = [_kernels._nvcc(), *_kernels._ARCH, *_kernels._COMMON,
               *_kernels.SOURCES[cu], "-o", str(d / "lib.so"),
               str(d / f"{cu}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{probe} probe: {name} failed to build:"
                               f"\n{log}")
        lib = ctypes.CDLL(os.path.abspath(out_dir / name / "lib.so"))
        cu_src = (out_dir / name / f"{cu}.cu").read_text()
        for fn in fns:
            bind(lib, fn, cu_src)
        libs[name] = lib
    return libs


def build_variants(parent: str = None) -> Dict[str, ctypes.CDLL]:
    """Compile every variant and load it; with ``parent``, also the kernel
    from the csrc/ of the checkout at that path."""
    edited = {name: {_HEADER: src}
              for name, src in variant_sources().items()}
    if parent is not None:
        csrc = Path(parent) / "clipper_tpu_torch" / "csrc"
        edited["parent"] = {p.name: p.read_text()
                            for p in csrc.glob("*.cu*")}
        if "tri_matvec.cu" not in edited["parent"]:
            raise SystemExit(f"tri_matvec_probe: no tri_matvec.cu in {csrc}")
    return build_edited("tri_matvec", "tri_matvec", edited,
                        ("tri_matvec_int8", "tri_matvec_bf16"))


_SUPER_FWD = "if ((warp >> 2) == p && i < m && flo < fhi) {"
_SUPER_TR = "        if (keep > 0) {"
_SUPER_UC = "for (int nn = lane; nn < K; nn += 32)\n          bulk_copy(uslot + q"
_SUPER_UR = ("for (int nn = lane; nn < K; nn += 32)\n            bulk_copy("
             "uslot + (2 + qr)")
_CORE_TR = "if (c > r && rs < kNR) {"
_CORE_FWD = "if (cb < kNC) {"
_CORE_COPY = "for (int e = tid; e < hr * per; e += kThreads) {"
_CORE_RED = ("if (k >= kKG || p >= hr) continue;",
             "if (k >= kKG || x >= wc) continue;")


def route_sources() -> Dict[str, Dict[str, str]]:
    """The ``--routes`` variants: file name -> text of the edited
    header, by variant (``super ...`` and ``core ...``)."""
    mma = (_kernels.CSRC / _HEADER).read_text()
    core = (_kernels.CSRC / "tri_matvec_core.cuh").read_text()
    no_u = _edit(_edit(mma, _SUPER_UC, _SUPER_UC.replace("nn < K", "nn < 0")),
                 _SUPER_UR, _SUPER_UR.replace("nn < K", "nn < 0"))
    no_u = _edit(_edit(no_u, "mbar_expect_tx(&rfull[qr], 2 * K * lr);",
                       "mbar_arrive(&rfull[qr]);"),
                 "mbar_expect_tx(&ufull[q], 2 * K * lc);",
                 "mbar_arrive(&ufull[q]);")
    no_fwd = _edit(mma, _SUPER_FWD, "if (false) {")
    no_red = _edit(_edit(core, _CORE_RED[0], "if (true) continue;"),
                   _CORE_RED[1], "if (true) continue;")
    no_core = _edit(_edit(core, _CORE_TR, "if (false) {"), _CORE_FWD,
                    "if (false) {")
    return {
        "super-full": {}, "super-nocompute": {
            _HEADER: _edit(no_fwd, _SUPER_TR, "        if (false) {")},
        "super-noforward": {_HEADER: no_fwd}, "super-nou": {_HEADER: no_u},
        "core-full": {}, "core-nocompute": {"tri_matvec_core.cuh": no_core},
        "core-nocopy": {"tri_matvec_core.cuh": _edit(
            core, _CORE_COPY, _CORE_COPY.replace("hr * per", "0"))},
        "core-noreduce": {"tri_matvec_core.cuh": no_red}}


def routes_main() -> list:
    """``--routes``: the super and core routes' variants, timed."""
    import torch

    from clipper_tpu_torch.bench.harness import time_ms
    from clipper_tpu_torch.ops import flattri

    dev = torch.device("cuda")
    libs = build_edited("tri_matvec_routes", "tri_matvec", route_sources(),
                        ("tri_matvec_int8", "tri_matvec_bf16",
                         "tri_matvec_f32", "tri_matvec_f64"))
    gen = torch.Generator(device=dev).manual_seed(1)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cases = [("super", W, m, t, distinct, kinds)
             for W, m, t, distinct in ((16, 2048, 16, False),
                                       (16, 2048, 64, False),
                                       (512, 1024, 64, True))
             for kinds in (("int8", "bf16"),)]
    cases += [("core", 16, 2000, 100, False, ("int8", "bf16")),
              ("core", 128, 1024, 128, True, ("f32", "f64"))]
    rows = []
    B, K = 128, 16
    for route, W, m, t, distinct, kinds in cases:
        nt = m // t
        S = flattri.tri_ncols(nt, t)
        content = torch.rand(W, 2 * t, S, generator=gen, device=dev)
        content = torch.where(content > 0.9, content, 0.0)
        idx = (torch.randperm(W, generator=gen, device=dev)[:B] if distinct
               else torch.randint(0, W, (B,), generator=gen, device=dev))
        idx = idx.to(torch.int32)
        for kind in kinds:
            tri = ((content * 127).round().to(torch.int8) if kind == "int8"
                   else content.to({"bf16": torch.bfloat16,
                                    "f32": torch.float32,
                                    "f64": torch.float64}[kind]))
            f64 = kind == "f64"
            udt = (torch.float32 if kind == "f32" else torch.float64 if f64
                   else torch.bfloat16)
            U = torch.rand(B, K, m, generator=gen, device=dev).to(udt)
            out = torch.empty(B, K, 2 * m, device=dev,
                              dtype=torch.float64 if f64 else torch.float32)
            args = (tri.data_ptr(), idx.data_ptr(), U.data_ptr(),
                    out.data_ptr())
            row = dict(route=route, storage=kind,
                       shape=f"W={W}, m={m}, t={t}, B={B}, K={K}")
            for name, lib in libs.items():
                if not name.startswith(route + "-"):
                    continue
                fn = getattr(lib, f"tri_matvec_{kind}")
                if kind in ("int8", "bf16"):
                    sc = (1 / 127,) if kind == "int8" else ()
                    taken = ctypes.c_int(-1)

                    def call(fn=fn, sc=sc, taken=taken):
                        return fn(*args, W, B, K, nt, t, S, *sc, stream,
                                  ctypes.byref(taken))
                else:
                    def call(fn=fn):
                        return fn(*args, B, K, nt, t, S, stream)
                _kernels.check(call(), f"tri_matvec_probe {name}")
                row[name.split("-")[1]] = time_ms(call, dev, 10)
            rows.append(row)
            print(f"{route} {kind} ({row['shape']}): " + " | ".join(
                f"{k} {v:.4f} ms" for k, v in row.items()
                if isinstance(v, float)), flush=True)
            del tri
    return rows


def main(argv: List[str] = None) -> list:
    import torch

    from clipper_tpu_torch.bench.harness import time_ms
    from clipper_tpu_torch.ops import flattri

    argv = sys.argv[1:] if argv is None else argv
    parent = None
    if len(argv) == 2 and argv[0] == "--parent":
        parent = argv[1]
    elif argv and argv != ["--routes"]:
        raise SystemExit("usage: python -m clipper_tpu_torch.bench."
                         "tri_matvec_probe [--parent DIR | --routes]")
    if not torch.cuda.is_available():
        raise SystemExit("tri_matvec_probe needs a CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    if argv == ["--routes"]:
        return routes_main()
    libs = build_variants(parent)
    names = [*VARIANTS, *(["parent"] if parent else [])]
    t, nt, P = 256, 4, 512
    m = t * nt
    S = flattri.tri_ncols(nt, t)
    gen = torch.Generator(device=dev).manual_seed(0)
    content = torch.rand(P, 2 * t, S, generator=gen, device=dev)
    content = torch.where(content > 0.9, content, 0.0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = []
    for storage in (torch.int8, torch.bfloat16):
        tri = ((content * 127).round().to(torch.int8)
               if storage == torch.int8 else content.to(storage))
        for B, K in ((128, 16), (512, 1)):
            idx = torch.randperm(P, generator=gen, device=dev)[:B].to(
                torch.int32)
            U = torch.rand(B, K, m, generator=gen, device=dev).bfloat16()
            out = torch.empty(B, K, 2 * m, device=dev)
            args = (tri.data_ptr(), idx.data_ptr(), U.data_ptr(),
                    out.data_ptr(), P, B, K, nt, t, S)
            n_bytes = (B * 2 * t * S * tri.element_size() + B * K * m * 2
                       + B * K * 2 * m * 4)
            row = dict(storage=str(storage).split(".")[-1], B=B, K=K,
                       bound_ms=n_bytes / 3.35e12 * 1e3)
            for name, lib in libs.items():
                if storage == torch.int8:
                    def call(lib=lib):
                        return lib.tri_matvec_int8(
                            *args, 1 / 127, stream,
                            *route_arg(lib, "tri_matvec_int8"))
                else:
                    def call(lib=lib):
                        return lib.tri_matvec_bf16(
                            *args, stream, *route_arg(lib, "tri_matvec_bf16"))
                _kernels.check(call(), f"tri_matvec_probe {name}")
                if name == "full":
                    full_out = out.clone()
                elif name == "parent":
                    row["equal_to_parent"] = bool(torch.equal(out, full_out))
                row[name] = time_ms(call, dev, 50)
            rows.append(row)
            print(f"{row['storage']} B={B} K={K}: "
                  + " | ".join(f"{n} {row[n]:.4f} ms" for n in names)
                  + f" | bound {row['bound_ms']:.4f} ms (bytes)"
                  + (f" | output bit-identical to the parent's: "
                     f"{row['equal_to_parent']}" if parent else ""),
                  flush=True)
    return rows


if __name__ == "__main__":
    main()
