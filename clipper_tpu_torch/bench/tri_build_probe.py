"""Ablations of the builds on the pair body (kernels 2 and 8, csrc/
tri_build.cu and csrc/tri_build_fused.cu; kernel 6, csrc/affinity_build.cu)
on the card: where their time goes.

Each variant is the builds' shared body (csrc/tri_pair_build.cuh) with one
part switched off by a text edit, compiled into each kernel by its own
nvcc under build/clipper_tpu_torch/probe/tri_build/<kernel>/<variant>/,
and timed through its C entry points (no wrapper): kernels 2 and 8 on
the W=512, m=1024 problems of ``chip_smoke.py``'s main path (the bunny at
rho=0.9 and the point-normal scans; ``parent_ab.stored_inputs``), t=256,
int8 and bf16 storage; kernel 6 on ``chip_smoke.py`` phase 6's two
problems (point-normal m=5000 at rho=0.8, the first bunny problem at
m=1024), f32 and f64:

- ``full``: the kernels as the package builds them;
- ``firstpass``: the first pass alone (masks and the screen of the gate
  for every pair), without the second pass's exact scores;
- ``nowrite``: both passes, without writing the staged codes out.

The variants' outputs are wrong by design; only their times mean
anything. Run on a machine with the card:

    python -m clipper_tpu_torch.bench.tri_build_probe

It prints the card's name and power limit, then one line per problem set
and storage with each variant's ms, for kernels 2, 8 and 6.
"""

from __future__ import annotations

import subprocess
import sys
from typing import Dict, List

from clipper_tpu_torch import _kernels
from clipper_tpu_torch.bench.tri_matvec_probe import _edit, build_edited

_HEADER = "tri_pair_build.cuh"
_SECOND = "  // the second pass:"
_WRITE = "  write_staged<T, kStream>(here, M + p.at"
_END = "}\n\n}  // namespace"
# keeps the first pass's marks alive where the second pass is cut
_KEEP = "  if (passed == 0x12345678u) here[0] = 1;\n  unit_sync<kN>(bar);\n"
VARIANTS = ("full", "firstpass", "nowrite")


def variant_sources() -> Dict[str, str]:
    """The text of every variant's body (csrc/tri_pair_build.cuh)."""
    src = (_kernels.CSRC / _HEADER).read_text()
    for mark in (_SECOND, _WRITE, _END):
        _edit(src, mark, mark)
    cut = src[src.index(_SECOND):src.index(_WRITE)]
    return {"full": src,
            "firstpass": _edit(src, cut, _KEEP),
            "nowrite": src[:src.index(_WRITE)] + src[src.index(_END):]}


def dense_variant_files() -> Dict[str, Dict[str, str]]:
    """Kernel 6's variants: the files (name -> text) each replaces."""
    return {name: {_HEADER: src} for name, src in variant_sources().items()}


def dense_rows(dev) -> list:
    """Kernel 6's variants on chip_smoke.py phase 6's two problems, f32
    and f64."""
    import numpy as np
    import torch

    from clipper_tpu_torch.bench import harness, parent_ab
    from clipper_tpu_torch.bench.harness import time_ms
    from clipper_tpu_torch.invariants import kernel_score
    from clipper_tpu_torch.ops.affinity import gather_endpoints

    libs = build_edited("tri_build/affinity_build", "affinity_build",
                        dense_variant_files(),
                        ("affinity_build_f32", "affinity_build_f64"))
    stream = torch.cuda.current_stream(dev).cuda_stream
    D1, D2, A, _ = harness.make_pointnormal_problem(
        np.random.default_rng(0), n=2000, m=5000, rho=0.8)
    At = torch.as_tensor(A, dtype=torch.int32, device=dev)
    B1, B2, BA = parent_ab.stored_inputs("euclidean", 1, 1024, dev)
    rows = []
    for dtype, name in ((torch.float32, "f32"), (torch.float64, "f64")):
        pn = gather_endpoints(torch.as_tensor(D1, dtype=dtype, device=dev),
                              torch.as_tensor(D2, dtype=dtype, device=dev),
                              At) + (At,)
        for kind, inv, (P1, P2, Ak) in (
                ("pointnormal", harness.pointnormal_invariant(), pn),
                ("euclidean", harness.default_invariant(),
                 (B1[0].to(dtype), B2[0].to(dtype), BA[0]))):
            code, _, params = kernel_score(inv)
            m = P1.shape[0]
            M, C = (torch.empty(m, m, dtype=dtype, device=dev)
                    for _ in range(2))
            row = dict(kernel="affinity_build", kind=kind, dtype=name, m=m)
            for v, lib in libs.items():
                fn = getattr(lib, f"affinity_build_{name}")

                def call(fn=fn):
                    return fn(P1.data_ptr(), P2.data_ptr(), Ak.data_ptr(),
                              M.data_ptr(), C.data_ptr(), m, code, *params,
                              1e-4, stream)
                _kernels.check(call(), f"tri_build_probe affinity_build {v}")
                row[v] = time_ms(call, dev, 20)
            rows.append(row)
            print(f"affinity_build {kind} {name} m={m}: " + " | ".join(
                f"{n} {row[n]:.4f} ms" for n in VARIANTS), flush=True)
            del M, C
        del pn
    return rows


def main(argv: List[str] = None) -> list:
    import torch

    from clipper_tpu_torch.bench import harness, parent_ab
    from clipper_tpu_torch.bench.harness import time_ms
    from clipper_tpu_torch.invariants import kernel_score
    from clipper_tpu_torch.ops import flattri

    argv = sys.argv[1:] if argv is None else argv
    if argv:
        raise SystemExit("usage: python -m clipper_tpu_torch.bench."
                         "tri_build_probe")
    if not torch.cuda.is_available():
        raise SystemExit("tri_build_probe needs a CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    edited = {name: {_HEADER: src}
              for name, src in variant_sources().items()}
    libs = {cu: build_edited(f"tri_build/{cu}", cu, edited,
                             (f"{cu}_int8", f"{cu}_bf16"))
            for cu in ("tri_build", "tri_build_fused")}
    W, m, t = 512, 1024, 256
    S = flattri.tri_ncols(m // t, t)
    stream = torch.cuda.current_stream(dev).cuda_stream
    mts = torch.full((W,), m, dtype=torch.int32, device=dev)
    rows = []
    for kind, inv in (("euclidean", harness.default_invariant()),
                      ("pointnormal", harness.pointnormal_invariant())):
        P1, P2, A = parent_ab.stored_inputs(kind, W, m, dev)
        code, _, params = kernel_score(inv)
        args = (P1.data_ptr(), P2.data_ptr(), A.data_ptr(), mts.data_ptr())
        for storage, sname in ((torch.int8, "int8"),
                               (torch.bfloat16, "bf16")):
            out = torch.empty(W, 2 * t, S, dtype=storage, device=dev)
            for cu, by_variant in libs.items():
                row = dict(kernel=cu, kind=kind, storage=sname, W=W, m=m)
                for name, lib in by_variant.items():
                    fn = getattr(lib, f"{cu}_{sname}")

                    def call(fn=fn):
                        return fn(*args, out.data_ptr(), W, m, t, S, code,
                                  *params, 1e-4, stream)
                    _kernels.check(call(), f"tri_build_probe {cu} {name}")
                    row[name] = time_ms(call, dev, 10)
                rows.append(row)
                print(f"{cu} {kind} {sname} W={W} m={m}: " + " | ".join(
                    f"{n} {row[n]:.4f} ms" for n in VARIANTS), flush=True)
            del out
    return rows + dense_rows(dev)


if __name__ == "__main__":
    main()
