"""Ablations of the flat-triangle builds (kernels 2 and 8, csrc/tri_build.cu
and csrc/tri_build_fused.cu) on the card: where their time goes.

Each variant is the builds' shared body (csrc/tri_pair_build.cuh) with one
part switched off by a text edit, compiled into both kernels by their own
nvcc under build/clipper_tpu_torch/probe/tri_build/<kernel>/<variant>/,
and timed through their C entry points (no wrapper) on
the W=512, m=1024 problems of ``chip_smoke.py``'s main path (the bunny at
rho=0.9 and the point-normal scans; ``parent_ab.stored_inputs``), t=256,
int8 and bf16 storage:

- ``full``: the kernels as the package builds them;
- ``firstpass``: the first pass alone (masks and the screen of the gate
  for every pair), without the second pass's exact scores;
- ``nowrite``: both passes, without writing the staged codes out.

The variants' outputs are wrong by design; only their times mean
anything. Run on a machine with the card:

    python -m clipper_tpu_torch.bench.tri_build_probe

It prints the card's name and power limit, then one line per problem set
and storage with each variant's ms, for kernel 2 and kernel 8.
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
_KEEP = "  if (passed == 0x12345678u) here[0] = 1;\n  unit_sync(bar);\n"
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
    return rows


if __name__ == "__main__":
    main()
