"""Ablations of the capacity engines' unit kernel (kernels 3 and 7,
csrc/sym_tile_mma.cuh) on the card: where its time goes.

Each variant is the package's sources with one part switched off by a
text edit of csrc/sym_tile_mma.cuh or csrc/bf16_mma.cuh, compiled into
csrc/sym_tiles_matvec.cu by its own nvcc under
build/clipper_tpu_torch/probe/sym_unit/<variant>/ and timed through its C
entry point (no wrapper) on a tile list at the capacity path's shapes:
m=65,536, t=128, random content, with its plan (ops/symstore.tiles_plan)
built beforehand; int8 at K=16 and K=1, bf16 at K=16.

- ``full``: the two passes as the package builds them;
- ``nocompute``: the unit pass's warps wait for every stage, release and
  refill it and write their (zero) partials, but take no product: the
  data movement alone (stages, u blocks, the workspace), and the
  reduction;
- ``noforward`` / ``notransposed``: one of the two products left out;
- ``nof64``: the products taken, their f32 tile partials not added to the
  f64 sums (kept alive by a test no value passes);
- ``noconv``: the int8 codes taken as they are, not converted to bf16;
- ``reduceonly``: the reduction pass alone (the unit pass not launched).

The variants' outputs are wrong by design; only their times mean
anything. Run on a machine with the card:

    python -m clipper_tpu_torch.bench.sym_unit_probe

It prints the card's name and power limit, then one line per storage and
K with each variant's ms beside the bound.
"""

from __future__ import annotations

import subprocess
import sys
from typing import Dict, List

from clipper_tpu_torch import _kernels
from clipper_tpu_torch.bench.tri_matvec_probe import _edit, build_edited

_HEADER = "sym_tile_mma.cuh"
_MMA = "bf16_mma.cuh"
_FORWARD = "    bf16mma::forward_regs<S, kT, NK, kT, true>("
_TRANSPOSED = "    bf16mma::transposed<S, kT, NK, kT, true>("
_ADD_ROW = "    add_row<0, NK>(fwd, i, pf);"
_ADD_COL = "    if (meta & kMetaTransposed) add_f64(col, pt);"
_CONVERT = "__byte_perm(w, 0x43434343u, kSel);"
_UNITS = "  if (plan.n_units > 0) {"
VARIANTS = ("full", "nocompute", "noforward", "notransposed", "nof64",
            "noconv", "reduceonly")


def _off(src: str, line: str) -> str:
    return _edit(src, line, line.replace("    bf16mma::",
                                         "    if (false) bf16mma::"))


def variant_sources() -> Dict[str, Dict[str, str]]:
    """Each variant's edited sources, file name -> text (none for full)."""
    src = (_kernels.CSRC / _HEADER).read_text()
    mma = (_kernels.CSRC / _MMA).read_text()
    no_f64 = _edit(_edit(src, _ADD_ROW, "    if (pf[0][0] == -1e30f)\n  "
                         + _ADD_ROW),
                   _ADD_COL, "    if (pt[0][0] == -1e30f) add_f64(col, pt);")
    return {"full": {},
            "nocompute": {_HEADER: _off(_off(src, _FORWARD), _TRANSPOSED)},
            "noforward": {_HEADER: _off(src, _FORWARD)},
            "notransposed": {_HEADER: _off(src, _TRANSPOSED)},
            "nof64": {_HEADER: no_f64},
            "noconv": {_MMA: _edit(mma, _CONVERT, "w;")},
            "reduceonly": {_HEADER: _edit(src, _UNITS, "  if (false) {")}}


def main(argv: List[str] = None) -> list:
    import torch

    from clipper_tpu_torch.bench.harness import time_ms
    from clipper_tpu_torch.ops import symstore

    argv = sys.argv[1:] if argv is None else argv
    if argv:
        raise SystemExit("usage: python -m "
                         "clipper_tpu_torch.bench.sym_unit_probe")
    if not torch.cuda.is_available():
        raise SystemExit("sym_unit_probe needs a CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    libs = build_edited("sym_unit", "sym_tiles_matvec", variant_sources(),
                        ("sym_tiles_matvec_int8", "sym_tiles_matvec_bf16"))
    m, t = 65536, 128
    nt = m // t
    T = nt * (nt + 1) // 2
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = []
    for storage in (torch.int8, torch.bfloat16):
        if storage == torch.int8:
            tiles = torch.randint(0, 128, (T, 2 * t, t), generator=gen,
                                  device=dev, dtype=torch.int8)
        else:
            tiles = torch.rand(T, 2 * t, t, generator=gen, device=dev,
                               dtype=torch.bfloat16)
        plan = symstore.tiles_device_plan(tiles, nt)
        for K in ((16, 1) if storage == torch.int8 else (16,)):
            U = torch.rand(K, m, generator=gen, device=dev).bfloat16()
            out = torch.empty(K, 2 * m, device=dev)
            ws = plan.workspace(K)
            args = (tiles.data_ptr(), T * 2 * t, t, *plan.args(),
                    U.data_ptr(), out.data_ptr(), ws.data_ptr(), K, nt, t, 0)
            n_bytes = (T * 2 * t * t * tiles.element_size() + K * m * 2
                       + K * 2 * m * 4)
            row = dict(storage=str(storage).split(".")[-1], K=K,
                       bound_ms=n_bytes / 3.35e12 * 1e3)
            for name, lib in libs.items():
                if storage == torch.int8:
                    def call(lib=lib):
                        return lib.sym_tiles_matvec_int8(*args, 1 / 127,
                                                         stream)
                else:
                    def call(lib=lib):
                        return lib.sym_tiles_matvec_bf16(*args, stream)
                _kernels.check(call(), f"sym_unit_probe {name}")
                row[name] = time_ms(call, dev, 10)
            rows.append(row)
            print(f"{row['storage']} K={K}: "
                  + " | ".join(f"{n} {row[n]:.4f} ms" for n in VARIANTS)
                  + f" | bound {row['bound_ms']:.4f} ms (bytes)",
                  flush=True)
        del tiles, plan
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
