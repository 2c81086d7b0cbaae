"""Ablations of the tri pool matvec (kernel 1, csrc/tri_matvec.cu) on the
card: where its time goes.

Each variant is the kernel's own source with one part switched off by a
text edit, compiled by its own nvcc into
build/clipper_tpu_torch/probe/<variant>/ and timed through its C entry
point (no wrapper) at the main path's shapes: m=1024, t=256, P=512 stored
problems of random content (10% of pairs kept), B=128 lanes at K=16 and
B=512 at K=1, int8 and bf16 storage.

- ``full``: the kernel as the package builds it;
- ``nocompute``: the consumer warps wait for every panel, release it and
  write their (zero) sums, but take no fragment and run no mma: the data
  movement alone (panels, u slots, the output's raw sums);
- ``noforward`` / ``notransposed``: one of the two products left out.

The variants' outputs are wrong by design; only their times mean
anything. Run on a machine with the card:

    python -m clipper_tpu_torch.bench.tri_matvec_probe

It prints the card's name and power limit, then one line per storage and
shape with each variant's ms beside the bound.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import Dict, List

from clipper_tpu_torch import _kernels

_FORWARD = "if ((warp >> 2) == (p & 1)) {"
_TRANSPOSED = ("        if (!diag) {\n#pragma unroll\n"
               "          for (int f = 0; f < F; ++f) {")
VARIANTS = ("full", "nocompute", "noforward", "notransposed")


def _edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"tri_matvec_probe: {old!r} is not in "
                           "csrc/tri_matvec.cu; update the probe's edits")
    return src.replace(old, new, 1)


def variant_sources() -> Dict[str, str]:
    """The source text of every variant."""
    src = (_kernels.CSRC / "tri_matvec.cu").read_text()
    no_fwd = _edit(src, _FORWARD, "if (false) {")
    no_tr = _edit(src, _TRANSPOSED, _TRANSPOSED.replace("!diag", "false"))
    return {"full": src, "nocompute": _edit(no_fwd, _TRANSPOSED,
                                            _TRANSPOSED.replace("!diag",
                                                                "false")),
            "noforward": no_fwd, "notransposed": no_tr}


def build_variants() -> Dict[str, ctypes.CDLL]:
    """Compile every variant (one nvcc each, all started together) and
    load them."""
    out_dir = _kernels.BUILD_DIR / "probe"
    procs = {}
    for name, src in variant_sources().items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "tri_matvec.cu").write_text(src)
        for h in _kernels.CSRC.glob("*.cuh"):
            (d / h.name).write_bytes(h.read_bytes())
        cmd = [_kernels._nvcc(), *_kernels._ARCH, *_kernels._COMMON,
               "-o", str(d / "lib.so"), str(d / "tri_matvec.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"tri_matvec_probe: {name} failed to build:"
                               f"\n{log}")
        lib = ctypes.CDLL(os.path.abspath(out_dir / name / "lib.so"))
        for fn in ("tri_matvec_int8", "tri_matvec_bf16"):
            getattr(lib, fn).argtypes = _kernels._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv: List[str] = None) -> list:
    import torch

    from clipper_tpu_torch.bench.harness import time_ms
    from clipper_tpu_torch.ops import flattri

    argv = sys.argv[1:] if argv is None else argv
    if argv:
        raise SystemExit("usage: python -m "
                         "clipper_tpu_torch.bench.tri_matvec_probe")
    if not torch.cuda.is_available():
        raise SystemExit("tri_matvec_probe needs a CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    libs = build_variants()
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
                        return lib.tri_matvec_int8(*args, 1 / 127, stream)
                else:
                    def call(lib=lib):
                        return lib.tri_matvec_bf16(*args, stream)
                _kernels.check(call(), f"tri_matvec_probe {name}")
                row[name] = time_ms(call, dev, 50)
            rows.append(row)
            print(f"{row['storage']} B={B} K={K}: "
                  + " | ".join(f"{n} {row[n]:.4f} ms" for n in VARIANTS)
                  + f" | bound {row['bound_ms']:.4f} ms (bytes)",
                  flush=True)
    return rows


if __name__ == "__main__":
    main()
