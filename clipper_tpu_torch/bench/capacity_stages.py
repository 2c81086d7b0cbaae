"""Stage times of the capacity path's warm calls.

One bunny problem (m=65,536 by default, rho=0.95, seed 0; u0 from numpy
``default_rng(0)``, as ``chip_smoke.py`` phase 4) through the facade's
triangle engine in f32, row-chunked (``--layout=rows``, the layout
``engine="auto"`` takes) or the tile list (``--layout=tiles``): one
warm-up call, then ``--calls`` timed calls, each printing its stage ms
(build, init, solve, polish; CUDA events on the card) and its wall s.

It calls nothing but the facade and the bench harness, so the same file
times another checkout's package beside this one in one machine session:
run it by path with PYTHONPATH set to that checkout, e.g.

    python3 clipper_tpu_torch/bench/capacity_stages.py 65536 --calls=3
    PYTHONPATH=build/parent python3 \\
        clipper_tpu_torch/bench/capacity_stages.py 65536 --calls=3

Usage:
  python -m clipper_tpu_torch.bench.capacity_stages [m] [--calls=3] \\
      [--layout=rows|tiles] [--device=cuda|cpu]
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

import clipper_tpu_torch
from clipper_tpu_torch import Clipper
from clipper_tpu_torch.bench import harness
from clipper_tpu_torch.types import Params

STAGES = ("build", "init", "solve", "polish")


def main(argv=None) -> list:
    pos, opts = harness.parse_argv(argv)
    dev = harness.bench_device(opts)
    m = int(pos[0]) if pos else 65536
    calls = int(opts.get("calls", 3))
    layout = str(opts.get("layout", "rows"))
    if layout not in ("rows", "tiles"):
        raise SystemExit(f"--layout must be rows or tiles, not {layout!r}")
    pkg = os.path.dirname(os.path.dirname(clipper_tpu_torch.__file__))
    print(f"capacity stages on {harness.device_name(dev)}: m={m}, "
          f"layout={layout}, package from {pkg}", flush=True)
    pcd0 = harness.load_bunny()
    pcd1, A, _ = harness.make_problem(pcd0, m, 0.95,
                                      np.random.default_rng(0))
    u0 = np.random.default_rng(0).random(m).astype(np.float32)
    stats = {}
    opts = {"stats": stats, **({"matvec": "xla"} if layout == "tiles"
                               else {})}
    c = Clipper(harness.default_invariant(), Params(), engine="triangle",
                dtype=torch.float32, device=dev, engine_opts=opts)
    c.score_pairwise_consistency(pcd0.astype(np.float32).T,
                                 pcd1.astype(np.float32).T,
                                 A.astype(np.int32))
    c.solve(u0=u0)
    rows = []
    for n in range(calls):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        c.solve(u0=u0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        row = dict(wall_s=time.perf_counter() - t0,
                   **{k: float(stats[k]) for k in STAGES})
        rows.append(row)
        print(f"call {n}: wall {row['wall_s']:.4f} s; stage ms "
              + ", ".join(f"{k}={row[k]:.3f}" for k in STAGES), flush=True)
    return rows


if __name__ == "__main__":
    main()
