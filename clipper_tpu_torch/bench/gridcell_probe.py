"""Per-stage times of one Monte-Carlo grid cell (the m=2048 probe).

Counterpart of ``clipper_tpu/bench/gridcell_probe.py``: the stacked pool
of the grid (``layout="stacked"``, int8, ``lanes=128``, ``window=12``,
``power_steps=4``: csrc/stored_build.cu on the card) on W problems at one
m, per outlier ratio, with each stage's time and the pool's window count.
The JAX driver re-dispatched the stages by hand (``fused=False``) to time
them under XLA; here the pool pipeline reports its own stage times
(``timings={}``: build, init, solve, polish; CUDA events on the card) and
windows and ticks (``stats={}``) from one timed call after a warm-up.
Inits: a CPU ``torch.Generator`` seeded 0, the same W vectors for every
ratio, as the JAX driver reused its key.

Usage: python -m clipper_tpu_torch.bench.gridcell_probe [trials] [m] \\
           [--rhos=0,0.4,0.8,0.9] [--device=cuda|cpu]
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from clipper_tpu_torch.bench import data, harness
from clipper_tpu_torch.parallel import pool
from clipper_tpu_torch.types import Params


def main(argv=None) -> List[dict]:
    pos, opts = harness.parse_argv(argv)
    dev = harness.bench_device(opts)
    W = int(pos[0]) if pos else 20
    m = int(pos[1]) if len(pos) > 1 else 2048
    rhos = ([float(x) for x in str(opts["rhos"]).split(",")]
            if "rhos" in opts else [0.0, 0.4, 0.8, 0.9])

    rng = np.random.default_rng(0)
    pcd0 = harness.load_bunny()
    D1 = torch.as_tensor(pcd0, dtype=torch.float32, device=dev)
    u0s = torch.rand(W, m, generator=torch.Generator().manual_seed(0)).to(
        dev)
    pipe = pool.make_pool_pipeline(
        harness.default_invariant(), Params(), storage_dtype=torch.int8,
        lanes=128, window=12, power_steps=4, layout="stacked", device=dev)

    print(f"grid cell probe on {harness.device_name(dev)}: W={W} m={m}",
          flush=True)
    rows = []
    for rho in rhos:
        problems = [harness.make_problem(pcd0, m, rho, rng)
                    for _ in range(W)]
        D2s = torch.as_tensor(np.stack([p[0] for p in problems]),
                              dtype=torch.float32, device=dev)
        As = torch.as_tensor(np.stack([p[1] for p in problems]),
                             dtype=torch.int32, device=dev)
        pipe(D1, D2s, As, u0s)          # warm-up
        harness.sync(dev)
        timings, stats = {}, {}
        t0 = time.perf_counter()
        solns = pipe(D1, D2s, As, u0s, timings=timings, stats=stats)
        harness.sync(dev)
        t_total = (time.perf_counter() - t0) * 1e3

        nnz = (solns.u > 0).sum(-1).cpu().numpy()
        masks = solns.mask.cpu().numpy()
        pr = [data.get_precision_recall(A[masks[b]], Agt)
              for b, (_, A, Agt) in enumerate(problems) if Agt.size]
        P = float(np.mean([p for p, _ in pr])) if pr else 1.0
        R = float(np.mean([r for _, r in pr])) if pr else 1.0
        ticks = stats["ticks"].cpu().numpy()
        row = dict(rho=rho, m=m, total_ms=t_total, windows=stats["windows"],
                   max_ticks=int(ticks.max()), max_nnz=int(nnz.max()),
                   precision=P, recall=R, **{f"{k}_ms": v
                                             for k, v in timings.items()})
        rows.append(row)
        print(f"rho={rho:4.2f}: build {timings['build']:7.1f} ms  init "
              f"{timings['init']:7.1f} ms  solve {timings['solve']:7.1f} ms "
              f"({stats['windows']} windows, max {row['max_ticks']} ticks)  "
              f"polish {timings['polish']:6.1f} ms  call {t_total:7.1f} ms  "
              f"max-nnz {row['max_nnz']}  P={P * 100:.1f}% R={R * 100:.1f}%",
              flush=True)
    return rows


if __name__ == "__main__":
    main()
