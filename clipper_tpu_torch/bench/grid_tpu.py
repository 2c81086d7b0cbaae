"""The Monte-Carlo benchmark grid through the pool engine, on the card.

Counterpart of ``clipper_tpu/bench/grid_tpu.py`` (reference:
benchmarks/main.cpp:206-294); the name is kept so that the counterpart is
easy to find, but it runs on the GPU (``--device=cuda``, the default) or,
with ``--device=cpu``, the plain PyTorch versions on the host. It runs
the reference grid, m in {64, 256, 512, 1024, 2048} x outlier ratio in
{0, .2, .4, .8, .9}, ``trials`` problems a cell, and solves each cell's
trials in one call of a pool pipeline:

- ``--engine=pool`` (the default): for m % 128 == 0 the triangle pool
  (``layout="tri"``, int8, ``tri_probes=16``, ``window=2``,
  ``power_steps=4``, ``d_scale=0.15``: csrc/tri_build.cu and
  csrc/tri_matvec.cu on the card), else the stacked pool
  (``layout="stacked"``, int8, ``window=12``, ``power_steps=4``:
  csrc/stored_build.cu), each with ``lanes=min(trials, 128)``;
- ``--engine=batched``: the batched engine in lock-step,
  ``make_batched_pipeline(matvec="stacked_bf16")``.

Low-outlier cells have cliques up to size m: the pool's polish takes its
exact-overflow branch (``pool.exact_objective_rows``) when a converged
support exceeds the top-k window. Prints a markdown table of the
per-problem time, the cell's call time and mean precision/recall, and
returns its rows. Problems come from numpy ``default_rng(0)``, inits from
a CPU ``torch.Generator`` seeded 0. The JAX driver's ``.jax_cache``
settings have no counterpart here.

Usage: python -m clipper_tpu_torch.bench.grid_tpu [trials] \\
           [--engine=pool|batched] [--device=cuda|cpu]
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from clipper_tpu_torch.bench import data, harness
from clipper_tpu_torch.parallel import batched, pool
from clipper_tpu_torch.types import Params

NUM_ASSOCS = (64, 256, 512, 1024, 2048)
OUTRATS = (0.0, 0.2, 0.4, 0.8, 0.9)


def main(argv=None) -> List[dict]:
    pos, opts = harness.parse_argv(argv)
    dev = harness.bench_device(opts)
    engine = str(opts.get("engine", "pool"))
    if engine not in ("pool", "batched"):
        raise ValueError(f"unknown engine {engine!r}")
    trials = int(pos[0]) if pos else 20

    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    pcd0 = harness.load_bunny()
    inv = harness.default_invariant()
    if engine == "pool":
        lanes = min(trials, 128)
        pipe_tri = pool.make_pool_pipeline(
            inv, Params(), storage_dtype=torch.int8, lanes=lanes, window=2,
            power_steps=4, layout="tri", tri_probes=16, d_scale=0.15,
            device=dev)
        pipe_stacked = pool.make_pool_pipeline(
            inv, Params(), storage_dtype=torch.int8, lanes=lanes, window=12,
            power_steps=4, layout="stacked", device=dev)

        def pipe_for(m):
            return pipe_tri if m % 128 == 0 else pipe_stacked
    else:
        pipe_b = batched.make_batched_pipeline(
            inv, Params(), solver="flat", matvec="stacked_bf16", device=dev)

        def pipe_for(m):
            return pipe_b

    print(f"grid on {harness.device_name(dev)}, engine={engine}, "
          f"{trials} trials a cell", flush=True)
    print("| rho | m | end-to-end/problem [ms] | batch total [ms] | P [%] "
          "| R [%] |")
    print("|---|---|---|---|---|---|")
    D1 = torch.as_tensor(pcd0, dtype=torch.float32, device=dev)
    rows = []
    for m in NUM_ASSOCS:
        for rho in OUTRATS:
            problems = [harness.make_problem(pcd0, m, rho, rng)
                        for _ in range(trials)]
            D2s = torch.as_tensor(np.stack([p[0] for p in problems]),
                                  dtype=torch.float32, device=dev)
            As = torch.as_tensor(np.stack([p[1] for p in problems]),
                                 dtype=torch.int32, device=dev)
            u0s = torch.rand(trials, m, generator=gen).to(dev)
            pipe = pipe_for(m)
            pipe(D1, D2s, As, u0s)          # warm-up
            harness.sync(dev)
            t0 = time.perf_counter()
            solns = pipe(D1, D2s, As, u0s)
            harness.sync(dev)
            dt = time.perf_counter() - t0

            masks = solns.mask.cpu().numpy()
            pr = [data.get_precision_recall(A[masks[b]], Agt)
                  for b, (_, A, Agt) in enumerate(problems) if Agt.size]
            ps, rs = zip(*pr)
            row = dict(rho=rho, m=m, ms_per_problem=dt / trials * 1e3,
                       ms_batch=dt * 1e3,
                       precision=float(np.mean(ps)),
                       recall=float(np.mean(rs)))
            rows.append(row)
            print(f"| {rho:.1f} | {m} | {row['ms_per_problem']:.2f} | "
                  f"{row['ms_batch']:.1f} | {row['precision'] * 100:.1f} | "
                  f"{row['recall'] * 100:.1f} |", flush=True)
    return rows


if __name__ == "__main__":
    main()
