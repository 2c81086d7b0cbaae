"""Pool-engine A/B driver: storage layouts x line-search configurations.

Counterpart of ``clipper_tpu/bench/pool_ab.py``: runs the whole pool
pipeline (build, compacted solve, polish) for each named configuration on
the same W problems and prints the best-of-3 call time, problems/s and
P/R. Every configuration names its layout and storage (int8) explicitly,
as the JAX call means it: the port's ``make_pool_pipeline`` defaults to
``layout="tri"`` where the JAX one defaults to ``"stacked"``. The JAX
driver's ``chunk=128`` shaped an XLA loop and its ``.jax_cache``
settings its compiles; neither has a counterpart here.

Named configurations: stacked (the stacked engine, window 12), tri (flat
triangle, K=1), tri-k8 / tri-k16 (the K-wide multiprobe tick), tri-k16-ds
(K=16 and d_scale=0.15, bench.py's).

Usage:
  python -m clipper_tpu_torch.bench.pool_ab [W] [--m=1024] [--rho=0.9] \\
      [--configs=stacked,tri-k16] [--device=cuda|cpu]
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from clipper_tpu_torch.bench import data, harness
from clipper_tpu_torch.parallel import pool
from clipper_tpu_torch.types import Params

CONFIGS = {
    "stacked": dict(layout="stacked", window=12),
    "tri": dict(layout="tri", tri_probes=1, window=12),
    "tri-k8": dict(layout="tri", tri_probes=8, window=6),
    "tri-k16": dict(layout="tri", tri_probes=16, window=2),
    "tri-k16-ds": dict(layout="tri", tri_probes=16, window=2,
                       d_scale=0.15),
}


def main(argv=None) -> List[dict]:
    pos, opts = harness.parse_argv(argv)
    dev = harness.bench_device(opts)
    W = int(pos[0]) if pos else 512
    m = int(opts.get("m", 1024))
    rho = float(opts.get("rho", 0.9))
    names = (str(opts["configs"]).split(",") if "configs" in opts
             else list(CONFIGS))

    rng = np.random.default_rng(0)
    pcd0 = harness.load_bunny()
    problems = [harness.make_problem(pcd0, m, rho, rng) for _ in range(W)]
    D1 = torch.as_tensor(pcd0, dtype=torch.float32, device=dev)
    D2s = torch.as_tensor(np.stack([p[0] for p in problems]),
                          dtype=torch.float32, device=dev)
    As = torch.as_tensor(np.stack([p[1] for p in problems]),
                         dtype=torch.int32, device=dev)
    u0s = torch.rand(W, m, generator=torch.Generator().manual_seed(0)).to(
        dev)
    inv = harness.default_invariant()

    print(f"pool A/B on {harness.device_name(dev)}: W={W} m={m} rho={rho}",
          flush=True)
    print("| config | ms/batch | problems/s | P [%] | R [%] |")
    print("|---|---|---|---|---|")
    rows = []
    for name in names:
        pipe = pool.make_pool_pipeline(inv, Params(), lanes=128,
                                       storage_dtype=torch.int8,
                                       power_steps=4, device=dev,
                                       **CONFIGS[name])
        s = pipe(D1, D2s, As, u0s)        # warm-up
        harness.sync(dev)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            s = pipe(D1, D2s, As, u0s)
            harness.sync(dev)
            best = min(best, time.perf_counter() - t0)
        masks = s.mask.cpu().numpy()
        pr = [data.get_precision_recall(A[masks[b]], Agt)
              for b, (_, A, Agt) in enumerate(problems)]
        ps, rs = zip(*pr)
        row = dict(config=name, m=m, rho=rho, ms=best * 1e3,
                   problems_per_s=W / best, precision=float(np.mean(ps)),
                   recall=float(np.mean(rs)))
        rows.append(row)
        print(f"| {name} | {row['ms']:.1f} | {row['problems_per_s']:.0f} | "
              f"{row['precision'] * 100:.1f} | {row['recall'] * 100:.1f} |",
              flush=True)
    return rows


if __name__ == "__main__":
    main()
