"""Mixed problem sizes: bucketed batching against homogeneous batches.

Counterpart of ``clipper_tpu/bench/mixed_bench.py``. Real association
queues mix m; the check is that a problem's cost in a mixed workload
tracks its own size bucket (pad to the bucket, one pool pipeline a
bucket: ``buckets.make_bucketed_pipeline``, which fills in the JAX
package's defaults, the stacked layout), not the workload's largest m.
Here with int8 storage, ``power_steps=4`` and ``window=12``, as the JAX
driver asks. Inits: U[0, 1) from a CPU ``torch.Generator`` seeded 0, one
a problem in order; the workload is then shuffled by numpy
``default_rng(0)``.

Usage: python -m clipper_tpu_torch.bench.mixed_bench [W_per_size] [reps] \\
           [--device=cuda|cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from clipper_tpu_torch.bench import data, harness
from clipper_tpu_torch.parallel import buckets
from clipper_tpu_torch.types import Params

SIZES = (256, 512, 1024, 2048)


def main(argv=None) -> dict:
    pos, opts = harness.parse_argv(argv)
    dev = harness.bench_device(opts)
    Wp = int(pos[0]) if len(pos) > 0 else 32
    reps = int(pos[1]) if len(pos) > 1 else 3
    rho = 0.9

    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    pcd0 = harness.load_bunny().astype(np.float32)
    workload, gts = [], []
    for m in SIZES:
        for _ in range(Wp):
            pcd1, A, Agt = harness.make_problem(pcd0, m, rho, rng)
            u0 = torch.rand(m, generator=gen).numpy()
            workload.append((pcd1.astype(np.float32), A.astype(np.int32),
                             u0))
            gts.append(Agt)
    order = rng.permutation(len(workload))
    workload = [workload[i] for i in order]
    gts = [gts[i] for i in order]

    bp = buckets.make_bucketed_pipeline(
        harness.default_invariant(), Params(), storage_dtype=torch.int8,
        power_steps=4, window=12, device=dev)

    def best_of(problems):
        solns = bp(pcd0, problems)           # warm-up; host results
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            solns = bp(pcd0, problems)
            times.append(time.perf_counter() - t0)
        return solns, min(times)

    print(f"mixed bench on {harness.device_name(dev)}", flush=True)
    solns, t_mixed = best_of(workload)
    pr = [data.get_precision_recall(A[s.mask.numpy()], Agt)
          for s, (_, A, _), Agt in zip(solns, workload, gts)]
    ps, rs = zip(*pr)
    n = len(workload)
    print(f"mixed workload: {n} problems (m in {SIZES}, {Wp} each), "
          f"{t_mixed * 1e3:.1f} ms total = {t_mixed / n * 1e3:.3f} ms/problem"
          f"  P={np.mean(ps) * 100:.1f}% R={np.mean(rs) * 100:.1f}%",
          flush=True)

    homo = {}
    for m in SIZES:
        probs = [w for w in workload if w[1].shape[0] == m]
        _, dt = best_of(probs)
        homo[m] = dt * 1e3
        print(f"  homogeneous m={m:5d}: {dt * 1e3:8.1f} ms for {len(probs)}"
              f" -> {dt / len(probs) * 1e3:.3f} ms/problem", flush=True)
    total_homo = sum(homo.values()) / 1e3
    print(f"mixed / sum-of-homogeneous = {t_mixed / total_homo:.2f} "
          f"(1.0 = zero heterogeneity penalty)", flush=True)
    return dict(mixed_ms=t_mixed * 1e3, precision=float(np.mean(ps)),
                recall=float(np.mean(rs)), homogeneous_ms=homo,
                ratio=t_mixed / total_homo)


if __name__ == "__main__":
    main()
