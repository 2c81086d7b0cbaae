"""Multistart overhead: K restarts a problem as extra pool lanes.

Counterpart of ``clipper_tpu/bench/multistart_bench.py``. The PGA solver
is a local method; the reference documents u0 sensitivity and leaves
restarts to the caller (reference: clipper.h:44-47). The pool makes K-way
multistart a scheduling problem: the K restarts are extra lanes sharing
the problem's stored [M; C] (``pool.make_pool_multistart_pipeline``), and
the restart is chosen by a top-k support polish, not a rebuild.

Prints single-start against K-restart cost a problem at matched settings
(the stacked pool: int8, ``power_steps=4``, ``window=12``,
``lanes=min(128, W)``; the single start names ``layout="stacked"``, the
JAX default, which the port's ``make_pool_pipeline`` does not share),
with the P/R each buys, best of ``reps`` timed calls after a warm-up;
returns both rows. Inits: (W, K, m) from a CPU ``torch.Generator``
seeded 0; the single start takes each problem's first.

Usage: python -m clipper_tpu_torch.bench.multistart_bench [W] [K] [reps] \\
           [--m=1024] [--rho=0.9] [--device=cuda|cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from clipper_tpu_torch.bench import data, harness
from clipper_tpu_torch.parallel import pool
from clipper_tpu_torch.types import Params


def main(argv=None) -> dict:
    pos, opts = harness.parse_argv(argv)
    dev = harness.bench_device(opts)
    W = int(pos[0]) if len(pos) > 0 else 128
    K = int(pos[1]) if len(pos) > 1 else 4
    reps = int(pos[2]) if len(pos) > 2 else 3
    m = int(opts.get("m", 1024))
    rho = float(opts.get("rho", 0.9))

    rng = np.random.default_rng(0)
    pcd0 = harness.load_bunny().astype(np.float32)
    problems = [harness.make_problem(pcd0, m, rho, rng) for _ in range(W)]
    D1 = torch.as_tensor(pcd0, device=dev)
    D2s = torch.as_tensor(np.stack([p[0] for p in problems]),
                          dtype=torch.float32, device=dev)
    As = torch.as_tensor(np.stack([p[1] for p in problems]),
                         dtype=torch.int32, device=dev)
    u0s = torch.rand(W, K, m, generator=torch.Generator().manual_seed(0)).to(
        dev)
    inv = harness.default_invariant()
    kw = dict(storage_dtype=torch.int8, power_steps=4, window=12,
              lanes=min(128, W), device=dev)

    def run(pipe, u0):
        solns = pipe(D1, D2s, As, u0)       # warm-up
        harness.sync(dev)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            solns = pipe(D1, D2s, As, u0)
            harness.sync(dev)
            ts.append(time.perf_counter() - t0)
        masks = solns.mask.cpu().numpy()
        pr = [data.get_precision_recall(A[masks[b]], Agt)
              for b, (_, A, Agt) in enumerate(problems)]
        ps, rs = zip(*pr)
        return min(ts), float(np.mean(ps)), float(np.mean(rs))

    print(f"multistart on {harness.device_name(dev)}: W={W} K={K} m={m} "
          f"rho={rho}", flush=True)
    single = pool.make_pool_pipeline(inv, Params(), layout="stacked", **kw)
    t1, p1, r1 = run(single, u0s[:, 0])
    print(f"single-start  : {t1 * 1e3:8.1f} ms for W={W} -> "
          f"{t1 / W * 1e3:.3f} ms/problem  P={p1 * 100:.1f}% "
          f"R={r1 * 100:.1f}%", flush=True)
    multi = pool.make_pool_multistart_pipeline(inv, Params(), restarts=K,
                                               **kw)
    tK, pK, rK = run(multi, u0s)
    print(f"multistart K={K}: {tK * 1e3:8.1f} ms for W={W} -> "
          f"{tK / W * 1e3:.3f} ms/problem  P={pK * 100:.1f}% "
          f"R={rK * 100:.1f}%", flush=True)
    print(f"multistart / single per-problem cost: {tK / t1:.2f}x "
          f"(naive K runs = {K}.00x)", flush=True)
    return dict(single=dict(m=m, rho=rho, ms=t1 * 1e3, precision=p1,
                            recall=r1),
                multi=dict(m=m, rho=rho, ms=tK * 1e3, precision=pK,
                           recall=rK, K=K))


if __name__ == "__main__":
    main()
