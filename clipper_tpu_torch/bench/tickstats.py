"""The flat solver's tick composition on the bench workload.

Counterpart of ``clipper_tpu/bench/tickstats.py``: per-lane probe counts
split into accepted steps and line-search backtracks, and the longest
lane, which sets the batch's time. Each problem's dense (M, C) is built
(``ops.affinity.score_pairwise_consistency``) and solved on its own
by ``flat_solve_single(stacked_dual_matvec(M, C, storage),
return_ticks=True)``, one probe a tick, as the JAX driver vmapped it over
the B problems, with [M; C] stored in ``--storage`` (bf16 by default,
the JAX driver's; int8 codes; or f32). Inits are drawn by a CPU
``torch.Generator`` seeded 0. The matvec is the plain stacked one, which
the JAX package left to XLA as well.

Usage: python -m clipper_tpu_torch.bench.tickstats [B] [m] [rho] \\
           [--power=0] [--storage=bf16|int8|f32] [--device=cuda|cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from clipper_tpu_torch.bench import harness
from clipper_tpu_torch.ops.affinity import score_pairwise_consistency
from clipper_tpu_torch.solvers import msrc_flat
from clipper_tpu_torch.types import Params


def lane_ticks(Ms: torch.Tensor, Cs: torch.Tensor, u0s: torch.Tensor,
               storage_dtype=None, power: int = 0,
               params: Params = Params()):
    """(outer i, ticks, backtracks) of each problem's own single solve:
    ``flat_solve_single`` over ``stacked_dual_matvec(M, C,
    storage_dtype)`` from u0 (after ``power`` power steps), as int64
    arrays of length B."""
    out = []
    for M, C, u0 in zip(Ms, Cs, u0s):
        mv = msrc_flat.stacked_dual_matvec(M, C, storage_dtype)
        if power:
            u0 = msrc_flat.power_init(mv, u0, power)
        _, _, i, ticks, nback = msrc_flat.flat_solve_single(
            mv, u0, params, return_ticks=True)
        out.append([int(i), int(ticks), int(nback)])
    i, ticks, nback = np.array(out, dtype=np.int64).T
    return i, ticks, nback


def main(argv=None) -> dict:
    pos, opts = harness.parse_argv(argv)
    dev = harness.bench_device(opts)
    B = int(pos[0]) if pos else 128
    m = int(pos[1]) if len(pos) > 1 else 1024
    rho = float(pos[2]) if len(pos) > 2 else 0.9
    power = int(opts.get("power", 0))
    storage = str(opts.get("storage", "bf16"))
    sdt = {"bf16": torch.bfloat16, "int8": torch.int8, "f32": None}[storage]
    dtype = torch.float32

    rng = np.random.default_rng(0)
    pcd0 = harness.load_bunny()
    problems = [harness.make_problem(pcd0, m, rho, rng) for _ in range(B)]
    D1 = torch.as_tensor(pcd0, dtype=dtype, device=dev)
    D2s = torch.as_tensor(np.stack([p[0] for p in problems]), dtype=dtype,
                          device=dev)
    As = torch.as_tensor(np.stack([p[1] for p in problems]),
                         dtype=torch.int32, device=dev)
    u0s = torch.rand(B, m, generator=torch.Generator().manual_seed(0)).to(
        dev)

    M, C = score_pairwise_consistency(harness.default_invariant(), D1, D2s,
                                      As, affinityeps=1e-4)
    i, ticks, nback = lane_ticks(M, C, u0s, sdt, power)
    acc = ticks - nback
    print(f"tick stats on {harness.device_name(dev)}: B={B} m={m} rho={rho}"
          f" storage={storage} power={power}", flush=True)
    for name, x in [("ticks", ticks), ("accepts", acc),
                    ("backtracks", nback), ("outer i", i)]:
        q = np.percentile(x, [50, 90, 99])
        print(f"{name:10s} mean={x.mean():7.1f} med={q[0]:6.0f} "
              f"p90={q[1]:6.0f} p99={q[2]:6.0f} max={x.max():6d}")
    util = ticks.sum() / (B * ticks.max())
    print(f"sum ticks={ticks.sum()} device lane-ticks={B * ticks.max()} "
          f"utilization={util * 100:.1f}%")
    w = int(np.argmax(ticks))
    print(f"slowest lane: ticks={ticks[w]} accepts={acc[w]} "
          f"backtracks={nback[w]} outer={i[w]}", flush=True)
    return dict(ticks=ticks, nback=nback, outer=i, utilization=float(util))


if __name__ == "__main__":
    main()
