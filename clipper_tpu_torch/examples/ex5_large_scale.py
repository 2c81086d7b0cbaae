"""Example 5: large-scale association through the capacity engines.

Counterpart of ``examples/ex5_large_scale.py``. The reference's ceiling is
one node's memory for the dense m x m double affinity matrix (reference:
src/clipper.cpp:29; the published operating point is m = 1000). This runs
the bunny registration protocol at m = 16,384 putative associations
through the same facade class a clipperpy user would call (reference:
include/clipper/clipper.h:78-183); only the engine changes:

  1. ``Clipper(engine="triangle")`` (the "auto" default from m >= 8192)
     solves over symmetric-triangle int8 tile storage with the row-chunked
     dual matvec (ops/symstore.solve_single; the rows kernel,
     csrc/sym_rows_matvec.cu, on the card). No dense (m, m) is made.
  2. ``Clipper(engine="sharded")`` splits the same triangle storage over
     the ranks of a ``torch.distributed`` process group, one all-reduce a
     solver tick (ops/symstore.solve_sharded_sym): the default group when
     one is initialized, else a 1-rank group made here (NCCL on the card,
     gloo on the CPU) and destroyed after.

Both polish the objective in full precision before the omega = round(F)
rounding, so P/R matches the dense f32 pipeline.

Run: python -m clipper_tpu_torch.examples.ex5_large_scale [m]
         [--device=cuda|cpu]
"""

import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist

import clipper_tpu_torch as ct
from clipper_tpu_torch.bench import data as bdata
from clipper_tpu_torch.bench import harness

P_BAR, R_BAR = 0.99, 0.85


@contextlib.contextmanager
def _process_group(dev: torch.device):
    """The default group if one is initialized, else a 1-rank group met
    through an in-memory store (no network), destroyed on the way out."""
    if dist.is_initialized():
        yield
        return
    if dev.type == "cuda":
        torch.cuda.set_device(torch.cuda.current_device() if dev.index is None
                              else dev.index)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def main(argv=None):
    pos, opts = harness.parse_argv(argv)
    dev = harness.bench_device(opts)
    m = int(pos[0]) if pos else 16384
    rho = 0.95
    rng = np.random.default_rng(0)
    pcd0 = harness.load_bunny().astype(np.float32)
    pcd1, A, Agt = harness.make_problem(pcd0, m, rho, rng)
    pcd1 = pcd1.astype(np.float32)
    inv = harness.default_invariant()

    tri_gb = (m * m + m * 128) / 1e9
    print(f"m={m} @ {rho:.0%} outliers: triangle int8 storage ~{tri_gb:.2f} "
          f"GB (dense f64, as the reference allocates: {8 * m * m / 1e9:.1f}"
          f" GB)")

    def run(engine, **engine_opts):
        c = ct.Clipper(inv, ct.Params(), dtype=torch.float32, engine=engine,
                       engine_opts=engine_opts, device=dev)
        t0 = time.perf_counter()
        c.score_pairwise_consistency(pcd0.T, pcd1.T, A)   # (d, n) columns
        c.solve()
        sel = c.get_selected_associations()
        dt = time.perf_counter() - t0
        p, r = bdata.get_precision_recall(sel, Agt)
        return sel, dt, p, r

    # --- one device, triangle engine, standard facade flow (engine='auto'
    # picks it from m >= 8192; named here for the example's sake) ---
    sel, dt, p, r = run("triangle", probes=8, power_steps=4)
    print(f"facade triangle engine: {dt:.2f} s (incl. first-call set-up)  "
          f"inliers={len(sel)}  precision {p:.1%}  recall {r:.1%}")
    assert p >= P_BAR and r >= R_BAR, (p, r)

    # --- sharded triangle engine over the process group's ranks ---
    with _process_group(dev):
        world = dist.get_world_size()
        sel2, dt2, p2, r2 = run("sharded", power_steps=4)
    print(f"{world}-rank sharded facade engine: {dt2:.2f} s  "
          f"inliers={len(sel2)}  precision {p2:.1%}  recall {r2:.1%}")
    assert p2 >= P_BAR and r2 >= R_BAR, (p2, r2)
    return p, r


if __name__ == "__main__":
    main()
