"""Triangle-sharded engine bench: one capacity problem over a process group.

Counterpart of ``clipper_tpu/bench/symshard_bench.py``: the
symmetric-triangle storage split over the D ranks of a
``torch.distributed`` group (``symstore.solve_sharded_sym``), ~m^2 / D
int8 bytes a rank, one f64 all-reduce a tick. It uses the default group
when one is initialized (``cpu_mesh_run --bench=symshard`` starts D gloo
ranks on the CPU, each calling :func:`main`); without one it runs one
rank, on the card in a 1-rank NCCL group that it makes and destroys
itself (met through an in-memory store, no network). Prints each
repetition's wall time (the first includes the kernels' first use) and
the best, F and P/R, and returns them (times, F, precision, recall,
ranks).

``--matvec``: 'pallas' (the chunk list, kernel 3 on the card), 'xla'
(the tile list, kernel 7) or 'auto' ('pallas'). ``--storage=bf16`` raises
on the card, where kernels 3 and 7 take int8, f32 or f64 storage. The JAX
driver's ``mv_chunk`` shaped an XLA loop and has no counterpart here.

Usage:
  python -m clipper_tpu_torch.bench.symshard_bench [m] [reps] \\
      [--rho=0.96] [--probes=1] [--power=4] [--storage=int8|bf16|f32] \\
      [--support=8192] [--build-chunk=64] [--matvec=auto|pallas|xla] \\
      [--device=cuda|cpu]
  python -m clipper_tpu_torch.bench.cpu_mesh_run --ranks 3 \\
      --bench=symshard 8192 1
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist

from clipper_tpu_torch.bench import data, harness
from clipper_tpu_torch.ops import symstore


@contextlib.contextmanager
def _group(dev: torch.device):
    """The default group when one is initialized; else, on the card, a
    1-rank NCCL group destroyed on the way out; else none (one rank)."""
    if dist.is_initialized() or dev.type != "cuda":
        yield
        return
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def main(argv=None) -> dict:
    pos, opts = harness.parse_argv(argv)
    dev = harness.bench_device(opts)
    m = int(pos[0]) if pos else 65536
    reps = int(pos[1]) if len(pos) > 1 else 1
    rho = float(opts.get("rho", 0.96))
    ints = {k: int(opts.get(k.replace("_", "-"), v)) for k, v in (
        ("probes", 1), ("power", 4), ("support", 8192),
        ("build_chunk", 64))}
    storage_name = str(opts.get("storage", "int8"))
    storage = {"int8": torch.int8, "bf16": torch.bfloat16,
               "f32": torch.float32}[storage_name]
    matvec = str(opts.get("matvec", "auto"))

    t = 128
    m_pad = -(-m // t) * t
    nt = m_pad // t
    T = nt * (nt + 1) // 2
    itemsize = torch.empty((), dtype=storage).element_size()
    tri_gb = T * 2 * t * t * itemsize / 1e9
    dense_gb = 2 * m_pad * m_pad * itemsize / 1e9

    rng = np.random.default_rng(0)
    pcd0 = harness.load_bunny().astype(np.float32)
    pcd1, A, Agt = harness.make_problem(pcd0, m, rho, rng)
    u0 = torch.rand(m, generator=torch.Generator().manual_seed(0))
    inv = harness.default_invariant()
    D1 = torch.as_tensor(pcd0, device=dev)
    D2 = torch.as_tensor(pcd1.astype(np.float32), device=dev)
    At = torch.as_tensor(A, dtype=torch.int32, device=dev)

    with _group(dev):
        D = dist.get_world_size() if dist.is_initialized() else 1
        print(f"m={m} (pad {m_pad}, nt={nt}, T={T}) on {D} rank(s) of "
              f"{harness.device_name(dev)}: triangle {storage_name} = "
              f"{tri_gb:.1f} GB total ({tri_gb / D:.2f} GB/rank); dense "
              f"stacked would be {dense_gb:.1f} GB", flush=True)
        times, soln = [], None
        for rep in range(max(1, reps)):
            stats = {}
            t0 = time.perf_counter()
            soln = symstore.solve_sharded_sym(
                inv, D1, D2, At, u0.to(dev), storage_dtype=storage,
                probes=ints["probes"], power_steps=ints["power"],
                support=ints["support"], build_chunk=ints["build_chunk"],
                matvec=matvec, stats=stats)
            F = float(soln.score)
            dt = time.perf_counter() - t0
            times.append(dt)
            print(f"rep {rep}: {dt:.2f} s (rep 0 includes first use)  "
                  f"F={F:.1f}  ticks={stats['ticks']}  stage ms: "
                  + ", ".join(f"{k}={stats[k]:.1f}" for k in
                              ("build", "init", "solve", "polish")),
                  flush=True)
    mask = soln.mask.cpu().numpy()
    p, r = data.get_precision_recall(A[mask], Agt)
    print(f"m={m} D={D} {storage_name}: best {min(times):.2f} s  "
          f"inliers={int(mask.sum())}  P={p * 100:.1f}% R={r * 100:.1f}%",
          flush=True)
    return dict(times=times, F=F, precision=p, recall=r, ranks=D)


if __name__ == "__main__":
    main()
