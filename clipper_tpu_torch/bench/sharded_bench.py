"""2D sharded engine bench: one large problem over mesh shapes.

Counterpart of ``clipper_tpu/bench/sharded_bench.py``: block-distributed
reduced-precision [M; C] storage (parallel/sharded.py), the chunked build
of each rank's block, the matvec's column sum and row gather, and strong
scaling over mesh shapes. It uses the default group when one is
initialized (``cpu_mesh_run --bench=sharded`` starts D gloo ranks on the
CPU, each calling :func:`main`); without one it runs one rank, on the
card in a 1-rank NCCL group that it makes and destroys itself
(``harness.process_group``).

Timing: the pipeline is built once a mesh shape, called once to warm up,
then ``reps`` times, each call fenced by reading F on the host; the best
is reported. The bunny problem (seed 0) takes u0 from a torch.Generator
seeded 0 (the JAX driver's jax.random key has no torch counterpart).

Usage:
  python -m clipper_tpu_torch.bench.sharded_bench [m] [reps] \\
      [--storage=int8|bf16|none] [--probes=K] [--power=N] [--rho=0.9] \\
      [--mesh=RxC ...] [--build-chunk=512] [--matvec-chunk=N] \\
      [--device=cuda|cpu]
  python -m clipper_tpu_torch.bench.cpu_mesh_run --ranks 4 \\
      --bench=sharded 1024 1

With no --mesh, every (R, C) factorisation of the rank count is swept;
a strong-scaling table follows when more than one shape ran.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from clipper_tpu_torch.bench import data, harness
from clipper_tpu_torch.parallel import sharded
from clipper_tpu_torch.types import Params

_STORAGE = {"int8": torch.int8, "bf16": torch.bfloat16, "none": None}


def _meshes(argv: List[str]) -> Optional[List[tuple]]:
    shapes = [tuple(int(x) for x in a.split("=", 1)[1].lower().split("x"))
              for a in argv if a.startswith("--mesh=")]
    return shapes or None


def _sweep(n: int) -> List[tuple]:
    """Every (r, c) with r c = n, by (r c, r)."""
    shapes = []
    for r in range(1, n + 1):
        if n % r == 0:
            shapes.append((r, n // r))
    return sorted(shapes, key=lambda s: (s[0] * s[1], s[0]))


def main(argv=None) -> Dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    pos, opts = harness.parse_argv(argv)
    dev = harness.bench_device(opts)
    m = int(pos[0]) if pos else 8192
    reps = int(pos[1]) if len(pos) > 1 else 3
    storage_name = str(opts.get("storage", "int8"))
    storage = _STORAGE[storage_name]
    probes = int(opts.get("probes", 16))
    power = int(opts.get("power", 4))
    rho = float(opts.get("rho", 0.9))
    build_chunk = int(opts.get("build-chunk", 512))
    matvec_chunk = opts.get("matvec-chunk")
    matvec_chunk = None if matvec_chunk is None else int(matvec_chunk)
    shapes = _meshes(argv)

    rng = np.random.default_rng(0)
    pcd0 = harness.load_bunny().astype(np.float32)
    pcd1, A, Agt = harness.make_problem(pcd0, m, rho, rng)
    u0 = torch.rand(m, generator=torch.Generator().manual_seed(0))
    inv = harness.default_invariant()
    At = torch.as_tensor(A, dtype=torch.int32, device=dev)
    P1 = torch.as_tensor(pcd0, device=dev)[At[:, 0].long()]
    P2 = torch.as_tensor(pcd1.astype(np.float32), device=dev)[At[:, 1].long()]
    itemsize = (torch.empty((), dtype=storage).element_size()
                if storage is not None else 4)

    rows, results = [], {}
    with harness.process_group(dev):
        world, rank = sharded._world()
        for shape in shapes or _sweep(world):
            R, C = shape
            if R * C > world:
                print(f"mesh {shape}: skipped (only {world} ranks)",
                      flush=True)
                continue
            mesh = sharded.make_mesh(shape)
            if not mesh.member:
                continue
            m_pad = sharded._padded_size(m, R, C)
            P1p, P2p, u0p = sharded.pad_problem(P1, P2, u0.to(dev), m_pad)
            A_pad = torch.nn.functional.pad(At, (0, 0, 0, m_pad - m),
                                            value=-1)
            pipeline = sharded.build_sharded_pipeline(
                inv, mesh, Params(), solver="flat", storage_dtype=storage,
                probes=probes, power_steps=power, build_chunk=build_chunk,
                matvec_chunk=matvec_chunk)
            blk_gb = 2 * m_pad * m_pad // (R * C) * itemsize / 1e9
            if rank == 0:
                print(f"mesh {shape}: m_pad={m_pad}, per-rank [M;C] block "
                      f"= {blk_gb:.2f} GB ({storage_name}) on "
                      f"{harness.device_name(dev)}", flush=True)
            u, F, ifinal, mask = pipeline(P1p, P2p, A_pad, u0p, m)
            float(F)
            times, stats = [], {}
            for _ in range(max(1, reps)):
                t0 = time.perf_counter()
                u, F, ifinal, mask = pipeline(P1p, P2p, A_pad, u0p, m,
                                              stats=stats)
                float(F)
                times.append(time.perf_counter() - t0)
            dt = min(times)
            p, r = data.get_precision_recall(A[mask[:m].cpu().numpy()], Agt)
            results[shape] = dt
            rows.append(dict(mesh=list(shape), m=m, rho=rho, ms=dt * 1e3,
                             F=float(F), ifinal=int(ifinal), precision=p,
                             recall=r, block_gb=blk_gb, stats=dict(stats)))
            if rank == 0:
                print(f"mesh {shape}: {dt * 1e3:9.1f} ms/solve  F="
                      f"{float(F):.2f}  P={p * 100:.1f}% R={r * 100:.1f}%  "
                      "stage ms: " + ", ".join(
                          f"{k}={stats[k]:.1f}" for k in
                          ("build", "init", "solve", "polish")),
                      flush=True)

    if len(results) > 1 and rank == 0:
        base_shape = next(iter(results))
        base_t = results[base_shape]
        base_n = base_shape[0] * base_shape[1]
        print("\nstrong scaling (fixed m, growing mesh):", flush=True)
        for shape, dt in results.items():
            n = shape[0] * shape[1]
            print(f"  mesh {shape}: speedup {base_t / dt:5.2f}x  "
                  f"efficiency {(base_t / dt) * (base_n / n):.2f}",
                  flush=True)
    return dict(rows=rows, ranks=world)


if __name__ == "__main__":
    main()
