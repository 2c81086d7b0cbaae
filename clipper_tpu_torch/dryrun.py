"""The multi-GPU dry run: every multi-rank path once, on a group of ranks.

Counterpart of ``__graft_entry__.dryrun_multichip``. :func:`dryrun_multichip`
runs inside a ``torch.distributed`` group of n ranks, every rank calling
it:

  * the 2D block-sharded engine (parallel/sharded.py) on the squarest
    mesh, in the working dtype and in int8 storage with 4 probes (small
    build and matvec chunks);
  * the triangle-sharded engine (ops/symstore.py) over the group, in its
    row-chunked ("pallas") and tile-list ("xla") modes;
  * ``batched.shard_batch`` with the batched engine on each rank's slice;
  * the stacked and tri pools over the group (``mesh=``);
  * the convergent check: one m=512 problem solved to convergence on the
    2D mesh must give, in f64, the mask of the single-device flat solver
    over the dense stacked [M; C], and in f32 a mask within IoU 0.95 of
    it (see :func:`dryrun_multichip`).

Iteration caps are tiny except in the convergent check. Every device runs
the JAX dry run's shapes (m=64, n=48, tiles of 16): on the card the int8
kernels take that tile by their CUDA-core routes (ops/flattri.matvec_route,
ops/symstore.matvec_route).

Command line:
    python -m clipper_tpu_torch.dryrun --ranks 2 --device cpu
spawns the ranks (gloo, bench/cpu_mesh_run.py; ``--device cuda`` puts
every rank on the one card); under torchrun, one card a rank,
    torchrun --nproc-per-node 4 -m clipper_tpu_torch.dryrun
joins the NCCL group that torchrun describes. Each prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from clipper_tpu_torch.invariants.euclidean import (EuclideanDistance,
                                                    EuclideanDistanceParams)
from clipper_tpu_torch.ops import symstore
from clipper_tpu_torch.ops.affinity import score_pairwise_consistency
from clipper_tpu_torch.parallel import batched, pool, sharded
from clipper_tpu_torch.solvers import msrc, msrc_flat
from clipper_tpu_torch.types import Params, resolve_device


def make_example(m: int = 256, n: int = 200, seed: int = 0):
    """(D1 (n, 3), D2 (n, 3), A (m, 2), u0 (m,)) as numpy: the JAX dry
    run's scene (m / 4 planted inliers under a rotation of 0.4 rad, the
    rest random), drawn from default_rng(seed); f32, A int32."""
    rng = np.random.default_rng(seed)
    D1 = rng.uniform(size=(n, 3))
    th = 0.4
    R = np.array([[np.cos(th), -np.sin(th), 0],
                  [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]])
    D2 = D1 @ R.T + rng.normal(0, 0.001, size=(n, 3))
    ni = m // 4
    A = np.zeros((m, 2), dtype=np.int32)
    A[:ni, 0] = A[:ni, 1] = np.arange(ni)
    A[ni:, 0] = rng.integers(0, n, m - ni)
    A[ni:, 1] = rng.integers(0, n, m - ni)
    u0 = rng.uniform(size=m)
    return (D1.astype(np.float32), D2.astype(np.float32), A,
            u0.astype(np.float32))


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dry run: {msg}")


def dryrun_multichip(n_ranks: int, device="cuda") -> Dict:
    """Every multi-rank path once on this group of n_ranks ranks (see the
    module docstring); raises on a wrong shape or a failed check. Runs on
    ``device`` ("cuda" by default: this process's current card; raises if
    missing). Returns a summary: the mesh shape, the problem size and
    tile, and the convergent check's masks (parity_float64,
    parity_float32: sizes, IoU and F beside the reference's)."""
    world, _ = sharded._world()
    _require(world == n_ranks, f"needs a group of {n_ranks} ranks; the "
             f"world has {world}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    m, n, tile = 64, 48, 16
    group = dist.group.WORLD if dist.is_initialized() else None
    inv = EuclideanDistance(EuclideanDistanceParams(sigma=0.015,
                                                    epsilon=0.05))
    # tiny iteration caps: this checks the paths, not convergence
    params = Params(maxoliters=3, maxiniters=5, maxlsiters=5)

    # one problem block-sharded over the 2D mesh
    mesh = sharded.make_mesh()
    D1, D2, A, u0 = make_example(m=m, n=n)
    soln = sharded.solve_sharded(inv, D1, D2, A, u0, params, mesh,
                                 device=dev)
    _require(tuple(soln.u.shape) == (m,), f"2D engine u {soln.u.shape}")
    soln = sharded.solve_sharded(inv, D1, D2, A, u0, params, mesh,
                                 storage_dtype=torch.int8, probes=4,
                                 power_steps=2, support=32, build_chunk=8,
                                 matvec_chunk=16, device=dev)
    _require(tuple(soln.u.shape) == (m,), f"2D int8 u {soln.u.shape}")

    # the triangle-sharded capacity engine over the group
    data = [torch.as_tensor(x, device=dev) for x in (D1, D2, A, u0)]
    for mode in ("pallas", "xla"):
        ssoln = symstore.solve_sharded_sym(
            inv, *data, params, group, tile=tile, storage_dtype=torch.int8,
            power_steps=2, support=32, build_chunk=2, matvec=mode)
        _require(tuple(ssoln.u.shape) == (m,),
                 f"triangle-sharded ({mode}) u {ssoln.u.shape}")

    # data parallel: the batch axis split over the group
    ex = [make_example(m=m, n=n, seed=s) for s in range(n_ranks)]
    args = tuple(np.stack([e[i] for e in ex]) for i in range(4))
    part = batched.shard_batch(args, group, device=dev)
    solns = batched.make_batched_pipeline(inv, params, device=dev)(*part)
    _require(tuple(solns.u.shape) == (1, m),
             f"batched slice u {solns.u.shape}")

    # the pools over the group: one compaction loop a rank
    W = 2 * n_ranks
    exp = [make_example(m=m, n=n, seed=100 + s) for s in range(W)]
    pargs = (exp[0][0],) + tuple(np.stack([e[i] for e in exp])
                                 for i in (1, 2, 3))
    for layout, opts in (("stacked", {}),
                         ("tri", dict(tri_probes=4, d_scale=0.15,
                                      tri_tile=tile))):
        pipe = pool.make_pool_pipeline(inv, params, lanes=2, window=2,
                                       power_steps=2, mesh=group,
                                       storage_dtype=torch.int8,
                                       layout=layout, device=dev, **opts)
        psolns = pipe(*pargs)
        _require(tuple(psolns.u.shape) == (W, m),
                 f"{layout} pool u {psolns.u.shape}")

    # convergent numerics: the 2D mesh against the single-device flat
    # solver over the dense stacked [M; C], to convergence. In f64 the
    # masks must be equal (the JAX check), max |du| reported. In f32 (the
    # JAX check's dtype) the solve is chaotic at the ulp level and this
    # problem's F sits 0.08 from omega's rounding boundary (the JAX
    # engine itself selects 127 of the 128 on a 1 x 1 CPU mesh), so f32
    # is held to an IoU of 0.95.
    pfull = Params()
    D1, D2, A, u0 = make_example(m=512, n=300, seed=7)
    out = dict(ranks=n_ranks, mesh=list(mesh.shape), m=m, tile=tile,
               device=str(dev))
    for dtype in (torch.float64, torch.float32):
        D1t, D2t, u0t = (torch.as_tensor(x, dtype=dtype, device=dev)
                         for x in (D1, D2, u0))
        At = torch.as_tensor(A, device=dev)
        soln = sharded.solve_sharded(inv, D1t, D2t, At, u0t, pfull, mesh,
                                     device=dev)
        M, C = score_pairwise_consistency(inv, D1t, D2t, At,
                                          affinityeps=1e-4)
        u, F, _ = msrc_flat.flat_solve_single(
            msrc_flat.stacked_dual_matvec(M, C), u0t, pfull)
        mask_ref = msrc.round_solution(u, F, pfull.rounding)
        a, b = soln.mask, mask_ref
        iou = float((a & b).sum()) / max(1, int((a | b).sum()))
        name = str(dtype).split(".")[-1]
        out[f"parity_{name}"] = dict(selected=int(a.sum()),
                                     reference=int(b.sum()), iou=iou,
                                     F=float(soln.score), F_ref=float(F))
        _require(int(b.sum()) > 0, "degenerate convergent check")
        if dtype == torch.float64:
            du = float((soln.u - u).abs().max())
            out["parity_float64"]["max_du"] = du
            _require(bool(torch.equal(a, b)),
                     f"convergent check (f64): the {mesh.R}x{mesh.C} mesh "
                     f"selects {int(a.sum())} vertices, the single-device "
                     f"solver {int(b.sum())} ({int((a != b).sum())} differ); "
                     f"max |du| {du:.3e}")
        else:
            _require(iou >= 0.95, f"convergent check (f32): IoU {iou:.4f} "
                     f"< 0.95 on the {mesh.R}x{mesh.C} mesh")
    return out


def _torchrun_main() -> Dict:
    """One rank under torchrun: the NCCL group from its environment (its
    address, world size and rank), one card a rank."""
    local = int(os.environ.get("LOCAL_RANK", 0))
    torch.cuda.set_device(local)
    dist.init_process_group("nccl")
    try:
        return dryrun_multichip(dist.get_world_size(), device="cuda")
    finally:
        dist.destroy_process_group()


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if "TORCHELASTIC_RUN_ID" in os.environ:
        out = _torchrun_main()
    else:
        from clipper_tpu_torch.bench import cpu_mesh_run
        resolve_device(args.device)
        out = cpu_mesh_run.run(args.ranks, [dict(kind="dryrun",
                                                 device=args.device)],
                               timeout=args.timeout)[0]
    print(json.dumps(out, default=str), flush=True)
    return out


if __name__ == "__main__":
    main()
