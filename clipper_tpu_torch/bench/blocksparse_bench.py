"""Block-sparse (occupied-tile) storage benchmark on a multi-object scene.

Counterpart of ``clipper_tpu/bench/blocksparse_bench.py``. The uniform
outlier bunny protocol fills every tile of M, so block-sparse storage
cannot win there. This benchmark measures the workload it exists for: k
rigid objects, each moving with its own transform, so associations of
object a are consistent only with associations of object a, M is
block-diagonal and about (k - 1)/k of its tiles are zero (reference:
element-sparse storage, include/clipper/types.h:19-22; the port:
ops/blocksparse.py).

It measures, at matched solver options (int8 storage, the K-probe
multiprobe tick, power init):
  1. the dual matvec: dense stacked [M; C] against the occupied tiles
     (CUDA events on the card, per call, at K probe columns);
  2. the end-to-end flat solve over each storage (synchronised wall);
and prints the found clique's precision against the union ground truth
and its recall against the object it won (MSRC converges to one densest
clique; successive extraction peels the others).

Usage: python -m clipper_tpu_torch.bench.blocksparse_bench [m] [k] [reps]
       [--rho=0.9] [--probes=16] [--power=4] [--tile=256]
       [--device=cuda|cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from clipper_tpu_torch.bench import data, harness
from clipper_tpu_torch.ops import blocksparse
from clipper_tpu_torch.ops.affinity import score_pairwise_consistency
from clipper_tpu_torch.solvers import msrc_flat
from clipper_tpu_torch.types import Params


def build_scene(pcd0, m, k, rho, rng):
    """k rigid objects, each with its own motion: block-diagonal
    consistency. Object b reuses the bunny, its target copy at a far
    offset, so associations across objects have wildly different pairwise
    distances in source and target (affinity 0). The numpy draws are the
    JAX package's, in its order.

    Returns (D1, D2, A, gts): A indexes (D1, D2); gts holds each object's
    ground-truth associations (global indices)."""
    mb = m // k
    n1 = pcd0.shape[0]
    D2s, As, gts = [], [], []
    for b in range(k):
        pcd1, A, Agt = harness.make_problem(pcd0, mb, rho, rng)
        off = np.zeros(3, pcd0.dtype)
        off[b % 3] = 50.0 * (b + 1)
        D2s.append(pcd1 + off)
        A = A.copy()
        A[:, 1] += b * n1
        As.append(A)
        if Agt.size:
            Agt = Agt.copy()
            Agt[:, 1] += b * n1
        gts.append(Agt)
    return pcd0, np.concatenate(D2s), np.concatenate(As), gts


def quality(M: torch.Tensor, A: np.ndarray, gts, u: np.ndarray):
    """(precision against the union ground truth, recall against the object
    won) of u rounded by omega = round(u'Mu) + 1 on its support, the JAX
    benchmark's rule; (0, 0) for an empty support or no ground truth."""
    s = np.flatnonzero(u > 0)
    gt_nonempty = [g for g in gts if g.size]
    if not s.size or not gt_nonempty:
        return 0.0, 0.0
    un = u[s] / np.linalg.norm(u[s])
    St = torch.as_tensor(s, device=M.device)
    Ms = M.index_select(0, St).index_select(1, St).double().cpu().numpy()
    omega = int(np.floor(float(un @ Ms @ un) + 0.5)) + 1
    Ain = A[np.argsort(-u, kind="stable")[:omega]]
    p, _ = data.get_precision_recall(Ain, np.concatenate(gt_nonempty))
    r = max(data.get_precision_recall(Ain, g)[1] for g in gt_nonempty)
    return p, r


def main(argv=None) -> dict:
    pos, opts = harness.parse_argv(argv)
    dev = harness.bench_device(opts)
    m = int(pos[0]) if len(pos) > 0 else 8192
    k = int(pos[1]) if len(pos) > 1 else 8
    reps = int(pos[2]) if len(pos) > 2 else 5
    rho = float(opts.get("rho", 0.9))
    K = int(opts.get("probes", 16))
    power = int(opts.get("power", 4))
    tile = int(opts.get("tile", 256))

    rng = np.random.default_rng(0)
    pcd0 = harness.load_bunny().astype(np.float32)
    D1, D2, A, gts = build_scene(pcd0, m, k, rho, rng)
    m = A.shape[0]          # k may not divide the requested m
    M, C = score_pairwise_consistency(
        harness.default_invariant(), torch.as_tensor(D1, device=dev),
        torch.as_tensor(D2, device=dev),
        torch.as_tensor(A, dtype=torch.int32, device=dev), affinityeps=1e-4)

    bs, info = blocksparse.from_dense(M, C, tile=tile,
                                      storage_dtype=torch.int8, device=dev)
    if bs is None:
        raise RuntimeError(f"scene not block-sparse (occupancy "
                           f"{info['occupancy']:.2f}): raise k")
    _, dense_info = blocksparse.from_dense(M, C, tile=tile,
                                           storage_dtype=torch.int8,
                                           max_occupancy=-1.0, device=dev)
    MC = dense_info["dense"]
    nt, m_pad = info["nt"], info["m_pad"]
    print(f"block-sparse bench on {harness.device_name(dev)}: m={m} (pad "
          f"{m_pad}) k={k} tile={tile}: occupancy "
          f"{info['occupancy'] * 100:.1f}% ({info['n_tiles']}/{nt * nt} "
          f"tiles), storage {bs.tiles.numel() / 1e6:.1f} MB vs dense "
          f"{MC.numel() / 1e6:.1f} MB", flush=True)

    gen = torch.Generator().manual_seed(0)
    U = torch.rand(m_pad, K, generator=gen).to(dev)
    mv_dense = msrc_flat.make_stacked_matvec(MC, torch.float32)
    mv_block = blocksparse.make_matvec(bs, nt, torch.float32)
    t_mv_d = harness.time_ms(lambda: mv_dense(U), dev, reps)
    t_mv_b = harness.time_ms(lambda: mv_block(U), dev, reps)
    print(f"dual matvec (K={K}, ms a call): dense int8 {t_mv_d:.4f} | "
          f"block-sparse int8 {t_mv_b:.4f} | {t_mv_d / t_mv_b:.2f}x",
          flush=True)

    u0 = torch.nn.functional.pad(torch.rand(m, generator=gen),
                                 (0, m_pad - m)).to(dev)
    params = Params()

    def solve(mv):
        u = msrc_flat.power_init(mv, u0, power)
        return msrc_flat.flat_solve_single_multiprobe(mv, u, params,
                                                      probes=K)

    row = dict(m=m, k=k, tile=tile, occupancy=info["occupancy"],
               n_tiles=info["n_tiles"], mv_dense_ms=t_mv_d,
               mv_block_ms=t_mv_b)
    for name, mv in (("dense", mv_dense), ("block", mv_block)):
        best, u = float("inf"), None
        for _ in range(max(1, reps)):
            t0 = time.perf_counter()
            u, F, _ = solve(mv)
            harness.sync(dev)
            best = min(best, time.perf_counter() - t0)
        p, r = quality(M, A, gts, u[:m].cpu().numpy())
        row.update({f"solve_{name}_ms": best * 1e3, f"P_{name}": p,
                    f"R_{name}": r})
        print(f"solve ({name} int8): {best * 1e3:8.1f} ms  P={p * 100:.1f}%"
              f" R(won object)={r * 100:.1f}%", flush=True)
    ratio = row["solve_dense_ms"] / row["solve_block_ms"]
    print(f"end-to-end solve: {ratio:.2f}x at occupancy "
          f"{info['occupancy'] * 100:.1f}%", flush=True)
    return row


if __name__ == "__main__":
    main()
