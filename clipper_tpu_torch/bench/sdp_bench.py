"""SDP (MSRC-SDR) at real sizes: scaling table + quality vs the PGA solver.

Counterpart of ``clipper_tpu/bench/sdp_bench.py``. The reference only
smoke-tests its SDP on a 20x20 matrix with no assertions (reference:
test/sdp_test.cpp:59-62) and its SCS backend is host-side; this runs the
port's ADMM (solvers/sdp.py) at the benchmark protocol's sizes and
records iterations, wall time, the certified duality gap, and P/R against
ground truth next to the PGA solver on the same (M, C). M and C are built
by the dense build kernel (``affinity_pallas.build_affinity_pallas``,
csrc/affinity_build.cu) on the card, as ``harness.run_grid`` builds; the
PGA row takes its u0 from a CPU ``torch.Generator`` seeded 0.

Usage:
  python -m clipper_tpu_torch.bench.sdp_bench [--sizes=256,1024] \\
      [--rho=0.9] [--batch=8] [--eps=1e-3] [--time-limit=0] [--zrank=0] \\
      [--aa=10] [--device=cuda|cpu]

--zrank=r switches the Z-step to the rank-r subspace-iteration projection
(sdp.Params.z_rank), the large-m route; 0 is the exact full eigh. --aa is
the acceleration interval (0 disables AA, whose (L, 2 n^2) history is
10.7 GB at n=8192). ``main`` returns the rows it prints.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from clipper_tpu_torch.bench import data as bdata
from clipper_tpu_torch.bench import harness
from clipper_tpu_torch.ops.affinity import gather_endpoints
from clipper_tpu_torch.ops.affinity_pallas import build_affinity_pallas
from clipper_tpu_torch.solvers import msrc, msrc_flat, sdp
from clipper_tpu_torch.types import Params, Rounding


def _build(inv, D1, pcd1, A, dev):
    """Dense (M, C) with identity diagonal, as the SDP takes them."""
    D2 = torch.as_tensor(pcd1, dtype=torch.float32, device=dev)
    At = torch.as_tensor(A, dtype=torch.int32, device=dev)
    P1, P2 = gather_endpoints(D1, D2, At)
    M, C = build_affinity_pallas(inv, P1, P2, At, affinityeps=1e-4)
    eye = torch.eye(M.shape[0], dtype=M.dtype, device=dev)
    return M, C, M + eye, C + eye


def _mask(nodes, m):
    mask = np.zeros(m, bool)
    mask[nodes] = True
    return mask


def main(argv=None) -> list:
    pos, opts = harness.parse_argv(argv)
    dev = harness.bench_device(opts)
    sizes = [int(x) for x in str(opts.get("sizes", "256,1024")).split(",")]
    rho = float(opts.get("rho", 0.9))
    batch = int(opts.get("batch", 8))
    eps = float(opts.get("eps", 1e-3))
    tlim = float(opts.get("time-limit", 0.0))
    zrank = int(opts.get("zrank", 0))
    aa = int(opts.get("aa", 10))

    rng = np.random.default_rng(0)
    pcd0 = harness.load_bunny().astype(np.float32)
    D1 = torch.as_tensor(pcd0, device=dev)
    inv = harness.default_invariant()
    sp = sdp.Params(eps_abs=eps, eps_rel=eps, time_limit_secs=tlim,
                    z_rank=zrank, acceleration_interval=aa,
                    acceleration_lookback=min(10, aa))

    print(f"sdp_bench on {harness.device_name(dev)}: eps={eps} rho={rho}",
          flush=True)
    rows = []
    for m in sizes:
        pcd1, A, Agt = harness.make_problem(pcd0, m, rho, rng)
        M, C, Mi, Ci = _build(inv, D1, pcd1, A, dev)

        # --- single SDP solve (a warm-up first) ---
        sdp.solve(Mi, Ci, sp, device=dev)
        soln = sdp.solve(Mi, Ci, sp, device=dev)
        p, r = bdata.get_precision_recall(A[_mask(soln.nodes, m)], Agt)
        per_it = soln.t_solve / max(1, soln.iters)
        print(f"SDP    m={m:5d}: {soln.t_solve * 1e3:9.1f} ms  "
              f"iters={soln.iters:4d} ({per_it * 1e3:.1f} ms/iter)  "
              f"gap={soln.gap:.2e}  "
              f"P={p * 100:.1f}% R={r * 100:.1f}%", flush=True)
        rows.append(dict(solver="sdp", m=m, rho=rho, ms=soln.t_solve * 1e3,
                         iters=soln.iters, ms_per_iter=per_it * 1e3,
                         gap=soln.gap, precision=p, recall=r))

        # --- PGA on the SAME (M, C) ---
        u0 = torch.rand(m, generator=torch.Generator().manual_seed(0)).to(dev)

        def pga():
            mv = msrc_flat.stacked_dual_matvec(M, C)
            u0p = msrc_flat.power_init(mv, u0, 4)
            return msrc_flat.flat_solve_single(mv, u0p, Params())

        (u, F, _), t_pga = harness.timed_call(pga, dev)
        mk = msrc.round_solution(u, F, Rounding.DSD_HEU).cpu().numpy()
        p2, r2 = bdata.get_precision_recall(A[mk], Agt)
        print(f"PGA    m={m:5d}: {t_pga * 1e3:9.1f} ms  "
              f"P={p2 * 100:.1f}% R={r2 * 100:.1f}%", flush=True)
        rows.append(dict(solver="pga", m=m, rho=rho, ms=t_pga * 1e3,
                         precision=p2, recall=r2))

        # --- batched SDP (one lock-step loop) at the smaller sizes ---
        if m <= 512 and batch > 1:
            probs = [harness.make_problem(pcd0, m, rho, rng)
                     for _ in range(batch)]
            built = [_build(inv, D1, pc, Ab, dev) for pc, Ab, _ in probs]
            Ms = torch.stack([b[2] for b in built])
            Cs = torch.stack([b[3] for b in built])
            sdp.solve_batched(Ms, Cs, sp, device=dev)       # warm-up
            t0 = time.perf_counter()
            solns = sdp.solve_batched(Ms, Cs, sp, device=dev)
            tb = time.perf_counter() - t0
            ps, rs = [], []
            for soln_b, (_, Ab, Agt_b) in zip(solns, probs):
                pb, rb = bdata.get_precision_recall(
                    Ab[_mask(soln_b.nodes, m)], Agt_b)
                ps.append(pb)
                rs.append(rb)
            print(f"SDPxB  m={m:5d}: {tb * 1e3:9.1f} ms for B={batch} "
                  f"({tb / batch * 1e3:.1f} ms/prob)  "
                  f"P={np.mean(ps) * 100:.1f}% R={np.mean(rs) * 100:.1f}%",
                  flush=True)
            rows.append(dict(solver="sdp_batched", m=m, rho=rho,
                             ms=tb * 1e3, batch=batch,
                             precision=float(np.mean(ps)),
                             recall=float(np.mean(rs))))
    return rows


if __name__ == "__main__":
    main()
