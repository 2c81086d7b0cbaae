"""Symmetric-triangle storage bench: capacity and the one-read matvecs.

Counterpart of ``clipper_tpu/bench/symstore_bench.py``. On one device at
large m it times:

  * the tile-list matvec (``symstore.make_sym_dual_matvec``: kernel 7,
    csrc/sym_tiles_matvec.cu, on the card) beside its plain version
    (``sym_tiles_matvec_plain``: the JAX driver's "XLA (2-read)" line);
  * the row-chunked matvec (``make_sym_dual_matvec_rows``: kernel 3,
    csrc/sym_rows_matvec.cu);
  * the dense stacked int8 matvec over (2m, m) storage (the plain
    gather-free matmul, ``msrc_flat.make_stacked_matvec``), where its
    storage and the f32 copy its matmul takes fit in 40 GB (m <= 63,245;
    the JAX driver's limit was 12 GB of storage);

and then one end-to-end solve over the row-chunked storage
(``symstore.solve_single``: build, power-init, flat solve, polish; one
warm call, then one timed call). The JAX names map to the port's so:
``make_sym_dual_matvec_pallas`` -> ``make_sym_dual_matvec`` and
``make_sym_dual_matvec_pallas_rows`` -> ``make_sym_dual_matvec_rows``.
The JAX driver's ``--tiles-block`` shaped the Mosaic grid and has no
counterpart. u0 from a CPU ``torch.Generator`` seeded 0.

Usage:
  python -m clipper_tpu_torch.bench.symstore_bench [m] [--probes=K] \\
      [--rho=0.95] [--skip-dense] [--mv-only] [--rows-only] \\
      [--device=cuda|cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from clipper_tpu_torch.bench import data, harness
from clipper_tpu_torch.ops import affinity_pallas, symstore
from clipper_tpu_torch.solvers import msrc, msrc_flat
from clipper_tpu_torch.types import Params, Rounding

DENSE_BYTES_MAX = 40e9   # int8 storage + its f32 matmul copy: 10 m^2 bytes


def main(argv=None) -> dict:
    pos, opts = harness.parse_argv(argv)
    dev = harness.bench_device(opts)
    m = int(pos[0]) if pos else 16384
    probes = int(opts.get("probes", 1))
    rho = float(opts.get("rho", 0.95))
    skip_dense = "skip-dense" in opts
    mv_only = "mv-only" in opts
    # chunked storage only: the capacity point cannot hold both layouts
    rows_only = "rows-only" in opts

    t = 128
    m_pad = -(-m // t) * t
    nt = m_pad // t
    pad = m_pad - m
    rng = np.random.default_rng(0)
    pcd0 = harness.load_bunny().astype(np.float32)
    pcd1, A, Agt = harness.make_problem(pcd0, m, rho, rng)
    pcd1 = pcd1.astype(np.float32)
    inv = harness.default_invariant()
    D1 = torch.as_tensor(pcd0, device=dev)
    D2 = torch.as_tensor(pcd1, device=dev)
    At = torch.as_tensor(A, dtype=torch.int32, device=dev)
    u0 = torch.rand(m, generator=torch.Generator().manual_seed(0)).to(dev)
    Al = At.long()
    P1 = torch.nn.functional.pad(D1[Al[:, 0]], (0, 0, 0, pad))
    P2 = torch.nn.functional.pad(D2[Al[:, 1]], (0, 0, 0, pad))
    Ap = torch.nn.functional.pad(At, (0, 0, 0, pad), value=-1)
    u0p = torch.nn.functional.pad(u0, (0, pad))
    Ks = [1, probes] if probes > 1 else [1]

    def operand(K):
        return u0p[:, None].repeat(1, K) if K > 1 else u0p

    T = nt * (nt + 1) // 2
    print(f"symstore bench on {harness.device_name(dev)}: m={m} (pad "
          f"{m_pad}, nt={nt}, T={T}); triangle int8 = "
          f"{T * 2 * t * t / 1e9:.2f} GB; dense stacked would be "
          f"{2 * m_pad * m_pad / 1e9:.2f} GB", flush=True)
    out = {"mv_ms": {}}

    def report(name, K, ms):
        out["mv_ms"][f"{name} K={K}"] = ms
        print(f"{name:30s} K={K}: {ms:8.3f} ms/tick", flush=True)

    if not rows_only:
        t0 = time.perf_counter()
        tiles = symstore.build_symtiles(inv, P1, P2, Ap, m, tile=t,
                                        storage_dtype=torch.int8)
        harness.sync(dev)
        print(f"tile build: {time.perf_counter() - t0:.2f} s", flush=True)
        mv = symstore.make_sym_dual_matvec(tiles, nt, torch.float32)
        for K in Ks:
            u = operand(K)
            report("sym tiles (kernel 7)" if dev.type == "cuda"
                   else "sym tiles (plain)",
                   K, harness.time_ms(lambda: mv(u), dev, reps=10))
            if dev.type == "cuda":
                U = u.reshape(m_pad, -1).T.contiguous()
                report("sym tiles plain (2-read)", K, harness.time_ms(
                    lambda: symstore.sym_tiles_matvec_plain(tiles, nt, U),
                    dev, reps=2))
        del tiles, mv

    G = min(32, nt)
    t0 = time.perf_counter()
    chunks = symstore.build_symchunks(inv, P1, P2, Ap, m, tile=t, G=G,
                                      storage_dtype=torch.int8)
    harness.sync(dev)
    print(f"chunk build (G={G}, {chunks.numel() / 1e9:.2f} GB incl. "
          f"slack): {time.perf_counter() - t0:.2f} s", flush=True)
    mv = symstore.make_sym_dual_matvec_rows(chunks, nt, torch.float32)
    for K in Ks:
        u = operand(K)
        report("sym rows (kernel 3)" if dev.type == "cuda"
               else "sym rows (plain)",
               K, harness.time_ms(lambda: mv(u), dev, reps=10))
    del chunks, mv

    if not skip_dense and 10 * m_pad * m_pad < DENSE_BYTES_MAX:
        MC = affinity_pallas.score_consistency_stored_pallas(
            inv, D1, D2, At, affinityeps=1e-4, storage_dtype=torch.int8)
        mvd = msrc_flat.make_stacked_matvec(MC, torch.float32)
        for K in Ks:
            u = u0[:, None].repeat(1, K) if K > 1 else u0
            report("dense stacked int8", K,
                   harness.time_ms(lambda: mvd(u), dev, reps=10))
        del MC, mvd
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if mv_only:
        return out

    def solve():
        return symstore.solve_single(
            inv, D1, D2, At, u0, Params(), tile=t, storage_dtype=torch.int8,
            probes=probes, power_steps=4, support=1024, matvec="pallas")

    (u, F, _), dt = harness.timed_call(solve, dev)
    mask = msrc.round_solution(u, F, Rounding.DSD_HEU).cpu().numpy()
    p, r = data.get_precision_recall(A[mask], Agt)
    print(f"end-to-end (build+solve+polish): {dt:.3f} s  F={float(F):.1f}  "
          f"P={p * 100:.1f}% R={r * 100:.1f}%", flush=True)
    out.update(e2e_s=dt, F=float(F), precision=p, recall=r)
    return out


if __name__ == "__main__":
    main()
