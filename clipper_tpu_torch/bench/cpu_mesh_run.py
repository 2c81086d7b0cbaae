"""Run the triangle-sharded engine on D gloo ranks on the CPU.

The counterpart of ``clipper_tpu/bench/cpu_mesh_run.py``, which ran the
sharded engines on a virtual N-device CPU mesh: here the mesh is D
processes joined by a ``torch.distributed`` gloo group, each running
``ops/symstore.solve_sharded_sym`` with ``device="cpu"`` on the same data.
The ranks start in **spawn** mode (a forked child would inherit the
parent's threads) and meet through a ``FileStore`` in a temporary
directory, so no network is used. ``init_process_group`` gets a 60 s
timeout and the join its own, so a hung collective fails instead of
hanging its caller.

Library use (the tests): :func:`run` solves a list of jobs on one group of
D ranks and returns rank 0's results as numpy, each with ``ranks_agree``:
whether every rank's u equals rank 0's bit for bit.

Command line, one bunny problem:
    python -m clipper_tpu_torch.bench.cpu_mesh_run --ranks 3 --m 1024 \\
        --rho 0.9 --matvec xla
prints one JSON line with P/R, F, ifinal, the stage times of rank 0 and
whether the ranks agree. With ``--bench=symshard`` the other arguments go
to ``bench/symshard_bench.py`` on every rank (:func:`run_bench`):
    python -m clipper_tpu_torch.bench.cpu_mesh_run --ranks 2 \\
        --bench=symshard 4096 1 --rho=0.95
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import queue
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np

INIT_TIMEOUT_S = 60


@contextlib.contextmanager
def _joined(rank: int, D: int, store_path: str, threads: int):
    """Join the gloo group of D ranks as ``rank``; leave it on the way
    out."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(threads)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, D), rank=rank,
        world_size=D, timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _rank_main(rank: int, D: int, store_path: str, jobs: List[Dict],
               threads: int, out) -> None:
    """One rank: join the gloo group, solve every job, send the results of
    rank 0 (u of every rank) to the parent, leave the group."""
    import torch

    from clipper_tpu_torch import Clipper
    from clipper_tpu_torch.bench import harness
    from clipper_tpu_torch.ops import symstore
    from clipper_tpu_torch.types import Params

    try:
        with _joined(rank, D, store_path, threads):
            results = []
            for job in jobs:
                job = dict(job)
                data = [torch.from_numpy(np.asarray(job.pop(k)))
                        for k in ("D1", "D2", "A", "u0")]
                inv = job.pop("invariant", None) or \
                    harness.default_invariant()
                params = job.pop("params", None) or Params()
                stats = {}
                if job.pop("facade", False):
                    c = Clipper(inv, params, dtype=data[3].dtype,
                                engine="sharded", device="cpu",
                                engine_opts=dict(job, stats=stats))
                    c.score_pairwise_consistency(data[0].T, data[1].T,
                                                 data[2])
                    sol = c.solve(u0=data[3])
                else:
                    sol = symstore.solve_sharded_sym(
                        inv, *data, params, None, stats=stats, **job)
                results.append(dict(u=sol.u.numpy(), mask=sol.mask.numpy(),
                                    score=float(sol.score),
                                    ifinal=int(sol.ifinal), stats=stats))
        out.put((rank, results, None))
    except BaseException as exc:   # report, then let the parent fail
        out.put((rank, None, repr(exc)))
        raise


def _bench_rank_main(rank: int, D: int, store_path: str, argv: List[str],
                     threads: int, out) -> None:
    """One rank of ``--bench=symshard``: symshard_bench.main(argv) on the
    CPU inside the gloo group; sends its return value to the parent."""
    from clipper_tpu_torch.bench import symshard_bench

    try:
        with _joined(rank, D, store_path, threads):
            res = symshard_bench.main(list(argv) + ["--device=cpu"])
        out.put((rank, res, None))
    except BaseException as exc:   # report, then let the parent fail
        out.put((rank, None, repr(exc)))
        raise


def _spawn(target, D: int, payload, threads: int, timeout: float) -> Dict:
    """Run target(rank, D, store_path, payload, threads, queue) on D
    spawned ranks; returns {rank: result}. Raises if a rank fails, or if
    the ranks do not all finish within ``timeout`` seconds."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=target, daemon=True,
                             args=(rank, D, os.path.join(tmp, "store"),
                                   payload, threads, out))
                 for rank in range(D)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        got, errors = {}, []
        try:
            # the first rank that fails ends the run: the others may be
            # waiting on it in a collective
            while len(got) < D and not errors:
                try:
                    rank, res, err = out.get(
                        timeout=max(0.1, deadline - time.monotonic()))
                except queue.Empty:
                    raise TimeoutError(
                        f"{D} gloo ranks did not finish within {timeout} s "
                        f"({sorted(got)} did)") from None
                if err is None:
                    got[rank] = res
                else:
                    errors.append(f"rank {rank}: {err}")
            for p in procs:
                if not errors:
                    p.join(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    if errors:
        raise RuntimeError("sharded CPU run failed: " + "; ".join(errors))
    return got


def run(D: int, jobs: List[Dict], *, threads: int = 1,
        timeout: float = 120.0) -> List[Dict]:
    """Solve each job (solve_sharded_sym's keyword arguments, with the
    numpy arrays D1, D2 (n, d), A (m, 2) and u0 (m,)) on D gloo ranks; a
    job with ``facade=True`` goes through ``Clipper(engine="sharded")``
    instead, its other keywords the engine_opts. Returns rank 0's result
    of each job (u, mask, score, ifinal, stats) with ``ranks_agree``. Raises if a rank fails, or if the ranks do not
    all finish within ``timeout`` seconds."""
    got = _spawn(_rank_main, D, jobs, threads, timeout)
    results = got[0]
    for j, res in enumerate(results):
        res["ranks_agree"] = all(np.array_equal(got[r][j]["u"], res["u"])
                                 for r in range(D))
    return results


def run_bench(D: int, argv: List[str], *, threads: int = 1,
              timeout: float = 600.0):
    """``symshard_bench.main(argv)`` on D gloo ranks on the CPU (the JAX
    package's ``cpu_mesh_run --bench=symshard``); returns rank 0's
    result."""
    return _spawn(_bench_rank_main, D, list(argv), threads, timeout)[0]


def main(argv=None):
    from clipper_tpu_torch.bench import data, harness

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--bench=symshard" in argv:
        argv.remove("--bench=symshard")
        ap = argparse.ArgumentParser(add_help=False)
        for flag, kind, default in (("--ranks", int, 2),
                                    ("--threads", int, 1),
                                    ("--timeout", float, 600.0)):
            ap.add_argument(flag, type=kind, default=default)
        args, rest = ap.parse_known_args(argv)
        return run_bench(args.ranks, rest, threads=args.threads,
                         timeout=args.timeout)

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--m", type=int, default=1024)
    ap.add_argument("--rho", type=float, default=0.9)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--matvec", default="auto",
                    choices=("auto", "pallas", "xla"))
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)

    pcd0 = harness.load_bunny()
    pcd1, A, Agt = harness.make_problem(pcd0, args.m, args.rho,
                                        np.random.default_rng(args.seed))
    u0 = np.random.default_rng(args.seed).random(args.m).astype(np.float32)
    job = dict(D1=pcd0.astype(np.float32), D2=pcd1.astype(np.float32),
               A=A.astype(np.int32), u0=u0, matvec=args.matvec, probes=16,
               power_steps=4)
    t0 = time.perf_counter()
    res = run(args.ranks, [job], threads=args.threads,
              timeout=args.timeout)[0]
    P, R = data.get_precision_recall(A[res["mask"]], Agt)
    print(json.dumps(dict(ranks=args.ranks, m=args.m, rho=args.rho,
                          matvec=args.matvec, precision=P, recall=R,
                          F=res["score"], ifinal=res["ifinal"],
                          ranks_agree=res["ranks_agree"],
                          wall_s=time.perf_counter() - t0,
                          stats=res["stats"])))


if __name__ == "__main__":
    main()
