"""Run the sharded engines, the pools and the dry run on D gloo ranks.

The counterpart of ``clipper_tpu/bench/cpu_mesh_run.py``, which ran the
sharded engines on a virtual N-device CPU mesh: here the mesh is D
processes joined by a ``torch.distributed`` gloo group, each running the
same job on the same data, on the CPU (``device="cuda"`` puts every rank
on the one card: gloo all-reduces CUDA tensors through the host, where
NCCL would refuse two ranks on one card). The ranks start in **spawn**
mode (a forked child would inherit the parent's threads) and meet
through a ``FileStore`` in a temporary directory, so no network is used.
``init_process_group`` gets a 60 s timeout and the join its own, so a
hung collective fails instead of hanging its caller.

Library use (the tests): :func:`run_all` runs a list of jobs (the
triangle-sharded engine, the 2D engine, the pool over the group,
shard_batch with the batched engine, the dry run) on one group of D
ranks and returns every rank's results as numpy; :func:`run` returns
rank 0's, each solve with ``ranks_agree``: whether every rank's u equals
rank 0's bit for bit.

Command line, one bunny problem through the triangle-sharded engine:
    python -m clipper_tpu_torch.bench.cpu_mesh_run --ranks 3 --m 1024 \\
        --rho 0.9 --matvec xla
prints one JSON line with P/R, F, ifinal, the stage times of rank 0 and
whether the ranks agree. With ``--bench=sharded`` (the JAX tool's
default) or ``--bench=symshard`` the other arguments go to
``bench/sharded_bench.py`` or ``bench/symshard_bench.py`` on every rank
(:func:`run_bench`):
    python -m clipper_tpu_torch.bench.cpu_mesh_run --ranks 4 \\
        --bench=sharded 1024 1 --rho=0.9
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


def _solution(sol, stats, launches) -> Dict:
    """A Solution as numpy; a single problem's score and ifinal as a float
    and an int."""
    score, ifinal = sol.score.cpu().numpy(), sol.ifinal.cpu().numpy()
    if score.ndim == 0:
        score, ifinal = float(score), int(ifinal)
    return dict(u=sol.u.cpu().numpy(), mask=sol.mask.cpu().numpy(),
                score=score, ifinal=ifinal, stats=stats, launches=launches)


def _symshard_job(job: Dict, dev):
    """The triangle-sharded engine on the default group (the facade's
    engine="sharded" with ``facade=True``)."""
    import torch

    from clipper_tpu_torch import Clipper
    from clipper_tpu_torch.bench import harness
    from clipper_tpu_torch.ops import symstore
    from clipper_tpu_torch.types import Params

    data = [torch.from_numpy(np.asarray(job.pop(k))).to(dev)
            for k in ("D1", "D2", "A", "u0")]
    inv = job.pop("invariant", None) or harness.default_invariant()
    params = job.pop("params", None) or Params()
    stats = {}
    if job.pop("facade", False):
        c = Clipper(inv, params, dtype=data[3].dtype, engine="sharded",
                    device=dev, engine_opts=dict(job, stats=stats))
        c.score_pairwise_consistency(data[0].T, data[1].T, data[2])
        return c.solve(u0=data[3]), stats
    return symstore.solve_sharded_sym(inv, *data, params, None, stats=stats,
                                      **job), stats


def _sharded_job(job: Dict, dev):
    """The 2D engine on ``mesh`` (a shape, None for the squarest, or
    "multihost" with ``local_world_size``); None on a rank outside the
    mesh."""
    from clipper_tpu_torch.bench import harness
    from clipper_tpu_torch.parallel import sharded
    from clipper_tpu_torch.types import Params

    shape = job.pop("mesh", None)
    if shape == "multihost":
        os.environ["LOCAL_WORLD_SIZE"] = str(job.pop("local_world_size"))
        mesh = sharded.make_mesh_multihost()
    else:
        mesh = sharded.make_mesh(shape)
    if not mesh.member:
        return None, None
    data = [job.pop(k) for k in ("D1", "D2", "A", "u0")]
    inv = job.pop("invariant", None) or harness.default_invariant()
    params = job.pop("params", None) or Params()
    stats = {}
    return sharded.solve_sharded(inv, *data, params, mesh, device=dev,
                                 stats=stats, **job), stats


def _pool_job(job: Dict, dev):
    """make_pool_pipeline(mesh=the default group) on the whole workload."""
    import torch.distributed as dist

    from clipper_tpu_torch.bench import harness
    from clipper_tpu_torch.parallel import pool
    from clipper_tpu_torch.types import Params

    data = [job.pop(k) for k in ("D1", "D2s", "As", "u0s")]
    inv = job.pop("invariant", None) or harness.default_invariant()
    params = job.pop("params", None) or Params()
    stats = {}
    pipe = pool.make_pool_pipeline(inv, params, mesh=dist.group.WORLD,
                                   device=dev, **job)
    return pipe(*data, stats=stats), dict(windows=stats["windows"])


def _batched_job(job: Dict, dev):
    """shard_batch over the default group, then the batched engine on this
    rank's slice."""
    import torch.distributed as dist

    from clipper_tpu_torch.bench import harness
    from clipper_tpu_torch.parallel import batched
    from clipper_tpu_torch.types import Params

    data = tuple(job.pop(k) for k in ("D1s", "D2s", "As", "u0s"))
    inv = job.pop("invariant", None) or harness.default_invariant()
    params = job.pop("params", None) or Params()
    part = batched.shard_batch(data, dist.group.WORLD, device=dev)
    return batched.make_batched_pipeline(inv, params, device=dev,
                                         **job)(*part), {}


_JOBS = {"symshard": _symshard_job, "sharded": _sharded_job,
         "pool": _pool_job, "batched": _batched_job}


def _run_job(job: Dict):
    """One job on this rank; its kernels' launches (on the card) with it."""
    import torch

    from clipper_tpu_torch import _kernels

    job = dict(job)
    kind = job.pop("kind", "symshard")
    dev = torch.device(job.pop("device", "cpu"))
    _kernels.reset_launches()
    if kind == "dryrun":
        from clipper_tpu_torch import dryrun
        return dryrun.dryrun_multichip(torch.distributed.get_world_size(),
                                       device=dev)
    sol, stats = _JOBS[kind](job, dev)
    if sol is None:
        return None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = {k: v for k, v in _kernels.LAUNCHES.items() if v}
    return _solution(sol, stats, launches)


def _rank_main(rank: int, D: int, store_path: str, jobs: List[Dict],
               threads: int, out) -> None:
    """One rank: join the gloo group, run every job, send its results to
    the parent, leave the group."""
    try:
        with _joined(rank, D, store_path, threads):
            results = [_run_job(job) for job in jobs]
        out.put((rank, results, None))
    except BaseException as exc:   # report, then let the parent fail
        out.put((rank, None, repr(exc)))
        raise


def _bench_rank_main(rank: int, D: int, store_path: str, payload,
                     threads: int, out) -> None:
    """One rank of ``--bench=symshard|sharded``: the bench's main(argv)
    inside the gloo group (on the CPU unless argv names a device); sends
    its return value to the parent."""
    import importlib

    name, argv = payload
    try:
        bench = importlib.import_module(f"clipper_tpu_torch.bench.{name}")
        if not any(a.startswith("--device=") for a in argv):
            argv = list(argv) + ["--device=cpu"]
        with _joined(rank, D, store_path, threads):
            res = bench.main(list(argv))
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


def run_all(D: int, jobs: List[Dict], *, threads: int = 1,
            timeout: float = 120.0) -> Dict[int, List]:
    """Run the jobs, in order, on one group of D gloo ranks; returns
    {rank: [that rank's result of each job]}. A job is a dict of numpy
    arrays and keywords with a ``kind`` and a ``device`` ("cpu" by
    default; "cuda" puts every rank on the current card):

    - "symshard" (the default): symstore.solve_sharded_sym's keywords
      with D1, D2 (n, d), A (m, 2), u0 (m,); ``facade=True`` goes
      through Clipper(engine="sharded") instead, its other keywords the
      engine_opts;
    - "sharded": the 2D engine, solve_sharded's keywords with D1, D2, A,
      u0 and ``mesh`` (a shape; None: the squarest; "multihost" with
      ``local_world_size``); a rank outside the mesh gives None;
    - "pool": make_pool_pipeline's keywords with D1, D2s, As, u0s, over
      the whole group;
    - "batched": make_batched_pipeline's keywords with D1s, D2s, As, u0s,
      each rank solving its shard_batch slice;
    - "dryrun": dryrun.dryrun_multichip over the group (its summary).

    A solve gives (u, mask, score, ifinal, stats, launches: this rank's
    kernel launches in the job). Raises if a rank fails, or if the ranks
    do not all finish within ``timeout`` seconds."""
    return _spawn(_rank_main, D, jobs, threads, timeout)


def run(D: int, jobs: List[Dict], *, threads: int = 1,
        timeout: float = 120.0) -> List[Dict]:
    """:func:`run_all`, returning rank 0's result of each job; a solve's
    with ``ranks_agree``: whether the u of every rank that gave one
    equals rank 0's bit for bit."""
    got = run_all(D, jobs, threads=threads, timeout=timeout)
    results = got[0]
    for j, res in enumerate(results):
        if res is not None and "u" in res:
            res["ranks_agree"] = all(
                got[r][j] is None or np.array_equal(got[r][j]["u"], res["u"])
                for r in range(D))
    return results


def run_bench(D: int, argv: List[str], *, bench: str = "symshard",
              threads: int = 1, timeout: float = 600.0):
    """``bench/<bench>.main(argv)`` (symshard_bench or sharded_bench) on D
    gloo ranks, on the CPU unless argv has ``--device=cuda`` (the JAX
    package's ``cpu_mesh_run --bench=...``); returns rank 0's result."""
    return _spawn(_bench_rank_main, D, (f"{bench}_bench", list(argv)),
                  threads, timeout)[0]


def main(argv=None):
    from clipper_tpu_torch.bench import data, harness

    argv = list(sys.argv[1:] if argv is None else argv)
    bench = [a for a in argv if a.startswith("--bench=")]
    if bench:
        argv.remove(bench[0])
        name = bench[0].split("=", 1)[1]
        if name not in ("symshard", "sharded"):
            raise ValueError(f"unknown --bench={name} (symshard, sharded)")
        ap = argparse.ArgumentParser(add_help=False)
        for flag, kind, default in (("--ranks", int, 2),
                                    ("--threads", int, 1),
                                    ("--timeout", float, 600.0)):
            ap.add_argument(flag, type=kind, default=default)
        args, rest = ap.parse_known_args(argv)
        return run_bench(args.ranks, rest, bench=name, threads=args.threads,
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
