"""The readings that a 4-card cell's limits are set from, on the cards.

    python3 benchmark/control_sharded.py --workload bunny.sharded_m262144 \\
        --seeds 1,2 --controls bf16 --faults offset,truncate,state \\
        [--problems 2] [--banks] [--out control.json]

At the cell's size a process judges two seeds: the third seed's judge
has run out of memory building its compressed rows (cause not found),
so more seeds take more calls.

``control.py`` runs one process; a cell whose entry kind runs SPMD
(``kinds/sharded2d.py``) needs its ranks. So this command is a launcher
that starts one rank a card (the cell's ``chips``) with torchrun's
environment, as ``ranks.launch`` does, and each rank runs the same
readings in lock step; rank 0 prints one JSON line a seed and then a
summary. A rank that fails ends the command at once, non-zero.

For each seed: the program's answer to the seed's first request, one
of the cell's bank of four (with ``--banks`` the seed is also the bank's
seed, so that each seed reads a problem of its own), judged
as the cell judges it (``Entry.answer_numbers``, F* from the upstream
solver in float64 over the reference's blocks), with the ranks'
disagreement; for each of the first ``--problems`` distinct problems
the seeds meet, each fault of ``--faults`` (``faults_sharded.py``)
planted under the program, and each control of ``--controls`` in the
program's place, judged alike. ``bf16`` is the plain reference one step
below the configuration's float32: the endpoints, scores, blocks and
the upstream solver in bfloat16 (``reference/blocked.py``, the dense
form), on the same problem from the same u0. The summary holds the
program's worst reading of every number over the seeds and each
control's and fault's least. The benchmark's own runs never run this.
"""

import argparse
import datetime
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DEADLINE_S = 3300


def control_numbers(entry, kind: str, i: int, device) -> dict:
    """The judge's numbers of control ``kind`` (``bf16``) put in the
    program's place on problem i of ``entry``, from the same u0."""
    import torch
    from benchmark.reference import blocked, judge
    from benchmark.traffic import generate

    if kind != "bf16":
        raise ValueError(f"unknown control {kind!r}")
    r = entry.requests[i]
    D1, D2, A = generate.problem(r, 0)
    P1, P2, At = judge.endpoints(D1, D2, A, device, torch.bfloat16)
    op = blocked.BlockOperator(entry.inv, entry.eps, P1, P2, At, entry.grid,
                               "dense")
    u, F, _, _ = blocked.pga_blocked(op, r.u0s[0])
    del op
    if device.type == "cuda":
        torch.cuda.empty_cache()
    u = u.float().cpu().numpy()
    return entry.answer_numbers(i, u, F, judge.round_dsd_heu(u, F), device)


def release(dev) -> None:
    """Frees what the last solve or judge left: the collector first, so
    that a cycle holding a block goes before the allocator's cache."""
    import gc
    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def passes(numbers: dict, limits: dict) -> bool:
    return all(numbers.get(k, math.inf) <= v for k, v in limits.items())


def rank_main(args) -> int:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from benchmark import faults_sharded, runner
    from benchmark.reference import blocked
    from benchmark.traffic import generate

    rank, local = int(os.environ["RANK"]), int(os.environ["LOCAL_RANK"])
    if args.device == "cuda":
        torch.cuda.set_device(local)
        dev, backend = torch.device("cuda", local), "nccl"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    torch.set_num_threads(1)
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=300))
    bench = runner.load_json(ROOT / "BENCHMARK.json")
    cell = runner.find(bench["workloads"], args.workload, "workload")
    config = runner.load_json(runner.BENCH_DIR / "configs"
                              / f"{cell['config']}.json")
    traffic = generate.load_traffic(cell["traffic"])
    if args.traffic:
        traffic.update(json.loads(args.traffic))
    limits = runner.load_json(runner.BENCH_DIR / "workloads"
                              / f"{cell['name']}.json")["limits"]
    kind = runner.entry_kind(traffic["entry"])
    workers = max(1, min(8, (os.cpu_count() or 1) // cell["chips"]))
    best, problems, rows = {}, [], []
    controls = [c for c in args.controls.split(",") if c]
    faults = [f for f in args.faults.split(",") if f]
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        entry = kind(config, dict(traffic, bank_seed=seed) if args.banks
                     else traffic, seed, dev, False, workers)
        entry.best = best
        key = entry.requests[0].u0s[0].tobytes()
        if key not in problems:
            problems.append(key)
        row = {"seed": seed, "problem": problems.index(key)}
        if dev.type == "cuda":
            row["allocated_bytes"] = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t1 = time.perf_counter()
        u, F, mask, stats = entry.solve(0)
        row["solve_s"] = time.perf_counter() - t1
        row["stats"] = stats
        if dev.type == "cuda":
            # the program's own peak, before the judge's
            row["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        t1 = time.perf_counter()
        row["program"] = dict(entry.answer_numbers(0, u, F, mask, dev),
                              rank_disagreement=blocked.rank_disagreement(
                                  [u], [F], dev))
        row["judge_s"] = time.perf_counter() - t1
        del u, F, mask
        release(dev)
        if row["problem"] < args.problems and not any(
                r["problem"] == row["problem"] for r in rows):
            for name in faults:
                t1 = time.perf_counter()
                with faults_sharded.plant(name, rank):
                    u, F, mask, _ = entry.solve(0)
                row[name] = dict(entry.answer_numbers(0, u, F, mask, dev),
                                 rank_disagreement=blocked.rank_disagreement(
                                     [u], [F], dev))
                row[f"{name}_s"] = time.perf_counter() - t1
                del u, F, mask
                release(dev)
            for name in controls:
                t1 = time.perf_counter()
                row[name] = control_numbers(entry, name, 0, dev)
                row[f"{name}_s"] = time.perf_counter() - t1
                release(dev)
        for name in ["program"] + faults + controls:
            if name in row:
                row[f"{name}_correct"] = passes(row[name], limits)
        row["s"] = time.perf_counter() - t0
        rows.append(row)
        del entry
        release(dev)
        if rank == 0:
            print(json.dumps(row), flush=True)
    summary = {"workload": args.workload, "seeds": len(rows),
               "problems": len(problems),
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu"),
               "ranks": dist.get_world_size()}
    for name in ["program"] + faults + controls:
        got = [r[name] for r in rows if name in r]
        pick = max if name == "program" else min
        summary[name] = {k: pick(g[k] for g in got)
                         for k in sorted({k for g in got for k in g})}
    dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(summary), flush=True)
        if args.out:
            Path(args.out).write_text(json.dumps(
                {"rows": rows, "summary": summary}, indent=1))
    return 0


def launch(argv, n: int) -> int:
    """Runs this command as ``n`` ranks on this host: 0 where every rank
    exited 0; at the first that fails, or at the deadline, the rest are
    stopped."""
    sys.path.insert(0, str(ROOT))
    from benchmark import ranks, runner
    port = str(ranks.free_port())
    hook = ranks._die_with_launcher()
    procs = []
    for r in range(n):
        env = dict(os.environ, **runner.cache_env(ROOT), RANK=str(r),
                   WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port, TORCH_NCCL_ASYNC_ERROR_HANDLING="1")
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--rank"] + argv, env=env,
            stdout=None if r == 0 else subprocess.DEVNULL,
            start_new_session=True, preexec_fn=hook))
    t0, rc = time.monotonic(), 0
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                rc = bad[0] if bad[0] > 0 else 1
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() - t0 > DEADLINE_S:
                rc = 124
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            ranks._kill(p)
            p.wait()
    return rc


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="bf16")
    ap.add_argument("--faults", default="offset,truncate,state")
    ap.add_argument("--banks", action="store_true",
                    help="each seed draws its own bank (bank_seed = the seed)")
    ap.add_argument("--problems", type=int, default=2,
                    help="distinct problems that the faults and the "
                         "controls run on")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--traffic", default="",
                    help="JSON of traffic keys to replace (tests: a small m)")
    ap.add_argument("--rank", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank:
        try:
            return rank_main(args)
        except BaseException:
            import traceback
            traceback.print_exc()
            sys.stderr.flush()
            os._exit(1)
    sys.path.insert(0, str(ROOT))
    from benchmark import runner
    cell = runner.find(runner.load_json(ROOT / "BENCHMARK.json")["workloads"],
                       args.workload, "workload")
    if args.device == "cuda":
        import torch
        if torch.cuda.device_count() < cell["chips"]:
            print(f"{cell['name']} needs {cell['chips']} cards",
                  file=sys.stderr)
            return 2
    return launch(argv, cell["chips"])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
