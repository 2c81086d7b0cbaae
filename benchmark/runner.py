"""One run of one cell: set-up, the measured window, the judge, the line.

``run.py`` is the command; :func:`main` reads ``BENCHMARK.json``, finds
the cell, its configuration and its traffic by name, refuses a machine
with fewer cards than the cell asks for, and prints the result as the
last line of standard output. :func:`run_cell` does the work and takes
the device as an argument, so that the tests can drive it on the CPU at a
small size.

The window is a closed loop of one client: request k + 1 starts when
request k's result is on the host, requests take the set-up's distinct
problems in turn, and the window closes at the end of the first request
that ends ``seconds`` or more after it opened; its length is the time to
that end. With ``--trace 1`` the window lasts the traffic's
``trace_seconds`` (at most ``seconds``) under ``torch.profiler``, and the
line carries the per-layer metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, Optional

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = Path(__file__).resolve().parent
# top-level modules that must not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "clipper_tpu")


def cache_env(root: Path = ROOT) -> Dict[str, str]:
    """Fixed cache directories inside the checkout for what PyTorch, CUDA
    and Triton may compile (the port's own kernels build into
    ``build/clipper_tpu_torch/`` of the checkout)."""
    base = root / "build" / "bench_cache"
    return {"TRITON_CACHE_DIR": str(base / "triton"),
            "TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "PYTORCH_KERNEL_CACHE_PATH": str(base / "torch_kernels"),
            "CUDA_CACHE_PATH": str(base / "cuda")}


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"missing {path}")
    return json.loads(path.read_text())


def find(items, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"BENCHMARK.json has no {what} {name!r}")


def cell_metrics(bench: dict, cell: str, group: str):
    """The metrics of ``group`` ("end_to_end" or "per_layer") that cell
    ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if group == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved
                             else [])]


def read_layer(name: str, record: dict) -> Optional[float]:
    """The reader ``metrics/<name>.py``'s value over a traced run's
    record, or None where it finds nothing to read."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


def forbidden_modules():
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def run_cell(bench: dict, cell: dict, config: dict, traffic: dict,
             limits: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             workers: int = 8) -> dict:
    """One run of a cell: the result's dict, with ``checks`` last."""
    import torch
    from benchmark import entries

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    entry = entries.ENTRIES[traffic["entry"]](config, traffic, seed, dev,
                                              trace, workers)
    for k in range(traffic["warm_requests"]):
        entry.request(k)
    entry.clear()
    entries.sync(dev)
    # what the set-up made stays out of the collector's sweeps in the
    # window, so that a sweep over it does not land in one run and not in
    # another
    gc.collect()
    gc.freeze()
    window = min(seconds, traffic["trace_seconds"]) if trace else seconds
    attempted = failed = 0
    errors = []
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    with prof if prof is not None else contextlib.nullcontext():
        t_open = time.perf_counter()
        while True:
            attempted += 1
            try:
                entry.request(attempted - 1)
            except Exception as exc:      # counted, and the run is wrong
                failed += 1
                errors.append(repr(exc))
            if time.perf_counter() - t_open >= window:
                break
        window_s = time.perf_counter() - t_open
    gc.unfreeze()
    done = attempted - failed
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell["chips"],
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                         if dev.type == "cuda" else 0)}
    found = forbidden_modules()
    if found:
        raise RuntimeError("loaded once the window closed: "
                           + ", ".join(found))
    metrics = {}
    breakdown = None
    if trace:
        from benchmark import trace as trace_mod
        summary = trace_mod.summarize(prof)
        del prof
        device_info.update(busy_s=summary.busy_s, window_s=window_s)
        record = dict(entry.layer, summary=summary, window_s=window_s,
                      requests=done)
        for m in cell_metrics(bench, cell["name"], "per_layer"):
            value = read_layer(m["name"], record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = summary.breakdown()
    else:
        values = dict(entry.end_to_end(window_s, done) if done else {},
                      setup_s=setup_s)
        for m in cell_metrics(bench, cell["name"], "end_to_end"):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}

    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    numbers = entry.judge(dev, traffic["judged"])
    judge_s = time.perf_counter() - t_judge
    readings = {}
    for n in numbers:
        for k, v in n.items():
            readings[k] = max(readings.get(k, -math.inf), v)
    checks = {}
    for name, limit in limits.items():
        vals = [n[name] for n in numbers if name in n]
        worst = max(vals) if vals else math.inf
        checks[name] = {"value": worst, "limit": limit, "answers": len(vals)}
    correct = (failed == 0 and done > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["errors"] = errors[:3]
    out["judge_s"] = judge_s
    out["readings"] = readings
    out["checks"] = checks
    return out


def finite(x: float) -> float:
    """x, with inf (an answer with no support) written as 1e300."""
    return x if math.isfinite(x) else 1e300


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")

    bench = load_json(ROOT / "BENCHMARK.json")
    cell = find(bench["workloads"], args.workload, "workload")
    config = load_json(BENCH_DIR / "configs" / f"{cell['config']}.json")
    from benchmark.traffic import generate
    traffic = generate.load_traffic(cell["traffic"])
    limits = load_json(BENCH_DIR / "workloads"
                       / f"{cell['name']}.json")["limits"]

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} cards; "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    # one host thread for PyTorch's own CPU work: the program's host path
    # is one Python thread, and idle workers spinning beside it add noise
    torch.set_num_threads(1)
    out = run_cell(bench, cell, config, traffic, limits, args.seed,
                   args.seconds, bool(args.trace), "cuda", t_start,
                   workers=min(8, os.cpu_count() or 1))
    found = forbidden_modules()
    if found:
        print("loaded in this process: " + ", ".join(found), file=sys.stderr)
        return 3
    for err in out["errors"]:
        print(f"request failed: {err}", file=sys.stderr)
    print(f"judged in {out.pop('judge_s'):.1f} s", file=sys.stderr)
    del out["errors"], out["readings"]
    checks = out.pop("checks")
    out["checks"] = {k: {"value": finite(v["value"]), "limit": v["limit"]}
                     for k, v in checks.items()}
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}, "
              f"worst of {c['answers']} answers)", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
