"""The readings that a cell's limits are set from, on the card.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \\
        --seconds 5 --controls bf16,f32 [--faults state,truncate,alter] \\
        [--out control.json]

For each seed: one run of the cell as ``run.py`` makes it (a window of
``--seconds``), with the worst reading of every number the judge has
(``reference/judge.py``), and then each control of ``--controls`` put in
the program's place on the same problems and from the same u0 (the
requests' first ``judged`` problems) and judged alike. A control is the
plain reference (``reference/scores.py`` and ``reference/solve.py``)
computed one step below the configuration's precision: ``bf16``
computes the endpoints, the scores, M, C and the solve in bfloat16
(float32's next step down); ``f32`` is the reference itself in float32,
which has to pass. ``--faults`` runs the cell again with each named
fault of ``faults.py`` planted under the timed path. The benchmark's own
runs never run this.
"""

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_numbers(kind: str, config: dict, traffic: dict, requests,
                    device):
    """Worst readings of the control ``kind`` over the requests' first
    ``traffic["judged"]`` problems."""
    import torch
    from benchmark.reference import judge, scores, solve
    from benchmark.traffic import generate

    inv, eps = config["invariant"], config["affinityeps"]
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    picks = [(b, w) for b, r in enumerate(requests)
             for w in range(r.As.shape[0])][:traffic["judged"]]
    worst = {}
    for b, w in picks:
        req = requests[b]
        D1, D2, A = generate.problem(req, w)
        P1, P2, At = judge.endpoints(D1, D2, A, device, dtype)
        M, C = scores.dense_mc(inv, P1, P2, At, eps)
        del P1, P2
        u, F, _ = solve.pga(M, C, torch.as_tensor(req.u0s[w],
                                                  device=device))
        u = u.float().cpu().numpy()
        best = judge.best_objective(inv, eps, D1, D2, A, req.u0s[w], device)
        got = judge.answer_numbers(inv, eps, D1, D2, A, u, F,
                                   judge.round_dsd_heu(u, F), device, best)
        if traffic["facade"]["judge_build"]:
            got.update(judge.build_numbers(inv, eps, D1, D2, A, M, C,
                                           device))
        del M, C
        if device.type == "cuda":
            torch.cuda.empty_cache()
        for k, v in got.items():
            worst[k] = max(worst.get(k, -math.inf), v)
    return worst, len(picks)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--controls", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from benchmark import faults, runner
    os.environ.update(runner.cache_env(ROOT))
    import torch
    from benchmark.traffic import generate
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = runner.load_json(ROOT / "BENCHMARK.json")
    cell = runner.find(bench["workloads"], args.workload, "workload")
    config = runner.load_json(runner.BENCH_DIR / "configs"
                              / f"{cell['config']}.json")
    traffic = generate.load_traffic(cell["traffic"])
    limits = runner.load_json(runner.BENCH_DIR / "workloads"
                              / f"{cell['name']}.json")["limits"]
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        out = runner.run_cell(bench, cell, config, traffic, limits, seed,
                              args.seconds, False, "cuda", t0)
        row = {"seed": seed, "correct": out["correct"],
               "metrics": {k: v["value"] for k, v in out["metrics"].items()},
               "memory_peak_bytes": out["device"]["memory_peak_bytes"],
               "program": out["readings"], "errors": out["errors"]}
        del out
        torch.cuda.empty_cache()
        requests = generate.make_requests(config, traffic, seed, 8)
        for kind in filter(None, args.controls.split(",")):
            t1 = time.perf_counter()
            row[kind], n = control_numbers(kind, config, traffic, requests,
                                           torch.device("cuda"))
            row[f"{kind}_problems"] = n
            row[f"{kind}_s"] = time.perf_counter() - t1
        for name in filter(None, args.faults.split(",")):
            with faults.plant(name):
                out = runner.run_cell(bench, cell, config, traffic, limits,
                                      seed, args.seconds, False, "cuda")
            row[name] = out["readings"]
            row[f"{name}_correct"] = out["correct"]
            del out
            torch.cuda.empty_cache()
        row["s"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload, "device":
               torch.cuda.get_device_name(0), "seeds": len(rows)}
    for kind in (["program"] + list(filter(None, args.controls.split(",")))
                 + list(filter(None, args.faults.split(",")))):
        names = sorted({k for r in rows for k in r.get(kind, {})})
        pick = max if kind == "program" else min
        summary[kind] = {k: pick(r[kind][k] for r in rows if k in r[kind])
                         for k in names}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps({"rows": rows,
                                              "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
