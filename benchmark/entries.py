"""The program's entries that a cell's window drives, one class a kind.

A traffic file's ``entry`` names the kind: ``"facade"`` calls a
``clipper_tpu_torch.Clipper``'s ``score_pairwise_consistency`` and then
``solve(u0)`` once a request on one problem. An entry is built in the
set-up from the configuration, the traffic and the seed, runs one request
at a time with its result on the host when it returns, times each
request on the host clock, keeps the answers that the judge will read
and, in a traced run, the spans that the per-layer metrics read. Nothing
else of the program is touched.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import judge
from benchmark.traffic import generate


def make_invariant(inv: dict):
    """The program's invariant of a configuration's ``invariant`` group."""
    from clipper_tpu_torch.invariants.euclidean import (
        EuclideanDistance, EuclideanDistanceParams)
    if inv["kind"] == "euclidean":
        return EuclideanDistance(EuclideanDistanceParams(
            sigma=inv["sigma"], epsilon=inv["epsilon"],
            mindist=inv.get("mindist", 0.0)))
    raise ValueError(f"unknown invariant {inv['kind']!r}")


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Span:
    """Milliseconds between two marks on the device's stream: CUDA events
    on the card, the host clock elsewhere."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)

    def start(self):
        if self.cuda:
            self.a.record()
        else:
            self.a = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self.b.record()
            self.b.synchronize()
            return self.a.elapsed_time(self.b)
        return (time.perf_counter() - self.a) * 1e3


class FacadeEntry:
    """One problem a request through the Clipper facade: the requests'
    problems in turn over ``slots`` Clippers in turn (a Clipper keeps its
    last build, which the judge reads), each solved from the u0 that the
    run's seed drew for it. ``layer`` collects the traced run's readings:
    ``stage_ms`` (lists a request) and ``launches`` (kernel family -> the
    bound seconds of each launch)."""

    def __init__(self, config, traffic, seed, dev, trace, workers):
        from clipper_tpu_torch import Clipper
        from clipper_tpu_torch.types import Params
        self.config, self.traffic, self.dev = config, traffic, dev
        self.trace = trace
        self.inv = config["invariant"]
        self.requests = generate.make_requests(config, traffic, seed,
                                               workers)
        self.keep_rng = np.random.default_rng(
            np.random.SeedSequence([seed, 2]))
        self.latency_ms: List[float] = []
        self.layer = {"stage_ms": {}, "launches": {}}
        self.kept = []
        f = traffic["facade"]
        inv = make_invariant(self.inv)
        self.clippers = [Clipper(inv, Params(affinityeps=config["affinityeps"]),
                                 dtype=torch.float32, engine=f["engine"],
                                 device=dev)
                         for _ in range(f["slots"])]
        self.data = []
        for r in self.requests:
            D1, D2, A = generate.problem(r, 0)
            self.data.append((D1.T, D2.T, A,
                              torch.as_tensor(r.u0s[0], device=dev)))
        self.slot_last = [None] * f["slots"]    # each Clipper's last problem
        self.span = Span(dev) if trace else None

    def stage(self, name: str, ms: float) -> None:
        self.layer["stage_ms"].setdefault(name, []).append(ms)

    def clear(self) -> None:
        """Forget what the warm-up requests left."""
        self.latency_ms.clear()
        self.kept.clear()
        for v in self.layer.values():
            v.clear()

    def request(self, k: int) -> None:
        i = k % len(self.data)
        c = self.clippers[k % len(self.clippers)]
        self.slot_last[k % len(self.clippers)] = i
        D1, D2, A, u0 = self.data[i]
        t0 = time.perf_counter()
        if self.trace:
            self.span.start()
        c.score_pairwise_consistency(D1, D2, A)
        if self.trace:
            build_ms = self.span.stop()
            self.span.start()
        sol = c.solve(u0)
        mask = sol.mask.cpu()            # the result, on the host
        if self.trace:
            solve_ms = self.span.stop()
        self.latency_ms.append((time.perf_counter() - t0) * 1e3)
        self.kept.append((i, sol.u, sol.score, mask))
        if self.trace:
            from benchmark import roofline
            self.stage("facade.build", build_ms)
            self.stage("facade.solve", solve_ms)
            self.layer["launches"].setdefault("affinity_build", []).append(
                roofline.affinity_build(self.traffic["m"],
                                        self.config["dims"], 4))

    def end_to_end(self, window_s: float, n: int) -> Dict[str, float]:
        return {"solve_ms": window_s * 1e3 / n,
                "solve_ms_p95": float(np.percentile(self.latency_ms, 95))}

    def judge(self, device, limit: int) -> List[Dict[str, float]]:
        """The numbers of a seeded sample of ``limit`` answers, and of each
        Clipper's last build (M + I, C + I) of the window."""
        eps = self.config["affinityeps"]
        best = {}       # problem -> F* from its u0 (judge.best_objective)
        out = []
        for k in self.keep_rng.permutation(len(self.kept))[:limit]:
            j, u, F, mask = self.kept[k]
            D1, D2, A = generate.problem(self.requests[j], 0)
            if j not in best:
                best[j] = judge.best_objective(
                    self.inv, eps, D1, D2, A, self.requests[j].u0s[0],
                    device)
            out.append(judge.answer_numbers(self.inv, eps, D1, D2, A, u,
                                            float(F), mask, device, best[j]))
        if self.traffic["facade"]["judge_build"]:
            for j, c in zip(self.slot_last, self.clippers):
                if j is None:
                    continue
                D1, D2, A = generate.problem(self.requests[j], 0)
                M, C = c.get_affinity_matrix(), c.get_constraint_matrix()
                out.append(judge.build_numbers(self.inv, eps, D1, D2, A, M,
                                               C, device, identity=True))
                del M, C
        return out


ENTRIES = {"facade": FacadeEntry}
