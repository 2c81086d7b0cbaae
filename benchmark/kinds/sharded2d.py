"""The entry kind ``sharded2d``: one problem a request through the 2D
block-sharded engine, ``clipper_tpu_torch.parallel.sharded.solve_sharded``,
every rank of the default group one block of an (R, C) mesh.

It runs SPMD (``benchmark/README.md``, "A cell on 4 cards"): every rank
draws the same bank of problems from the traffic's ``bank_seed`` on its
own card, builds the same mesh (``sharded.make_mesh``, collective) and
calls ``solve_sharded`` on request k in lock step; a request ends with
the mask on the host. The engine's options are the traffic's
``sharded`` group: the mesh, the storage dtype, the solver, the probes,
``support`` (at least the cluster, so that the polish takes the top-k
branch), ``build_chunk`` and ``matvec_chunk`` (so that no matvec casts
the whole block). The solver's parameters are upstream's defaults with
the configuration's ``affinityeps`` and rounding.

The program's own stage clock (``stats``, CUDA events on the card)
fills ``layer["stage_ms"]``: ``sharded.build``, ``sharded.solve`` (init
and solve) and ``sharded.polish``; ``layer["launches"]`` holds each
request's least times of one block build and one block matvec
(``roofline_sharded.py``). The judge (``reference/blocked.py``) runs SPMD over the same ranks:
F* by the upstream solver in float64 over the reference's own blocks,
kept as compressed rows (``blocked.py``'s ``csr`` form), the dense
judge's numbers over each judged answer's support, and
``rank_disagreement``, how far any rank's u and F differ from rank 0's
over every answer of the window, which has to be 0.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark import roofline_sharded
from benchmark.entries import make_invariant
from benchmark.reference import blocked, judge
from benchmark.traffic import generate

STORAGE = {"int8": torch.int8, "bfloat16": torch.bfloat16, "float32": None}


class Entry:
    def __init__(self, config, traffic, seed, dev, trace, workers):
        from clipper_tpu_torch.parallel import sharded
        from clipper_tpu_torch.types import Params, Rounding
        self.sharded = sharded
        self.config, self.traffic, self.dev = config, traffic, dev
        self.inv = config["invariant"]
        self.eps = config["affinityeps"]
        s = traffic["sharded"]
        self.grid = tuple(s["mesh"])
        self.storage = s["storage"]
        self.mesh = sharded.make_mesh(self.grid)
        self.params = Params(affinityeps=self.eps,
                             rounding=Rounding[config["rounding"]])
        self.opts = dict(solver=s["solver"],
                         storage_dtype=STORAGE[self.storage],
                         probes=s["probes"], support=s["support"],
                         build_chunk=s["build_chunk"],
                         matvec_chunk=s["matvec_chunk"])
        if config["working_dtype"] != "float32":
            raise ValueError("the kind runs the float32 working dtype; the "
                             f"configuration says {config['working_dtype']}")
        self.invariant = make_invariant(self.inv)
        self.requests = generate.make_requests(config, traffic, seed,
                                               workers)
        self.keep_rng = np.random.default_rng(
            np.random.SeedSequence([seed, 2]))
        self.data = []
        for r in self.requests:
            D1, D2, A = generate.problem(r, 0)
            self.data.append(tuple(torch.as_tensor(x, device=dev)
                                   for x in (D1, D2, A, r.u0s[0])))
        self.layer = {"stage_ms": {}, "launches": {}}
        self.kept = []
        self.best: Dict[bytes, float] = {}     # u0's bytes -> F*
        m = traffic["m"]
        self.bounds = {
            "block_build": roofline_sharded.block_build(m, *self.grid,
                                                        self.storage),
            "block_matvec": roofline_sharded.block_matvec(m, *self.grid,
                                                          self.storage)}

    def clear(self) -> None:
        """Forget what the warm-up requests left."""
        self.kept.clear()
        for v in self.layer.values():
            v.clear()

    def solve(self, i: int):
        """(u, F, the mask on the host, stats) of problem i."""
        D1, D2, A, u0 = self.data[i]
        stats: Dict = {}
        sol = self.sharded.solve_sharded(
            self.invariant, D1, D2, A, u0, self.params, self.mesh,
            affinityeps=self.eps, device=self.dev, stats=stats, **self.opts)
        return sol.u, sol.score, sol.mask.cpu(), stats

    def request(self, k: int) -> None:
        i = k % len(self.data)
        u, F, mask, stats = self.solve(i)
        self.kept.append((i, u, F, mask))
        st = self.layer["stage_ms"]
        st.setdefault("sharded.build", []).append(stats["build"])
        st.setdefault("sharded.solve", []).append(stats["init"]
                                                  + stats["solve"])
        st.setdefault("sharded.polish", []).append(stats["polish"])
        for name, bound in self.bounds.items():
            self.layer["launches"].setdefault(name, []).append(bound)

    def end_to_end(self, window_s: float, n: int) -> Dict[str, float]:
        return {"solve_ms": window_s * 1e3 / n}

    def best_objective(self, i: int, device) -> float:
        """F* of problem i from its u0, by the upstream solver in float64
        over the reference's blocks (every rank, in lock step)."""
        r = self.requests[i]
        key = r.u0s[0].tobytes()
        if key not in self.best:
            P1, P2, At = judge.endpoints(*generate.problem(r, 0), device)
            op = blocked.BlockOperator(self.inv, self.eps, P1, P2, At,
                                       self.grid, "csr")
            self.best[key] = blocked.best_objective_blocked(op, r.u0s[0])
            del op
            if device.type == "cuda":
                torch.cuda.empty_cache()
        return self.best[key]

    def answer_numbers(self, i: int, u, F, mask, device) -> Dict[str, float]:
        """The judge's numbers of one answer to problem i."""
        D1, D2, A = generate.problem(self.requests[i], 0)
        return blocked.answer_numbers_blocked(
            self.inv, self.eps, D1, D2, A, u, float(F), mask, device,
            self.best_objective(i, device))

    def judge(self, device, limit: int) -> List[Dict[str, float]]:
        """The numbers of a seeded sample of ``limit`` answers, each with
        the ranks' disagreement over every answer of the window."""
        apart = blocked.rank_disagreement([u for _, u, _, _ in self.kept],
                                          [F for _, _, F, _ in self.kept],
                                          device)
        out = []
        for k in self.keep_rng.permutation(len(self.kept))[:limit]:
            i, u, F, mask = self.kept[k]
            out.append(dict(self.answer_numbers(i, u, F, mask, device),
                            rank_disagreement=apart))
        return out
