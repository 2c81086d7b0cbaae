"""The 2D block-sharded engine held to the blocked plain reference.

``benchmark/reference/blocked.py`` judges the 2D engine at a scale
where no (m, m) matrix can be formed: here it is held to the dense judge (``benchmark/reference/judge.py``) in one
process, in each of its forms, and then run SPMD on one group of 4
spawned gloo ranks (``bench/cpu_mesh_run``'s spawn, under its own
deadline) beside ``parallel.sharded.solve_sharded`` on a 2 x 2 mesh, on
bunny problems of the benchmark's generator at m = 96 and 512 (rho
0.9), with int8 and float32 storage: every answer passes the judge's
limits, every rank returns the same u, F and mask, the blocked F*
equals the dense one, and the engine's spans and counters are recorded
under a profiler and nowhere else.
"""

import contextlib
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import blocked, judge
from benchmark.traffic import generate
from clipper_tpu_torch.bench import cpu_mesh_run

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmark" / "configs"
                     / "bunny_euclid.json").read_text())
# the limits of the blocked judge's numbers: the program read at most
# 8.4e-8, 0 and 1.4e-3 on four H100s at m = 262,144, the bf16 reference
# 1.1e-3 and 0.94 (PERF.md, Findings)
LIMITS = {"objective_err": 1e-5, "solve_shortfall": 0.03,
          "support_inconsistency": 0.02, "mask_err": 0,
          "rank_disagreement": 0}
INV, EPS = CONFIG["invariant"], CONFIG["affinityeps"]
SIZES = (96, 512)
STORAGES = ("int8", "float32")
SPANS = ("sharded.build", "sharded.solve", "sharded.polish",
         "sharded.matvec", "sharded.collective")
COUNTERS = ("sharded.matvecs", "sharded.collective_calls",
            "sharded.collective_bytes", "sharded.polish_exact")


def bunny(m, seed=3):
    """(D1, D2, A, u0) of one bunny problem of the benchmark's generator
    at m associations, rho 0.9."""
    traffic = dict(problems=1, m=m, rho=0.9, bank_seed=20261024 + m,
                   distinct_requests=1)
    r = generate.make_requests(CONFIG, traffic, seed, 2)[0]
    return (*generate.problem(r, 0), r.u0s[0])


@pytest.fixture(scope="module")
def dense_best():
    """The dense judge's F* of each problem, from its u0."""
    return {m: judge.best_objective(INV, EPS, *bunny(m), "cpu")
            for m in SIZES}


@pytest.mark.parametrize("m", SIZES)
@pytest.mark.parametrize("form", blocked.FORMS)
def test_blocked_best_objective_equals_dense(dense_best, m, form):
    """F* over one block (one process), each form, in float64: the dense
    judge's within 1e-12."""
    D1, D2, A, u0 = bunny(m)
    P1, P2, At = judge.endpoints(D1, D2, A, "cpu")
    op = blocked.BlockOperator(INV, EPS, P1, P2, At, form=form,
                               budget=4096)
    F = blocked.best_objective_blocked(op, u0)
    assert abs(F - dense_best[m]) <= 1e-12 * dense_best[m]


@pytest.mark.parametrize("m", SIZES)
@pytest.mark.parametrize("answer", ("f32", "bf16", "init"))
def test_blocked_answer_numbers_equal_dense(dense_best, m, answer):
    """The judge's numbers over supp(u) x supp(u) are the dense judge's,
    on a sound answer (the reference in float32), a lower-precision one
    and one with a wide support (the rescaled u0)."""
    from benchmark.reference import scores, solve
    D1, D2, A, u0 = bunny(m)
    P1, P2, At = judge.endpoints(D1, D2, A, "cpu")
    M, C = scores.dense_mc(INV, P1, P2, At, EPS)
    if answer == "init":
        u = (M @ torch.as_tensor(u0, dtype=torch.float64)).float()
        F = float(u @ u)
    else:
        dtype = torch.float32 if answer == "f32" else torch.bfloat16
        u, F, _ = solve.pga(M.to(dtype), C.to(dtype), torch.as_tensor(u0))
    u = u.float().numpy()
    mask = judge.round_dsd_heu(u, F)
    mask[0] = not mask[0]
    want = judge.answer_numbers(INV, EPS, D1, D2, A, u, F, mask, "cpu",
                                dense_best[m])
    got = blocked.answer_numbers_blocked(INV, EPS, D1, D2, A, u, F, mask,
                                         "cpu", dense_best[m], budget=5000)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-15), k


def test_answer_with_no_support_reads_inf():
    D1, D2, A, _ = bunny(96)
    got = blocked.answer_numbers_blocked(INV, EPS, D1, D2, A, np.zeros(96),
                                         0.0, np.zeros(96, bool), "cpu", 1.0)
    assert all(math.isinf(v) for v in got.values())


def test_operator_refuses_a_grid_the_group_cannot_fill():
    D1, D2, A, _ = bunny(96)
    P1, P2, At = judge.endpoints(D1, D2, A, "cpu")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        blocked.BlockOperator(INV, EPS, P1, P2, At, (2, 2))
    with pytest.raises(ValueError, match="float64"):
        blocked.BlockOperator(INV, EPS, *judge.endpoints(
            D1, D2, A, "cpu", torch.float32), (1, 1), "csr")


# ----------------------------------------------------------------------
# SPMD: one group of 4 gloo ranks
# ----------------------------------------------------------------------

def _solve(mesh, data, storage, traced, **kw):
    """One solve_sharded, the m = 262,144 settings scaled down: (u, F,
    mask, stats, the tracer's totals)."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.entries import make_invariant
    from clipper_tpu_torch.parallel import sharded
    from clipper_tpu_torch.types import Params
    from clipper_tpu_torch.utils import profiling

    D1, D2, A, u0 = data
    opts = dict(storage_dtype=torch.int8 if storage == "int8" else None,
                support=128, build_chunk=16, matvec_chunk=64)
    opts.update(kw)
    stats = {}
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) if traced else \
            contextlib.nullcontext():
        sol = sharded.solve_sharded(make_invariant(INV), D1, D2, A, u0,
                                    Params(affinityeps=EPS), mesh,
                                    affinityeps=EPS, device="cpu",
                                    stats=stats, **opts)
    totals = profiling.totals()
    profiling.reset()
    return sol.u, sol.score, sol.mask, stats, totals


def _rank_main(rank, D, store_path, payload, threads, out):
    """Each job of ``payload`` on this rank: the program's answer, the
    blocked reference's F* (rebuilt and kept) and its numbers, the
    ranks' disagreement, the tracer's totals."""
    try:
        with cpu_mesh_run._joined(rank, D, store_path, threads):
            from clipper_tpu_torch.parallel import sharded
            mesh = sharded.make_mesh((2, 2))
            results = []
            for job in payload:
                data = bunny(job["m"])
                u, F, mask, stats, totals = _solve(
                    mesh, data, job["storage"], job["traced"],
                    **job.get("opts", {}))
                D1, D2, A, u0 = data
                P1, P2, At = judge.endpoints(D1, D2, A, "cpu")
                best = {form: blocked.best_objective_blocked(
                    blocked.BlockOperator(INV, EPS, P1, P2, At, (2, 2), form,
                                          budget=2048), u0)
                    for form in ("rebuild", "csr")}
                numbers = blocked.answer_numbers_blocked(
                    INV, EPS, D1, D2, A, u, float(F), mask, "cpu",
                    best["rebuild"])
                numbers["rank_disagreement"] = blocked.rank_disagreement(
                    [u], [F], torch.device("cpu"))
                results.append(dict(u=u.numpy(), F=float(F),
                                    mask=mask.numpy(), stats=stats,
                                    totals=totals, best=best,
                                    numbers=numbers))
        out.put((rank, results, None))
    except BaseException as exc:
        out.put((rank, None, repr(exc)))
        raise


JOBS = ([dict(m=m, storage=s, traced=(s == "int8")) for m in SIZES
         for s in STORAGES]
        + [dict(m=512, storage="int8", traced=False),
           # a support narrower than u's: the exact polish
           dict(m=512, storage="int8", traced=True, opts=dict(support=8))])
TRACED, UNTRACED = 2, 4     # the same solve under a profiler and not


@pytest.fixture(scope="module")
def spmd():
    """{job index: every rank's result}, on one group of 4 gloo ranks
    under a 120 s deadline."""
    got = cpu_mesh_run._spawn(_rank_main, 4, JOBS, 1, 120.0)
    return {j: [got[r][j] for r in range(4)] for j in range(len(JOBS))}


def _ids(j):
    job = JOBS[j]
    return f"m{job['m']}-{job['storage']}" + (
        f"-support{job['opts']['support']}" if "opts" in job else "") + (
        "-traced" if job["traced"] else "")


@pytest.mark.parametrize("j", range(len(JOBS)), ids=_ids)
def test_engine_passes_the_judges_limits(spmd, j):
    for r in spmd[j]:
        for k, limit in LIMITS.items():
            assert r["numbers"][k] <= limit, (k, r["numbers"])


@pytest.mark.parametrize("j", range(len(JOBS)), ids=_ids)
def test_every_rank_returns_the_same_answer(spmd, j):
    r0 = spmd[j][0]
    for r in spmd[j][1:]:
        np.testing.assert_array_equal(r["u"], r0["u"])
        np.testing.assert_array_equal(r["mask"], r0["mask"])
        assert r["F"] == r0["F"]
        assert r["stats"]["polish_branch"] == r0["stats"]["polish_branch"]
        assert r["best"] == r0["best"]
    assert r0["numbers"]["rank_disagreement"] == 0.0


@pytest.mark.parametrize("m", SIZES)
def test_spmd_reference_equals_dense(spmd, dense_best, m):
    """The blocked F* on 2 x 2 ranks, rebuilt and kept, is the dense
    judge's."""
    for j, job in enumerate(JOBS):
        if job["m"] == m:
            for form, F in spmd[j][0]["best"].items():
                assert abs(F - dense_best[m]) <= 1e-12 * dense_best[m], form


@pytest.mark.parametrize("j", [j for j, job in enumerate(JOBS)
                               if job["traced"]], ids=_ids)
def test_spans_and_counters_under_a_profiler(spmd, j):
    """Every span opens; one block matvec a flat-init step and a tick,
    each with one column sum and one row gather of known bytes; the
    polish's branch counted."""
    m = JOBS[j]["m"]
    for r in spmd[j]:
        spans, counters = r["totals"]["spans"], r["totals"]["counters"]
        assert set(SPANS) <= set(spans)
        assert set(COUNTERS) <= set(counters)
        n = counters["sharded.matvecs"]
        assert spans["sharded.matvec"]["count"] == n
        # flat init: two matvecs; the host loop ticks in groups of 4
        assert n == 2 + 4 * math.ceil(r["stats"]["ticks"] / 4)
        exact = r["stats"]["polish_branch"] == "exact"
        assert counters["sharded.polish_exact"] == int(exact)
        assert counters["sharded.collective_calls"] == 2 * n + exact
        assert spans["sharded.collective"]["count"] == 2 * n + exact
        # a column sum of (m, 1) f64 partials and a row gather of an
        # (m, 2, 1) f32 buffer a matvec; the exact polish one f64 number
        assert counters["sharded.collective_bytes"] == 16 * m * n + 8 * exact
        for name in ("sharded.build", "sharded.solve", "sharded.polish"):
            assert spans[name]["count"] == 1


def test_exact_polish_branch_ran(spmd):
    assert spmd[len(JOBS) - 1][0]["stats"]["polish_branch"] == "exact"
    assert spmd[0][0]["stats"]["polish_branch"] == "support"


@pytest.mark.parametrize("j", [j for j, job in enumerate(JOBS)
                               if not job["traced"]], ids=_ids)
def test_nothing_recorded_without_a_profiler(spmd, j):
    for r in spmd[j]:
        assert r["totals"] == {"spans": {}, "counters": {}}


def test_traced_and_untraced_solves_agree(spmd):
    """The tracer changes nothing the engine computes."""
    assert JOBS[TRACED] == dict(JOBS[UNTRACED], traced=True)
    for a, b in zip(spmd[TRACED], spmd[UNTRACED]):
        np.testing.assert_array_equal(a["u"], b["u"])
        assert a["F"] == b["F"] and a["stats"]["ticks"] == b["stats"]["ticks"]
