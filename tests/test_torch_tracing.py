"""The port's tracer (utils/profiling) inside the dense facade and the PGA
loop: its spans under a profiler, its counters against the loop's own
counts, and nothing of it, not a record-function region nor a host read,
without a profiler."""

import contextlib

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from clipper_tpu_torch import Clipper, EuclideanDistance
from clipper_tpu_torch.solvers import msrc
from clipper_tpu_torch.types import Params
from clipper_tpu_torch.utils import profiling

SPANS = ("facade.score", "facade.solve", "pga", "pga.outer", "pga.inner",
         "pga.line_search", "facade.round")
# each span's parent, as the facade and the loop nest them
PARENT = {"facade.score": None, "facade.solve": None, "pga": "facade.solve",
          "pga.outer": "pga", "pga.inner": "pga.outer",
          "pga.line_search": "pga.inner", "facade.round": "facade.solve"}
COUNTERS = ("pga.host_reads", "pga.linesearch_steps", "pga.inner_steps",
            "pga.outer_steps", "pga.read_wait_ns")
# (seed, dtype, maxiniters): at the default the loop backtracks and
# takes two outer passes; two inner steps a pass take many passes, with
# frozen checks among them
CASES = [(seed, dtype, maxiniters) for seed in (0, 1)
         for dtype in (torch.float32, torch.float64)
         for maxiniters in (Params().maxiniters, 2)]


def problem(seed, n=80, outliers=0.5, noise=0.02):
    """A registration of n noisy points, with a share of the associations
    drawn at random: (D1, D2, A, u0)."""
    rng = np.random.default_rng(seed)
    D1 = rng.uniform(size=(3, n))
    D2 = D1 + noise * rng.normal(size=(3, n))
    A = np.stack([np.arange(n), np.arange(n)], 1)
    bad = rng.uniform(size=n) < outliers
    A[bad, 1] = rng.integers(0, n, size=bad.sum())
    return D1, D2, A, rng.uniform(size=n)


def clipper(seed, dtype, maxiniters=Params().maxiniters):
    D1, D2, A, u0 = problem(seed)
    c = Clipper(EuclideanDistance(), Params(maxiniters=maxiniters),
                dtype=dtype, device="cpu")
    return c, (D1, D2, A), u0


@contextlib.contextmanager
def counting_reads():
    """Count every host read of a tensor's truth value."""
    seen = [0]
    real = torch.Tensor.__bool__

    def counted(self):
        seen[0] += 1
        return real(self)

    torch.Tensor.__bool__ = counted
    try:
        yield seen
    finally:
        torch.Tensor.__bool__ = real


@pytest.fixture(autouse=True)
def empty_tracer():
    profiling.reset()
    yield
    profiling.reset()


def traced_solve(seed, dtype, maxiniters):
    c, data, u0 = clipper(seed, dtype, maxiniters)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        c.score_pairwise_consistency(*data)
        soln = c.solve(u0)
    return c, soln, prof


@pytest.mark.parametrize("seed, dtype, maxiniters", CASES)
def test_spans_under_a_profiler(seed, dtype, maxiniters):
    _, _, prof = traced_solve(seed, dtype, maxiniters)
    totals = profiling.totals()
    assert set(totals["spans"]) == set(SPANS)
    events = [e for e in prof.events() if e.name in SPANS]
    assert all(e.device_type == DeviceType.CPU for e in events)
    for name in SPANS:
        assert sum(e.name == name for e in events) == \
            totals["spans"][name]["count"], name
    s = totals["spans"]
    assert s["pga.inner"]["count"] == s["pga.line_search"]["count"]
    assert s["pga.outer"]["count"] >= 1
    for name in SPANS:
        assert 0 <= s[name]["self_ms"] <= s[name]["ms"] + 1e-9, name

    spans = profiling.spans()
    request = spans[0].request
    assert request is not None
    for sp in spans:
        assert sp.request == request and sp.end_ns >= sp.start_ns
        parent = spans[sp.parent] if sp.parent >= 0 else None
        assert (parent.name if parent else None) == PARENT[sp.name], sp
        if parent:
            assert parent.start_ns <= sp.start_ns <= sp.end_ns <= \
                parent.end_ns
    # the profiler's own events nest as the tracer's do
    by_name = {n: [e for e in events if e.name == n] for n in SPANS}
    for name, parent in PARENT.items():
        for e in by_name[name] if parent else ():
            assert any(p.time_range.start <= e.time_range.start
                       and e.time_range.end <= p.time_range.end
                       for p in by_name[parent]), name


def test_each_build_opens_a_request():
    c, data, u0 = clipper(0, torch.float32)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            c.score_pairwise_consistency(*data)
            c.solve(u0)
            c.solve(u0)
    spans = profiling.spans()
    top = [sp for sp in spans if sp.parent < 0]
    assert [sp.name for sp in top] == ["facade.score", "facade.solve",
                                       "facade.solve"] * 2
    first, second = top[0].request, top[3].request
    assert first != second
    assert [sp.request for sp in top] == [first] * 3 + [second] * 3
    assert {sp.request for sp in spans} == {first, second}


def counting_operators(M, C, calls):
    """dense_operators whose products count themselves."""
    ops = msrc.dense_operators(M, C)

    def make(d):
        calls["make_mv_Md"] += 1
        mv = ops.make_mv_Md(d)

        def mv_Md(u):
            calls["mv_Md"] += 1
            return mv(u)
        return mv_Md

    return msrc.PGAOperators(mv_M=ops.mv_M, mv_C=ops.mv_C, make_mv_Md=make)


@pytest.mark.parametrize("seed, dtype, maxiniters", CASES)
def test_counters_are_the_loops_counts(seed, dtype, maxiniters):
    c, data, u0 = clipper(seed, dtype, maxiniters)
    c.score_pairwise_consistency(*data)
    M, C = c._M, c._C
    calls = {"make_mv_Md": 0, "mv_Md": 0}
    ops = counting_operators(M, C, calls)
    u0 = torch.as_tensor(u0, dtype=dtype)
    with profile(activities=[ProfilerActivity.CPU]):
        with counting_reads() as reads:
            msrc.run_pga(ops, u0, c.params)
    got = profiling.totals()
    counters, spans = got["counters"], got["spans"]
    assert set(counters) == set(COUNTERS)
    outer = calls["make_mv_Md"]
    assert counters["pga.host_reads"] == reads[0]
    assert counters["pga.outer_steps"] == outer == \
        spans["pga.outer"]["count"]
    # a pass's gradient takes one product, each trial one more
    assert counters["pga.linesearch_steps"] == calls["mv_Md"] - outer
    assert counters["pga.inner_steps"] == spans["pga.inner"]["count"]
    ls, inner = counters["pga.linesearch_steps"], counters["pga.inner_steps"]
    # one read a trial, an inner step and a pass; at most one frozen check
    # a pass
    assert ls + inner + outer <= reads[0] <= ls + inner + 2 * outer
    assert 0 <= counters["pga.read_wait_ns"] <= spans["pga"]["ms"] * 1e6


def test_counters_sum_over_solves():
    c, data, u0 = clipper(1, torch.float32)
    with profile(activities=[ProfilerActivity.CPU]):
        c.score_pairwise_consistency(*data)
        c.solve(u0)
        once = profiling.totals()["counters"]
        c.solve(u0)
    twice = profiling.totals()["counters"]
    for name in COUNTERS[:-1]:
        assert twice[name] == 2 * once[name], name


def test_nothing_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a record-function region was entered")

    monkeypatch.setattr(profiling, "_RecordFunction", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not profiling.tracing()
    c, data, u0 = clipper(0, torch.float32)
    c.score_pairwise_consistency(*data)
    c.solve(u0)
    assert profiling.totals() == {"spans": {}, "counters": {}}
    assert profiling.spans() == []


@pytest.mark.parametrize("seed, dtype, maxiniters", CASES)
def test_same_solution_and_reads_with_and_without_a_profiler(seed, dtype,
                                                              maxiniters):
    c, data, u0 = clipper(seed, dtype, maxiniters)
    c.score_pairwise_consistency(*data)
    with counting_reads() as off_reads:
        off = c.solve(u0)
    with profile(activities=[ProfilerActivity.CPU]):
        with counting_reads() as on_reads:
            on = c.solve(u0)
    assert off_reads[0] == on_reads[0] > 0
    assert profiling.totals()["counters"]["pga.host_reads"] == on_reads[0]
    for name in ("u", "score", "mask", "ifinal"):
        a, b = getattr(off, name), getattr(on, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name


# ---- the kernel route (csrc/pga_dense.cu) on the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_route_publishes_one_read_a_solve(cuda, dtype):
    D1, D2, A, u0 = problem(0)
    c = Clipper(EuclideanDistance(), Params(), dtype=dtype, device=cuda)
    with profile(activities=[ProfilerActivity.CPU]):
        c.score_pairwise_consistency(D1, D2, A)
        for _ in range(3):
            c.solve(u0)
    got = profiling.totals()
    counters, spans = got["counters"], got["spans"]
    assert set(counters) == set(COUNTERS) | {"pga.device_loops"}
    assert counters["pga.device_loops"] == counters["pga.host_reads"] == 3
    # the pga span around each launch; the loop's own spans stay on the
    # host loop
    assert spans["pga"]["count"] == 3
    assert not {"pga.outer", "pga.inner", "pga.line_search"} & set(spans)
    assert 0 <= counters["pga.read_wait_ns"] <= spans["pga"]["ms"] * 1e6


@pytest.mark.cuda
def test_kernel_route_counts_are_the_host_loops_f64(cuda):
    """In f64 the kernel takes the host loop's trials, inner steps and
    outer passes, one for one. (At two inner steps a pass the truncated
    loop is chaotic at the ulp even in f64: on the CPU the host loop's
    counts move when its sums are merely reversed, so those cases are not
    compared.)"""
    for seed in (0, 1):
        D1, D2, A, u0 = problem(seed)
        c = Clipper(EuclideanDistance(), Params(), dtype=torch.float64,
                    device=cuda)
        c.score_pairwise_consistency(D1, D2, A)
        u0 = torch.as_tensor(u0, dtype=torch.float64, device=cuda)
        counts = []
        for run in (lambda: msrc.find_dense_clique(c._M, c._C, u0, c.params),
                    lambda: msrc.run_pga(msrc.dense_operators(c._M, c._C),
                                         u0, c.params)):
            profiling.reset()
            with profile(activities=[ProfilerActivity.CPU]):
                run()
            counters = profiling.totals()["counters"]
            counts.append([counters[n] for n in COUNTERS[1:4]])
        assert counts[0] == counts[1] and counts[0][0] > 0, seed
