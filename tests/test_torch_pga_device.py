"""The dense PGA loop as one persistent kernel (csrc/pga_dense.cu) against
the host loop (solvers/msrc.run_pga over dense_operators) on the same
CUDA tensors, and the dispatch between the two on the CPU.

This file imports no JAX, so on a machine with a card it runs without
the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_pga_device.py

Tests marked ``cuda`` skip where torch.cuda.is_available() is false.
"""

import dataclasses
import functools
import json
import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from clipper_tpu_torch import Clipper, _kernels
from clipper_tpu_torch.bench import harness
from clipper_tpu_torch.solvers import msrc
from clipper_tpu_torch.types import Params
from clipper_tpu_torch.utils import profiling

# (m, seed): eight problems at the benchmark's m and four at an m that is
# a multiple of no tile
PROBLEMS = [(2048, s) for s in range(8)] + [(300, s) for s in range(8, 12)]
# the JAX package's f64 solve of each problem on the CPU (ifinal, F, the
# mask's indices), written and checked by tests/test_torch_pga_jax.py
JAX_WITNESS = os.path.join(os.path.dirname(__file__), "data",
                           "pga_dense_jax.json")
# edge parameters, on one small problem: the benchmark's planted faults
# (maxiniters=0 with maxoliters=1; maxiniters=1), each alone, and the
# rest of Params' switches
EDGES = {
    "state": dict(maxiniters=0, maxoliters=1),
    "maxiniters0": dict(maxiniters=0),
    "maxoliters1": dict(maxoliters=1),
    "truncate": dict(maxiniters=1),
    "maxoliters0": dict(maxoliters=0),
    "maxlsiters1": dict(maxlsiters=1),
    "no_rescale": dict(rescale_u0=False),
    "beta": dict(beta=0.5, tol_u=1e-6, tol_F=1e-7),
}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _bunny():
    return harness.load_bunny()


@functools.lru_cache(maxsize=None)
def problem(m, seed):
    """One bunny problem at rho = 0.9 and its u0, made with numpy:
    (D1 (3, n), D2 (3, n), A (m, 2), u0 (m,))."""
    rng = np.random.default_rng(seed)
    pcd0 = _bunny()
    pcd1, A, _ = harness.make_problem(pcd0, m, 0.9, rng)
    return pcd0.T, pcd1.T, A, rng.uniform(size=m)


def matrices(m, seed, dtype):
    """(M, C, u0) of a problem on the card in dtype."""
    D1, D2, A, u0 = problem(m, seed)
    c = Clipper(harness.default_invariant(), Params(), dtype=dtype,
                device="cuda")
    c.score_pairwise_consistency(D1, D2, A)
    return c._M, c._C, torch.as_tensor(u0, dtype=dtype, device="cuda")


def traced(fn):
    """fn()'s result and the loop's published (trials, inner steps, outer
    passes, host reads, device loops)."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    c = profiling.totals()["counters"]
    profiling.reset()
    return out, (c["pga.linesearch_steps"], c["pga.inner_steps"],
                 c["pga.outer_steps"], c["pga.host_reads"],
                 c.get("pga.device_loops", 0))


def both(M, C, u0, params, fuse_md=True):
    """(kernel's (u, F, ifinal), its counts), the host loop's likewise."""
    launches = _kernels.LAUNCHES["pga_dense"]
    dev = traced(lambda: msrc.find_dense_clique(M, C, u0, params,
                                                fuse_md=fuse_md))
    assert _kernels.LAUNCHES["pga_dense"] == launches + 1
    host = traced(lambda: msrc.run_pga(msrc.dense_operators(M, C, fuse_md),
                                       u0, params, dtype=M.dtype))
    assert dev[1][3:] == (1, 1) and host[1][4] == 0
    return dev, host


def same_run(a, b):
    """f64: the same ifinal, mask and trial, inner and outer counts, u
    within 1e-10 and F within 1e-10 relative."""
    (u, F, i), counts = a
    (ub, Fb, ib), counts_b = b
    return (u.dtype == ub.dtype and i.dtype == ib.dtype == torch.int32
            and int(i) == int(ib) and counts[:3] == counts_b[:3]
            and torch.equal(msrc.round_solution(u, F),
                            msrc.round_solution(ub, Fb))
            and float((u - ub).abs().max()) <= 1e-10
            and abs(float(F) - float(Fb)) <= 1e-10 * max(1.0, abs(float(Fb))))


def assert_same_run(dev, host):
    (u, _, i), counts = dev
    (uh, _, ih), counts_h = host
    assert (int(i), counts[:3]) == (int(ih), counts_h[:3])
    assert float((u - uh).abs().max()) <= 1e-10
    assert same_run(dev, host)


def reversed_operators(M, C):
    """dense_operators with each product summed in reverse column order:
    the host loop with its sums in another order."""
    def mv(A):
        return lambda u: (A * u).flip(-1).sum(-1)

    def make(d):
        return mv(M + d * C)

    return msrc.PGAOperators(mv_M=mv(M), mv_C=mv(C), make_mv_Md=make)


def check_f64(M, C, u0):
    """f64: the host loop's ifinal, mask and trial, inner and outer counts,
    u within 1e-10. Where the host loop's own run moves when its sums are
    merely reversed (one m=2048 problem of the eight: 40 trials with
    cuBLAS's sums, 38 reversed, 37 in the kernel, u some 5e-8 apart; on
    the CPU MKL's 40, reversed or blocked 37: a backtracking test decided
    at the rounding), the kernel's run keeps the host loop's ifinal, mask,
    inner steps and outer passes and F within 1e-10, and its u and trial
    count lie no farther from the host loop's than twice as far as the
    reversed host loop's."""
    dev, host = both(M, C, u0, Params())
    assert msrc.round_solution(*dev[0][:2]).sum() > 0
    if same_run(dev, host):
        return
    rev = traced(lambda: msrc.run_pga(reversed_operators(M, C), u0,
                                      Params(), dtype=M.dtype))
    assert not same_run(rev, host)
    (u, F, i), counts = dev
    (uh, Fh, ih), counts_h = host
    (ur, _, _), counts_r = rev
    assert int(i) == int(ih) and counts[1:3] == counts_h[1:3]
    assert torch.equal(msrc.round_solution(u, F),
                       msrc.round_solution(uh, Fh))
    assert abs(float(F) - float(Fh)) <= 1e-10 * abs(float(Fh))
    assert float((u - uh).abs().max()) <= 2 * float((ur - uh).abs().max())
    assert abs(counts[0] - counts_h[0]) <= 2 * abs(counts_r[0] - counts_h[0])


def ranks(u):
    """Each vertex's place in round_solution's stable descending order."""
    order = torch.argsort(-u, stable=True)
    return torch.empty_like(order).scatter_(
        0, order, torch.arange(u.numel(), device=u.device))


def check_f32(M, C, u0):
    """f32: the kernel's sums run in another order than cuBLAS's, so F
    within 1e-4 of the host loop's, not bit for bit, and the same mask
    wherever the host loop's own mask holds when its sums are reversed.
    Where it does not (on the H100 one m=2048 problem of the eight, whose
    omega-th and next largest u lie 3e-5 apart), the kernel's mask may
    differ from the host loop's by no more vertices than the reversal
    moves, each that close to the rounding's boundary in the host loop's
    ranking."""
    ((u, F, _), _), ((uh, Fh, _), _) = both(M, C, u0, Params())
    assert u.dtype == torch.float32
    assert abs(float(F) - float(Fh)) <= 1e-4 * float(Fh)
    mask, mask_h = msrc.round_solution(u, F), msrc.round_solution(uh, Fh)
    if torch.equal(mask, mask_h):
        return
    ur, Fr, _ = msrc.run_pga(reversed_operators(M, C), u0, Params(),
                             dtype=M.dtype)
    moved = int((msrc.round_solution(ur, Fr) ^ mask_h).sum())
    diff = torch.nonzero(mask ^ mask_h).flatten()
    assert 0 < diff.numel() <= moved
    omega = int(torch.floor(Fh + 0.5))
    assert int((ranks(uh)[diff] - omega).abs().max()) <= moved


@pytest.mark.cuda
@pytest.mark.parametrize("m, seed", PROBLEMS)
def test_f64_matches_host_loop(cuda, m, seed):
    check_f64(*matrices(m, seed, torch.float64))


def jax_distance(out, w):
    """(vertices, ifinal, F relative) between a solve and the JAX
    package's (a JAX_WITNESS entry)."""
    u, F, i = out
    mask = msrc.round_solution(u, F).cpu().numpy()
    jmask = np.zeros(mask.size, dtype=bool)
    jmask[w["mask"]] = True
    return (int((mask ^ jmask).sum()), abs(int(i) - w["ifinal"]),
            abs(float(F) - w["F"]) / abs(w["F"]))


@pytest.mark.cuda
@pytest.mark.parametrize("m, seed", PROBLEMS)
def test_f64_matches_jax(cuda, m, seed):
    """The JAX package's f64 solve of the same points and u0 on the CPU
    (JAX_WITNESS) as an independent witness: the kernel's mask and ifinal
    are JAX's and its F within 1e-9 of JAX's (M and C are built on the
    card here, by JAX there); where the kernel's run and the host loop's
    differ (the order-sensitive problem), the kernel lies no farther from
    JAX in mask, ifinal and F than the host loop does."""
    with open(JAX_WITNESS) as f:
        w = json.load(f)[f"{m}/{seed}"]
    dev, host = both(*matrices(m, seed, torch.float64), Params())
    d_dev = jax_distance(dev[0], w)
    if d_dev[:2] == (0, 0) and d_dev[2] <= 1e-9:
        return
    assert not same_run(dev, host)
    d_host = jax_distance(host[0], w)
    assert all(a <= b for a, b in zip(d_dev, d_host))


@pytest.mark.cuda
@pytest.mark.parametrize("m, seed", PROBLEMS)
def test_f32_matches_host_loop(cuda, m, seed):
    check_f32(*matrices(m, seed, torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_past_8192_through_the_dense_engine(cuda, dtype):
    """m = 8500 through Clipper(engine="dense"): the vector a matrix pass
    stages takes two chunks in f32 and three in f64, and a block's 64 or
    65 rows go in four or five groups of 16. f64 is held as at m=2048. In
    f32 a solve this large is chaotic at the ulp: on the H100 the host
    loop over cuBLAS's sums, over reversed sums and on the CPU end 1.1e-3
    apart in F, 3 vertices apart in the mask, with other ifinals, on
    three problems of three; so the kernel's F is held within 2e-3 of the
    host loop's and its mask to an IoU of 0.99."""
    D1, D2, A, u0 = problem(8500, 12)
    c = Clipper(harness.default_invariant(), Params(), dtype=dtype,
                engine="dense", device="cuda")
    c.score_pairwise_consistency(D1, D2, A)
    M, C = c._M, c._C
    u0 = torch.as_tensor(u0, dtype=dtype, device="cuda")
    if dtype == torch.float64:
        check_f64(M, C, u0)
    else:
        ((u, F, _), _), ((uh, Fh, _), _) = both(M, C, u0, Params())
        assert abs(float(F) - float(Fh)) <= 2e-3 * float(Fh)
        mask, mask_h = (msrc.round_solution(u, F),
                        msrc.round_solution(uh, Fh))
        assert int((mask & mask_h).sum()) >= 0.99 * int((mask | mask_h).sum())
    launches = _kernels.LAUNCHES["pga_dense"]
    assert torch.equal(c.solve(u0).mask,
                       msrc.solve_msrc(M, C, u0, c.params).mask)
    assert _kernels.LAUNCHES["pga_dense"] == launches + 2


@pytest.mark.cuda
@pytest.mark.parametrize("fuse_md", [True, False])
@pytest.mark.parametrize("edge", sorted(EDGES))
def test_edge_parameters(cuda, edge, fuse_md):
    M, C, u0 = matrices(300, 8, torch.float64)
    dev, host = both(M, C, u0, Params(**EDGES[edge]), fuse_md=fuse_md)
    assert_same_run(dev, host)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_unfused_matches_host_loop(cuda, dtype):
    M, C, u0 = matrices(2048, 0, dtype)
    dev, host = both(M, C, u0, Params(), fuse_md=False)
    if dtype == torch.float64:
        assert_same_run(dev, host)
    (u, F, _), _ = dev
    (uh, Fh, _), _ = host
    assert torch.equal(msrc.round_solution(u, F),
                       msrc.round_solution(uh, Fh))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stall_guard_stop(cuda, dtype):
    """With no line-search trial no step moves u, so every pass is frozen:
    f32's stall guard stops the third pass, f64 (no guard) runs to
    maxoliters."""
    M, C, u0 = matrices(300, 9, dtype)
    dev, host = both(M, C, u0, Params(maxlsiters=0, maxoliters=20))
    if dtype == torch.float64:
        assert_same_run(dev, host)
    outer = msrc._STALL_OUTERS if dtype == torch.float32 else 20
    assert dev[1][:3] == host[1][:3] == (0, outer, outer)
    assert int(dev[0][2]) == int(host[0][2]) == outer


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_two_launches_are_bit_equal(cuda, dtype):
    M, C, u0 = matrices(2048, 1, dtype)
    a = msrc.find_dense_clique(M, C, u0, Params())
    b = msrc.find_dense_clique(M, C, u0, Params())
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_one_launch_a_solve(cuda):
    M, C, u0 = matrices(2048, 2, torch.float32)
    before = dict(_kernels.LAUNCHES)
    for _ in range(3):
        msrc.solve_msrc(M, C, u0, Params())
    after = _kernels.LAUNCHES
    assert after["pga_dense"] == before["pga_dense"] + 3
    assert {k for k in after if after[k] != before[k]} == {"pga_dense"}


@pytest.mark.cuda
def test_no_synchronisation_in_solve(cuda):
    M, C, u0 = matrices(2048, 3, torch.float32)
    msrc.solve_msrc(M, C, u0, Params())        # the library and its grid
    torch.cuda.synchronize()
    assert not profiling.tracing()
    torch.cuda.set_sync_debug_mode("error")
    try:
        soln = msrc.solve_msrc(M, C, u0, Params())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert soln.mask.sum() > 0


@pytest.mark.cuda
def test_the_facade_takes_the_kernel(cuda):
    """Clipper's dense engine solves through the kernel: one launch a
    solve, the mask of the host loop in f64."""
    D1, D2, A, u0 = problem(300, 10)
    c = Clipper(harness.default_invariant(), Params(), dtype=torch.float64,
                device="cuda")
    c.score_pairwise_consistency(D1, D2, A)
    launches = _kernels.LAUNCHES["pga_dense"]
    soln = c.solve(u0)
    assert _kernels.LAUNCHES["pga_dense"] == launches + 1
    uh, Fh, ih = msrc.run_pga(msrc.dense_operators(c._M, c._C),
                              soln.u0, c.params, dtype=torch.float64)
    assert torch.equal(soln.mask, msrc.round_solution(uh, Fh))
    assert int(soln.ifinal) == int(ih)


# ---- the dispatch and the kernel's arguments, on the CPU ----

CPU_CASES = [(torch.float32, Params()), (torch.float64, Params()),
             (torch.float32, Params(maxiniters=3, rescale_u0=False)),
             (torch.float64, Params(maxlsiters=2, beta=0.5))]


def _graph(m=40, seed=0, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    W = np.triu(rng.uniform(size=(m, m)), 1)
    W = np.where(np.triu(rng.uniform(size=(m, m)) < 0.4, 1), W, 0.0)
    M = W + W.T
    return (torch.as_tensor(M, dtype=dtype),
            torch.as_tensor((M > 0).astype(np.float64), dtype=dtype),
            torch.as_tensor(rng.uniform(size=m), dtype=dtype))


def _refuse(*args, **kwargs):
    raise AssertionError("the kernel's wrapper was reached")


@pytest.mark.parametrize("fuse_md", [True, False])
@pytest.mark.parametrize("dtype, params", CPU_CASES)
def test_cpu_takes_the_host_loop(dtype, params, fuse_md, monkeypatch):
    """CPU tensors keep the host loop, bit for bit."""
    monkeypatch.setattr(msrc, "pga_dense_cuda", _refuse)
    M, C, u0 = _graph(dtype=dtype)
    assert not msrc.takes_kernel(M, C, u0)
    got = msrc.find_dense_clique(M, C, u0, params, fuse_md=fuse_md)
    want = msrc.run_pga(msrc.dense_operators(M, C, fuse_md), u0, params,
                        dtype=dtype)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_other_operators_keep_the_host_loop(monkeypatch):
    """run_pga over operators of its own (here a counting wrapper of the
    dense ones) never reaches the kernel's wrapper."""
    monkeypatch.setattr(msrc, "pga_dense_cuda", _refuse)
    M, C, u0 = _graph(seed=1)
    dense = msrc.dense_operators(M, C)
    calls = []
    ops = msrc.PGAOperators(mv_M=lambda u: calls.append(1) or dense.mv_M(u),
                            mv_C=dense.mv_C, make_mv_Md=dense.make_mv_Md)
    msrc.run_pga(ops, u0, Params())
    assert calls


def test_sharded_engine_keeps_the_host_loop(monkeypatch):
    """The 2D engine's nested solver (one rank, no group) runs run_pga over
    its own operators: the host loop."""
    from clipper_tpu_torch.parallel import sharded
    monkeypatch.setattr(msrc, "pga_dense_cuda", _refuse)
    reached = []
    real = msrc.run_pga

    def spy(ops, *args, **kwargs):
        reached.append(ops)
        return real(ops, *args, **kwargs)

    monkeypatch.setattr(msrc, "run_pga", spy)
    rng = np.random.default_rng(5)
    D1 = rng.uniform(size=(60, 3))
    D2 = D1 + 0.01 * rng.normal(size=D1.shape)
    A = np.stack([np.arange(60), np.arange(60)], 1)
    A[::3, 1] = rng.integers(0, 60, size=20)
    sol = sharded.solve_sharded(harness.default_invariant(), D1, D2, A,
                                rng.uniform(size=60), Params(),
                                solver="nested", device="cpu")
    assert len(reached) == 1 and sol.mask.sum() > 0


def _fake(dtype, is_cuda=True, m=8):
    return types.SimpleNamespace(is_cuda=is_cuda, dtype=dtype, shape=(m, m))


@pytest.mark.parametrize("dtypes, cuda_flags, kernel", [
    ((torch.float32,) * 3, (True,) * 3, True),
    ((torch.float64,) * 3, (True,) * 3, True),
    ((torch.float16,) * 3, (True,) * 3, False),
    ((torch.bfloat16,) * 3, (True,) * 3, False),
    ((torch.float32, torch.float64, torch.float32), (True,) * 3, False),
    ((torch.float64,) * 3, (True, True, False), False),
    ((torch.float32,) * 3, (False, True, True), False),
])
def test_dispatch_by_device_and_dtype(dtypes, cuda_flags, kernel,
                                      monkeypatch):
    """find_dense_clique launches the kernel for M, C and u0 on the card in
    f32 or f64 (u0 is cast to M's dtype), else runs the host loop."""
    route = []
    monkeypatch.setattr(msrc, "pga_dense_cuda",
                        lambda *a, **k: route.append("kernel"))
    monkeypatch.setattr(msrc, "run_pga",
                        lambda *a, **k: route.append("host"))
    monkeypatch.setattr(msrc, "dense_operators", lambda *a, **k: None)
    M, C, u0 = (_fake(d, f) for d, f in zip(dtypes, cuda_flags))
    msrc.find_dense_clique(M, C, u0, Params())
    assert route == ["kernel" if kernel else "host"]
    assert msrc.takes_kernel(M, C, u0) == kernel
    assert not msrc.takes_kernel(_fake(torch.float32, m=0),
                                 _fake(torch.float32, m=0),
                                 _fake(torch.float32, m=0))


def test_the_planted_faults_reach_the_kernel_route(monkeypatch):
    """benchmark/faults.py swaps msrc.find_dense_clique: the dispatch
    lives inside it, so solve_msrc hands the fault's Params to the
    kernel's route."""
    seen = []
    monkeypatch.setattr(msrc, "takes_kernel", lambda *a: True)
    monkeypatch.setattr(msrc, "pga_dense_cuda",
                        lambda M, C, u0, params, **k: seen.append(params)
                        or (u0, torch.zeros((), dtype=u0.dtype),
                            torch.zeros((), dtype=torch.int32)))
    from benchmark import faults
    M, C, u0 = _graph(seed=2, dtype=torch.float32)
    for name, want in (("state", dict(maxiniters=0, maxoliters=1)),
                       ("truncate", dict(maxiniters=1))):
        with faults.plant(name):
            msrc.solve_msrc(M, C, u0, Params())
        assert seen.pop() == dataclasses.replace(Params(), **want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("params", [
    Params(), Params(eps=1e-7, tol_u=1e-3, tol_F=1e-12, beta=0.3),
    Params(tol_u=1e-20, maxoliters=5, maxiniters=0, maxlsiters=0,
           rescale_u0=False)])
def test_kernel_arguments_are_the_host_loops(dtype, params):
    """The packed scalars are the values _run_pga compares, in dtype."""
    a = msrc.pga_dense_args(params, dtype)
    as_t = functools.partial(torch.tensor, dtype=dtype)
    assert a.floor_eps == msrc._floor(msrc._EPS_FACTOR, dtype)
    assert a.floor_act == msrc._floor(msrc._ACTIVITY_FACTOR, dtype)
    assert a.tol_u == float(msrc._eps_like(params.tol_u, 1.0, dtype))
    for name in ("beta", "eps", "tol_F"):
        assert getattr(a, name) == float(as_t(getattr(params, name))), name
    # each is exact in dtype
    for name in ("beta", "eps", "tol_u", "tol_F", "floor_eps", "floor_act"):
        assert float(as_t(getattr(a, name))) == getattr(a, name), name
    # the thresholds the kernel forms from them are the host loop's
    for scale in (0.0, 1e-3, 1.0, 37.5, 1e6):
        s = as_t(scale)
        assert torch.equal(torch.maximum(as_t(a.eps), a.floor_eps * s),
                           msrc._eps_like(params.eps, s, dtype))
        assert torch.equal(torch.maximum(as_t(a.eps), a.floor_act * s),
                           msrc._eps_active(params.eps, s, dtype))
        assert torch.equal(torch.maximum(as_t(a.tol_F), a.floor_eps * s),
                           msrc._eps_like(params.tol_F, s, dtype))
    assert (a.maxoliters, a.maxiniters, a.maxlsiters) == (
        params.maxoliters, params.maxiniters, params.maxlsiters)
    assert a.rescale_u0 == int(params.rescale_u0)
    assert a.stall_outers == (0 if dtype == torch.float64
                              else msrc._STALL_OUTERS)


def test_wrapper_rejects_cpu_tensors():
    M, C, u0 = _graph()
    with pytest.raises(ValueError, match="on the card"):
        msrc.pga_dense_cuda(M, C, u0)


def test_the_source_is_built_with_its_entries():
    assert _kernels.SOURCES["pga_dense"] == ["--fmad=false"]
    assert "pga_dense" in _kernels.LAUNCHES
    src = (_kernels.CSRC / "pga_dense.cu").read_text()
    for entry in ("pga_dense_f32", "pga_dense_f64", "pga_dense_grid"):
        assert f"int {entry}(" in src and entry in _kernels._SIGNATURES
    assert len(_kernels._SIGNATURES["pga_dense_f32"]) == src.split(
        "int pga_dense_f32(")[1].split(")")[0].count(",") + 1
    assert '#include "' not in src          # no header of its own
