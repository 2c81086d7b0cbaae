"""Port parity: the stacked pool layout, its multistart pipeline and polish.

Mirrors tests/test_pool.py (:30-192, :319-430) where it uses the stacked
layout: clipper_tpu.parallel.pool against clipper_tpu_torch.parallel.pool
(device="cpu": the plain versions) on the same numpy inputs.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clipper_tpu as ct
from clipper_tpu.bench import harness as jharness
from clipper_tpu.parallel import pool as jpool
from clipper_tpu.solvers import msrc_flat as jmsrc_flat
from clipper_tpu_torch import EuclideanDistance, EuclideanDistanceParams
from clipper_tpu_torch.bench import data, harness
from clipper_tpu_torch.parallel import pool
from clipper_tpu_torch.solvers import msrc_flat
from clipper_tpu_torch.types import Params, Rounding

from test_msrc_flat import random_graph

INV_J = ct.EuclideanDistance(ct.EuclideanDistanceParams(sigma=0.015,
                                                        epsilon=0.05))
INV_T = EuclideanDistance(EuclideanDistanceParams(sigma=0.015, epsilon=0.05))


def _graphs(rng, W, m=24, density=0.35):
    Ms, Cs, u0s = [], [], []
    for _ in range(W):
        M, C = random_graph(rng, m=m, density=density)
        Ms.append(M)
        Cs.append(C)
        u0s.append(rng.uniform(size=m))
    return np.stack(Ms), np.stack(Cs), np.stack(u0s)


def _inits(MCs, u0s):
    bmv = msrc_flat.make_stacked_pool_matvec(MCs, u0s.dtype)
    return msrc_flat.flat_init_batched(bmv, None, u0s, Params())


@pytest.mark.parametrize("W,lanes,window", [(7, 3, 4), (8, 8, 2),
                                            (5, 8, 4), (12, 4, 1)])
def test_solve_pool_matches_jax_f64(W, lanes, window):
    """Any (W, lanes, window) split gives JAX's ifinal exactly and its u
    and F within 1e-12 (f64, the same storage and u0)."""
    Ms, Cs, u0s = _graphs(np.random.default_rng(42 + W), W)
    MCs = np.concatenate([Ms, Cs], axis=1)
    jinits = jax.vmap(lambda M, C, u0: jmsrc_flat.flat_init(
        jmsrc_flat.stacked_dual_matvec(M, C), u0, ct.Params()))(
        jnp.asarray(Ms), jnp.asarray(Cs), jnp.asarray(u0s))
    ju, jF, ji = jax.jit(lambda a, b: jpool.solve_pool(
        a, b, ct.Params(), lanes=lanes, window=window))(jnp.asarray(MCs),
                                                        jinits)
    MCt = torch.from_numpy(MCs)
    stats = {}
    u, F, i, nwin = pool.solve_pool(MCt, _inits(MCt, torch.from_numpy(u0s)),
                                    lanes=lanes, window=window,
                                    return_windows=True, stats=stats)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=1e-12)
    np.testing.assert_allclose(F.numpy(), np.asarray(jF), rtol=0, atol=1e-12)
    assert stats["windows"] == nwin >= 1
    assert stats["ticks"].shape == (W,) and bool((stats["ticks"] > 0).all())


def test_problem_of_shares_storage_and_its_contract():
    """Restarts mapped onto shared storage through problem_of run exactly
    as over duplicated storage; W inits over P != W matrices without a
    mapping raise (test_pool.py:319)."""
    Ms, Cs, _ = _graphs(np.random.default_rng(5), 3)
    MCs = torch.from_numpy(np.concatenate([Ms, Cs], axis=1))
    K = 2
    u0s = torch.from_numpy(np.random.default_rng(6).uniform(size=(3 * K, 24)))
    problem_of = torch.arange(3).repeat_interleave(K)
    dup = MCs.repeat_interleave(K, dim=0)
    a = pool.solve_pool(MCs, _inits(dup, u0s), lanes=4, window=2,
                        problem_of=problem_of)
    b = pool.solve_pool(dup, _inits(dup, u0s), lanes=4, window=2)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    with pytest.raises(ValueError, match="problem_of"):
        pool.solve_pool(MCs, _inits(dup, u0s), lanes=2, window=2)


@pytest.fixture(scope="module")
def bunny():
    """W=8 bunny problems at m=200 (not a multiple of 128: the stacked
    layout's own case), 90% outliers."""
    pcd0 = harness.load_bunny()
    rng = np.random.default_rng(31)
    probs = [harness.make_problem(pcd0, 200, 0.9, rng) for _ in range(8)]
    D2s = np.stack([p[0] for p in probs])
    As = np.stack([p[1] for p in probs]).astype(np.int32)
    u0 = np.random.default_rng(32).random((8, 200))
    return pcd0, D2s, As, [p[2] for p in probs], u0


ENGINE = dict(layout="stacked", lanes=4, window=12, power_steps=4)


def _pr(As, masks, Agts):
    pr = np.array([data.get_precision_recall(As[b][masks[b]], Agts[b])
                   for b in range(len(Agts))])
    return pr.mean(0)


@pytest.mark.parametrize("storage", ["int8", "bfloat16"])
def test_stacked_pipeline_matches_jax(bunny, storage):
    """Quantized stacked storage: masks equal on all but at most one of 8
    problems (the plain matvecs sum exact products in another f32 order),
    mean P/R within 1 point."""
    pcd0, D2s, As, Agts, u0 = bunny
    f32 = np.float32
    sj = jpool.make_pool_pipeline(
        jharness.default_invariant(), ct.Params(),
        storage_dtype=getattr(jnp, storage), **ENGINE)(
        jnp.asarray(pcd0, f32), jnp.asarray(D2s, f32), jnp.asarray(As),
        jnp.asarray(u0, f32))
    timings, stats = {}, {}
    st = pool.make_pool_pipeline(
        harness.default_invariant(), Params(),
        storage_dtype=getattr(torch, storage), device="cpu", **ENGINE)(
        pcd0.astype(f32), D2s.astype(f32), As, u0.astype(f32),
        timings=timings, stats=stats)
    assert set(timings) == {"build", "init", "solve", "polish"}
    assert stats["windows"] >= 1
    mj, mt = np.asarray(sj.mask), st.mask.numpy()
    assert mt.shape == (8, 200) and st.u.dtype == torch.float32
    assert (mj == mt).all(1).sum() >= 7
    pj, rj = _pr(As, mj, Agts)
    pt, rt = _pr(As, mt, Agts)
    assert abs(pj - pt) <= 0.01 and abs(rj - rt) <= 0.01
    assert pt > 0.97 and rt > 0.8


def test_stacked_pipeline_f64_full_precision_matches_jax_exactly(bunny):
    """storage_dtype=None in f64 (the full-precision plain build): the
    same ifinal and masks, F within 1e-9."""
    pcd0, D2s, As, _, u0 = bunny
    sj = jpool.make_pool_pipeline(jharness.default_invariant(), ct.Params(),
                                  storage_dtype=None, **ENGINE)(
        jnp.asarray(pcd0), jnp.asarray(D2s), jnp.asarray(As),
        jnp.asarray(u0))
    st = pool.make_pool_pipeline(harness.default_invariant(), Params(),
                                 storage_dtype=None, device="cpu",
                                 **ENGINE)(pcd0, D2s, As, u0)
    np.testing.assert_array_equal(st.ifinal.numpy(), np.asarray(sj.ifinal))
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    np.testing.assert_allclose(st.score.numpy(), np.asarray(sj.score),
                               rtol=0, atol=1e-9)


def _registration(rng, W, n=60, ni=20, m=128, K=None, noise=0.003):
    D1 = rng.uniform(size=(n, 3))
    D2s, As = [], []
    for _ in range(W):
        th = rng.uniform(0, np.pi)
        R = np.array([[np.cos(th), -np.sin(th), 0],
                      [np.sin(th), np.cos(th), 0], [0, 0, 1]])
        D2s.append(D1 @ R.T + rng.normal(0, noise, size=(n, 3)))
        A = np.zeros((m, 2), dtype=np.int32)
        A[:ni, 0] = A[:ni, 1] = np.arange(ni)
        A[ni:, 0] = rng.integers(0, n, m - ni)
        A[ni:, 1] = rng.integers(0, n, m - ni)
        As.append(A)
    shape = (W, m) if K is None else (W, K, m)
    return D1, np.stack(D2s), np.stack(As), rng.uniform(size=shape)


def _rotation(rng):
    th = rng.uniform(0, np.pi)
    return np.array([[np.cos(th), -np.sin(th), 0],
                     [np.sin(th), np.cos(th), 0], [0, 0, 1]])


def _two_cliques(rng, W, K, n=60, m=128, big=20, small=12):
    """Scenes with two consistent sets: associations 0..big-1 follow one
    rigid motion, big..big+small-1 another; the rest are random. Restart
    w % K of problem w starts on the big set, the others on the small one,
    so each problem has one clear best restart (no near-tie for ulps to
    break)."""
    D1 = rng.uniform(size=(n, 3))
    D2s, As, u0s = [], [], []
    for w in range(W):
        D2 = D1 @ _rotation(rng).T
        D2[40:] = D1[40:] @ _rotation(rng).T + rng.uniform(size=3)
        D2s.append(D2 + rng.normal(0, 0.002, size=(n, 3)))
        A = np.zeros((m, 2), dtype=np.int32)
        A[:big, 0] = A[:big, 1] = np.arange(big)
        A[big:big + small, 0] = A[big:big + small, 1] = 40 + np.arange(small)
        rest = m - big - small
        A[big + small:] = rng.integers(0, n, (rest, 2))
        As.append(A)
        u0 = rng.uniform(0, 0.05, size=(K, m))
        for k in range(K):
            on = (np.arange(big) if k == w % K
                  else big + np.arange(small))
            u0[k, on] += 1.0
        u0s.append(u0)
    return D1, np.stack(D2s), np.stack(As), np.stack(u0s)


@pytest.mark.parametrize("dtype,storage,support", [
    ("float64", None, 256), ("float32", "int8", 256),
    ("float32", "bfloat16", 16)])
def test_multistart_matches_jax(dtype, storage, support):
    """Best-of-K over shared storage: the same best restart (ifinal) and
    masks as the JAX package. support=16 is narrower than the 20-wide
    clique, so the exact row-chunked polish picks the winner."""
    W, K = 4, 3
    D1, D2s, As, u0s = _two_cliques(np.random.default_rng(21), W, K)
    args = [D1.astype(dtype), D2s.astype(dtype), As, u0s.astype(dtype)]
    opts = dict(restarts=K, lanes=5, window=4, support=support)
    sj = jpool.make_pool_multistart_pipeline(
        INV_J, ct.Params(), build="xla",
        storage_dtype=None if storage is None else getattr(jnp, storage),
        **opts)(*[jnp.asarray(a) for a in args])
    st = pool.make_pool_multistart_pipeline(
        INV_T, Params(), device="cpu",
        storage_dtype=None if storage is None else getattr(torch, storage),
        **opts)(*args)
    assert st.mask.shape == (W, 128) and st.u0.shape == (W, 128)
    np.testing.assert_array_equal(st.ifinal.numpy(), np.arange(W) % K)
    np.testing.assert_array_equal(st.ifinal.numpy(), np.asarray(sj.ifinal))
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    # f64 full precision follows JAX's trajectory; reduced storage sums
    # exact products in another f32 order, so the lanes stop at other
    # points on the same clique: F then agrees within the 0.5 margin that
    # omega = round(F) needs
    tol = 1e-9 if storage is None else 0.5
    np.testing.assert_allclose(st.score.numpy(), np.asarray(sj.score),
                               rtol=0, atol=tol)
    for w in range(W):           # the winner's u0 is its restart's
        np.testing.assert_array_equal(st.u0[w].numpy(),
                                      args[3][w, int(st.ifinal[w])])


def test_multistart_beats_single_start():
    """test_pool.py:153: best-of-K scores at least restart 0's single-start
    solve, and keeps the inlier clique."""
    W, K, ni = 4, 3, 20
    D1, D2s, As, u0s = _registration(np.random.default_rng(22), W, K=K)
    args = (D1.astype(np.float32), D2s.astype(np.float32), As,
            u0s.astype(np.float32))
    best = pool.make_pool_multistart_pipeline(
        INV_T, Params(), restarts=K, lanes=5, window=4, device="cpu")(*args)
    single = pool.make_pool_pipeline(
        INV_T, Params(), layout="stacked", storage_dtype=torch.bfloat16,
        lanes=5, window=4, device="cpu")(*args[:3], args[3][:, 0])
    for w in range(W):
        assert float(best.score[w]) >= float(single.score[w]) - 1e-4
        sel = set(np.flatnonzero(best.mask[w].numpy()))
        assert len(sel & set(range(ni))) >= ni - 4, (w, sel)
    with pytest.raises(ValueError, match="u0s must be"):
        pool.make_pool_multistart_pipeline(INV_T, restarts=2,
                                           device="cpu")(*args)


def test_support_polish_matches_jax():
    """support_polish (top-k) against the JAX package on the same
    sparse nonnegative u, f64: within 1e-10; with k >= the support it
    equals the full rebuild."""
    rng = np.random.default_rng(31)
    D1, D2s, As, _ = _registration(rng, 3)
    for b in range(3):
        u = rng.random(128)
        u[u < 0.8] = 0.0
        jargs = [jnp.asarray(x) for x in (D1, D2s[b], As[b], u)]
        targs = [torch.from_numpy(x) for x in (D1, D2s[b], As[b], u)]
        for k in (16, 128):
            ref = float(jpool.support_polish(INV_J, *jargs, k=k))
            got = float(pool.support_polish(INV_T, *targs, k=k))
            assert abs(got - ref) <= 1e-10, (b, k, got, ref)
        P1 = torch.from_numpy(D1[As[b, :, 0]])[None]
        P2 = torch.from_numpy(D2s[b][As[b, :, 1]])[None]
        A = torch.from_numpy(As[b])[None]
        ut = targs[3][None]
        full = pool._polish_batch(INV_T, P1, P2, A, ut, None, 1e-4)
        assert abs(float(full[0]) - got) <= 1e-10


def test_support_overflow_matches_jax():
    """test_pool.py:378: a 60-wide clique past support=16 takes the exact
    row-chunked polish in the stacked pipeline: masks and F as JAX's."""
    W, ni = 4, 60
    D1, D2s, As, u0s = _registration(np.random.default_rng(17), W, n=80,
                                     ni=ni, noise=0.001)
    args = [D1.astype(np.float32), D2s.astype(np.float32), As,
            u0s.astype(np.float32)]
    opts = dict(lanes=4, window=4, support=16)
    sj = jpool.make_pool_pipeline(INV_J, ct.Params(), build="xla",
                                  **opts)(*[jnp.asarray(a) for a in args])
    st = pool.make_pool_pipeline(INV_T, Params(), layout="stacked",
                                 storage_dtype=torch.bfloat16, device="cpu",
                                 **opts)(*args)
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    # the polished F is u's exact objective (the top-16 polish would
    # truncate it far below ni); the u themselves differ from JAX's by
    # the f32 summation order of the bf16 products, so F agrees with
    # JAX's within the 0.5 omega-rounding margin
    P1 = torch.from_numpy(args[0][As[..., 0]])
    P2 = torch.from_numpy(np.stack([d[a] for d, a in zip(args[1],
                                                         As[..., 1])]))
    full = pool._polish_batch(INV_T, P1, P2, torch.from_numpy(As), st.u,
                                  None, 1e-4)
    torch.testing.assert_close(st.score, full, rtol=1e-5, atol=0)
    np.testing.assert_allclose(st.score.numpy(), np.asarray(sj.score),
                               rtol=0, atol=0.5)
    assert bool((st.score > ni * 0.8).all())


def test_build_resolution_and_option_guards():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    for storage in (torch.int8, torch.bfloat16):
        assert pool._resolve_build("auto", storage, INV_T, cpu) == "xla"
        assert pool._resolve_build("auto", storage, INV_T, cuda) == "pallas"
    assert pool._resolve_build("auto", torch.float32, INV_T, cuda) == "xla"
    assert pool._resolve_build("auto", None, INV_T, cuda) == "xla"
    assert pool._resolve_build("auto", torch.int8, object(), cuda) == "xla"
    assert pool._resolve_build("pallas", torch.int8, INV_T, cpu) == "pallas"
    with pytest.raises(ValueError, match="direct-to-storage"):
        pool._resolve_build("pallas", None, INV_T, cpu)
    with pytest.raises(ValueError, match="unknown build"):
        pool._resolve_build("mosaic", torch.int8, INV_T, cpu)
    for bad in (dict(tri_probes=4), dict(d_scale=0.5),
                dict(warm_alpha=True)):
        with pytest.raises(ValueError, match="layout='tri' only"):
            pool.make_pool_pipeline(INV_T, layout="stacked", device="cpu",
                                    **bad)
    with pytest.raises(ValueError, match="unknown layout"):
        pool.make_pool_pipeline(INV_T, layout="tiles", device="cpu")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        pool.make_pool_multistart_pipeline(
            INV_T, Params(rounding=Rounding.DSD), device="cpu")
    assert any("DSD" in str(w.message) for w in rec)
