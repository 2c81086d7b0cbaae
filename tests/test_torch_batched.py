"""Port parity: the batched and multistart flat solves, the batched
pipeline in every matvec mode, and the tick-chunked flat solve.

Mirrors tests/test_msrc_flat.py (:63-200) and tests/test_parallel.py
(:43-60): clipper_tpu against clipper_tpu_torch (device="cpu": the plain
versions) on the same numpy inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clipper_tpu as ct
from clipper_tpu.parallel import batched as jbatched
from clipper_tpu.solvers import msrc_flat as jmsrc_flat
from clipper_tpu_torch import EuclideanDistance, EuclideanDistanceParams
from clipper_tpu_torch.parallel import batched
from clipper_tpu_torch.solvers import msrc_flat
from clipper_tpu_torch.types import Params, Rounding

from test_msrc_flat import random_graph

INV_J = ct.EuclideanDistance(ct.EuclideanDistanceParams(sigma=0.015,
                                                        epsilon=0.05))
INV_T = EuclideanDistance(EuclideanDistanceParams(sigma=0.015, epsilon=0.05))


def _graphs(seed, B, m=24, density=0.35):
    rng = np.random.default_rng(seed)
    Ms, Cs, u0s = [], [], []
    for _ in range(B):
        M, C = random_graph(rng, m=m, density=density)
        Ms.append(M)
        Cs.append(C)
        u0s.append(rng.uniform(size=m))
    return np.stack(Ms), np.stack(Cs), np.stack(u0s)


def _assert_solutions_equal(st, sj, tol=1e-12):
    np.testing.assert_array_equal(st.ifinal.numpy(), np.asarray(sj.ifinal))
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    np.testing.assert_allclose(st.u.numpy(), np.asarray(sj.u), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(st.score.numpy(), np.asarray(sj.score),
                               rtol=0, atol=tol)


def test_solve_batched_matches_jax():
    """B lanes in lock-step give each lane JAX's vmapped flat solve: the
    same ifinal and masks, u and F within 1e-12 (f64)."""
    Ms, Cs, u0s = _graphs(2, 5)
    sj = jax.jit(lambda a, b, c: jmsrc_flat.solve_batched(a, b, c,
                                                          ct.Params()))(
        jnp.asarray(Ms), jnp.asarray(Cs), jnp.asarray(u0s))
    st = msrc_flat.solve_batched(*map(torch.from_numpy, (Ms, Cs, u0s)))
    _assert_solutions_equal(st, sj)


def test_solve_multistart_matches_jax():
    """K inits of one problem: the same winning lane (its u0), ifinal,
    mask, and u and F within 1e-12 (f64); DSD rounds NONZERO."""
    Ms, Cs, _ = _graphs(4, 1, m=40, density=0.45)
    u0s = np.random.default_rng(5).uniform(size=(6, 40))
    for rnd, jrnd in ((Rounding.DSD_HEU, ct.Rounding.DSD_HEU),
                      (Rounding.DSD, ct.Rounding.DSD)):
        sj = jmsrc_flat.solve_multistart(jnp.asarray(Ms[0]),
                                         jnp.asarray(Cs[0]),
                                         jnp.asarray(u0s),
                                         ct.Params(rounding=jrnd))
        st = msrc_flat.solve_multistart(torch.from_numpy(Ms[0]),
                                        torch.from_numpy(Cs[0]),
                                        torch.from_numpy(u0s),
                                        Params(rounding=rnd))
        _assert_solutions_equal(st, sj)
        np.testing.assert_array_equal(st.u0.numpy(), np.asarray(sj.u0))


def _problems(seed, B, n=60, ni=20, m=128, noise=0.0):
    rng = np.random.default_rng(seed)
    D1s, D2s, As = [], [], []
    for _ in range(B):
        D1 = rng.uniform(size=(n, 3))
        th = rng.uniform(0, np.pi)
        R = np.array([[np.cos(th), -np.sin(th), 0],
                      [np.sin(th), np.cos(th), 0], [0, 0, 1]])
        D2 = D1 @ R.T + rng.normal(0, noise, size=(n, 3))
        A = np.zeros((m, 2), dtype=np.int32)
        A[:ni, 0] = A[:ni, 1] = np.arange(ni)
        A[ni:, 0] = rng.integers(0, n, m - ni)
        A[ni:, 1] = rng.integers(0, n, m - ni)
        D1s.append(D1)
        D2s.append(D2)
        As.append(A)
    return (np.stack(D1s), np.stack(D2s), np.stack(As),
            rng.uniform(size=(B, m)))


@pytest.mark.parametrize("solver,matvec,dtype", [
    ("flat", "stacked", "float64"), ("nested", "stacked", "float64"),
    ("flat", "stacked", "float32"), ("nested", "stacked", "float32"),
    ("flat", "stacked_bf16", "float32"), ("flat", "stacked_int8", "float32"),
    ("flat", "fused", "float32")])
def test_batched_pipeline_matches_jax(solver, matvec, dtype):
    """Every solver and matvec mode of make_batched_pipeline against
    JAX's on the same problems: equal masks.

    f64 runs noisy scenes: the ifinal are equal too, and u agrees within
    1e-6 (the build's distances round differently in the last bit, which
    the steep Gaussian score and the solver's stopping tests amplify to
    ~1e-8). f32 runs noise-free scenes, as test_msrc_flat.py:122 does:
    there the f32 sums, which the two packages take in another order,
    do not flip the solver's activity threshold (Cbu > eps, a difference
    of near-equal sums) on any problem. On noisy scenes they can, and an
    f32 lane then follows another homotopy path."""
    noise = 0.001 if dtype == "float64" else 0.0
    D1s, D2s, As, u0s = _problems(9, 3, noise=noise)
    args = [D1s.astype(dtype), D2s.astype(dtype), As, u0s.astype(dtype)]
    sj = jbatched.make_batched_pipeline(INV_J, ct.Params(), solver=solver,
                                        matvec=matvec)(
        *[jnp.asarray(a) for a in args])
    stats = {}
    st = batched.make_batched_pipeline(INV_T, Params(), solver=solver,
                                       matvec=matvec, device="cpu")(
        *args, stats=stats)
    assert st.u.dtype == getattr(torch, dtype) and st.mask.shape == (3, 128)
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    if dtype == "float64":
        np.testing.assert_array_equal(st.ifinal.numpy(),
                                      np.asarray(sj.ifinal))
        np.testing.assert_allclose(st.u.numpy(), np.asarray(sj.u), rtol=0,
                                   atol=1e-6)
    if solver == "flat":
        assert stats["ticks"] >= 1
    sel = set(np.flatnonzero(st.mask[0].numpy()))
    assert len(sel & set(range(20))) >= 18, (matvec, sel)


def test_batched_pipeline_shared_d1_and_multiprobe():
    """A 2-D D1 is shared by every problem (JAX's shared_d1=True); the
    K=8 line search selects what the single probe selects."""
    D1s, D2s, As, u0s = _problems(11, 3)
    D1 = D1s[0]
    D2s = np.stack([D1 @ np.eye(3)[[1, 0, 2]] for _ in range(3)])
    args = [D1.astype(np.float32), D2s.astype(np.float32), As,
            u0s.astype(np.float32)]
    sj = jbatched.make_batched_pipeline(INV_J, ct.Params(), shared_d1=True)(
        *[jnp.asarray(a) for a in args])
    one = batched.make_batched_pipeline(INV_T, Params(), device="cpu")(*args)
    np.testing.assert_array_equal(one.mask.numpy(), np.asarray(sj.mask))
    for matvec in ("stacked", "stacked_bf16"):
        ref = batched.make_batched_pipeline(INV_T, Params(), matvec=matvec,
                                            device="cpu")(*args)
        mp = batched.make_batched_pipeline(INV_T, Params(), matvec=matvec,
                                           probes=8, device="cpu")(*args)
        assert torch.equal(mp.mask, ref.mask)


def test_make_solve_pipeline_matches_jax():
    Ms, Cs, u0s = _graphs(3, 3)
    sj = jbatched.make_solve_pipeline(ct.Params())(
        *map(jnp.asarray, (Ms, Cs, u0s)))
    st = batched.make_solve_pipeline(Params())(
        *map(torch.from_numpy, (Ms, Cs, u0s)))
    _assert_solutions_equal(st, sj, tol=1e-10)


def test_batched_options_and_unported():
    for bad, err in ((dict(solver="bfs"), "unknown solver"),
                     (dict(matvec="dense"), "unknown matvec"),
                     (dict(matvec="fused", probes=4), "multiprobe")):
        with pytest.raises(ValueError, match=err):
            batched.make_batched_pipeline(INV_T, device="cpu", **bad)
    # shard_batch is ported: one rank without a group keeps the whole
    # batch, as tensors on the device; a mesh must split the batch
    part = batched.shard_batch({"u0s": np.ones((3, 4))}, None, device="cpu")
    assert part["u0s"].shape == (3, 4) and part["u0s"].device.type == "cpu"
    with pytest.raises(ValueError, match="batch B=3 must be divisible"):
        batched.rank_rows(3, 2, 0, "batch B")


def _chunked(mv, s, params, chunk, **opts):
    while not bool(s.done):
        s = msrc_flat.flat_solve_ticks(mv, s, params, ticks=chunk, **opts)
    return s


@pytest.mark.parametrize("opts", [{}, dict(probes=4, d_scale=0.15),
                                  dict(warm_alpha=True)])
def test_flat_solve_ticks_chunked_equals_uninterrupted(opts):
    """Driving a single-lane solve in chunks of ticks, with the same tick
    options every chunk, reproduces the uninterrupted solve bit for bit;
    at the defaults both equal the JAX package's chunked flat_solve_ticks
    (f64, within 1e-12)."""
    M, C, u0 = (x[0] for x in _graphs(6, 1, m=40, density=0.45))
    Mt, Ct, u0t = map(torch.from_numpy, (M, C, u0))
    mv = msrc_flat.stacked_dual_matvec(Mt, Ct)
    params = Params()
    whole = msrc_flat.flat_solve_ticks(mv, msrc_flat.flat_init(mv, u0t,
                                                               params),
                                       params, ticks=None, **opts)
    for chunk in (1, 3, 7):
        s = _chunked(mv, msrc_flat.flat_init(mv, u0t, params), params, chunk,
                     **opts)
        for name in s._fields:
            assert torch.equal(getattr(s, name), getattr(whole, name)), name
    if opts:
        return
    jmv = jmsrc_flat.stacked_dual_matvec(jnp.asarray(M), jnp.asarray(C))
    js = jmsrc_flat.flat_init(jmv, jnp.asarray(u0), ct.Params())
    while not bool(js.done):
        js = jmsrc_flat.flat_solve_ticks(jmv, js, ct.Params(), ticks=3)
    for name in ("ticks", "i", "j", "done", "nback"):
        np.testing.assert_array_equal(getattr(whole, name).numpy(),
                                      np.asarray(getattr(js, name)))
    for name in ("u", "F", "d"):
        np.testing.assert_allclose(getattr(whole, name).numpy(),
                                   np.asarray(getattr(js, name)), rtol=0,
                                   atol=1e-12)
