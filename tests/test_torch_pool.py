"""Port parity: the triangle-pool pipeline end to end, and its polish.

The bench protocol (bunny, 90% outliers) at W=8, m=256 with bench.py's
engine settings through clipper_tpu.parallel.pool and
clipper_tpu_torch.parallel.pool (device="cpu": the plain versions).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clipper_tpu.bench import harness as jharness
from clipper_tpu.parallel import pool as jpool
from clipper_tpu.types import Params as JParams
from clipper_tpu_torch.bench import data, harness
from clipper_tpu_torch.parallel import pool
from clipper_tpu_torch.types import Params

W, M_ASSOC = 8, 256
ENGINE = dict(lanes=4, window=2, power_steps=4, layout="tri", tri_probes=16,
              d_scale=0.15)


@pytest.fixture(scope="module")
def problems():
    pcd0 = harness.load_bunny()
    rng = np.random.default_rng(21)
    probs = [harness.make_problem(pcd0, M_ASSOC, 0.9, rng) for _ in range(W)]
    D2s = np.stack([p[0] for p in probs])
    As = np.stack([p[1] for p in probs]).astype(np.int32)
    u0 = np.random.default_rng(22).random((W, M_ASSOC))
    return pcd0, D2s, As, [p[2] for p in probs], u0


def _pr(As, masks, Agts):
    pr = np.array([data.get_precision_recall(As[b][masks[b]], Agts[b])
                   for b in range(len(Agts))])
    return pr.mean(0)


def _run_both(problems, dt, storage_t, storage_j, w=W, **opts):
    """The first w problems through both pipelines, ENGINE's options
    updated by opts."""
    pcd0, D2s, As, _, u0 = problems
    engine = dict(ENGINE, **opts)
    jp = jpool.make_pool_pipeline(jharness.default_invariant(), JParams(),
                                  storage_dtype=storage_j, **engine)
    sj = jp(jnp.asarray(pcd0, dt), jnp.asarray(D2s[:w], dt),
            jnp.asarray(As[:w]), jnp.asarray(u0[:w], dt))
    tp = pool.make_pool_pipeline(harness.default_invariant(), Params(),
                                 storage_dtype=storage_t, device="cpu",
                                 **engine)
    timings = {}
    st = tp(pcd0.astype(dt), D2s[:w].astype(dt), As[:w], u0[:w].astype(dt),
            timings=timings)
    assert set(timings) == {"build", "init", "solve", "polish"}
    return sj, st


def _assert_matches(problems, sj, st, w=W):
    """The bar of the f32 pools: masks equal on all but one problem, mean
    P/R within 1 point, and the bench protocol's quality."""
    _, _, As, Agts, _ = problems
    mj = np.asarray(sj.mask)
    mt = st.mask.numpy()
    assert st.mask.shape == (w, M_ASSOC) and st.u.dtype == torch.float32
    assert (mj == mt).all(1).sum() >= w - 1
    pj, rj = _pr(As[:w], mj, Agts[:w])
    pt, rt = _pr(As[:w], mt, Agts[:w])
    assert abs(pj - pt) <= 0.01 and abs(rj - rt) <= 0.01
    assert pt > 0.97 and rt > 0.8


def test_pipeline_int8_matches_jax(problems):
    sj, st = _run_both(problems, np.float32, torch.int8, jnp.int8)
    _assert_matches(problems, sj, st)


def test_pipeline_bf16_matches_jax(problems):
    """bf16 storage (the JAX package's default) in the tri pool, W=4."""
    sj, st = _run_both(problems, np.float32, torch.bfloat16, jnp.bfloat16,
                       w=4)
    _assert_matches(problems, sj, st, w=4)


def test_pipeline_tri_tile_matches_jax(problems):
    """tri_tile=128 at m=256 (two row blocks where the default takes one
    256 tile), against the JAX package's tri_tile=128."""
    sj, st = _run_both(problems, np.float32, torch.int8, jnp.int8,
                       tri_tile=128)
    _assert_matches(problems, sj, st)


def test_pipeline_f64_matches_jax_exactly(problems):
    sj, st = _run_both(problems, np.float64, None, None)
    np.testing.assert_array_equal(st.ifinal.numpy(), np.asarray(sj.ifinal))
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    np.testing.assert_allclose(st.score.numpy(), np.asarray(sj.score),
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("k", [16, 256])
def test_polish_objectives_match_jax(problems, k):
    """support_objective (top-k) and exact_objective_rows against the JAX
    package on the same converged-looking u (sparse, nonnegative)."""
    pcd0, D2s, As, _, _ = problems
    rng = np.random.default_rng(23)
    u = rng.random((2, M_ASSOC))
    u[u < 0.9] = 0.0
    inv_j = jharness.default_invariant()
    inv_t = harness.default_invariant()
    for b in range(2):
        P1 = pcd0[As[b, :, 0]]
        P2 = D2s[b][As[b, :, 1]]
        jargs = [jnp.asarray(x) for x in (P1, P2, As[b], u[b])]
        targs = [torch.from_numpy(x) for x in (P1, P2, As[b], u[b])]
        ref = float(jpool.support_objective(inv_j, *jargs, k=k))
        got = float(pool.support_objective(inv_t, *targs, k=k))
        assert abs(got - ref) <= 1e-10
        ref = float(jpool.exact_objective_rows(inv_j, *jargs))
        got = float(pool.exact_objective_rows(inv_t, *targs))
        assert abs(got - ref) <= 1e-10
    # batched over problems equals one at a time
    P1s = torch.from_numpy(np.stack([pcd0[As[b, :, 0]] for b in range(2)]))
    P2s = torch.from_numpy(np.stack([D2s[b][As[b, :, 1]] for b in range(2)]))
    Fb = pool.exact_objective_rows(inv_t, P1s, P2s, torch.from_numpy(As[:2]),
                                   torch.from_numpy(u))
    Fs = pool.support_objective(inv_t, P1s, P2s, torch.from_numpy(As[:2]),
                                torch.from_numpy(u), k=M_ASSOC)
    np.testing.assert_allclose(Fb.numpy(), Fs.numpy(), rtol=0, atol=1e-10)


def test_pool_schedule_covers_every_problem(problems):
    """Lane compaction with fewer lanes than problems writes every
    problem's result once; windows run until no lane is active."""
    from clipper_tpu_torch.ops import flattri
    from clipper_tpu_torch.ops.affinity import gather_endpoints
    from clipper_tpu_torch.solvers import msrc_flat
    pcd0, D2s, As, _, u0 = problems
    P1, P2 = gather_endpoints(torch.from_numpy(pcd0).float(),
                              torch.from_numpy(D2s).float(),
                              torch.from_numpy(As))
    tri = flattri.build_tri(harness.default_invariant(), P1, P2,
                            torch.from_numpy(As), torch.full((W,), M_ASSOC))
    bmv = flattri.make_tri_pool_matvec(tri, 1, torch.float32)
    inits = msrc_flat.flat_init_batched(bmv, torch.arange(W),
                                        torch.from_numpy(u0).float())
    u, F, i, nwin = pool.solve_pool_tri(tri, 1, inits, lanes=3, window=2,
                                        probes=16, d_scale=0.15,
                                        return_windows=True)
    u1, F1, i1 = pool.solve_pool_tri(tri, 1, inits, lanes=W, window=2,
                                     probes=16, d_scale=0.15)
    assert nwin >= 3 and bool((F > 0).all())
    # a lane's trajectory does not depend on the schedule
    torch.testing.assert_close(u, u1, rtol=0, atol=0)
    torch.testing.assert_close(i, i1, rtol=0, atol=0)


def test_pipeline_rejects_unported_and_bad_shapes():
    inv = harness.default_invariant()
    # the stacked layout is ported: it builds, for any m
    assert callable(pool.make_pool_pipeline(inv, layout="stacked",
                                            device="cpu"))
    # mesh= is ported: it takes a torch.distributed ProcessGroup
    with pytest.raises(TypeError, match="ProcessGroup"):
        pool.make_pool_pipeline(inv, layout="tri", mesh=object(),
                                device="cpu")
    # the defaults are the main path: layout="tri", int8 storage
    pipe = pool.make_pool_pipeline(inv, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        pipe(np.zeros((10, 3), np.float32), np.zeros((2, 10, 3), np.float32),
             np.zeros((2, 100, 2), np.int32), np.ones((2, 100), np.float32))
    # tri_tile: the JAX package's semantics and error text
    pipe = pool.make_pool_pipeline(inv, tri_tile=384, device="cpu")
    with pytest.raises(ValueError, match="divisible by 384"):
        pipe(np.zeros((10, 3), np.float32), np.zeros((2, 10, 3), np.float32),
             np.zeros((2, 256, 2), np.int32), np.ones((2, 256), np.float32))
    with pytest.raises(ValueError, match="layout='tri' only"):
        pool.make_pool_pipeline(inv, layout="stacked", tri_tile=128,
                                device="cpu")


@pytest.mark.parametrize("dt, stall_outers", [
    (np.float64, 0), (np.float64, 1), (np.float64, 5), (np.float32, 1)])
def test_stall_outers_matches_jax(problems, dt, stall_outers):
    """make_pool_pipeline(stall_outers=...) against the JAX pipeline from
    the same u0: in f64 (full-precision storage; the stalled-homotopy guard
    is off in f64) masks and ifinal equal on every problem; in f32 (int8
    storage, where the guard stops a lane after one frozen outer) on all
    but one, as the f32 pools' bar."""
    f64 = dt == np.float64
    storage_t, storage_j = (None, None) if f64 else (torch.int8, jnp.int8)
    sj, st = _run_both(problems, dt, storage_t, storage_j,
                       stall_outers=stall_outers)
    same_mask = (st.mask.numpy() == np.asarray(sj.mask)).all(1)
    same_i = st.ifinal.numpy() == np.asarray(sj.ifinal)
    need = W if f64 else W - 1
    assert same_mask.sum() >= need and same_i.sum() >= need
