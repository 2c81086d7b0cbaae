"""Port parity: the tri pool's kernel variants and the point-normal pools.

The tile-major (P, T, 2t, t) layout and its single-probe matvec, the
one-block-per-problem build, solve_pool_tri over tile-major storage, and
the point-normal tri and stacked pool pipelines, each against
clipper_tpu (its XLA paths, and its Pallas kernels in interpret mode) on
the same numpy inputs. Mirrors tests/test_flattri.py:270-309.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clipper_tpu as ct
from clipper_tpu.bench import harness as jharness
from clipper_tpu.ops import flattri as jflattri
from clipper_tpu.parallel import pool as jpool
from clipper_tpu.solvers import msrc as jmsrc
from clipper_tpu.solvers import msrc_flat as jmsrc_flat
from clipper_tpu.types import Params as JParams
from clipper_tpu_torch import _kernels, interop
from clipper_tpu_torch.bench import data, harness
from clipper_tpu_torch.ops import flattri
from clipper_tpu_torch.ops.affinity import gather_endpoints
from clipper_tpu_torch.parallel import pool
from clipper_tpu_torch.solvers import msrc
from clipper_tpu_torch.types import Params

PN = dict(sigp=0.03, epsp=0.06, sign=0.05, epsn=0.15)


def _random_stacked(rng, m, density=0.3):
    M = np.triu(rng.random((m, m)), 1)
    M[M < 1.0 - density] = 0.0
    M = M + M.T
    return np.concatenate([M, (M > 0).astype(np.float64)], axis=0)


@pytest.mark.parametrize("nt", [1, 3])
def test_repack_stacked_tiles_matches_jax(nt):
    rng = np.random.default_rng(nt)
    t = 16
    MC = _random_stacked(rng, nt * t)
    ref = np.asarray(jflattri.repack_stacked_tiles(jnp.asarray(MC), t))
    got = flattri.repack_stacked_tiles(torch.from_numpy(MC), t)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the tile-major form of the flat triangle: tile k at columns k t
    flat = flattri.repack_stacked(torch.from_numpy(MC), t)
    T = nt * (nt + 1) // 2
    view = flat.view(2 * t, T, t).permute(1, 0, 2)
    assert torch.equal(view, got)
    a, b = flattri._tile_assembly(nt, torch.float64)
    ja, jb = jflattri._tile_assembly(nt, jnp.float64)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


@pytest.mark.parametrize("kind", ["f64", "int8", "bf16"])
def test_tiles_matvec_matches_jax(kind):
    """The tiles matvec's CPU path against the JAX package's XLA version
    and its Pallas kernel in interpret mode, on one (P=3, T=10, 2t, t)
    storage, t=128: f64 within 1e-12 (tests/test_flattri.py:290-309's
    bar), int8 and bf16 within f32 summation error (5e-6 on unit-norm u);
    and against the flat matvec on the same content."""
    rng = np.random.default_rng(9)
    t, nt, P, B = 128, 4, 3, 5
    m = t * nt
    MCs = [_random_stacked(rng, m) for _ in range(P)]
    if kind == "int8":
        MCs = [np.asarray(jmsrc_flat.quantize_stacked(jnp.asarray(MC)))
               for MC in MCs]
    elif kind == "bf16":
        MCs = [np.asarray(jnp.asarray(MC, jnp.bfloat16)) for MC in MCs]
    tri = np.stack([np.asarray(jflattri.repack_stacked_tiles(
        jnp.asarray(MC), t)) for MC in MCs])
    dt = np.float64 if kind == "f64" else np.float32
    U = rng.random((B, m))
    U /= np.linalg.norm(U, axis=1, keepdims=True)
    U = U.astype(dt)
    idx = np.array([2, 0, 1, 2, 0], np.int32)
    tol = 1e-12 if kind == "f64" else 5e-6
    refs = [maker(jnp.asarray(tri), nt, dt)(jnp.asarray(idx), jnp.asarray(U))
            for maker in (jflattri.make_tri_pool_matvec_tiles_xla,
                          jflattri.make_tri_pool_matvec_tiles)]
    tri_t = interop.tri_to_torch(tri)
    before = dict(_kernels.LAUNCHES)
    got = flattri.make_tri_pool_matvec_tiles(tri_t, nt, torch.from_numpy(
        U).dtype)(torch.from_numpy(idx), torch.from_numpy(U))
    assert _kernels.LAUNCHES == before
    for ref in refs:
        for g, r in zip(got, ref):
            assert g.shape == (B, m)
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                       atol=tol)
    flat = interop.tri_to_torch(np.stack([np.asarray(
        jflattri.repack_stacked(jnp.asarray(MC), t)) for MC in MCs]))
    fl = flattri.make_tri_pool_matvec(flat, nt, got[0].dtype)(
        torch.from_numpy(idx), torch.from_numpy(U))
    for g, f in zip(got, fl):
        torch.testing.assert_close(g, f, rtol=0, atol=tol)
    with pytest.raises(ValueError, match="one probe"):
        flattri.make_tri_pool_matvec_tiles(tri_t, nt, torch.float32)(
            None, torch.zeros(B, 2, m))


def _bunny(m, seed):
    rng = np.random.default_rng(seed)
    pcd0 = harness.load_bunny().astype(np.float32)
    pcd1, A, _ = harness.make_problem(pcd0, m, 0.9, rng)
    return pcd0, pcd1.astype(np.float32), A.astype(np.int32)


def _pointnormal(m, seed, n=300):
    D1, D2, A, Agt = harness.make_pointnormal_problem(
        np.random.default_rng(seed), n=n, m=m, rho=0.9)
    return D1.astype(np.float32), D2.astype(np.float32), A, Agt


@pytest.mark.parametrize("kind", ["euclidean", "pointnormal"])
def test_build_tri_fused_matches_jax(kind):
    """build_tri_pallas_fused's CPU path bit-equal to the JAX package's
    fused build (interpret mode) at m=256, t=128, and to build_tri."""
    m, t = 256, 128
    if kind == "euclidean":
        D1, D2, A = _bunny(m, seed=8)
        inv_j = jharness.default_invariant()
    else:
        D1, D2, A, _ = _pointnormal(m, seed=8)
        inv_j = ct.PointNormalDistance(ct.PointNormalDistanceParams(**PN))
    inv_t = interop.invariant_from_params(kind,
                                          dataclasses.asdict(inv_j.params))
    jD1, jD2, jA = jnp.asarray(D1), jnp.asarray(D2), jnp.asarray(A)
    ref = jflattri.build_tri_pallas_fused(inv_j, jD1[jA[:, 0]][None],
                                          jD2[jA[:, 1]][None], jA[None],
                                          jnp.asarray([m]), t=t)
    P1, P2 = gather_endpoints(torch.from_numpy(D1), torch.from_numpy(D2),
                              torch.from_numpy(A))
    At, mts = torch.from_numpy(A)[None], torch.tensor([m])
    got = flattri.build_tri_pallas_fused(inv_t, P1[None], P2[None], At, mts,
                                         t=t)
    assert got.dtype == torch.int8 and (got[:, t:] > 0).sum() > m
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert torch.equal(got, flattri.build_tri(inv_t, P1[None], P2[None], At,
                                              mts, t=t))


def test_solve_pool_tri_tiles_matches_jax():
    """solve_pool_tri(matvec='tiles') on the CPU against the JAX package's
    solve_pool_tri(matvec='xla') on the same f64 tile-major storage and
    inits (W=4 bunny problems, m=256, t=128): equal ifinal and masks."""
    W, m, t = 4, 256, 128
    nt = m // t
    probs = [_bunny(m, seed=30 + w) for w in range(W)]
    inv_j = jharness.default_invariant()
    tris = []
    for D1, D2, A in probs:
        flat = jflattri.build_tri_xla(inv_j, jnp.asarray(D1, jnp.float64),
                                      jnp.asarray(D2, jnp.float64),
                                      jnp.asarray(A), m, t=t,
                                      storage_dtype=None)
        MC = flattri.dense_stacked(torch.tensor(np.asarray(flat)), nt)
        tris.append(np.asarray(jflattri.repack_stacked_tiles(
            jnp.asarray(MC.numpy()), t)))
    tri = jnp.asarray(np.stack(tris))
    u0 = np.random.default_rng(31).random((W, m))
    bmv = jflattri.make_tri_pool_matvec_tiles_xla(tri, nt, jnp.float64)
    idx = jnp.arange(W, dtype=jnp.int32)
    inits = jmsrc_flat.flat_init_batched(bmv, idx, jnp.asarray(u0),
                                         JParams())
    uj, Fj, ij = jpool.solve_pool_tri(tri, nt, inits, JParams(), lanes=2,
                                      window=2, matvec="xla")
    inits_t = interop.state_to_torch(
        {k: np.asarray(v) for k, v in inits._asdict().items()})
    ut, Ft, it = pool.solve_pool_tri(interop.tri_to_torch(np.asarray(tri)),
                                     nt, inits_t, Params(), lanes=2,
                                     window=2, matvec="tiles")
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    for w in range(W):
        np.testing.assert_array_equal(
            msrc.round_solution(ut[w], Ft[w]).numpy(),
            np.asarray(jmsrc.round_solution(uj[w], Fj[w])))
    with pytest.raises(ValueError, match="one probe"):
        pool.solve_pool_tri(interop.tri_to_torch(np.asarray(tri)), nt,
                            inits_t, probes=16)
    with pytest.raises(ValueError, match="does not take"):
        pool.solve_pool_tri(interop.tri_to_torch(np.asarray(tri)), nt,
                            inits_t, matvec="pallas")


@pytest.mark.parametrize("layout", ["tri", "stacked"])
def test_pointnormal_pool_matches_jax(layout):
    """The point-normal pool pipelines with per-problem D1 (W=4, m=256,
    int8 storage) against the JAX package's (shared_d1=False): equal
    masks, and the scan-alignment quality."""
    W, m = 4, 256
    probs = [_pointnormal(m, seed=40 + w) for w in range(W)]
    D1s, D2s, As = (np.stack([p[i] for p in probs]) for i in range(3))
    u0 = np.random.default_rng(41).random((W, m)).astype(np.float32)
    engine = dict(lanes=4, window=2, power_steps=4)
    if layout == "tri":
        engine.update(tri_probes=16, d_scale=0.15)
    inv_j = ct.PointNormalDistance(ct.PointNormalDistanceParams(**PN))
    jp = jpool.make_pool_pipeline(inv_j, JParams(), shared_d1=False,
                                  layout=layout, storage_dtype=jnp.int8,
                                  **engine)
    sj = jp(jnp.asarray(D1s), jnp.asarray(D2s), jnp.asarray(As),
            jnp.asarray(u0))
    tp = pool.make_pool_pipeline(harness.pointnormal_invariant(), Params(),
                                 layout=layout, storage_dtype=torch.int8,
                                 device="cpu", **engine)
    st = tp(D1s, D2s, As, u0)
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    pr = np.array([data.get_precision_recall(As[w][st.mask[w].numpy()],
                                             probs[w][3]) for w in range(W)])
    assert pr[:, 0].mean() >= 0.95 and pr[:, 1].mean() >= 0.8, pr
