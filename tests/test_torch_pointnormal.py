"""Port parity: the point-normal invariant and its scan-alignment protocol.

The same numpy inputs go through clipper_tpu (invariants/pointnormal.py,
bench/harness.py's point-normal generator, the affinity build, the dense
facade) and clipper_tpu_torch on the CPU (the plain versions). Mirrors
tests/test_pointnormal_pipeline.py and tests/test_affinity_pallas.py's
point-normal cases.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clipper_tpu as ct
from clipper_tpu.bench import harness as jharness
from clipper_tpu.solvers import msrc as jmsrc
from clipper_tpu_torch import Clipper, interop
from clipper_tpu_torch.bench import data, harness
from clipper_tpu_torch.invariants.pointnormal import (
    PointNormalDistance, PointNormalDistanceParams)
from clipper_tpu_torch.ops.affinity import (build_affinity,
                                            score_pairwise_consistency)
from clipper_tpu_torch.solvers import msrc
from clipper_tpu_torch.types import Params

PN = dict(sigp=0.03, epsp=0.06, sign=0.05, epsn=0.15)


def _endpoints(rng, m):
    """(m, 6) point-normal endpoints whose normals are scaled by 1 + 1e-6,
    so every self dot product, and the duplicated and reversed normals of
    rows 1 and 2, fall past +-1 and exercise the clamp."""
    pts = rng.uniform(-1.0, 1.0, size=(m, 3))
    nrm = rng.normal(size=(m, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm[1] = nrm[0]
    nrm[2] = -nrm[0]
    return np.concatenate([pts, nrm * (1 + 1e-6)], axis=1)


def _pair():
    rng = np.random.default_rng(0)
    P1 = _endpoints(rng, 40)
    th = 0.4
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]])
    P2 = np.concatenate([P1[:, :3] @ R.T + 0.01 * rng.normal(size=(40, 3)),
                         P1[:, 3:] @ R.T], axis=1)
    return P1, P2


@pytest.mark.parametrize("params", [PN, {}])
def test_scores_match_jax(params):
    """__call__, score_matrix, score_block and score_block_t in f64 within
    1e-12 of the JAX invariant's, with dot products past +-1 clamped to
    angle 0 and pi on both sides (no NaN)."""
    inv_j = ct.PointNormalDistance(ct.PointNormalDistanceParams(**params))
    inv_t = interop.invariant_from_params(
        "pointnormal", dataclasses.asdict(inv_j.params))
    assert isinstance(inv_t, PointNormalDistance) and inv_t.symmetric
    P1, P2 = _pair()
    j1, j2 = jnp.asarray(P1), jnp.asarray(P2)
    t1, t2 = torch.from_numpy(P1), torch.from_numpy(P2)
    assert float(np.max(P1[:, 3:6] @ P1[:, 3:6].T)) > 1.0
    assert float(np.min(P1[:, 3:6] @ P1[:, 3:6].T)) < -1.0

    got = inv_t.score_matrix(t1, t2).numpy()
    ref = np.asarray(inv_j.score_matrix(j1, j2))
    assert np.isfinite(got).all() and (got > 0).sum() > 40
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    # rows 0, 1 share a normal: their angle is clamped to 0 in both sets
    assert got[0, 1] == ref[0, 1] and got[0, 1] > 0
    r, c = slice(3, 17), slice(9, 40)
    got = inv_t.score_block(t1[r], t1[c], t2[r], t2[c]).numpy()
    ref = np.asarray(inv_j.score_block(j1[r], j1[c], j2[r], j2[c]))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    got_t = inv_t.score_block_t(t1[r], t1[c].T, t2[r], t2[c].T).numpy()
    ref_t = np.asarray(inv_j.score_block_t(j1[r], j1[c].T, j2[r], j2[c].T))
    np.testing.assert_allclose(got_t, ref_t, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got_t, got)
    i = np.arange(40)
    j = (i * 7 + 3) % 40
    got = inv_t(t1[i], t1[j], t2[i], t2[j]).numpy()
    ref = np.asarray(inv_j(j1[i], j1[j], j2[i], j2[j]))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


def test_make_pointnormal_problem_matches_jax():
    """One default_rng(seed) gives both packages the same problem."""
    got = harness.make_pointnormal_problem(np.random.default_rng(5), n=300,
                                           m=400, rho=0.8)
    ref = jharness.make_pointnormal_problem(np.random.default_rng(5), n=300,
                                            m=400, rho=0.8)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    inv = harness.pointnormal_invariant()
    assert dataclasses.asdict(inv.params) == PN


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_score_pairwise_consistency_matches_jax(dtype):
    """f32: M within rtol 3e-5 and fewer than 1e-4 of C differing (the JAX
    package's own bar between its kernel and dense build,
    tests/test_affinity_pallas.py:60-62); f64: C exact, M within 1e-12."""
    D1, D2, A, _ = harness.make_pointnormal_problem(
        np.random.default_rng(3), n=300, m=400, rho=0.8)
    D1, D2 = D1.astype(dtype), D2.astype(dtype)
    inv_j = ct.PointNormalDistance(ct.PointNormalDistanceParams(**PN))
    Mj, Cj = ct.score_pairwise_consistency(inv_j, jnp.asarray(D1),
                                           jnp.asarray(D2), jnp.asarray(A))
    Mt, Ct = score_pairwise_consistency(harness.pointnormal_invariant(),
                                        torch.from_numpy(D1),
                                        torch.from_numpy(D2),
                                        torch.from_numpy(A))
    Mj, Cj = np.asarray(Mj), np.asarray(Cj)
    assert Mt.dtype == getattr(torch, np.dtype(dtype).name)
    assert (Cj > 0).sum() > 400
    if dtype == np.float64:
        np.testing.assert_array_equal(Ct.numpy(), Cj)
        np.testing.assert_allclose(Mt.numpy(), Mj, rtol=0, atol=1e-12)
    else:
        np.testing.assert_allclose(Mt.numpy(), Mj, rtol=3e-5, atol=1e-5)
        assert (Ct.numpy() != Cj).mean() < 1e-4


def test_pointnormal_scan_alignment():
    """tests/test_pointnormal_pipeline.py's scan alignment (m=512, 85%
    outliers) through the port: the same P/R bars, and the JAX package's
    mask."""
    D1, D2, A, Agt = harness.make_pointnormal_problem(
        np.random.default_rng(0), n=400, m=512, rho=0.85, noise=0.005)
    u0 = np.random.default_rng(1).uniform(size=512)
    M, C, _ = build_affinity(harness.pointnormal_invariant(),
                             torch.from_numpy(D1), torch.from_numpy(D2),
                             torch.from_numpy(A))
    u, F, _ = msrc.find_dense_clique(M, C, torch.from_numpy(u0), Params())
    mask = msrc.round_solution(u, F).numpy()
    p, r = data.get_precision_recall(A[mask], Agt)
    assert p >= 0.95, p
    assert r >= 0.60, r
    inv_j = ct.PointNormalDistance(ct.PointNormalDistanceParams(**PN))
    Mj, Cj, _ = ct.build_affinity(inv_j, jnp.asarray(D1), jnp.asarray(D2),
                                  jnp.asarray(A))
    uj, Fj, _ = jmsrc.find_dense_clique(Mj, Cj, jnp.asarray(u0), ct.Params())
    np.testing.assert_array_equal(
        mask, np.asarray(jmsrc.round_solution(uj, Fj)))


def test_pointnormal_rigid_invariance():
    """Scores are invariant to the rigid transform (perfect data): every
    distinct pair fully consistent."""
    D1, D2, A, _ = harness.make_pointnormal_problem(
        np.random.default_rng(2), n=100, m=100, rho=0.0, noise=0.0)
    M, C, _ = build_affinity(PointNormalDistance(), torch.from_numpy(D1),
                             torch.from_numpy(D2), torch.from_numpy(A))
    iu = np.triu_indices(100, 1)
    assert (M.numpy()[iu] > 0.999).all()
    assert (C.numpy()[iu] == 1).all()


def test_dense_facade_matches_jax():
    """The dense facade on a point-normal problem (m=256, f64) from one
    numpy u0: the JAX facade's mask and F."""
    D1, D2, A, Agt = harness.make_pointnormal_problem(
        np.random.default_rng(4), n=300, m=256, rho=0.8)
    u0 = np.random.default_rng(5).random(256)
    inv_j = ct.PointNormalDistance(ct.PointNormalDistanceParams(**PN))
    cj = ct.Clipper(inv_j, ct.Params(), dtype=jnp.float64, engine="dense")
    cj.score_pairwise_consistency(D1.T, D2.T, A)
    sj = cj.solve(u0=jnp.asarray(u0))
    ctt = Clipper(PointNormalDistance(PointNormalDistanceParams(**PN)),
                  Params(), dtype=torch.float64, engine="dense", device="cpu")
    ctt.score_pairwise_consistency(D1.T, D2.T, A)
    st = ctt.solve(u0=u0)
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    assert abs(float(st.score) - float(sj.score)) <= 1e-9 * abs(
        float(sj.score))
    p, r = data.get_precision_recall(ctt.get_selected_associations(), Agt)
    assert p >= 0.95 and r >= 0.6, (p, r)
