"""Port parity: Euclidean scoring and the affinity builds.

Same numpy inputs through clipper_tpu and clipper_tpu_torch; the
reference's 12x12 MATLAB golden affinity (test/affinity_test.cpp:95-106).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clipper_tpu.invariants.euclidean import (
    EuclideanDistance as JEuclidean,
    EuclideanDistanceParams as JEuclideanParams)
from clipper_tpu.ops import affinity as jaffinity
from clipper_tpu.ops import pairwise as jpairwise
from clipper_tpu_torch.invariants.euclidean import (EuclideanDistance,
                                                    EuclideanDistanceParams)
from clipper_tpu_torch.ops import affinity, pairwise

MTRUE = np.array([
    [1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0],
    [0, 1, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0, 0],
    [0, 1, 0, 1, 0, 0, 0, 0, 0, 0, 1, 0],
    [1, 0, 0, 0, 1, 0, 0, 0, 1, 1, 0, 0],
    [0, 0, 0, 0, 0, 1, 0, 1, 0, 0, 0, 0],
    [0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 1, 0, 1, 0, 0, 0, 0],
    [1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0],
    [0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0],
    [0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1],
], dtype=np.float64)


def _points(seed, n=40, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(dtype),
            (rng.normal(size=(n, 3)) * 0.9).astype(dtype))


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-6)])
def test_score_matrix_and_block_match_jax(dtype, tol):
    P1, P2 = _points(0, dtype=dtype)
    p = dict(sigma=0.3, epsilon=1.0)
    inv_t = EuclideanDistance(EuclideanDistanceParams(**p))
    inv_j = JEuclidean(JEuclideanParams(**p))
    ref = np.asarray(inv_j.score_matrix(jnp.asarray(P1), jnp.asarray(P2)))
    got = inv_t.score_matrix(torch.from_numpy(P1), torch.from_numpy(P2))
    assert got.dtype == torch.from_numpy(P1).dtype
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)
    r, c = slice(3, 17), slice(11, 40)
    refb = np.asarray(inv_j.score_block(*(jnp.asarray(x) for x in
                                          (P1[r], P1[c], P2[r], P2[c]))))
    gotb = inv_t.score_block(*(torch.from_numpy(x) for x in
                               (P1[r], P1[c], P2[r], P2[c])))
    np.testing.assert_allclose(gotb.numpy(), refb, rtol=0, atol=tol)
    gott = inv_t.score_block_t(*(torch.from_numpy(x) for x in
                                 (P1[r], P1[c].T, P2[r], P2[c].T)))
    np.testing.assert_array_equal(gott.numpy(), gotb.numpy())
    # the broadcasting per-pair callable agrees with the structured form
    pair = inv_t(torch.from_numpy(P1)[:, None], torch.from_numpy(P1)[None],
                 torch.from_numpy(P2)[:, None], torch.from_numpy(P2)[None])
    np.testing.assert_allclose(pair.numpy(), ref, rtol=0, atol=tol)


def test_mindist_matches_jax():
    P1, P2 = _points(1)
    p = dict(sigma=0.5, epsilon=2.0, mindist=1.0)
    ref = np.asarray(JEuclidean(JEuclideanParams(**p)).score_matrix(
        jnp.asarray(P1), jnp.asarray(P2)))
    got = EuclideanDistance(EuclideanDistanceParams(**p)).score_matrix(
        torch.from_numpy(P1), torch.from_numpy(P2))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)
    assert (ref == 0).any() and (ref > 0).any()


def test_gram_form_matches_jax():
    rng = np.random.default_rng(2)
    P = rng.normal(size=(30, 12))                 # d > 8: Gram form
    Q = rng.normal(size=(20, 12))
    np.testing.assert_allclose(
        pairwise.pairwise_sqdist_matrix(torch.from_numpy(P)).numpy(),
        np.asarray(jpairwise.pairwise_sqdist_matrix(jnp.asarray(P))),
        rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        pairwise.cross_sqdist_matrix(torch.from_numpy(P),
                                     torch.from_numpy(Q)).numpy(),
        np.asarray(jpairwise.cross_sqdist_matrix(jnp.asarray(P),
                                                 jnp.asarray(Q))),
        rtol=0, atol=1e-12)


def test_euclidean_affinity_golden():
    """The reference's 4-point model vs SE(3)-transformed 3-point view,
    all-to-all associations: M + I equals the MATLAB golden exactly."""
    model = np.array([[0, 2, 0, 2], [0, 0, 3, 2], [0, 0, 0, 0]], np.float64)
    th = np.pi / 8
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]])
    tr = np.array([5.0, 3.0, 0.0])
    view = (R.T @ (model - tr[:, None]))[:, :3]
    A = np.stack([np.repeat(np.arange(4), 3), np.tile(np.arange(3), 4)], 1)
    M, C = affinity.score_pairwise_consistency(
        EuclideanDistance(), torch.from_numpy(model.T.copy()),
        torch.from_numpy(view.T.copy()), torch.from_numpy(A))
    eye = np.eye(12)
    np.testing.assert_array_equal(M.numpy() + eye, MTRUE)
    np.testing.assert_array_equal(C.numpy() + eye, MTRUE)


def test_distinctness_mask():
    A = torch.tensor([[0, 0], [0, 1], [1, 0], [2, 2]])
    mask = affinity.distinctness_mask(A).numpy()
    ref = np.asarray(jaffinity.distinctness_mask(jnp.asarray(A.numpy())))
    np.testing.assert_array_equal(mask, ref)
    assert not mask[0, 1] and not mask[0, 2] and mask[1, 2] and mask[0, 3]
    assert not mask.diagonal().any()


@pytest.mark.parametrize("m_true", [None, 31])
def test_score_consistency_stored_parity(m_true):
    """int8 codes: C exact and M within +-1 (an ulp of exp can move a code
    at a rounding tie); bf16 and f32 dense builds equal to tolerance."""
    rng = np.random.default_rng(3)
    n, m = 40, 48
    D1, D2 = _points(3, n=n, dtype=np.float32)
    A = rng.integers(0, n, size=(m, 2)).astype(np.int32)
    p = dict(sigma=0.3, epsilon=1.0)
    inv_t = EuclideanDistance(EuclideanDistanceParams(**p))
    inv_j = JEuclidean(JEuclideanParams(**p))
    args_j = (jnp.asarray(D1), jnp.asarray(D2), jnp.asarray(A))
    args_t = (torch.from_numpy(D1), torch.from_numpy(D2), torch.from_numpy(A))

    ref = np.asarray(jaffinity.score_consistency_stored(
        inv_j, *args_j, affinityeps=1e-4, m_true=m_true,
        storage_dtype=jnp.int8))
    got = affinity.score_consistency_stored(
        inv_t, *args_t, affinityeps=1e-4, m_true=m_true,
        storage_dtype=torch.int8).numpy()
    np.testing.assert_array_equal(got[m:], ref[m:])
    d = np.abs(got[:m].astype(int) - ref[:m].astype(int))
    assert d.max() <= 1 and (d > 0).sum() <= 2

    Mj, Cj = jaffinity.score_pairwise_consistency(inv_j, *args_j,
                                                  m_true=m_true)
    Mt, Ct = affinity.score_pairwise_consistency(inv_t, *args_t,
                                                 m_true=m_true)
    np.testing.assert_allclose(Mt.numpy(), np.asarray(Mj), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(Ct.numpy(), np.asarray(Cj))
    bf = affinity.score_consistency_stored(inv_t, *args_t, m_true=m_true,
                                           storage_dtype=torch.bfloat16)
    np.testing.assert_allclose(bf.float().numpy(),
                               np.concatenate([Mt.numpy(), Ct.numpy()]),
                               rtol=1e-2, atol=0)
