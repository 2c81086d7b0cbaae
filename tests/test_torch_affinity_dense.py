"""Port parity: the dense affinity build and the point-normal stored build.

Mirrors tests/test_affinity_pallas.py (:24-76, :112-134): the JAX
package's build_affinity_pallas and score_consistency_stored_pallas
(interpret mode on the CPU) against clipper_tpu_torch.ops.affinity_pallas,
whose CPU tensors take the plain versions (ops.affinity's
pairwise_from_endpoints and stored_from_endpoints).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clipper_tpu as ct
from clipper_tpu.ops import affinity_pallas as jap
from clipper_tpu_torch import _kernels, interop
from clipper_tpu_torch.ops import affinity_pallas
from clipper_tpu_torch.ops.affinity import (gather_endpoints,
                                            score_pairwise_consistency)


def _euclid_inputs(rng, m, n=100):
    """tests/test_affinity_pallas.py's make_inputs."""
    D1 = rng.uniform(size=(n, 3)).astype(np.float32)
    th = 0.5
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]])
    D2 = (D1 @ R.T).astype(np.float32)
    A = np.stack([rng.integers(0, n, m), rng.integers(0, n, m)],
                 1).astype(np.int32)
    return D1, D2, A


def _pointnormal_inputs(rng, m, n=80):
    """tests/test_affinity_pallas.py's point-normal scene."""
    pts = rng.uniform(size=(n, 3))
    nr = rng.normal(size=(n, 3))
    nr /= np.linalg.norm(nr, axis=1, keepdims=True)
    th = 0.3
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]])
    D1 = np.concatenate([pts, nr], 1).astype(np.float32)
    D2 = np.concatenate([pts @ R.T, nr @ R.T], 1).astype(np.float32)
    A = np.stack([rng.integers(0, n, m), rng.integers(0, n, m)],
                 1).astype(np.int32)
    return D1, D2, A


def _invariants(kind):
    if kind == "euclidean":
        inv_j = ct.EuclideanDistance(ct.EuclideanDistanceParams(
            sigma=0.05, epsilon=0.2))
    else:
        inv_j = ct.PointNormalDistance()
    return inv_j, interop.invariant_from_params(
        kind, dataclasses.asdict(inv_j.params))


@pytest.mark.parametrize("kind", ["euclidean", "pointnormal"])
@pytest.mark.parametrize("m", [300, 512])
def test_build_affinity_matches_jax(kind, m):
    """The port's dense build on the CPU against the JAX kernel in
    interpret mode (m=300: a ragged edge tile; m=512: a tile multiple):
    M within rtol 3e-5 and fewer than 1e-4 of C differing, the JAX
    package's own bar between its kernel and its dense build; M has a zero
    diagonal and C is M's pattern; no launch counted."""
    rng = np.random.default_rng(m)
    make = _euclid_inputs if kind == "euclidean" else _pointnormal_inputs
    D1, D2, A = make(rng, m)
    inv_j, inv_t = _invariants(kind)
    Mj, Cj = jap.build_affinity_pallas(inv_j, jnp.asarray(D1)[A[:, 0]],
                                       jnp.asarray(D2)[A[:, 1]],
                                       jnp.asarray(A))
    P1, P2 = gather_endpoints(torch.from_numpy(D1), torch.from_numpy(D2),
                              torch.from_numpy(A))
    before = dict(_kernels.LAUNCHES)
    M, C = affinity_pallas.build_affinity_pallas(inv_t, P1, P2,
                                                 torch.from_numpy(A))
    assert _kernels.LAUNCHES == before
    assert M.shape == C.shape == (m, m) and M.dtype == torch.float32
    Mj, Cj = np.asarray(Mj), np.asarray(Cj)
    assert (Cj > 0).sum() > m
    np.testing.assert_allclose(M.numpy(), Mj, rtol=3e-5, atol=1e-5)
    assert (C.numpy() != Cj).mean() < 1e-4
    assert not M.diagonal().any() and torch.equal(C, (M > 0).float())
    # the same function as score_pairwise_consistency, bit for bit
    Md, Cd = score_pairwise_consistency(inv_t, torch.from_numpy(D1),
                                        torch.from_numpy(D2),
                                        torch.from_numpy(A))
    assert torch.equal(M, Md) and torch.equal(C, Cd)


def test_build_affinity_f64():
    """In f64 the port's build keeps the working precision, C exactly the
    JAX kernel's and M within 1e-12."""
    rng = np.random.default_rng(7)
    D1, D2, A = _pointnormal_inputs(rng, 200)
    D1, D2 = D1.astype(np.float64), D2.astype(np.float64)
    inv_j, inv_t = _invariants("pointnormal")
    Mj, Cj = jap.build_affinity_pallas(inv_j, jnp.asarray(D1)[A[:, 0]],
                                       jnp.asarray(D2)[A[:, 1]],
                                       jnp.asarray(A))
    P1, P2 = gather_endpoints(torch.from_numpy(D1), torch.from_numpy(D2),
                              torch.from_numpy(A))
    M, C = affinity_pallas.build_affinity_pallas(inv_t, P1, P2,
                                                 torch.from_numpy(A))
    assert M.dtype == C.dtype == torch.float64
    np.testing.assert_array_equal(C.numpy(), np.asarray(Cj))
    np.testing.assert_allclose(M.numpy(), np.asarray(Mj), rtol=0, atol=1e-12)


@pytest.mark.parametrize("m_true,storage", [
    pytest.param(None, "int8", id="None"),
    pytest.param(150, "int8", id="150"),
    pytest.param(150, "bfloat16", id="150-bfloat16")])
def test_stored_pointnormal_matches_jax(m_true, storage):
    """The point-normal stacked build (tests/test_affinity_pallas.py
    :112-134's scene, m=200, which no tile divides), int8 codes or bf16
    values, against the JAX kernel: every entry equal; the output equals
    its transpose; rows and columns at or past m_true are zero."""
    rng = np.random.default_rng(1)
    D1, D2, A = _pointnormal_inputs(rng, 200)
    inv_j, inv_t = _invariants("pointnormal")
    ref = jap.score_consistency_stored_pallas(
        inv_j, jnp.asarray(D1), jnp.asarray(D2), jnp.asarray(A),
        m_true=m_true, storage_dtype=getattr(jnp, storage), tile=128)
    got = affinity_pallas.score_consistency_stored_pallas(
        inv_t, torch.from_numpy(D1), torch.from_numpy(D2),
        torch.from_numpy(A), m_true=m_true,
        storage_dtype=getattr(torch, storage))
    assert got.dtype == getattr(torch, storage) and got.shape == (400, 200)
    assert (got[200:] > 0).sum() > 200
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref, np.float32))
    for half in (got[:200], got[200:]):
        assert torch.equal(half, half.T)
    if m_true is not None:
        assert not got[:, m_true:].any() and not got[m_true:200].any()


def test_dense_build_guards():
    """The kernel wrapper raises for CPU tensors, for an invariant the
    kernel does not compute and for endpoints of the wrong width."""
    inv = _invariants("pointnormal")[1]
    P = torch.zeros(8, 6)
    A = torch.zeros(8, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="on the card"):
        affinity_pallas.affinity_build_cuda(inv, P, P, A)
    with pytest.raises(NotImplementedError, match="PointNormalDistance"):
        affinity_pallas.affinity_build_cuda(object(), P, P, A)
    with pytest.raises(ValueError, match="on the card"):
        affinity_pallas.stored_build_cuda(inv, P[None], P[None], A[None],
                                          torch.tensor([8]))
