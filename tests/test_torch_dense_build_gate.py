"""What the dense build kernel's design rests on, on the CPU.

Kernel 6 (csrc/affinity_build.cu) runs the triangle builds' body
(csrc/tri_pair_build.cuh) over the dense (m, m) map: each unordered pair
of 64 x 64 tiles once, written in place and transposed, a diagonal tile
scoring i < j only; a screen (f32) or the exact gate (f64) for every
pair, the score's tail only where the gate passes. Here, on the same
numpy inputs:

- the Python mirror of its placement (affinity_pallas.dense_tile_pair)
  writes every entry of an (m, m) array exactly once and scores every
  distinct pair exactly once, for m in {1, 63, 64, 65, 203, 1024};
- the plain dense build (what the kernel is held to) equals the JAX
  package's build_affinity_pallas in interpret mode on points planted at
  the gates' edges (harness.gate_boundary_endpoints), f32 and f64, both
  invariants, with affinityeps at 1e-4, 0 and -1 (C = 1 on every distinct
  pair, the zero scores too).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clipper_tpu as ct
from clipper_tpu.ops import affinity_pallas as jap
from clipper_tpu_torch import _kernels
from clipper_tpu_torch.bench import harness
from clipper_tpu_torch.ops import affinity_pallas
from clipper_tpu_torch.ops.affinity import pairwise_from_endpoints

KINDS = ["euclidean", "pointnormal"]
# the plants of harness.gate_boundary_endpoints that the build keeps at
# affinityeps >= 0
KEPT = {"below", "below_both", "coincident", "antiparallel", "clamp"}


def _invariants(kind):
    """(JAX, port) invariants with the bench protocol's parameters."""
    inv_t = (harness.default_invariant() if kind == "euclidean"
             else harness.pointnormal_invariant())
    params = dataclasses.asdict(inv_t.params)
    inv_j = (ct.EuclideanDistance(ct.EuclideanDistanceParams(**params))
             if kind == "euclidean"
             else ct.PointNormalDistance(ct.PointNormalDistanceParams(
                 **params)))
    return inv_j, inv_t


@pytest.mark.parametrize("m", [1, 63, 64, 65, 203, 1024])
def test_dense_pairs_place_each_entry_once(m):
    """Every block's tile, written in place and (off the diagonal)
    transposed, puts each (i, j) of the (m, m) M and C exactly once and
    with the value of its own pair; the pairs each block scores (a
    diagonal tile's i < j, an off-diagonal tile's every pair) cover each
    distinct pair i < j exactly once."""
    n = -(-m // 64)
    lo = np.minimum.outer(np.arange(m), np.arange(m))
    hi = np.maximum.outer(np.arange(m), np.arange(m))
    dense = (lo * m + hi).astype(np.int64)      # unique a pair, symmetric
    out = np.full(m * m, -1, np.int64)
    hits = np.zeros(m * m, np.int64)
    scored = np.zeros((m, m), np.int64)
    for k in range(n * (n + 1) // 2):
        p = affinity_pallas.dense_tile_pair(k, m)
        assert p.gr0 <= p.gc0 and p.diag == (p.gr0 == p.gc0)
        assert p.mirror == (not p.diag) and 1 <= p.rows <= 64
        blk = dense[p.gr0:p.gr0 + p.rows, p.gc0:p.gc0 + p.cols]
        at = (p.at + m * np.arange(p.rows)[:, None]
              + np.arange(p.cols)[None, :])
        out[at] = blk
        hits[at] += 1
        if p.mirror:
            at_t = (p.at_t + m * np.arange(p.cols)[:, None]
                    + np.arange(p.rows)[None, :])
            out[at_t] = blk.T
            hits[at_t] += 1
        rows = p.gr0 + np.arange(p.rows)[:, None]
        cols = p.gc0 + np.arange(p.cols)[None, :]
        live = rows < cols if p.diag else np.ones_like(rows * cols, bool)
        np.add.at(scored, (np.broadcast_to(rows, live.shape)[live],
                           np.broadcast_to(cols, live.shape)[live]), 1)
    assert (hits == 1).all()
    np.testing.assert_array_equal(out.reshape(m, m), dense)
    np.testing.assert_array_equal(scored, np.triu(np.ones((m, m),
                                                          np.int64), 1))


@pytest.mark.parametrize("affeps", [1e-4, 0.0, -1.0])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_dense_build_matches_jax_at_the_gate(kind, dtype, affeps):
    """The plain dense build on the gate-edge points (m=203: no tile
    divides it; the plants at the gate's bound in the working precision)
    against the JAX package's build_affinity_pallas in interpret mode: C
    exactly equal; M within rtol 3e-5 in f32 (the bar of
    test_torch_affinity_dense: the JAX kernel forms the gaussian's
    parameters as x64 promotes them) and 1e-12 in f64; the "at" plants
    exactly at the bound in the working precision, and every plant kept
    as planted (all of them at affinityeps < 0, with C = 1 on every
    distinct pair there); a zero diagonal; no launch counted."""
    inv_j, inv_t = _invariants(kind)
    m = 203
    P1, P2, A, plants = harness.gate_boundary_endpoints(
        inv_t, 1, m, 9, dtype=getattr(np, dtype))
    P1, P2, A = P1[0], P2[0], A[0]
    assert P1.dtype == getattr(np, dtype) and len(plants) == 10
    Mj, Cj = jap.build_affinity_pallas(inv_j, jnp.asarray(P1),
                                       jnp.asarray(P2), jnp.asarray(A),
                                       affinityeps=affeps)
    Mj, Cj = np.asarray(Mj), np.asarray(Cj)
    before = dict(_kernels.LAUNCHES)
    M, C = affinity_pallas.build_affinity_pallas(
        inv_t, torch.from_numpy(P1), torch.from_numpy(P2),
        torch.from_numpy(A), affinityeps=affeps)
    assert _kernels.LAUNCHES == before
    assert M.dtype == C.dtype == getattr(torch, dtype)
    assert Mj.dtype == getattr(np, dtype)
    np.testing.assert_array_equal(C.numpy(), Cj)
    if dtype == "float32":
        np.testing.assert_allclose(M.numpy(), Mj, rtol=3e-5, atol=0)
    else:
        np.testing.assert_allclose(M.numpy(), Mj, rtol=0, atol=1e-12)
    assert not M.diagonal().any() and not C.diagonal().any()
    Mp, Cp = pairwise_from_endpoints(inv_t, torch.from_numpy(P1),
                                     torch.from_numpy(P2),
                                     torch.from_numpy(A), affinityeps=affeps)
    assert torch.equal(M, Mp) and torch.equal(C, Cp)
    bound = getattr(np, dtype)(inv_t.params.epsp if kind == "pointnormal"
                               else inv_t.params.epsilon)
    for i, j, what in plants:
        if what.startswith("at"):
            dl = (np.linalg.norm(P1[j, :3] - P1[i, :3])
                  - np.linalg.norm(P2[j, :3] - P2[i, :3]))
            assert dl == bound, (what, dl)
        kept = affeps < 0 or what in KEPT
        assert bool(C[i, j] > 0) == kept == bool(C[j, i] > 0), what
    distinct = ~((A[:, None, 0] == A[None, :, 0])
                 | (A[:, None, 1] == A[None, :, 1]))
    if affeps < 0:
        np.testing.assert_array_equal(C.numpy() > 0, distinct)
        assert bool(((M == 0) & (C > 0)).any())
    else:
        np.testing.assert_array_equal(C.numpy() > 0, M.numpy() > affeps)
