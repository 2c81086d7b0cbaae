"""What the flat-triangle build kernels' design rests on, on the CPU.

Kernels 2 and 8 (csrc/tri_pair_build.cuh) score each distinct pair once,
walking pairs of 64-row sub-tiles by a closed form, and run the score's
tail only where its gate passes. Here, against clipper_tpu.ops.flattri on
the same numpy inputs where a JAX function exists:

- the Python mirror of the kernels' placement (flattri.tri_sub_pair)
  writes every entry of the (2t, S) storage exactly once, for nt = 1..17;
- the plain score is symmetric bit for bit, and the point-normal score is
  0 wherever dp >= epsp whatever dn, on points planted at the gates'
  edges (harness.gate_boundary_endpoints);
- the plain build equals the JAX package's on those points.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clipper_tpu as ct
from clipper_tpu.ops import flattri as jflattri
from clipper_tpu_torch import interop
from clipper_tpu_torch.bench import harness
from clipper_tpu_torch.ops import flattri
from clipper_tpu_torch.ops.affinity import pairwise_from_endpoints
from clipper_tpu_torch.ops.pairwise import (cross_distance_matrix,
                                            cross_inner_matrix)

KINDS = ["euclidean", "pointnormal"]
# the plants of harness.gate_boundary_endpoints that the build keeps
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


def _jax_scores(inv_j, P1, P2):
    """The JAX invariant's (W, m, m) f32 scores, problem by problem."""
    return np.stack([np.asarray(inv_j.score_block(
        jnp.asarray(a), jnp.asarray(a), jnp.asarray(b), jnp.asarray(b)))
        for a, b in zip(P1, P2)])


@pytest.mark.parametrize("nt", range(1, 18))
def test_sub_pairs_place_each_entry_once(nt):
    """Every sub-tile pair's block, written in place and (where mirrored)
    transposed, puts each entry of the M half exactly once and where
    repack_stacked puts it, for t with and without a 64-row remainder."""
    for t in (16, 100, 128) + ((256,) if nt <= 8 else ()):
        m, q = nt * t, flattri.tri_sub_tiles(t)
        S = flattri.tri_ncols(nt, t)
        lo = np.minimum.outer(np.arange(m), np.arange(m))
        hi = np.maximum.outer(np.arange(m), np.arange(m))
        dense = (lo * m + hi).astype(np.int64)   # unique a pair, symmetric
        ref = flattri.repack_stacked(
            torch.from_numpy(np.concatenate([dense, dense])), t)[:t].numpy()
        out = np.full(t * S, -1, np.int64)
        hits = np.zeros(t * S, np.int64)
        n = nt * q
        for k in range(n * (n + 1) // 2):
            p = flattri.tri_sub_pair(k, nt, t)
            blk = dense[p.gr0:p.gr0 + p.rows, p.gc0:p.gc0 + p.cols]
            assert p.diag == (p.gr0 == p.gc0) and p.gr0 <= p.gc0
            if p.diag:
                assert p.rows == p.cols and not p.mirror
            at = (p.at + S * np.arange(p.rows)[:, None]
                  + np.arange(p.cols)[None, :])
            out[at] = blk
            hits[at] += 1
            if p.mirror:
                at_t = (p.at_t + S * np.arange(p.cols)[:, None]
                        + np.arange(p.rows)[None, :])
                out[at_t] = blk.T
                hits[at_t] += 1
        assert (hits == 1).all(), (nt, t)
        np.testing.assert_array_equal(out.reshape(t, S), ref)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_score_symmetric_bit_for_bit(kind):
    """score(i, j) and score(j, i) have the same bits in the port's plain
    build and in the JAX package's, gate-edge plants included; so do C
    and the quantized codes. The plants land as planted."""
    inv_j, inv_t = _invariants(kind)
    P1, P2, A, plants = harness.gate_boundary_endpoints(inv_t, 2, 256, 5)
    M, C = pairwise_from_endpoints(inv_t, torch.from_numpy(P1),
                                   torch.from_numpy(P2), torch.from_numpy(A))
    assert M.dtype == torch.float32
    assert torch.equal(M.view(torch.int32), M.transpose(1, 2).view(
        torch.int32))
    assert torch.equal(C, C.transpose(1, 2))
    Mj = _jax_scores(inv_j, P1, P2)
    np.testing.assert_array_equal(Mj.view(np.int32),
                                  np.swapaxes(Mj, 1, 2).view(np.int32))
    for i, j, what in plants:
        kept = what in KEPT
        assert bool((C[:, i, j] > 0).all()) == kept, what
        assert bool((C[:, i, j] > 0).any()) == kept, what


def test_pointnormal_zero_where_dp_fails():
    """The point-normal score is 0 wherever dp >= epsp, whatever dn (so its
    tail, the angles, matters only past the gate); the planted pairs at
    dp = epsp with dn = 0 included. Both packages' scores."""
    inv_j, inv_t = _invariants("pointnormal")
    P1, P2, A, plants = harness.gate_boundary_endpoints(inv_t, 2, 256, 6)
    X1, X2 = torch.from_numpy(P1), torch.from_numpy(P2)
    l1 = cross_distance_matrix(X1[..., :3], X1[..., :3])
    l2 = cross_distance_matrix(X2[..., :3], X2[..., :3])
    dp = (l1 - l2).abs()
    a1 = torch.arccos(torch.clamp(cross_inner_matrix(X1[..., 3:],
                                                     X1[..., 3:]), -1, 1))
    a2 = torch.arccos(torch.clamp(cross_inner_matrix(X2[..., 3:],
                                                     X2[..., 3:]), -1, 1))
    dn = (a1 - a2).abs()
    fails = dp >= np.float32(inv_t.params.epsp)
    # pairs the angles alone would keep are among the gate's failures
    assert bool((fails & (dn < inv_t.params.epsn)).any())
    s_t = inv_t.score_block(X1, X1, X2, X2)
    s_j = torch.from_numpy(_jax_scores(inv_j, P1, P2))
    for s in (s_t, s_j):
        assert not bool(s[fails].any())
        assert bool(s[~fails].any())
    at = [(i, j) for i, j, what in plants if what.startswith("at")]
    assert at
    for i, j in at:
        assert bool(fails[:, i, j].all()) and bool((dn[:, i, j] == 0).all())


@pytest.mark.parametrize("storage", ["int8", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_build_matches_jax_at_the_gate(kind, storage):
    """The plain tri build (what kernels 2 and 8 are held to) on the
    gate-edge points, m_true < m on one problem, against the JAX
    package's build_tri_pallas in interpret mode: C exact; M equal, or one
    code (one bf16 ulp) apart where exp's last bit moved a rounding tie,
    on at most 1 in 1000 stored edges."""
    inv_j, inv_t = _invariants(kind)
    W, m, t = 2, 256, 128
    P1, P2, A, _ = harness.gate_boundary_endpoints(inv_t, W, m, 7)
    mts = np.array([m, 200], np.int32)
    ref = interop.tri_to_torch(np.asarray(jflattri.build_tri_pallas(
        inv_j, jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(A),
        jnp.asarray(mts), t=t, storage_dtype=getattr(jnp, storage))))
    got = flattri.build_tri_plain(inv_t, torch.from_numpy(P1),
                                  torch.from_numpy(P2), torch.from_numpy(A),
                                  torch.from_numpy(mts), t=t,
                                  storage_dtype=getattr(torch, storage))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.equal(got[:, t:], ref[:, t:])
    nnz = int((ref[:, t:] > 0).sum())
    assert nnz > 0
    bits = torch.int8 if storage == "int8" else torch.int16
    d = (got[:, :t].view(bits).int() - ref[:, :t].view(bits).int()).abs()
    assert int(d.max()) <= 1
    assert int((d > 0).sum()) <= 1e-3 * nnz


@pytest.mark.parametrize("kind", KINDS)
def test_gate_shares_count_each_stage(kind):
    """harness.gate_shares, the survivor shares the benchmarks print,
    against a count in numpy f64 on the same points (away from the gate's
    edge the two agree; at most the planted edge pairs may differ) and
    against the plain build: every kept pair is queued, every queued pair
    passes the gate; point-normal, every kept pair passes both gates."""
    _, inv_t = _invariants(kind)
    W, m = 2, 256
    P1, P2, A, plants = harness.gate_boundary_endpoints(inv_t, W, m, 8)
    mts = np.array([m, 200])
    X1, X2, At = (torch.from_numpy(x) for x in (P1, P2, A))
    shares = harness.gate_shares(inv_t, X1, X2, At, torch.from_numpy(mts))
    assert set(shares) == ({"gate", "queued", "both"} if kind == "pointnormal"
                           else {"gate", "queued"})
    pairs = W * m * (m - 1) // 2
    iu = np.triu_indices(m, 1)
    l1 = np.linalg.norm(P1[:, :, None, :3] - P1[:, None, :, :3], axis=-1)
    l2 = np.linalg.norm(P2[:, :, None, :3] - P2[:, None, :, :3], axis=-1)
    p = inv_t.params
    gate = np.abs(l1 - l2)[:, iu[0], iu[1]] < (p.epsp if kind == "pointnormal"
                                              else p.epsilon)
    assert abs(shares["gate"] * pairs - gate.sum()) <= 2 * len(plants)
    _, C = pairwise_from_endpoints(inv_t, X1, X2, At,
                                   m_true=torch.from_numpy(mts))
    kept = int((C[:, iu[0], iu[1]] > 0).sum())
    assert 0 < kept <= shares["queued"] * pairs <= shares["gate"] * pairs
    if kind == "pointnormal":
        assert kept <= shares["both"] * pairs <= shares["queued"] * pairs
