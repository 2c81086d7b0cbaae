"""Port parity: the stacked [M; C] direct-to-storage build.

Mirrors tests/test_affinity_pallas.py (:79-135): the JAX package's
score_consistency_stored_pallas (interpret mode on the CPU) against
clipper_tpu_torch.ops.affinity_pallas, whose CPU tensors take the plain
build ops.affinity.score_consistency_stored.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipper_tpu.bench import harness as jharness
from clipper_tpu.ops import affinity_pallas as jap
from clipper_tpu_torch import _kernels
from clipper_tpu_torch.bench import harness
from clipper_tpu_torch.invariants.base import PairwiseInvariant
from clipper_tpu_torch.ops import affinity_pallas
from clipper_tpu_torch.ops.affinity import (gather_endpoints,
                                            score_consistency_stored)


def _bunny(m, seed):
    rng = np.random.default_rng(seed)
    pcd0 = harness.load_bunny().astype(np.float32)
    pcd1, A, _ = harness.make_problem(pcd0, m, 0.9, rng)
    return pcd0, pcd1.astype(np.float32), A.astype(np.int32)


def _assert_storage_close(got, ref, m):
    """C half exact; M codes within one code (int8) or one bf16 ulp at a
    counted few entries: round(127 s) and bf16(s) ties moved by an ulp of
    exp or sqrt (the ROADMAP storage bar)."""
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape == (2 * m, m), (got.shape, ref.shape)
    n_c = int((got[m:] != ref[m:]).sum())
    d = np.abs(got[:m] - ref[:m])
    step = np.maximum(np.abs(ref[:m]), 1.0) * 2.0 ** -7   # one code / ulp
    edges = int((ref[m:] > 0).sum())
    what = (f"C entries differing {n_c}; M entries differing "
            f"{int((d > 0).sum())} (bar {max(2, 1e-3 * edges)}, {edges} "
            f"edges), past one code {int((d > step).sum())}, max difference "
            f"{float(d.max())}")
    assert n_c == 0, what
    assert (d <= step).all(), what
    assert (d > 0).sum() <= max(2, 1e-3 * edges), what


@pytest.mark.parametrize("storage", ["int8", "bfloat16"])
@pytest.mark.parametrize("m,m_true", [(256, None), (256, 180), (200, None),
                                      (200, 150)])
def test_stored_build_matches_jax(storage, m, m_true):
    """m = 256 and m = 200 (no tile divides it), with m_true < m: the
    port's function on the CPU against JAX's kernel; no launch counted;
    the output equals its transpose."""
    D1, D2, A = _bunny(m, seed=m + (m_true or 0))
    inv_j = jharness.default_invariant()
    ref = jap.score_consistency_stored_pallas(
        inv_j, jnp.asarray(D1), jnp.asarray(D2), jnp.asarray(A),
        m_true=m_true, storage_dtype=getattr(jnp, storage), tile=128)
    before = dict(_kernels.LAUNCHES)
    got = affinity_pallas.score_consistency_stored_pallas(
        harness.default_invariant(), torch.from_numpy(D1),
        torch.from_numpy(D2), torch.from_numpy(A), m_true=m_true,
        storage_dtype=getattr(torch, storage))
    moved = {k: (before.get(k), _kernels.LAUNCHES.get(k))
             for k in set(before) | set(_kernels.LAUNCHES)
             if before.get(k) != _kernels.LAUNCHES.get(k)}
    assert not moved, f"launches counted on the CPU: {moved}"
    assert got.dtype == getattr(torch, storage)
    _assert_storage_close(got, ref, m)
    for name, half in (("M", got[:m]), ("C", got[m:])):
        assert torch.equal(half, half.T), \
            f"{name} half not symmetric at {int((half != half.T).sum())}"
    if m_true is not None:
        assert not got[:, m_true:].any() and not got[m_true:m].any()


def test_batched_build_equals_per_problem():
    """A (W, m, 2) batch with per-problem datasets and m_true equals the
    one-problem calls, and the plain build it wraps."""
    m = 200
    probs = [_bunny(m, seed=s) for s in (1, 2, 3)]
    D1 = torch.from_numpy(probs[0][0])
    D2s = torch.from_numpy(np.stack([p[1] for p in probs]))
    As = torch.from_numpy(np.stack([p[2] for p in probs]))
    mts = torch.tensor([m, 120, m])
    inv = harness.default_invariant()
    out = affinity_pallas.score_consistency_stored_pallas(
        inv, D1, D2s, As, m_true=mts)
    assert out.shape == (3, 2 * m, m) and out.dtype == torch.int8
    for w in range(3):
        one = affinity_pallas.score_consistency_stored_pallas(
            inv, D1, D2s[w], As[w], m_true=int(mts[w]))
        assert torch.equal(out[w], one)
        assert torch.equal(one, score_consistency_stored(
            inv, D1, D2s[w], As[w], m_true=int(mts[w])))


def test_guards():
    class Asym(PairwiseInvariant):
        symmetric = False

    A = torch.zeros(8, 2, dtype=torch.int32)
    D = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="symmetric"):
        affinity_pallas.score_consistency_stored_pallas(Asym(), D, D, A)
    P1, P2 = gather_endpoints(D, D[None], A[None])
    inv = harness.default_invariant()
    mts = torch.tensor([8])
    with pytest.raises(ValueError, match="on the card"):
        affinity_pallas.stored_build_cuda(inv, P1, P2, A[None], mts)
    with pytest.raises(NotImplementedError, match="EuclideanDistance"):
        affinity_pallas.stored_build_cuda(object(), P1, P2, A[None], mts)
    with pytest.raises(NotImplementedError, match="int8 or bf16"):
        affinity_pallas.stored_build_cuda(inv, P1, P2, A[None], mts,
                                          storage_dtype=torch.float32)


@pytest.mark.parametrize("nt", range(1, 18))
def test_stored_tile_pair_enumerates_upper_triangle(nt):
    """The stacked build kernel's block -> tile pair map (its Python
    mirror, step for step) walks the unordered tile pairs I <= J of nt x
    nt tiles row-major, each once: block k of nt (nt + 1) / 2."""
    pairs = [(i, j) for i in range(nt) for j in range(i, nt)]
    assert [affinity_pallas.stored_tile_pair(k, nt)
            for k in range(len(pairs))] == pairs
