"""Affinity / constraint matrix construction.

Counterpart of ``clipper_tpu/ops/affinity.py`` (reference:
src/clipper.cpp:21-65): for each pair of associations, score 0 if they
share an endpoint in either dataset (distinctness), else the invariant's
score, kept only strictly above ``affinityeps``. M carries a zero diagonal
(the solver adds the implicit identity); C is the 0/1 pattern of M.
Every function broadcasts over a leading problem dimension.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from clipper_tpu_torch.invariants.base import PairwiseInvariant
from clipper_tpu_torch.solvers.msrc_flat import _INT8_SCALE
from clipper_tpu_torch.types import as_association


def create_all_to_all(n1: int, n2: int, device=None) -> torch.Tensor:
    """All-to-all association hypothesis, row-major over (i, j): A[k] =
    (k // n2, k % n2) (reference: include/clipper/utils.h:61-71)."""
    i = torch.arange(n1, dtype=torch.int32, device=device).repeat_interleave(n2)
    j = torch.arange(n2, dtype=torch.int32, device=device).repeat(n1)
    return torch.stack([i, j], dim=1)


def build_affinity(invariant: PairwiseInvariant, D1: torch.Tensor,
                   D2: torch.Tensor, A: Optional[torch.Tensor] = None, *,
                   affinityeps: float = 1e-4, dtype=None):
    """Dense symmetric (M, C) from (n, d) row-major data and (m, 2)
    associations (all-to-all when A is None): the facade's dense build.
    Returns (M, C, A) with zero-diagonal M, its 0/1 pattern C, and the
    int32 association tensor used. Computed in ``dtype`` (default D1's)."""
    if A is None:
        A = create_all_to_all(D1.shape[0], D2.shape[0], device=D1.device)
    A = as_association(A, device=D1.device)
    dtype = dtype or D1.dtype
    M, C = score_pairwise_consistency(invariant, D1.to(dtype), D2.to(dtype),
                                      A, affinityeps=affinityeps)
    return M, C, A


def distinctness_mask(A: torch.Tensor) -> torch.Tensor:
    """(..., m, m) bool: True where associations i and j share no endpoint
    (reference: src/clipper.cpp:35-38). The diagonal is False."""
    same1 = A[..., :, 0, None] == A[..., None, :, 0]
    same2 = A[..., :, 1, None] == A[..., None, :, 1]
    return ~(same1 | same2)


def gather_endpoints(D1, D2, A) -> Tuple[torch.Tensor, torch.Tensor]:
    """P1 = D1[A[..., 0]], P2 = D2[A[..., 1]]; D1/D2 may be shared (n, d)
    or per problem (W, n, d) when A is (W, m, 2). A negative index counts
    from the end, as in indexing (pad rows carry A = -1)."""
    A = A.long()

    def take(D, a):
        if D.dim() == a.dim() + 1:        # one dataset per problem
            a = torch.where(a < 0, a + D.shape[-2], a)
            return torch.gather(D, -2, a[..., None].expand(
                *a.shape, D.shape[-1]))
        return D[a]

    return take(D1, A[..., 0]), take(D2, A[..., 1])


def _keep_mask(invariant, P1, P2, A, affinityeps, m_true):
    scores = invariant.score_matrix(P1, P2)
    keep = distinctness_mask(A) & (scores > affinityeps)
    if m_true is not None:
        m = A.shape[-2]
        mt = torch.as_tensor(m_true, device=A.device)
        valid = torch.arange(m, device=A.device) < mt[..., None]
        keep = keep & valid[..., :, None] & valid[..., None, :]
    return scores, keep


def pairwise_from_endpoints(invariant: PairwiseInvariant, P1, P2, A, *,
                            affinityeps: float = 1e-4,
                            m_true=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, C) from gathered (..., m, d) endpoints; see
    :func:`score_pairwise_consistency`."""
    scores, keep = _keep_mask(invariant, P1, P2, A, affinityeps, m_true)
    if getattr(invariant, "symmetric", False):
        M = torch.where(keep, scores, 0.0)
        return M, keep.to(scores.dtype)
    # mirror the strict upper triangle (reference: src/clipper.cpp:31-32)
    Mu = torch.triu(torch.where(keep, scores, 0.0), diagonal=1)
    Cu = torch.triu(keep, diagonal=1)
    return (Mu + Mu.transpose(-1, -2),
            (Cu | Cu.transpose(-1, -2)).to(scores.dtype))


def score_pairwise_consistency(invariant: PairwiseInvariant, D1, D2, A, *,
                               affinityeps: float = 1e-4,
                               m_true=None) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Dense symmetric (M, C) for a fixed association set.

    m_true: optional scalar or (W,) — rows/cols >= m_true are zeroed in both
    M and C (exact padding for mixed-size batches).
    """
    P1, P2 = gather_endpoints(D1, D2, A)
    return pairwise_from_endpoints(invariant, P1, P2, A,
                                   affinityeps=affinityeps, m_true=m_true)


def stored_from_endpoints(invariant: PairwiseInvariant, P1, P2, A, *,
                          affinityeps: float = 1e-4, m_true=None,
                          storage_dtype=torch.int8) -> torch.Tensor:
    """Stacked [M; C] in the storage dtype from gathered endpoints; see
    :func:`score_consistency_stored`."""
    scores, keep = _keep_mask(invariant, P1, P2, A, affinityeps, m_true)
    if not getattr(invariant, "symmetric", False):
        keep = torch.triu(keep, diagonal=1)
        scores = torch.where(keep, scores, 0.0)
        scores = scores + scores.transpose(-1, -2)
        keep = keep | keep.transpose(-1, -2)
    if storage_dtype == torch.int8:
        Mq = torch.clamp(torch.round(torch.where(keep, scores, 0.0)
                                     * _INT8_SCALE), 0, 127).to(torch.int8)
        Cq = torch.where(keep, int(_INT8_SCALE), 0).to(torch.int8)
    else:
        Mq = torch.where(keep, scores, 0.0).to(storage_dtype)
        Cq = keep.to(storage_dtype)
    return torch.cat([Mq, Cq], dim=-2)


def score_consistency_stored(invariant: PairwiseInvariant, D1, D2, A, *,
                             affinityeps: float = 1e-4, m_true=None,
                             storage_dtype=torch.int8) -> torch.Tensor:
    """Stacked (..., 2m, m) [M; C] directly in the storage dtype: int8
    codes clip(round_half_even(127 s), 0, 127) and C = 127, or the raw
    values cast to a float storage dtype."""
    P1, P2 = gather_endpoints(D1, D2, A)
    return stored_from_endpoints(invariant, P1, P2, A,
                                 affinityeps=affinityeps, m_true=m_true,
                                 storage_dtype=storage_dtype)
