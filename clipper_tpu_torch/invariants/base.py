"""Invariant protocol: vectorized geometric-consistency scoring.

Counterpart of ``clipper_tpu/invariants/base.py`` (reference:
include/clipper/invariants/abstract.h:56-72). An invariant is a callable on
tensors of endpoints with broadcasting,

    scores = invariant(ai, aj, bi, bj)   # (..., d) x4 -> (...)

and built-ins override :meth:`score_matrix` / :meth:`score_block` with
structured forms. Leading batch dimensions broadcast through every method.
"""

from __future__ import annotations

import torch


class PairwiseInvariant:
    """Base class for pairwise geometric invariants.

    ``symmetric``: True when score(i, j) == score(j, i) exactly; symmetric
    invariants allow the one-pass (no upper-triangle mirror) builds.
    """

    symmetric: bool = False

    def __call__(self, ai, aj, bi, bj):
        """Score consistency of associations (ai->bi) and (aj->bj):
        (..., d) endpoints -> (...,) scores in [0, 1]."""
        raise NotImplementedError

    def score_matrix(self, P1: torch.Tensor, P2: torch.Tensor) -> torch.Tensor:
        """(..., m, m) pairwise scores from gathered (..., m, d) endpoints."""
        return self(P1[..., :, None, :], P1[..., None, :, :],
                    P2[..., :, None, :], P2[..., None, :, :])

    def score_block(self, P1r, P1c, P2r, P2c) -> torch.Tensor:
        """(..., mr, mc) score tile between a row block and a column block;
        equals the corresponding tile of :meth:`score_matrix`."""
        return self(P1r[..., :, None, :], P1c[..., None, :, :],
                    P2r[..., :, None, :], P2c[..., None, :, :])


Invariant = PairwiseInvariant
