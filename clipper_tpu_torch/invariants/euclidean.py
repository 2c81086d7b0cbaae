"""Euclidean-distance pairwise invariant.

Counterpart of ``clipper_tpu/invariants/euclidean.py`` (reference:
src/invariants/euclidean_distance.cpp:13-31):

    l1 = ||ai - aj||,  l2 = ||bi - bj||
    0                                  if mindist > 0 and min(l1, l2) < mindist
    c = |l1 - l2|
    exp(-c^2 / (2 sigma^2))            if c < epsilon
    0                                  otherwise

The score is computed as exp(((-0.5 c) c) / s2) with s2 = sigma * sigma
formed in double and applied in the working dtype, as the JAX package
does; the build kernel (csrc/tri_build.cu) uses the same order.
"""

from __future__ import annotations

import dataclasses

import torch

from clipper_tpu_torch.invariants.base import BuiltinScore, PairwiseInvariant
from clipper_tpu_torch.ops.pairwise import (cross_distance_matrix,
                                            pairwise_distance_matrix)


@dataclasses.dataclass(frozen=True)
class EuclideanDistanceParams:
    sigma: float = 0.01     # spread ("variance") of the exponential kernel
    epsilon: float = 0.06   # consistency bound: inlier/outlier gate
    mindist: float = 0.0    # min allowable intra-set distance between inliers


class EuclideanDistance(PairwiseInvariant):
    symmetric = True

    def __init__(self, params: EuclideanDistanceParams = EuclideanDistanceParams()):
        self.params = params

    def cuda_score(self) -> BuiltinScore:
        """Kind 0 (csrc/euclid_score.cuh): (sigma^2, epsilon, mindist, 0)."""
        p = self.params
        return BuiltinScore(0, 3, (p.sigma * p.sigma, p.epsilon, p.mindist,
                                   0.0))

    def _score_from_lengths(self, l1, l2):
        p = self.params
        c = torch.abs(l1 - l2)
        # divide by a tensor on c's device: PyTorch's CUDA division by a
        # Python scalar multiplies by its f32 reciprocal instead, which can
        # move the score by an ulp and an int8 code by one
        s2 = torch.full((), p.sigma * p.sigma, dtype=c.dtype, device=c.device)
        scr = torch.where(c < p.epsilon, torch.exp(-0.5 * c * c / s2), 0.0)
        if p.mindist > 0:
            scr = torch.where((l1 < p.mindist) | (l2 < p.mindist), 0.0, scr)
        return scr

    def __call__(self, ai, aj, bi, bj):
        l1 = torch.linalg.vector_norm(ai - aj, dim=-1)
        l2 = torch.linalg.vector_norm(bi - bj, dim=-1)
        return self._score_from_lengths(l1, l2)

    def score_matrix(self, P1, P2):
        return self._score_from_lengths(pairwise_distance_matrix(P1),
                                        pairwise_distance_matrix(P2))

    def score_block(self, P1r, P1c, P2r, P2c):
        return self._score_from_lengths(cross_distance_matrix(P1r, P1c),
                                        cross_distance_matrix(P2r, P2c))

    def score_block_t(self, P1r, P1ct, P2r, P2ct):
        """score_block with the column blocks given as (..., d, mc); the
        same arithmetic (the JAX package's Pallas build takes this form)."""
        return self.score_block(P1r, P1ct.transpose(-1, -2),
                                P2r, P2ct.transpose(-1, -2))
