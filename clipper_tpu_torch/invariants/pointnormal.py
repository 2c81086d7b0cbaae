"""Point-normal pairwise invariant (planes / surfels / patches).

Counterpart of ``clipper_tpu/invariants/pointnormal.py`` (reference:
src/invariants/pointnormal_distance.cpp:13-35, defaults from
include/clipper/invariants/pointnormal_distance.h:25-31). A datum is a
6-vector: a point, then a unit normal.

    l1, l2   = intra-set point distances
    a1, a2   = intra-set normal angles  acos(ni . nj)
    dp = |l1 - l2|,  dn = |a1 - a2|
    score = exp(-dp^2/(2 sigp^2)) * exp(-dn^2/(2 sign^2))   if dp<epsp and dn<epsn
            0                                               otherwise

The dot product is clamped to [-1, 1] before acos (the reference's raw
std::acos gives NaN just outside it). Each score is computed as the JAX
expression is, in the same order: exp(((-0.5 d) d) / s) with s = sig *
sig formed in double and applied in the working dtype, gated by the
strict comparisons. The build kernels (csrc/pointnormal_score.cuh) repeat
these steps, with the inner products of ops/pairwise.cross_inner_matrix.
"""

from __future__ import annotations

import dataclasses

import torch

from clipper_tpu_torch.invariants.base import BuiltinScore, PairwiseInvariant
from clipper_tpu_torch.ops.pairwise import (cross_distance_matrix,
                                            cross_distance_rt,
                                            cross_inner_matrix,
                                            pairwise_distance_matrix,
                                            pairwise_inner_matrix)


@dataclasses.dataclass(frozen=True)
class PointNormalDistanceParams:
    sigp: float = 0.5    # point: spread of exponential kernel
    epsp: float = 0.5    # point: consistency bound
    sign: float = 0.10   # normal: spread of exponential kernel
    epsn: float = 0.35   # normal: consistency bound


def _acos(dot):
    return torch.arccos(torch.clamp(dot, -1.0, 1.0))


class PointNormalDistance(PairwiseInvariant):
    symmetric = True

    def __init__(self, params: PointNormalDistanceParams = PointNormalDistanceParams()):
        self.params = params

    def cuda_score(self) -> BuiltinScore:
        """Kind 1 (csrc/pointnormal_score.cuh): (sigp^2, epsp, sign^2,
        epsn)."""
        p = self.params
        return BuiltinScore(1, 6, (p.sigp * p.sigp, p.epsp, p.sign * p.sign,
                                   p.epsn))

    def _score(self, l1, l2, a1, a2):
        p = self.params
        dp = torch.abs(l1 - l2)
        dn = torch.abs(a1 - a2)
        # divide by tensors on the device: PyTorch's CUDA division by a
        # Python scalar multiplies by its f32 reciprocal instead
        sp2 = torch.full((), p.sigp * p.sigp, dtype=dp.dtype, device=dp.device)
        sn2 = torch.full((), p.sign * p.sign, dtype=dp.dtype, device=dp.device)
        sp = torch.exp(-0.5 * dp * dp / sp2)
        sn = torch.exp(-0.5 * dn * dn / sn2)
        return torch.where((dp < p.epsp) & (dn < p.epsn), sp * sn, 0.0)

    def __call__(self, ai, aj, bi, bj):
        l1 = torch.linalg.vector_norm(ai[..., :3] - aj[..., :3], dim=-1)
        l2 = torch.linalg.vector_norm(bi[..., :3] - bj[..., :3], dim=-1)
        a1 = _acos((ai[..., 3:6] * aj[..., 3:6]).sum(-1))
        a2 = _acos((bi[..., 3:6] * bj[..., 3:6]).sum(-1))
        return self._score(l1, l2, a1, a2)

    def score_matrix(self, P1, P2):
        l1 = pairwise_distance_matrix(P1[..., :3])
        l2 = pairwise_distance_matrix(P2[..., :3])
        a1 = _acos(pairwise_inner_matrix(P1[..., 3:6]))
        a2 = _acos(pairwise_inner_matrix(P2[..., 3:6]))
        return self._score(l1, l2, a1, a2)

    def score_block(self, P1r, P1c, P2r, P2c):
        l1 = cross_distance_matrix(P1r[..., :3], P1c[..., :3])
        l2 = cross_distance_matrix(P2r[..., :3], P2c[..., :3])
        a1 = _acos(cross_inner_matrix(P1r[..., 3:6], P1c[..., 3:6]))
        a2 = _acos(cross_inner_matrix(P2r[..., 3:6], P2c[..., 3:6]))
        return self._score(l1, l2, a1, a2)

    def score_block_t(self, P1r, P1ct, P2r, P2ct):
        """score_block with the column blocks given as (..., 6, mc); the
        same arithmetic (the JAX package's Pallas build takes this form)."""
        l1 = cross_distance_rt(P1r[..., :3], P1ct[..., :3, :])
        l2 = cross_distance_rt(P2r[..., :3], P2ct[..., :3, :])
        a1 = _acos(cross_inner_matrix(P1r[..., 3:6],
                                      P1ct[..., 3:6, :].transpose(-1, -2)))
        a2 = _acos(cross_inner_matrix(P2r[..., 3:6],
                                      P2ct[..., 3:6, :].transpose(-1, -2)))
        return self._score(l1, l2, a1, a2)
