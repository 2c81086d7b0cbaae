"""Pairwise-distance primitives for affinity construction.

Counterpart of ``clipper_tpu/ops/pairwise.py``. Two forms that round
differently, both kept:

- small d (point clouds, d <= 8): coordinate-unrolled broadcast
  differences, summed ((0 + dx^2) + dy^2) + dz^2 in coordinate order —
  no Gram cancellation. The build kernel (csrc/tri_build.cu) repeats this
  order step by step.
- large d: the Gram identity ||x - y||^2 = ||x||^2 + ||y||^2 - 2 x.y.

The inner products (the point-normal invariant's normal angles) follow
the same rule. Every function broadcasts over leading batch dimensions.
"""

from __future__ import annotations

import torch

_GRAM_DIM_THRESHOLD = 8


def _unrolled_sqdist(Pr: torch.Tensor, Pc: torch.Tensor) -> torch.Tensor:
    d = Pr.shape[-1]
    sq = torch.zeros(Pr.shape[:-1] + Pc.shape[-2:-1], dtype=Pr.dtype,
                     device=Pr.device)
    for k in range(d):
        diff = Pr[..., :, k, None] - Pc[..., None, :, k]
        sq = sq + diff * diff
    return sq


def pairwise_sqdist_matrix(P: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distance matrix of the rows of P: (..., m, d) ->
    (..., m, m)."""
    if P.shape[-1] <= _GRAM_DIM_THRESHOLD:
        return _unrolled_sqdist(P, P)
    g = P @ P.transpose(-1, -2)
    sq = torch.diagonal(g, dim1=-2, dim2=-1)
    out = sq[..., :, None] + sq[..., None, :] - 2.0 * g
    return torch.clamp(out, min=0.0)


def pairwise_distance_matrix(P: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(pairwise_sqdist_matrix(P))


def cross_sqdist_matrix(Pr: torch.Tensor, Pc: torch.Tensor) -> torch.Tensor:
    """Squared distances between row sets: (..., mr, d) x (..., mc, d) ->
    (..., mr, mc)."""
    if Pr.shape[-1] <= _GRAM_DIM_THRESHOLD:
        return _unrolled_sqdist(Pr, Pc)
    g = Pr @ Pc.transpose(-1, -2)
    out = ((Pr * Pr).sum(-1)[..., :, None] + (Pc * Pc).sum(-1)[..., None, :]
           - 2.0 * g)
    return torch.clamp(out, min=0.0)


def cross_distance_matrix(Pr: torch.Tensor, Pc: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(cross_sqdist_matrix(Pr, Pc))


def cross_inner_matrix(Pr: torch.Tensor, Pc: torch.Tensor) -> torch.Tensor:
    """Inner products between row sets: (..., mr, d) x (..., mc, d) ->
    (..., mr, mc). For d <= 8 the products are summed ((0 + x0 y0) + x1 y1)
    + ... in coordinate order, elementwise: the build kernels repeat that
    order, and the result depends on no BLAS and no TF32 flag. Larger d
    contracts with a matmul, as the JAX package's ``P @ P.T`` does."""
    if Pr.shape[-1] > _GRAM_DIM_THRESHOLD:
        return Pr @ Pc.transpose(-1, -2)
    g = torch.zeros(Pr.shape[:-1] + Pc.shape[-2:-1], dtype=Pr.dtype,
                    device=Pr.device)
    for k in range(Pr.shape[-1]):
        g = g + Pr[..., :, k, None] * Pc[..., None, :, k]
    return g


def pairwise_inner_matrix(P: torch.Tensor) -> torch.Tensor:
    """Inner-product (Gram) matrix of the rows of P: (..., m, d) ->
    (..., m, m); see :func:`cross_inner_matrix`."""
    return cross_inner_matrix(P, P)


def cross_sqdist_rt(Pr: torch.Tensor, Pct: torch.Tensor) -> torch.Tensor:
    """Squared distances with the column set pre-transposed: (..., mr, d) x
    (..., d, mc) -> (..., mr, mc), the same arithmetic as
    :func:`cross_sqdist_matrix`'s unrolled form for any d (the JAX
    package's form for its Pallas builds)."""
    return _unrolled_sqdist(Pr, Pct.transpose(-1, -2))


def cross_distance_rt(Pr: torch.Tensor, Pct: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(cross_sqdist_rt(Pr, Pct))
