"""MSRC solver helpers: thresholds, stall guard and rounding.

Counterpart of the main-path subset of ``clipper_tpu/solvers/msrc.py``
(:70-133, :292-311); the nested solver itself is not ported yet (see
ROADMAP.md, Queue 1 item 9). Working dtypes are explicit ``torch.dtype``s.
"""

from __future__ import annotations

import torch

from clipper_tpu_torch.types import Rounding


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x over mask along the last dimension (0 where empty)."""
    cnt = mask.sum(-1)
    return torch.where(mask, x, 0.0).sum(-1) / torch.clamp(cnt, min=1)


# Dtype-aware numerical thresholds: every threshold is floored at 100x the
# dtype's machine epsilon times the quantity's scale (see the JAX module for
# the measured rationale). In f64 the reference values dominate.
_EPS_FACTOR = 100.0
_ACTIVITY_FACTOR = 2000.0


def _floor(factor: float, dtype: torch.dtype) -> float:
    # the product is formed in the working dtype, as numpy/JAX do
    return float(torch.tensor(factor, dtype=dtype)
                 * torch.finfo(dtype).eps)


def _eps_like(params_eps, scale, dtype: torch.dtype):
    scale = torch.as_tensor(scale, dtype=dtype)
    return torch.maximum(torch.tensor(params_eps, dtype=dtype,
                                      device=scale.device),
                         _floor(_EPS_FACTOR, dtype) * scale)


def _eps_active(params_eps, scale, dtype: torch.dtype):
    scale = torch.as_tensor(scale, dtype=dtype)
    return torch.maximum(torch.tensor(params_eps, dtype=dtype,
                                      device=scale.device),
                         _floor(_ACTIVITY_FACTOR, dtype) * scale)


# Stalled-homotopy guard (reduced-precision modes only): a lane whose inner
# loop converges without moving u for this many consecutive outers stops.
_STALL_OUTERS = 3


def _stall_guard_enabled(dtype: torch.dtype) -> bool:
    return dtype != torch.float64


def round_solution(u: torch.Tensor, F: torch.Tensor,
                   rounding: Rounding = Rounding.DSD_HEU) -> torch.Tensor:
    """(..., m) bool mask of selected vertices.

    NONZERO (reference: src/clipper.cpp:290-292) and DSD_HEU
    (reference: src/clipper.cpp:302-309): the round(F) largest entries of
    u, ranked by a STABLE descending sort so ties (zeros) at the omega
    boundary select the same vertices as the JAX package.
    """
    if rounding == Rounding.NONZERO:
        return u > 0.0
    if rounding == Rounding.DSD_HEU:
        omega = torch.floor(F + 0.5).to(torch.int32)
        m = u.shape[-1]
        order = torch.argsort(-u, dim=-1, stable=True)
        ar = torch.arange(m, dtype=torch.int32, device=u.device)
        ranks = torch.empty_like(order, dtype=torch.int32).scatter_(
            -1, order, ar.expand_as(order).contiguous())
        return ranks < omega[..., None]
    raise ValueError(f"rounding {rounding} not supported in the pipelines; "
                     "DSD rounding needs the host solver")
