"""Rigid-transform estimation from selected correspondences.

Counterpart of ``clipper_tpu/utils/transforms.py``. The reference library
leaves SE(3) recovery to examples (Open3D point-to-point in the ex4
notebook; SVD/Procrustes on plane parameters in reference:
examples/matlab/ex3_planecloud.m:100-115); this ships it as an op:
weighted Kabsch/Umeyama alignment via ``torch.linalg.svd``, on the
inputs' device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def kabsch_se3(P, Q, weights=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-fit rotation R and translation t with R @ P_i + t ~= Q_i.

    Args:
        P: (n, 3) source points (tensor or array).
        Q: (n, 3) target points.
        weights: optional (n,) nonnegative weights (e.g. the solver's u).

    Returns:
        (R, t): (3, 3) rotation (det +1) and (3,) translation, tensors of
        P's dtype on P's device.
    """
    P = torch.as_tensor(P)
    Q = torch.as_tensor(Q, dtype=P.dtype, device=P.device)
    if weights is None:
        weights = torch.ones(P.shape[0], dtype=P.dtype, device=P.device)
    weights = torch.as_tensor(weights, dtype=P.dtype, device=P.device)
    w = weights / torch.clamp_min(torch.sum(weights), 1e-30)

    mu_p = torch.sum(P * w[:, None], dim=0)
    mu_q = torch.sum(Q * w[:, None], dim=0)
    Pc = P - mu_p
    Qc = Q - mu_q

    H = (Pc * w[:, None]).T @ Qc
    U, _, Vt = torch.linalg.svd(H)
    det = torch.linalg.det(Vt.T @ U.T)
    D = torch.diag(torch.stack([torch.ones_like(det), torch.ones_like(det),
                                det]))
    R = Vt.T @ D @ U.T
    t = mu_q - R @ mu_p
    return R, t


def transform_rmse(P, Q, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """RMSE of R @ P + t vs Q."""
    P = torch.as_tensor(P, dtype=R.dtype, device=R.device)
    Q = torch.as_tensor(Q, dtype=R.dtype, device=R.device)
    resid = (P @ R.T + t) - Q
    return torch.sqrt(torch.mean(torch.sum(resid * resid, dim=-1)))
