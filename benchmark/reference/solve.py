"""The upstream solver in plain PyTorch, for the judge and the control.

Graduated projected gradient ascent with the homotopy on the penalty d
(mit-acl/clipper src/clipper.cpp:172-323) over dense (m, m) M and C,
then DSD_HEU rounding (:func:`judge.round_dsd_heu`). Every tolerance is
floored at 100 times the working dtype's epsilon times its scale (the
activity threshold at 2000 times), so that a solve in a low precision
ends; in float64 the upstream values hold. The judge runs it in float64
for ``solve_shortfall``; the control puts it in the program's place, in
a lower precision than the configuration states (``control.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch

TOL_U, TOL_F, EPS = 1e-8, 1e-9, 1e-9
MAX_INNER, MAX_OUTER, BETA, MAX_LS = 200, 1000, 0.25, 99


def _floor(value: float, factor: float, scale, dtype) -> float:
    return max(value, factor * torch.finfo(dtype).eps * float(scale))


def pga(M: torch.Tensor, C: torch.Tensor, u0: torch.Tensor
        ) -> Tuple[torch.Tensor, float, int]:
    """(u, F, outer iterations) from u0 over M and C (zero diagonals, the
    identity implicit), computed in M's dtype."""
    dtype = M.dtype
    ones = torch.ones((), dtype=dtype, device=M.device)

    def mv_md(u, d):
        return M @ u + (C @ u) * d

    def grad(u, d):
        return (1.0 + d) * u - d * u.sum() + mv_md(u, d)

    def d_terms(u):
        su = u.sum()
        cbu = su - C @ u - u
        act = (cbu > _floor(EPS, 2000.0, su, dtype)) & (u > EPS)
        ratio = (M @ u + u) / torch.where(act, cbu, ones)
        return act, ratio

    u = u0.to(dtype)
    u = M @ u + u
    u = u / torch.linalg.vector_norm(u)
    act, ratio = d_terms(u)
    d = ratio[act].mean() if bool(act.any()) else torch.zeros_like(ones)
    tol_u = _floor(TOL_U, 100.0, 1.0, dtype)
    i, F = 0, torch.zeros_like(ones)
    while i < MAX_OUTER:
        g = grad(u, d)
        F = u @ g
        for _ in range(MAX_INNER):
            alpha = 1.0
            for _ in range(MAX_LS):
                un = torch.clamp(u + alpha * g, min=0.0)
                un = un / torch.linalg.vector_norm(un)
                gn = grad(un, d)
                Fn = un @ gn
                dF = Fn - F
                if not bool(dF < -_floor(EPS, 100.0, abs(float(F)), dtype)):
                    break
                alpha *= BETA
            du = float(torch.linalg.vector_norm(un - u))
            u, g, F = un, gn, Fn
            if du < tol_u or abs(float(dF)) < _floor(TOL_F, 100.0,
                                                      abs(float(F)), dtype):
                break
        act, ratio = d_terms(u)
        if not bool(act.any()):
            break
        d = d + ratio[act].abs().mean()
        i += 1
    return u, float(F), i

