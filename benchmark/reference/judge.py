"""The numbers that judge an answer against the plain reference.

For one problem (its datasets, associations and the configuration) and
one answer (u, the objective F and the selected mask), the reference
works M and C out again from the inputs in float64 (``scores``) on the
rows of u's support S = {i : u_i > 0} and judges:

- ``objective_err``: |F - u'(M + I)u| / u'(M + I)u, the objective the
  answer reports against the one its own u has (the polish or the
  in-loop objective, and through it the build);
- ``solve_shortfall``: max(0, F* - u'(M + I)u) / F*, with F* the
  objective that the upstream solver (``solve.pga``) reaches in float64
  from the same u0 over the same M and C: whether the answer's u got as
  far as the solver does (a solve cut short, fewer steps or a looser
  tolerance, or a u on a smaller cluster reads above 0; an answer that
  found a better cluster than the reference's reads 0);
- ``support_inconsistency``: the largest mass of u that a vertex of S
  finds on vertices of S inconsistent with it, over the mass of u: the
  homotopy ends only when no vertex of the support carries more than the
  activity threshold (upstream src/clipper.cpp:218-281; the port's
  float32 threshold is 2000 eps32 of that mass), so a solve that ran
  leaves a consistent support;
- ``mask_err``: the vertices where the mask differs from the rounding of
  (u, F) (DSD_HEU: the round(F) largest entries of u, ties by index;
  upstream src/clipper.cpp:302-309), an exact comparison.

A dense answer's build is judged by :func:`build_numbers`: ``build_err``,
||M - M_ref||_F / ||M_ref||_F, and ``c_err``, the share of C's entries
that differ. An answer with no support or a non-finite entry reads inf
on every number. Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from benchmark.reference import scores, solve

ANSWER_NUMBERS = ("objective_err", "solve_shortfall",
                  "support_inconsistency", "mask_err")
BUILD_NUMBERS = ("build_err", "c_err")


def endpoints(D1, D2, A, device, dtype=torch.float64):
    """(P1, P2, A) gathered in ``dtype`` on ``device`` from NumPy or
    tensor inputs: P1 = D1[A[:, 0]], P2 = D2[A[:, 1]]."""
    D1 = torch.as_tensor(np.asarray(D1), dtype=dtype, device=device)
    D2 = torch.as_tensor(np.asarray(D2), dtype=dtype, device=device)
    A = torch.as_tensor(np.asarray(A), dtype=torch.long, device=device)
    return D1[A[:, 0]], D2[A[:, 1]], A


def round_dsd_heu(u: np.ndarray, F: float) -> np.ndarray:
    """The (m,) mask of the round(F) largest entries of u (F + 0.5
    floored in float32, as the answer's F is), ties by index."""
    omega = int(np.floor(np.float32(F) + np.float32(0.5)))
    order = np.argsort(-u, kind="stable")
    mask = np.zeros(u.shape[0], bool)
    mask[order[:max(0, omega)]] = True
    return mask


def best_objective(inv: dict, affinityeps: float, D1, D2, A, u0,
                   device) -> float:
    """F* of ``solve_shortfall``: u'(M + I)u of the upstream solver's u,
    run in float64 from u0 over the reference's M and C."""
    P1, P2, At = endpoints(D1, D2, A, device)
    M, C = scores.dense_mc(inv, P1, P2, At, affinityeps)
    u0 = torch.as_tensor(np.asarray(u0), dtype=torch.float64, device=device)
    u, _, _ = solve.pga(M, C, u0)
    return float(u @ (M @ u) + u @ u)


def answer_numbers(inv: dict, affinityeps: float, D1, D2, A, u, F, mask,
                   device, F_best: float,
                   budget: int = 1 << 25) -> Dict[str, float]:
    """The numbers of one answer (see the module docstring). u, mask:
    (m,) arrays or tensors; F a number; F_best the problem's
    :func:`best_objective` from the answer's u0."""
    u = np.asarray(torch.as_tensor(u).detach().cpu(), dtype=np.float64)
    mask = np.asarray(torch.as_tensor(mask).detach().cpu(), dtype=bool)
    F = float(F)
    support = np.flatnonzero(u > 0)
    if (not np.isfinite(u).all() or not math.isfinite(F) or support.size == 0
            or (u < 0).any()):
        return {k: math.inf for k in ANSWER_NUMBERS}
    P1, P2, At = endpoints(D1, D2, A, device)
    m = At.shape[0]
    ut = torch.as_tensor(u, device=device)
    S = torch.as_tensor(support, device=device)
    gS = torch.empty(S.numel(), dtype=torch.float64, device=device)
    bad_mass = torch.empty(S.numel(), dtype=torch.float64, device=device)
    step = scores.block_rows(m, budget)
    for s in range(0, S.numel(), step):
        rows = S[s:s + step]
        Mb, Cb = scores.mc_block(inv, P1, P2, At, rows, affinityeps)
        gS[s:s + step] = Mb @ ut + ut[rows]
        off = Cb[:, S] | (rows[:, None] == S[None, :])
        bad_mass[s:s + step] = (~off).double() @ ut[S]
    Fu = float(ut[S] @ gS)
    return {
        "objective_err": abs(F - Fu) / abs(Fu),
        "solve_shortfall": max(0.0, F_best - Fu) / F_best,
        "support_inconsistency": float(bad_mass.max() / ut[S].sum()),
        "mask_err": float((mask != round_dsd_heu(u, F)).sum()),
    }


def build_numbers(inv: dict, affinityeps: float, D1, D2, A, M, C, device,
                  identity: bool = False,
                  budget: int = 1 << 25) -> Dict[str, float]:
    """``build_err`` and ``c_err`` of a dense build (M, C: (m, m) tensors
    with zero diagonals, or with the identity on them where
    ``identity``, as the upstream accessors give them) against the
    reference's, a block of rows at a time."""
    P1, P2, At = endpoints(D1, D2, A, device)
    m = At.shape[0]
    if tuple(M.shape) != (m, m) or tuple(C.shape) != (m, m):
        return {k: math.inf for k in BUILD_NUMBERS}
    diff2 = ref2 = 0.0
    c_diff = 0
    step = scores.block_rows(m, budget)
    for s in range(0, m, step):
        rows = torch.arange(s, min(m, s + step), device=device)
        Mb, Cb = scores.mc_block(inv, P1, P2, At, rows, affinityeps)
        Mp = M[s:s + len(rows)].to(device=device, dtype=torch.float64)
        Cp = C[s:s + len(rows)].to(device=device, dtype=torch.float64)
        if identity:
            eye = rows[:, None] == torch.arange(m, device=device)
            Mp, Cp = Mp - eye.double(), Cp - eye.double()
        Cp = Cp != 0
        if not bool(torch.isfinite(Mp).all()):
            return {k: math.inf for k in BUILD_NUMBERS}
        diff2 += float(((Mp - Mb) ** 2).sum())
        ref2 += float((Mb ** 2).sum())
        c_diff += int((Cp != Cb).sum())
    return {"build_err": math.sqrt(diff2 / ref2) if ref2 else math.inf,
            "c_err": c_diff / (m * m)}
