"""The plain reference where no (m, m) matrix can be formed.

At m = 262,144 a dense float64 M is 550 GB, so the judge of the 2D
block-sharded engine works a block at a time, on the same rules as the dense judge
(``judge.py``, ``scores.py``, ``solve.py``), in plain PyTorch and NumPy,
with nothing of the program:

- :func:`mc_rows`: M and C of a set of rows against a set of columns in
  the endpoints' dtype, the distinctness, diagonal and ``affinityeps``
  masks of ``scores.mc_block`` (upstream src/clipper.cpp:35-55);
- :class:`BlockOperator`: u -> (M u, C u) over an (R, C) grid of blocks,
  one block a rank of the default process group (rank ri C + ci holds
  rows ri and columns ci), run SPMD: each rank forms its block's
  partial products and one all-reduce in float64 of a (2, m) buffer
  that is zero outside its rows sums them, so every rank holds the same
  (M u, C u). Its ``form`` says how the block is held: ``rebuild``
  scores it again, a chunk of rows at a time, on every call (the
  definition); ``csr`` scores it once and keeps its nonzeros in float64
  as compressed rows (the block is 12.5% dense on the bunny protocol, so
  this is exact and costs 20 bytes a nonzero: 43 GB of a rank's 80 GB at
  m = 262,144 on 2 x 2, where rebuilding would score a rank's 1.7e10
  pairs in float64 on every call of the judge's solve); ``dense``
  keeps the block whole in its dtype (a lower-precision reference);
- :func:`pga_blocked`: the upstream solver, ``solve.pga``'s algorithm,
  floors and tolerances, over such an operator: every rank ends with the
  same u, F and outer count;
- :func:`answer_numbers_blocked`: the dense judge's numbers of one
  answer (``judge.answer_numbers``), over supp(u) x supp(u) alone, which
  is all that u'Mu and the support's consistency read;
- :func:`rank_disagreement`: how far the ranks' answers differ.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from benchmark.reference import judge, scores, solve

FORMS = ("rebuild", "csr", "dense")


def mc_rows(config: dict, P1, P2, A, rows, cols, affinityeps: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, C) of ``rows`` against ``cols`` (1-D index tensors): P1, P2
    (m, d) gathered endpoints, A (m, 2). M holds the kept scores (zero on
    the diagonal and for pairs that share an endpoint), C its 0/1 pattern
    as bool; with ``cols`` every column this is ``scores.mc_block``."""
    Ar, Ac = A[rows], A[cols]
    distinct = ((Ar[:, None, 0] != Ac[None, :, 0])
                & (Ar[:, None, 1] != Ac[None, :, 1]))
    s = scores.score_block(config, P1[rows], P1[cols], P2[rows], P2[cols])
    keep = distinct & (s > affinityeps)
    return torch.where(keep, s, torch.zeros((), dtype=s.dtype,
                                            device=s.device)), keep


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _bounds(m: int, n: int) -> List[int]:
    return [m * i // n for i in range(n + 1)]


def _csr_pair(Mb: torch.Tensor):
    """M's and C's rows of a chunk as compressed rows with 32-bit
    indices, sharing them: (M, C) with C's values 1."""
    Mc = Mb.to_sparse_csr()
    crow = Mc.crow_indices().to(torch.int32)
    col = Mc.col_indices().to(torch.int32)
    vals = Mc.values()
    size = tuple(Mb.shape)
    return (torch.sparse_csr_tensor(crow, col, vals, size,
                                    check_invariants=False),
            torch.sparse_csr_tensor(crow, col, torch.ones_like(vals), size,
                                    check_invariants=False))


class BlockOperator:
    """u -> (M u, C u), both (m,) in ``dtype``, over this rank's block of
    an (R, C) grid (``grid``; R C ranks in the default group, or one
    process at (1, 1)). Every rank calls it alike; see the module
    docstring for ``form``. ``budget``: entries of a chunk of rows."""

    def __init__(self, config: dict, affinityeps: float, P1, P2, A,
                 grid: Sequence[int] = (1, 1), form: str = "rebuild",
                 budget: int = 1 << 25):
        if form not in FORMS:
            raise ValueError(f"form {form!r} is not one of {FORMS}")
        world, rank = _world()
        R, C = (int(g) for g in grid)
        if R * C != world:
            raise ValueError(f"a {R} x {C} grid needs {R * C} ranks; "
                             f"the group has {world}")
        if form == "csr" and P1.dtype != torch.float64:
            raise ValueError("the csr form keeps float64")
        self.config, self.eps = config, affinityeps
        self.P1, self.P2, self.A = P1, P2, A
        self.m, self.dtype, self.form = A.shape[0], P1.dtype, form
        self.world = world
        ri, ci = divmod(rank, C)
        rb, cb = _bounds(self.m, R), _bounds(self.m, C)
        self.r0, self.r1 = rb[ri], rb[ri + 1]
        self.c0, self.c1 = cb[ci], cb[ci + 1]
        self.cols = torch.arange(self.c0, self.c1, device=P1.device)
        self.step = max(1, budget // max(1, self.c1 - self.c0))
        self.kept = []
        if form != "rebuild":
            for s, rows in self._chunks():
                Mb, _ = mc_rows(config, P1, P2, A, rows, self.cols,
                                affinityeps)
                if form == "csr":
                    self.kept.append(_csr_pair(Mb))
                else:
                    self.kept.append(Mb)
                del Mb

    def _chunks(self):
        for s in range(self.r0, self.r1, self.step):
            yield s, torch.arange(s, min(self.r1, s + self.step),
                                  device=self.P1.device)

    def _partials(self, uc):
        out = []
        for k, (s, rows) in enumerate(self._chunks()):
            if self.form == "rebuild":
                Mb, Cb = mc_rows(self.config, self.P1, self.P2, self.A, rows,
                                 self.cols, self.eps)
                out.append((Mb @ uc, Cb.to(self.dtype) @ uc))
            elif self.form == "csr":
                Mk, Ck = self.kept[k]
                out.append((Mk @ uc, Ck @ uc))
            else:
                Mk = self.kept[k]
                out.append((Mk @ uc, (Mk != 0).to(self.dtype) @ uc))
        return out

    def __call__(self, u: torch.Tensor):
        u = u.to(self.dtype)
        parts = self._partials(u[self.c0:self.c1])
        y = torch.zeros((2, self.m), dtype=torch.float64, device=u.device)
        y[0, self.r0:self.r1] = torch.cat([p[0] for p in parts])
        y[1, self.r0:self.r1] = torch.cat([p[1] for p in parts])
        if self.world > 1:
            # each entry sums its row's C partials and zeros: every rank
            # gets the same bits
            dist.all_reduce(y)
        return y[0].to(self.dtype), y[1].to(self.dtype)


def pga_blocked(op, u0) -> Tuple[torch.Tensor, float, int, torch.Tensor]:
    """(u, F, outer iterations, M u) from u0 over ``op`` (a
    :class:`BlockOperator`): ``solve.pga`` line for line, in op's dtype,
    with each (M u, C u) formed once for each u it is asked of."""
    dtype = op.dtype
    u = torch.as_tensor(u0, device=op.P1.device).to(dtype)
    ones = torch.ones((), dtype=dtype, device=u.device)
    last = [None, None, None]

    def mc(u):
        if last[0] is not u:
            last[:] = [u, *op(u)]
        return last[1], last[2]

    def grad(u, d):
        Mu, Cu = mc(u)
        return (1.0 + d) * u - d * u.sum() + (Mu + Cu * d)

    def d_terms(u):
        Mu, Cu = mc(u)
        su = u.sum()
        cbu = su - Cu - u
        act = (cbu > solve._floor(solve.EPS, 2000.0, su, dtype)) & (
            u > solve.EPS)
        ratio = (Mu + u) / torch.where(act, cbu, ones)
        return act, ratio

    u = mc(u)[0] + u
    u = u / torch.linalg.vector_norm(u)
    act, ratio = d_terms(u)
    d = ratio[act].mean() if bool(act.any()) else torch.zeros_like(ones)
    tol_u = solve._floor(solve.TOL_U, 100.0, 1.0, dtype)
    i, F = 0, torch.zeros_like(ones)
    while i < solve.MAX_OUTER:
        g = grad(u, d)
        F = u @ g
        for _ in range(solve.MAX_INNER):
            alpha = 1.0
            for _ in range(solve.MAX_LS):
                un = torch.clamp(u + alpha * g, min=0.0)
                un = un / torch.linalg.vector_norm(un)
                gn = grad(un, d)
                Fn = un @ gn
                dF = Fn - F
                if not bool(dF < -solve._floor(solve.EPS, 100.0,
                                               abs(float(F)), dtype)):
                    break
                alpha *= solve.BETA
            du = float(torch.linalg.vector_norm(un - u))
            u, g, F = un, gn, Fn
            if du < tol_u or abs(float(dF)) < solve._floor(
                    solve.TOL_F, 100.0, abs(float(F)), dtype):
                break
        act, ratio = d_terms(u)
        if not bool(act.any()):
            break
        d = d + ratio[act].abs().mean()
        i += 1
    return u, float(F), i, mc(u)[0]


def best_objective_blocked(op, u0) -> float:
    """F* of ``solve_shortfall`` (``judge.best_objective``): u'(M + I)u of
    the upstream solver's u from u0 over ``op``, on every rank."""
    u, _, _, Mu = pga_blocked(op, u0)
    return float(u @ Mu + u @ u)


def answer_numbers_blocked(config: dict, affinityeps: float, D1, D2, A, u,
                           F, mask, device, F_best: float,
                           budget: int = 1 << 25) -> Dict[str, float]:
    """``judge.answer_numbers`` of one answer, computed over supp(u) x
    supp(u) only (u is zero elsewhere, so u'Mu and the support's
    inconsistency read nothing else), in float64."""
    u = np.asarray(torch.as_tensor(u).detach().cpu(), dtype=np.float64)
    mask = np.asarray(torch.as_tensor(mask).detach().cpu(), dtype=bool)
    F = float(F)
    support = np.flatnonzero(u > 0)
    if (not np.isfinite(u).all() or not math.isfinite(F) or support.size == 0
            or (u < 0).any()):
        return {k: math.inf for k in judge.ANSWER_NUMBERS}
    P1, P2, At = judge.endpoints(D1, D2, A, device)
    ut = torch.as_tensor(u, device=device)
    S = torch.as_tensor(support, device=device)
    uS = ut[S]
    gS = torch.empty(S.numel(), dtype=torch.float64, device=device)
    bad_mass = torch.empty(S.numel(), dtype=torch.float64, device=device)
    step = scores.block_rows(S.numel(), budget)
    for s in range(0, S.numel(), step):
        rows = S[s:s + step]
        Mb, Cb = mc_rows(config, P1, P2, At, rows, S, affinityeps)
        gS[s:s + step] = Mb @ uS + ut[rows]
        off = Cb | (rows[:, None] == S[None, :])
        bad_mass[s:s + step] = (~off).double() @ uS
    Fu = float(uS @ gS)
    return {
        "objective_err": abs(F - Fu) / abs(Fu),
        "solve_shortfall": max(0.0, F_best - Fu) / F_best,
        "support_inconsistency": float(bad_mass.max() / uS.sum()),
        "mask_err": float((mask != judge.round_dsd_heu(u, F)).sum()),
    }


def rank_disagreement(us: Sequence[torch.Tensor], Fs: Sequence, device
                      ) -> float:
    """The largest |u_r - u_0|_inf and |F_r - F_0| over the ranks of the
    default group and the answers (us, Fs: this rank's, in the same order
    on every rank), gathered on ``device``; 0 in one process, inf where
    ranks kept different numbers of answers or a difference is NaN.
    Every rank calls it."""
    world, _ = _world()
    if world == 1:
        return 0.0
    mine = torch.cat([torch.zeros(0, dtype=torch.float64, device=device)]
                     + [torch.cat([torch.as_tensor(u).double().reshape(-1),
                                   torch.as_tensor(F).double().reshape(1)
                                   .to(u.device)]).to(device)
                        for u, F in zip(us, Fs)])
    n = torch.tensor([mine.numel(), -mine.numel()], device=device)
    dist.all_reduce(n, op=dist.ReduceOp.MAX)
    if int(n[0]) != -int(n[1]):
        return math.inf
    if mine.numel() == 0:
        return 0.0
    every = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(every, mine)
    return max(float(torch.nan_to_num((t - every[0]).abs(), nan=math.inf)
                     .max()) for t in every)
