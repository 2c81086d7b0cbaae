"""MSRC-SDR: semidefinite relaxation of the maximum-spectral-radius clique.

Counterpart of ``clipper_tpu/solvers/sdp.py``. The reference parses the
problem into SCS conic form and calls the external SCS solver (reference:
src/sdp.cpp:96-214); this solves the same program directly on dense
(M, C) with an ADMM splitting:

    maximize   <M, X>
    subject to tr(X) = 1,  X >= 0 (PSD),
               X_ij >= 0            where C_ij = 1
               X_ij  = 0            where C_ij = 0

Splitting X = Z:
    X-step: elementwise projection of (Z - U + M/rho) onto the sign/zero
            pattern constraints.
    Z-step: projection of (X + U) onto the spectrahedron
            {Z PSD, tr Z = 1} = eigh + simplex projection of eigenvalues
            (or, with ``z_rank`` > 0, a rank-r projection by warm-started
            subspace iteration).
    U    += X - Z.

with adaptive rho by residual balancing, safeguarded type-II Anderson
acceleration (AA) on the (Z, U) fixed point, and a certified dual bound:
the consensus dual T = rho U is repaired to an exactly dual-feasible point
(W = max(T - M, 0) on the allowed set, Y = T on the zero set) and
dobj = lambda_max(M + W + Y) bounds the SDP optimum for ANY iterate, so
gap = dobj - pobj certifies the solve. The certificate is computed in
f64 on the solve's own device (the JAX package computes it in host f64;
it is exact by construction either way). Node extraction matches the
reference (src/sdp.cpp:251-262): the top eigenvector v of X, i with
|v_i| > max|v|/2.

The JAX solver is plain XLA (no Pallas kernel), so this is plain PyTorch:
``torch.linalg.eigh`` / ``qr`` / ``solve`` and elementwise ops. The JAX
``while_loop`` is a host loop over a batched state: every tensor of
:class:`_State` has a leading problem dimension B (a single solve is
B = 1), and the loop's control (``it``, ``done``, the AA history depth
``hist``) lives on the host. Each iteration copies one small flag tensor
(each problem's ``done`` and whether its rho changed) to the host, so
the iteration count, the AA attempts and their acceptances follow the
JAX package's exactly. :func:`solve_batched` runs the (B, n, n) state
with a per-problem active mask: a finished problem is frozen, as a
vmapped ``while_loop`` freezes it, and the AA candidate is built when
any active problem attempts one and selected per problem, as the vmapped
``lax.cond`` selects.
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from clipper_tpu_torch.types import resolve_device


@dataclasses.dataclass(frozen=True)
class Params:
    """Mirrors reference sdp::Params (reference: include/clipper/sdp.h:39-52).

    acceleration_interval/lookback drive the safeguarded Anderson scheme
    (0 disables it). eps_infeas is a no-op by mathematics, not omission:
    X = I/n is strictly feasible and the spectrahedron is compact, so
    neither primal nor dual infeasibility can occur.
    """

    verbose: bool = False             # residual prints at chunk boundaries
    max_iters: int = 2000
    acceleration_interval: int = 10
    acceleration_lookback: int = 10
    eps_abs: float = 1e-3
    eps_rel: float = 1e-3
    eps_infeas: float = 1e-7          # vacuous for MSRC-SDR (API parity)
    time_limit_secs: float = 0.0      # > 0: checked at chunk boundaries
    rho: float = 2.0                  # initial ADMM penalty
    alpha: float = 1.6                # over-relaxation in (1, 2)
    adaptive_rho: bool = True         # residual balancing
    rho_mu: float = 10.0              # imbalance trigger
    rho_tau: float = 2.0              # scale factor per adjustment
    # large-m route: rank-r spectrahedron projection via warm-started
    # subspace iteration instead of the full O(n^3) eigh (0 = exact eigh).
    # The optimal X is (near) rank-1, so a small r captures the exact
    # projection once tau clears lambda_{r+1}; earlier iterations are
    # inexact-ADMM steps, and the f64 certificate stays valid.
    z_rank: int = 0
    z_power_iters: int = 2            # subspace refinement rounds per step
    # auto_tune tightens eps to <= 1e-4 from n = 2048, switches to the
    # rank-64 Z-step there, and disables AA over ~2 GiB of history, each
    # with a warning naming the override (the JAX package's thresholds).
    auto_tune: bool = True


# auto_tune thresholds (the JAX package's, clipper_tpu/solvers/sdp.py:103-107)
_TUNE_N_EPS = 2048          # eps=1e-3 extraction collapse from here
_TUNE_EPS = 1e-4
_TUNE_N_ZRANK = 2048        # exact-eigh knee
_TUNE_ZRANK = 64
_TUNE_AA_BYTES = 2 << 30    # AA difference-history budget


def _resolve_params(params: Params, n: int, itemsize: int) -> Params:
    """Apply auto_tune's scale-dependent overrides (with warnings)."""
    if not params.auto_tune:
        return params
    changes = {}
    if n >= _TUNE_N_EPS and (params.eps_abs > _TUNE_EPS
                             or params.eps_rel > _TUNE_EPS):
        changes["eps_abs"] = min(params.eps_abs, _TUNE_EPS)
        changes["eps_rel"] = min(params.eps_rel, _TUNE_EPS)
        warnings.warn(
            f"sdp auto_tune: eps tightened to {_TUNE_EPS:g} at n={n} "
            f"(eps=1e-3 under-converges extraction for n >= {_TUNE_N_EPS}; "
            "set auto_tune=False to keep your values)", stacklevel=3)
    if params.z_rank == 0 and n >= _TUNE_N_ZRANK:
        changes["z_rank"] = min(_TUNE_ZRANK, n)
        warnings.warn(
            f"sdp auto_tune: z_rank={_TUNE_ZRANK} subspace Z-step at n={n} "
            "(exact eigh per-iteration cost passes its knee here; set "
            "z_rank=-1 or auto_tune=False to force the exact eigh)",
            stacklevel=3)
    L = max(int(params.acceleration_lookback), 0)
    aa_bytes = 2 * L * 2 * n * n * itemsize
    if params.acceleration_interval > 0 and aa_bytes > _TUNE_AA_BYTES:
        changes["acceleration_interval"] = 0
        warnings.warn(
            f"sdp auto_tune: Anderson acceleration disabled at n={n} — its "
            f"difference history would hold {aa_bytes / 2**30:.1f} GiB "
            "(budget 2 GiB); set auto_tune=False to force it", stacklevel=3)
    return dataclasses.replace(params, **changes) if changes else params


def _warn_underconverged(soln: "Solution", params: Params, n: int):
    """Post-solve certificate check: the extraction rule reads the top
    eigenvector of X, which is only meaningful near the optimum."""
    if not params.auto_tune:
        return
    rel_gap = soln.gap / max(1.0, abs(soln.pobj))
    if soln.iters >= params.max_iters or rel_gap > 0.05:
        warnings.warn(
            f"sdp: iterate under-converged (iters={soln.iters}/"
            f"{params.max_iters}, certified rel gap {rel_gap:.2e}) — node "
            "extraction from the top eigenvector may be unreliable; raise "
            "max_iters or tighten eps", stacklevel=3)


@dataclasses.dataclass
class Solution:
    """Mirrors reference sdp::Solution (include/clipper/sdp.h:15-37).

    X (n, n), lambdas (n,) and evec1 (n,) are tensors on the solve's
    device (``X.cpu()`` copies it when asked); nodes is a list of ints.
    t_solve covers the ADMM (ended by a device synchronise), t_extract the
    node extraction and the f64 certificate. dobj is a certified upper
    bound on the SDP optimum, so gap = dobj - pobj certifies optimality.
    """

    X: torch.Tensor
    lambdas: torch.Tensor
    evec1: torch.Tensor
    thr: float
    nodes: List[int]
    iters: int
    pobj: float
    dobj: float
    t: float = 0.0
    t_solve: float = 0.0
    t_extract: float = 0.0

    @property
    def gap(self) -> float:
        return self.dobj - self.pobj


def _project_simplex(lam: torch.Tensor) -> torch.Tensor:
    """Euclidean projection of eigenvalues (..., n) onto
    {l >= 0, sum l = 1}, along the last dimension."""
    n = lam.shape[-1]
    s = torch.sort(lam, dim=-1, descending=True).values
    css = torch.cumsum(s, dim=-1)
    ar = torch.arange(1, n + 1, device=lam.device)
    cond = s - (css - 1.0) / ar.to(lam.dtype) > 0
    rho = torch.where(cond, ar, 0).max(dim=-1, keepdim=True).values
    tau = (css.gather(-1, rho - 1) - 1.0) / rho.to(lam.dtype)
    return torch.clamp_min(lam - tau, 0.0)


class _State(NamedTuple):
    """The ADMM carry, each field with a leading problem dimension B. it,
    done and hist are host (CPU) tensors: the loop's control."""
    it: torch.Tensor        # (B,) int32, host
    Z: torch.Tensor         # (B, n, n)
    U: torch.Tensor         # (B, n, n) scaled dual
    rho: torch.Tensor       # (B,)
    r_prim: torch.Tensor    # (B,)
    r_dual: torch.Tensor    # (B,)
    done: torch.Tensor      # (B,) bool, host
    # Anderson difference histories over vec([Z; U]), row 0 newest
    dF: torch.Tensor        # (B, L, 2 n^2) ((B, 1, 1) without AA)
    dG: torch.Tensor
    f_prev: torch.Tensor    # (B, 2 n^2) ((B, 1) without AA)
    g_prev: torch.Tensor
    hist: torch.Tensor      # (B,) int32, host: valid history depth
    Qsub: torch.Tensor      # (B, n, r) subspace basis ((B, 1, 1) at r = 0)


def _fro(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=(-2, -1))


def _bcast(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, ..., 1) broadcasting against ``like``."""
    return v.reshape(v.shape + (1,) * (like.dim() - 1))


class _ADMM:
    """The iteration of one (batched) problem set: the JAX _admm_pieces's
    x-step, z-steps, fixed point and body, over (B, n, n) tensors."""

    def __init__(self, Ms: torch.Tensor, Cs: torch.Tensor, params: Params):
        self.M = Ms
        self.B, self.n = Ms.shape[0], Ms.shape[-1]
        self.dtype, self.device = Ms.dtype, Ms.device
        self.params = params
        self.alpha = torch.tensor(params.alpha, dtype=self.dtype,
                                  device=self.device)
        self.allowed = Cs != 0   # identity diagonal: X_ii >= 0 allowed
        self.L = max(int(params.acceleration_lookback), 0)
        self.use_aa = params.acceleration_interval > 0 and self.L > 0
        self.r = min(int(params.z_rank), self.n) if params.z_rank else 0
        self.sqn = float(np.sqrt(self.n))

    def init(self) -> _State:
        B, n, r, dt, dev = self.B, self.n, self.r, self.dtype, self.device
        d = 2 * n * n
        eye = torch.eye(n, dtype=dt, device=dev)
        Q0 = (torch.eye(n, r, dtype=dt, device=dev) if r > 0
              else torch.zeros((1, 1), dtype=dt, device=dev))
        hshape = (B, self.L, d) if self.use_aa else (B, 1, 1)
        vshape = (B, d) if self.use_aa else (B, 1)
        inf = torch.full((B,), math.inf, dtype=dt, device=dev)
        return _State(
            it=torch.zeros(B, dtype=torch.int32),
            Z=(eye / n).expand(B, n, n).clone(),
            U=torch.zeros((B, n, n), dtype=dt, device=dev),
            rho=torch.full((B,), self.params.rho, dtype=dt, device=dev),
            r_prim=inf, r_dual=inf.clone(),
            done=torch.zeros(B, dtype=torch.bool),
            dF=torch.zeros(hshape, dtype=dt, device=dev),
            dG=torch.zeros(hshape, dtype=dt, device=dev),
            f_prev=torch.zeros(vshape, dtype=dt, device=dev),
            g_prev=torch.zeros(vshape, dtype=dt, device=dev),
            hist=torch.zeros(B, dtype=torch.int32),
            Qsub=Q0.expand(B, *Q0.shape).clone())

    def x_step(self, Z, U, rho):
        V = Z - U + self.M / _bcast(rho, Z)
        return torch.where(self.allowed, torch.clamp_min(V, 0.0), 0.0)

    def z_step_full(self, V, Q):
        lam, Qe = torch.linalg.eigh((V + V.mT) / 2)
        lam = _project_simplex(lam)
        return (Qe * lam[:, None, :]) @ Qe.mT, Q

    def z_step_lowrank(self, V, Q):
        """Rank-r spectrahedron projection by warm-started subspace
        iteration on the shifted A + c I (c = ||A||_F bounds |lambda|), so
        the dominant subspace is the top algebraic one; Rayleigh-Ritz on
        the unshifted A. Exact once the projection's water level clears
        lambda_{r+1}; an inexact-ADMM step before."""
        A = (V + V.mT) / 2
        c = torch.sqrt(torch.sum(A * A, dim=(-2, -1))) + torch.tensor(
            1e-6, dtype=self.dtype, device=self.device)
        c = c[:, None, None]
        for _ in range(max(int(self.params.z_power_iters), 1)):
            Q = torch.linalg.qr(A @ Q + c * Q)[0]
        AQ = A @ Q
        S = Q.mT @ AQ
        lam, W = torch.linalg.eigh((S + S.mT) / 2)   # (B, r) ascending
        lam_p = _project_simplex(lam)
        Qr = Q @ W
        return (Qr * lam_p[:, None, :]) @ Qr.mT, Q

    def fixed_point(self, Z, U, rho, Q):
        """One ADMM sweep; returns (X, Z+, U+, Q+)."""
        X = self.x_step(Z, U, rho)
        Xr = self.alpha * X + (1.0 - self.alpha) * Z     # over-relaxation
        z_step = self.z_step_lowrank if self.r > 0 else self.z_step_full
        Zn, Qn = z_step(Xr + U, Q)
        Un = U + Xr - Zn
        return X, Zn, Un, Qn

    def pack(self, Z, U):
        return torch.cat([Z.reshape(self.B, -1), U.reshape(self.B, -1)], 1)

    def unpack(self, v):
        nn = self.n * self.n
        return (v[:, :nn].reshape(self.B, self.n, self.n),
                v[:, nn:].reshape(self.B, self.n, self.n))

    def try_aa(self, s: _State, dF, dG, f, g, depth, Qp):
        """Type-II AA candidate of every problem over its ``depth`` valid
        history rows, mapped once more; returns the mapped candidate and
        each problem's safeguard (its fixed-point residual no larger than
        the plain iterate's)."""
        L, dt, dev = self.L, self.dtype, self.device
        valid = (torch.arange(L)[None, :] < depth[:, None]).to(
            device=dev, dtype=dt)                             # (B, L)
        Fm = dF * valid[:, :, None]                           # (B, L, d)
        G_ = Fm @ Fm.mT                                       # (B, L, L)
        reg = 1e-10 * (1.0 + torch.diagonal(G_, dim1=-2, dim2=-1).sum(-1))
        eye = torch.eye(L, dtype=dt, device=dev)
        gamma = torch.linalg.solve(G_ + reg[:, None, None] * eye,
                                   Fm @ f[:, :, None])[:, :, 0]
        gamma = gamma * valid
        cand = g - (gamma[:, None, :] @ (dG * valid[:, :, None]))[:, 0]
        Zc, Uc = self.unpack(cand)
        _, Zc2, Uc2, Qc = self.fixed_point(Zc, Uc, s.rho, Qp)
        fc = self.pack(Zc2, Uc2) - cand
        ok = (torch.linalg.vector_norm(fc, dim=-1)
              <= torch.linalg.vector_norm(f, dim=-1))
        return Zc2, Uc2, Qc, ok

    def body(self, s: _State) -> _State:
        """One iteration of every problem (the JAX body); the caller
        freezes the inactive ones. One device-to-host copy: the flags."""
        p = self.params
        X, Zp, Up, Qp = self.fixed_point(s.Z, s.U, s.rho, s.Qsub)
        if self.use_aa:
            g = self.pack(Zp, Up)
            f = g - self.pack(s.Z, s.U)
            have_prev = s.hist > 0
            dF, dG = s.dF, s.dG
            if bool(have_prev.any()):
                # roll by one, row 0 newest; problems without a previous
                # point keep their history
                keep = _bcast(have_prev.to(self.device), dF)
                dF = torch.where(keep, torch.cat(
                    [(f - s.f_prev)[:, None], dF[:, :-1]], 1), dF)
                dG = torch.where(keep, torch.cat(
                    [(g - s.g_prev)[:, None], dG[:, :-1]], 1), dG)
            depth = torch.clamp_max(s.hist, self.L)
            do_try = ((s.it % p.acceleration_interval
                       == p.acceleration_interval - 1) & (depth > 0))
            Zn, Un = Zp, Up
            if bool(do_try.any()):
                Zc2, Uc2, Qc, ok = self.try_aa(s, dF, dG, f, g, depth, Qp)
                ok = ok & do_try.to(self.device)
                Zn = torch.where(_bcast(ok, Zp), Zc2, Zp)
                Un = torch.where(_bcast(ok, Up), Uc2, Up)
                Qp = torch.where(_bcast(ok, Qp), Qc, Qp)
        else:
            Zn, Un = Zp, Up
            dF, dG, f, g = s.dF, s.dG, s.f_prev, s.g_prev

        rho0 = s.rho
        r_prim = _fro(X - Zn)
        r_dual = rho0 * _fro(Zn - s.Z)
        # SCS-style scaling: the absolute term grows with sqrt(#entries)
        # = n (the JAX package's sdp.py:331-335)
        eps_p = (p.eps_abs * self.sqn
                 + p.eps_rel * torch.maximum(_fro(X), _fro(Zn)))
        eps_d = p.eps_abs * self.sqn + p.eps_rel * _fro(
            _bcast(rho0, Un) * Un)
        done = (r_prim < eps_p) & (r_dual < eps_d)

        # residual balancing (Boyd et al. 3.4.1): rescale the scaled dual
        # on every rho change; the AA history is invalidated by it
        rho = rho0
        hist = (torch.clamp_max(s.hist + 1, self.L) if self.use_aa
                else s.hist)
        if p.adaptive_rho:
            up = r_prim > p.rho_mu * r_dual
            down = r_dual > p.rho_mu * r_prim
            scale = torch.where(
                up, torch.full_like(rho0, p.rho_tau),
                torch.where(down, torch.full_like(rho0, 1.0 / p.rho_tau),
                            torch.ones_like(rho0)))
            rho = torch.clamp(rho0 * scale, 1e-3, 1e3)
            Un = Un * _bcast(rho0 / rho, Un)
            flags = torch.stack([done, rho != rho0]).cpu()
            hist = torch.where(flags[1], 0, hist)
        else:
            flags = done[None].cpu()
        return _State(s.it + 1, Zn, Un, rho, r_prim, r_dual, flags[0],
                      dF, dG, f, g, hist.to(torch.int32), Qp)


def _freeze(new: _State, old: _State, active: torch.Tensor) -> _State:
    """Keep the inactive problems' old state (a vmapped while_loop's
    select)."""
    if bool(active.all()):
        return new
    out = []
    for a, b in zip(new, old):
        mask = active.to(a.device)
        out.append(torch.where(_bcast(mask, a), a, b))
    return _State(*out)


def _active(s: _State, params: Params) -> torch.Tensor:
    return ~s.done & (s.it < params.max_iters)


def _admm_chunk(admm: _ADMM, s: _State, chunk: Optional[int]) -> _State:
    """Advance every active problem by up to ``chunk`` iterations (to the
    end when None): the same iterations however the run is cut."""
    steps = 0
    active = _active(s, admm.params)
    while bool(active.any()) and (chunk is None or steps < chunk):
        s = _freeze(admm.body(s), s, active)
        active = _active(s, admm.params)
        steps += 1
    return s


def _drive(admm: _ADMM, s: _State, t0: float) -> _State:
    """Run to the end, stopping at a chunk boundary (every
    max(5 interval, 25) iterations, as the JAX package's chunked driver)
    once ``time_limit_secs`` has passed; ``verbose`` prints the residuals
    there."""
    p = admm.params
    if not (p.time_limit_secs > 0 or p.verbose):
        return _admm_chunk(admm, s, None)
    chunk = max(int(p.acceleration_interval) * 5, 25)
    while True:
        s = _admm_chunk(admm, s, chunk)
        it = int(s.it.max())
        if p.verbose:
            print(f"sdp: iter {it:5d}  r_prim {float(s.r_prim.max()):.3e}  "
                  f"r_dual {float(s.r_dual.max()):.3e}  "
                  f"rho {float(s.rho.max()):.2e}", flush=True)
        if not bool(_active(s, p).any()):
            break
        if (p.time_limit_secs > 0
                and time.perf_counter() - t0 > p.time_limit_secs):
            if p.verbose:
                print(f"sdp: time limit {p.time_limit_secs}s "
                      f"reached at iter {it}", flush=True)
            break
    return s


def _finalize(admm: _ADMM, Cs: torch.Tensor, s: _State):
    """(X, lambdas, evec1, T) of every problem. eigh symmetrizes its input
    here as JAX's does (torch reads one triangle)."""
    X = s.Z
    lam, Q = torch.linalg.eigh((X + X.mT) / 2)
    T = _bcast(s.rho, s.U) * (s.U + s.U.mT) / 2
    return X, lam, Q[..., -1], T


def _certify_f64(M, C, X, T):
    """Exact-arithmetic certificate in f64 on the tensors' device: pobj
    and the repaired dual bound. (W, Y) are dual-feasible by construction
    for any T, so gap = dobj - pobj is a true optimality certificate
    whatever precision the iterates were computed in. Batched: (B,) each."""
    M64, X64, T64 = M.double(), X.double(), T.double()
    D = torch.where(C != 0, M64 + torch.clamp_min(T64 - M64, 0.0), T64)
    dobj = torch.linalg.eigvalsh((D + D.mT) / 2)[..., -1]
    pobj = torch.sum(M64 * X64, dim=(-2, -1))
    return pobj, dobj


def _solutions(admm: _ADMM, Cs: torch.Tensor, s: _State,
               t0: float) -> List[Solution]:
    """Finalize, extract nodes and certify every problem of ``s``."""
    X, lam, evec1, T = _finalize(admm, Cs, s)
    if X.is_cuda:
        torch.cuda.synchronize(X.device)
    t1 = time.perf_counter()
    a = evec1.abs()
    thr = a.max(dim=-1).values / 2.0
    sel = (a > thr[:, None]).cpu().numpy()
    pobj, dobj = _certify_f64(admm.M, Cs, X, T)
    pobj, dobj, thr = pobj.tolist(), dobj.tolist(), thr.tolist()
    t2 = time.perf_counter()
    return [Solution(X=X[b], lambdas=lam[b], evec1=evec1[b], thr=thr[b],
                     nodes=[int(i) for i in np.flatnonzero(sel[b])],
                     iters=int(s.it[b]), pobj=pobj[b], dobj=dobj[b],
                     t=t2 - t0, t_solve=t1 - t0, t_extract=t2 - t1)
            for b in range(admm.B)]


def _setup(Ms, Cs, device):
    """(M, C) as tensors on the device, C in M's dtype; f32 on the card
    refuses TF32 (the process-wide flag is the caller's to set)."""
    dev = resolve_device(device)
    Ms = torch.as_tensor(Ms, device=dev)
    if not Ms.is_floating_point():
        Ms = Ms.to(torch.get_default_dtype())
    Cs = torch.as_tensor(Cs, device=dev).to(Ms.dtype)
    if (Ms.is_cuda and Ms.dtype == torch.float32
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "sdp: f32 matrices on the card need "
            "torch.backends.cuda.matmul.allow_tf32 = False")
    return Ms, Cs


def solve_batched(Ms, Cs, params: Params = Params(), *,
                  device="cuda") -> List[Solution]:
    """The SDR of a batch of problems (B, n, n) (identity diagonal) in
    one lock-step loop; each problem's iterations, nodes and objectives
    are those of its own :func:`solve`. Used for batched loop-closure
    cross-checking."""
    t0 = time.perf_counter()
    Ms, Cs = _setup(Ms, Cs, device)
    params = _resolve_params(params, Ms.shape[-1], Ms.element_size())
    admm = _ADMM(Ms, Cs, params)
    s = _admm_chunk(admm, admm.init(), None)
    out = _solutions(admm, Cs, s, t0)
    for soln in out:
        _warn_underconverged(soln, params, Ms.shape[-1])
    return out


def solve(M, C, params: Params = Params(), *, device="cuda") -> Solution:
    """Solve the MSRC SDR for dense symmetric M, C WITH identity diagonal
    (the reference passes getAffinityMatrix()/getConstraintMatrix() output,
    reference: src/clipper.cpp:103-104). ``time_limit_secs`` is checked
    every max(5 acceleration_interval, 25) iterations, where ``verbose``
    prints the residuals."""
    t0 = time.perf_counter()
    Ms, Cs = _setup(M, C, device)
    params = _resolve_params(params, Ms.shape[-1], Ms.element_size())
    admm = _ADMM(Ms[None], Cs[None], params)
    s = _drive(admm, admm.init(), t0)
    soln = _solutions(admm, Cs[None], s, t0)[0]
    _warn_underconverged(soln, params, Ms.shape[-1])
    return soln
