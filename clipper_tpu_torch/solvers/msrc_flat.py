"""Flattened MSRC solver: a per-lane state machine for batched solves.

Counterpart of ``clipper_tpu/solvers/msrc_flat.py``. One tick is one
line-search probe (one dual matvec M u, C u); every lane carries its own
(outer i, inner j, line-search k, alpha, d) state and transitions
independently (reference: src/clipper.cpp:218-281). Where the JAX package
vmapped a per-lane function, every function here takes the lanes as a
leading (B, ...) dimension: u is (B, m), scalars are (B,), multiprobe
candidates (B, K, m).

``batch_dual(idx, U)`` is any batched dual matvec returning (M U, C U) of
U's shape for lanes reading pool problems ``idx`` (ops/flattri.py, or
:func:`make_stacked_pool_matvec`; idx=None means lane b reads problem b).

The single-problem forms (:func:`power_init`, :func:`flat_init`,
:func:`flat_solve_single`, :func:`flat_solve_single_multiprobe`,
:func:`flat_solve_ticks`, :func:`recompute_objective`) keep the JAX
package's surface: u is (m,), and ``dual_matvec(u)`` takes (m,) or (m, K)
candidate columns and returns (M u, C u) of the same shape. They run the
batched ticks at B=1, and the JAX ``while_loop`` becomes a host loop.

The stacked [M; C] storage of the dense engines (:func:`quantize_stacked`,
:func:`make_stacked_matvec`, :func:`make_stacked_pool_matvec`) and the
batched and multistart solves (:func:`solve_batched`,
:func:`solve_multistart`) run their lanes in lock-step through the same
batched ticks.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from clipper_tpu_torch.solvers import msrc
from clipper_tpu_torch.types import Params, Rounding, Solution

# int8 affinity quantization scale: M in [0, 1] and C in {0, 1} are stored
# as round(127 * [M; C]); one 1/127 output scale dequantizes both halves.
_INT8_SCALE = 127.0


class _FlatState(NamedTuple):
    u: torch.Tensor        # (B, m) accepted iterate
    gradF: torch.Tensor    # (B, m) gradient at u for current d
    F: torch.Tensor        # (B,) objective at u
    d: torch.Tensor        # (B,) homotopy penalty
    alpha: torch.Tensor    # (B,) line-search step size
    lsk: torch.Tensor      # (B,) int32 line-search iteration k
    j: torch.Tensor        # (B,) int32 inner iteration count
    i: torch.Tensor        # (B,) int32 outer iteration count
    done: torch.Tensor     # (B,) bool lane finished
    stall: torch.Tensor    # (B,) int32 consecutive frozen-u outers
    ticks: torch.Tensor    # (B,) int32 diagnostic probe count
    nback: torch.Tensor    # (B,) int32 diagnostic rejected-probe count


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _grad_from_mv(u, d, Mu, Cu):
    """gradF = (M + I) u - d Cb u with Cb u = 1 sum(u) - C u - u: the
    cancellation-free form of the reference's gradient (clipper.cpp:219).
    d has one entry per row of u (shape u.shape[:-1])."""
    return (Mu + u) - d[..., None] * (u.sum(-1, keepdim=True) - Cu - u)


def _d_terms(u, Mu, Cu, params: Params, dtype):
    """Activity mask and d-update ratios (reference: clipper.cpp:202-209)."""
    su = u.sum(-1, keepdim=True)
    Cbu = su - Cu - u
    eps_d = msrc._eps_active(params.eps, su, dtype)
    idxD = (Cbu > eps_d) & (u > params.eps)
    ratio = (Mu + u) / torch.where(idxD, Cbu, 1.0)
    return idxD, ratio


def _init_rescale(u0, Mu0, params: Params):
    """The init's one power step (reference: clipper.cpp:193-198)."""
    u = Mu0 + u0 if params.rescale_u0 else u0
    return u / _norm(u)


def _init_from_mv(u, Mu, Cu, params: Params, dtype) -> _FlatState:
    """Initial (B, ...) state from the rescaled iterates' matvec."""
    idxD, ratio = _d_terms(u, Mu, Cu, params, dtype)
    d0 = torch.where(idxD.any(-1), msrc._masked_mean(ratio, idxD),
                     0.0).to(dtype)
    gradF0 = _grad_from_mv(u, d0, Mu, Cu)
    F0 = _dot(u, gradF0)
    B = u.shape[0]
    dev = u.device

    def zi():
        return torch.zeros(B, dtype=torch.int32, device=dev)

    return _FlatState(u=u, gradF=gradF0, F=F0, d=d0,
                      alpha=torch.ones(B, dtype=dtype, device=dev),
                      lsk=zi(), j=zi(), i=zi(),
                      done=torch.zeros(B, dtype=torch.bool, device=dev),
                      stall=zi(), ticks=zi(), nback=zi())


def power_init_batched(batch_dual, idx, U0, steps: int):
    """``steps`` power iterations v <- normalize((M + I) v) on every lane,
    one batched matvec each (an init strategy; steps=0 is the reference)."""
    V = U0
    for _ in range(steps):
        MV, _ = batch_dual(idx, V)
        W = MV + V
        V = W / _norm(W)
    return V


def flat_init_batched(batch_dual, idx, U0,
                      params: Params = Params()) -> _FlatState:
    """Initial lane states (reference: clipper.cpp:193-209)."""
    dtype = U0.dtype
    MU0, _ = batch_dual(idx, U0)
    U = _init_rescale(U0, MU0, params)
    MU, CU = batch_dual(idx, U)
    return _init_from_mv(U, MU, CU, params, dtype)


def _tick_probe(s: _FlatState) -> torch.Tensor:
    """The tick's projected candidate (reference: clipper.cpp:235-237)."""
    unew = torch.clamp(s.u + s.alpha[:, None] * s.gradF, min=0.0)
    return unew / _norm(unew)


def _where(c, a, b):
    """Lane-wise select: c (B,) against (B, ...) operands."""
    return torch.where(c.reshape(c.shape + (1,) * (a.dim() - 1)), a, b)


def _outer_and_freeze(s: _FlatState, unew, Mu, Cu, gradFnew, Fnew, deltaF,
                      accept, alpha_out, lsk_out, nback_add, params: Params,
                      dtype, d_scale: float,
                      stall_outers: int = 0) -> _FlatState:
    """The accept / inner / outer transitions shared by the single-probe
    and multiprobe ticks (reference: clipper.cpp:253-280), then the freeze
    of lanes that were already done. stall_outers: the stalled-homotopy
    guard's count of frozen outers (0: msrc._STALL_OUTERS)."""
    stall_guard = msrc._stall_guard_enabled(dtype)
    stall_outers = stall_outers or msrc._STALL_OUTERS

    deltau = torch.linalg.vector_norm(unew - s.u, dim=-1)
    tol_u = msrc._eps_like(params.tol_u, 1.0, dtype)
    tol_F = msrc._eps_like(params.tol_F, torch.abs(Fnew), dtype)
    inner_conv = (deltau < tol_u) | (torch.abs(deltaF) < tol_F)
    j_next = s.j + 1
    inner_done = accept & (inner_conv | (j_next >= params.maxiniters))

    idxD, ratio = _d_terms(unew, Mu, Cu, params, dtype)
    active = idxD.any(-1)
    deltad = msrc._masked_mean(torch.abs(ratio), idxD)
    if d_scale != 1.0:
        deltad = deltad * torch.tensor(d_scale, dtype=dtype)
    d_new = s.d + deltad
    i_next = torch.where(active, s.i + 1, s.i)
    outer_exhausted = i_next >= params.maxoliters
    lane_done = inner_done & (~active | outer_exhausted)

    frozen = inner_done & (s.j == 0) & (deltau < tol_u)
    stall_next = torch.where(inner_done,
                             torch.where(frozen, s.stall + 1, 0), s.stall)
    if stall_guard:
        lane_done = lane_done | (inner_done & (stall_next >= stall_outers))

    grad_refresh = _grad_from_mv(unew, d_new, Mu, Cu)
    F_refresh = _dot(unew, grad_refresh)

    take_outer = inner_done & active & ~outer_exhausted & ~lane_done

    u_out = _where(accept, unew, s.u)
    gradF_out = _where(take_outer, grad_refresh,
                       _where(accept, gradFnew, s.gradF))
    F_out = torch.where(take_outer, F_refresh,
                        torch.where(accept, Fnew, s.F))
    d_out = torch.where(take_outer, d_new, s.d)
    j_out = torch.where(inner_done, 0, torch.where(accept, j_next, s.j))
    i_out = torch.where(inner_done, i_next, s.i)

    frz = s.done
    i32 = torch.int32
    return _FlatState(
        u=_where(frz, s.u, u_out),
        gradF=_where(frz, s.gradF, gradF_out),
        F=torch.where(frz, s.F, F_out),
        d=torch.where(frz, s.d, d_out),
        alpha=torch.where(frz, s.alpha, alpha_out),
        lsk=torch.where(frz, s.lsk, lsk_out).to(i32),
        j=torch.where(frz, s.j, j_out).to(i32),
        i=torch.where(frz, s.i, i_out).to(i32),
        done=s.done | lane_done,
        stall=torch.where(frz, s.stall, stall_next).to(i32),
        ticks=torch.where(frz, s.ticks, s.ticks + 1).to(i32),
        nback=torch.where(frz, s.nback, s.nback + nback_add).to(i32),
    )


def _tick_update(s: _FlatState, unew, Mu, Cu, params: Params, dtype,
                 warm_alpha: bool = False, d_scale: float = 1.0,
                 stall_outers: int = 0) -> _FlatState:
    """Everything after a single-probe tick's matvec (see the JAX module for
    warm_alpha, d_scale and stall_outers; the defaults are the
    reference)."""
    gradFnew = _grad_from_mv(unew, s.d, Mu, Cu)
    Fnew = _dot(unew, gradFnew)
    deltaF = Fnew - s.F

    eps_ls = msrc._eps_like(params.eps, torch.abs(s.F), dtype)
    backtrack = (deltaF < -eps_ls) & (s.lsk + 1 < params.maxlsiters)
    accept = ~backtrack

    if warm_alpha:
        alpha_up = torch.clamp(s.alpha / params.beta, max=1.0)
    else:
        alpha_up = torch.ones_like(s.alpha)
    alpha_out = torch.where(accept, alpha_up, s.alpha * params.beta)
    lsk_out = torch.where(accept, 0, s.lsk + 1)
    nback_add = torch.where(accept, 0, 1)
    return _outer_and_freeze(s, unew, Mu, Cu, gradFnew, Fnew, deltaF,
                             accept, alpha_out, lsk_out, nback_add, params,
                             dtype, d_scale, stall_outers)


def make_flat_tick_batched(batch_dual, params: Params, dtype,
                           warm_alpha: bool = False, d_scale: float = 1.0,
                           stall_outers: int = 0):
    """Batched single-probe tick: (idx, states) -> states, one batched
    dual matvec over all lanes' candidates."""
    def body(idx, ls: _FlatState) -> _FlatState:
        U = _tick_probe(ls)
        MU, CU = batch_dual(idx, U)
        return _tick_update(ls, U, MU, CU, params, dtype, warm_alpha,
                            d_scale, stall_outers)

    return body


def _mp_probe(s: _FlatState, K: int, beta: torch.Tensor):
    """K backtracking candidates (B, K, m) and their alphas (B, K), built
    by the reference's repeated alpha * beta (clipper.cpp:246-248)."""
    a = s.alpha
    alist = [a]
    for _ in range(K - 1):
        a = a * beta
        alist.append(a)
    alphas = torch.stack(alist, dim=-1)
    U = torch.clamp(s.u[:, None, :] + alphas[..., None] * s.gradF[:, None, :],
                    min=0.0)
    return U / _norm(U), alphas


def _mp_update(s: _FlatState, U, MU, CU, alphas, params: Params, dtype,
               warm_alpha: bool = False, d_scale: float = 1.0,
               stall_outers: int = 0) -> _FlatState:
    """Multiprobe tick tail: the first acceptable candidate of each lane
    (reference: clipper.cpp:246-251), then the standard transitions."""
    B, K, _ = U.shape
    beta = torch.tensor(params.beta, dtype=dtype, device=U.device)
    sU = U.sum(-1)
    gradFnewK = (MU + U) - s.d[:, None, None] * (sU[..., None] - CU - U)
    FnewK = (U * gradFnewK).sum(-1)
    deltaFK = FnewK - s.F[:, None]

    eps_ls = msrc._eps_like(params.eps, torch.abs(s.F), dtype)
    pos = s.lsk[:, None] + torch.arange(K, dtype=s.lsk.dtype,
                                        device=U.device)
    ok = (deltaFK >= -eps_ls[:, None]) | (pos + 1 >= params.maxlsiters)
    accept = ok.any(-1)
    # torch.argmax refuses bool; on int it returns the FIRST maximal index,
    # the candidate the JAX package picks
    q = torch.argmax(ok.to(torch.int32), dim=-1)
    lane = torch.arange(B, device=U.device)
    unew = U[lane, q]
    Mu_q = MU[lane, q]
    Cu_q = CU[lane, q]
    gradFnew = gradFnewK[lane, q]
    Fnew = FnewK[lane, q]
    deltaF = deltaFK[lane, q]

    if warm_alpha:
        alpha_up = torch.clamp(alphas[lane, q] / params.beta, max=1.0)
    else:
        alpha_up = torch.ones_like(s.alpha)
    alpha_out = torch.where(accept, alpha_up, alphas[:, -1] * beta)
    lsk_out = torch.where(accept, 0, s.lsk + K)
    nback_add = torch.where(accept, q.to(torch.int32), K)
    return _outer_and_freeze(s, unew, Mu_q, Cu_q, gradFnew, Fnew, deltaF,
                             accept, alpha_out, lsk_out, nback_add, params,
                             dtype, d_scale, stall_outers)


def make_flat_tick_multiprobe_batched(batch_dual, params: Params, dtype,
                                      probes: int, warm_alpha: bool = False,
                                      d_scale: float = 1.0,
                                      stall_outers: int = 0):
    """Batched K-wide multiprobe tick: (idx, states) -> states. Each tick
    evaluates K backtracking candidates per lane in ONE batched matvec
    over (B, K, m) rows; the semantics are the sequential reference line
    search evaluated K probes at a time."""
    K = int(probes)

    def body(idx, ls: _FlatState) -> _FlatState:
        beta = torch.tensor(params.beta, dtype=dtype, device=ls.u.device)
        U, alphas = _mp_probe(ls, K, beta)
        MU, CU = batch_dual(idx, U)
        return _mp_update(ls, U, MU, CU, alphas, params, dtype, warm_alpha,
                          d_scale, stall_outers)

    return body


def make_tick(batch_dual, params: Params, dtype, *, probes: int = 1,
              warm_alpha: bool = False, d_scale: float = 1.0,
              stall_outers: int = 0):
    """The single-probe tick at probes=1, else the K-wide multiprobe tick."""
    K = int(probes)
    if K < 1:
        raise ValueError(f"probes must be >= 1, got {probes}")
    if K > 1:
        return make_flat_tick_multiprobe_batched(
            batch_dual, params, dtype, K, warm_alpha=warm_alpha,
            d_scale=d_scale, stall_outers=stall_outers)
    return make_flat_tick_batched(batch_dual, params, dtype,
                                  warm_alpha=warm_alpha, d_scale=d_scale,
                                  stall_outers=stall_outers)


# the host loop reads ``done`` once per this many ticks; a done lane is
# frozen, so the extra ticks change nothing (as in the pool's window)
_DONE_EVERY = 4


def drive(tick, idx, s: _FlatState, max_ticks: Optional[int] = None):
    """Tick every lane until all are done, reading ``done`` once per
    _DONE_EVERY ticks, or for at most ``max_ticks`` ticks. Returns (state,
    ticks run): the lock-step count, done lanes frozen throughout."""
    n = 0
    while (max_ticks is None or n < max_ticks) and not bool(s.done.all()):
        step = _DONE_EVERY if max_ticks is None else min(_DONE_EVERY,
                                                         max_ticks - n)
        for _ in range(step):
            s = tick(idx, s)
        n += step
    return s, n


# ----------------------------------------------------------------------
# single-problem forms (one lane, the JAX package's (m,) / (m, K) surface)
# ----------------------------------------------------------------------


def _one_lane(dual_matvec):
    """A B=1 batched dual matvec over a single-problem ``dual_matvec``:
    (1, m) rows -> (m,) vector, (1, K, m) rows -> (m, K) columns."""
    def bd(idx, U):
        if U.dim() == 2:
            Mu, Cu = dual_matvec(U[0])
            return Mu[None], Cu[None]
        MU, CU = dual_matvec(U[0].T)
        return MU.T[None], CU.T[None]

    return bd


def _unbatch(s: _FlatState) -> _FlatState:
    return _FlatState(*(x[0] for x in s))


def power_init(dual_matvec, u0: torch.Tensor, steps: int) -> torch.Tensor:
    """``steps`` power iterations v <- normalize((M + I) v) on u0 (m,),
    one matvec each (an init strategy; steps=0 is the reference)."""
    return power_init_batched(_one_lane(dual_matvec), None, u0[None],
                              steps)[0]


def flat_init(dual_matvec, u0: torch.Tensor,
              params: Params = Params()) -> _FlatState:
    """Initial single-lane state, scalars 0-d (reference: clipper.cpp:193-209)."""
    return _unbatch(flat_init_batched(_one_lane(dual_matvec), None, u0[None],
                                      params))


def flat_solve_state(dual_matvec, state: _FlatState,
                     params: Params = Params(), *, probes: int = 1,
                     d_scale: float = 1.0) -> _FlatState:
    """Drive a single-lane state (from :func:`flat_init`) until it is done:
    the single-probe tick at probes=1, else the K-wide multiprobe tick at
    warm_alpha=False, whose transitions are those of the JAX package's
    flat_solve_single_multiprobe (the alpha after a rejected tick is
    alist[-1] * beta, and nback grows by q or K). The host reads ``done``
    once per _DONE_EVERY ticks."""
    return flat_solve_ticks(dual_matvec, state, params, ticks=None,
                            probes=probes, d_scale=d_scale)


def flat_solve_ticks(dual_matvec, state: _FlatState,
                     params: Params = Params(), *, ticks: Optional[int],
                     probes: int = 1, d_scale: float = 1.0,
                     warm_alpha: bool = False) -> _FlatState:
    """Advance a single-lane state by at most ``ticks`` probe ticks (until
    done when ticks is None): the checkpoint/resume primitive. A lane that
    is done freezes, so driving a solve in chunks reproduces the
    uninterrupted trajectory bit for bit, provided every chunk gets the
    same tick options (probes, d_scale, warm_alpha, params) as the
    uninterrupted solve: a resume with other options follows another
    trajectory. The JAX package's flat_solve_ticks runs the default tick
    only; the defaults here are that tick."""
    tick = make_tick(_one_lane(dual_matvec), params, state.u.dtype,
                     probes=probes, warm_alpha=warm_alpha, d_scale=d_scale)
    s, _ = drive(tick, None, _FlatState(*(x[None] for x in state)),
                 max_ticks=ticks)
    return _unbatch(s)


def _result(s: _FlatState, return_ticks: bool):
    if return_ticks:
        return s.u, s.F, s.i, s.ticks, s.nback
    return s.u, s.F, s.i


def flat_solve_single(
        dual_matvec: Callable[[torch.Tensor], Tuple[torch.Tensor,
                                                    torch.Tensor]],
        u0: torch.Tensor, params: Params = Params(), *,
        d_scale: float = 1.0, return_ticks: bool = False):
    """One problem through the flat solver, one probe per tick.

    dual_matvec(u) must return (M u, C u) for u (m,). Returns (u, F,
    ifinal) with reference semantics, and with ``return_ticks=True`` also
    the probe-tick and rejected-probe counts. d_scale: the homotopy schedule
    refinement (1.0 = reference schedule)."""
    s = flat_init(dual_matvec, u0, params)
    return _result(flat_solve_state(dual_matvec, s, params,
                                    d_scale=d_scale), return_ticks)


def flat_solve_single_multiprobe(
        dual_matvec: Callable[[torch.Tensor], Tuple[torch.Tensor,
                                                    torch.Tensor]],
        u0: torch.Tensor, params: Params = Params(), *, probes: int = 8,
        d_scale: float = 1.0, return_ticks: bool = False):
    """Flat solver with a K-wide line search: K = ``probes`` backtracking
    candidates per matvec tick, with the semantics of the sequential
    reference line search (reference: src/clipper.cpp:234-251).
    dual_matvec must take (m,) vectors and (m, K) candidate columns."""
    s = flat_init(dual_matvec, u0, params)
    return _result(flat_solve_state(dual_matvec, s, params, probes=probes,
                                    d_scale=d_scale), return_ticks)


def recompute_objective(dual_matvec, u: torch.Tensor) -> torch.Tensor:
    """u'(M + I)u in the matvec's precision: the converged objective,
    independent of d once u's support is a clique."""
    Mu, _ = dual_matvec(u)
    return torch.dot(u, Mu + u)


# ----------------------------------------------------------------------
# stacked [M; C] storage: the dense engines' matvec
# ----------------------------------------------------------------------

def quantize_stacked(MC: torch.Tensor) -> torch.Tensor:
    """[M; C] in [0, 1] -> int8 codes clip(round_half_even(127 x), 0, 127)
    (see _INT8_SCALE)."""
    return torch.clamp(torch.round(MC * _INT8_SCALE), 0, 127).to(torch.int8)


def stacked_products(MC: torch.Tensor, U: torch.Tensor,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """(..., 2m, m) stacked storage times U (..., m) or (..., m, K), in
    out_dtype, with the JAX package's casts (msrc_flat.py:778-808): u is
    cast to the storage dtype (bf16 for int8 codes), the products are
    summed in out_dtype when the storage has that dtype and in f32
    otherwise, and int8 results are cast to out_dtype, then scaled by
    1/127 in it.

    int8 and bf16 operands are exact in f32 (and in TF32), so the sums are
    formed in f32 from f32 copies: a bf16 matmul would round its output
    to bf16, and cuBLAS may reduce bf16 products in reduced precision.
    Only f32 storage on the card depends on the TF32 flag; it raises
    there when TF32 is on rather than change the flag."""
    return finish_stacked(stacked_partials(MC, U, out_dtype), MC.dtype,
                          out_dtype)


def stacked_partials(MC: torch.Tensor, U: torch.Tensor,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """:func:`stacked_products` before its cast to out_dtype and its int8
    scaling: the sums in their accumulation dtype (out_dtype when the
    storage has it, else f32), for a caller that adds several of them
    before :func:`finish_stacked` rounds once (the 2D sharded engine)."""
    cdt = torch.bfloat16 if MC.dtype == torch.int8 else MC.dtype
    acc = out_dtype if MC.dtype == out_dtype else torch.float32
    if (MC.is_cuda and MC.dtype == torch.float32 and acc == torch.float32
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "stacked matvec: f32 storage on the card needs "
            "torch.backends.cuda.matmul.allow_tf32 = False")
    return torch.matmul(MC.to(acc), U.to(cdt).to(acc))


def finish_stacked(Y: torch.Tensor, storage_dtype: torch.dtype,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """Sums of :func:`stacked_partials` cast to out_dtype, then scaled by
    1/127 in it for int8 storage."""
    Y = Y.to(out_dtype)
    if storage_dtype == torch.int8:
        # a 0-d CPU tensor enters a CUDA op as a host scalar
        Y = Y * torch.tensor(1.0 / _INT8_SCALE, dtype=out_dtype)
    return Y


def make_stacked_matvec(MC: torch.Tensor, out_dtype: torch.dtype):
    """Single-problem dual matvec over prepared (2m, m) stacked storage
    (f64/f32/bf16/int8): u (m,) or (m, K) -> (M u, C u) of u's shape."""
    m = MC.shape[-1]

    def mv(u):
        y = stacked_products(MC, u, out_dtype)
        return y[:m], y[m:]

    return mv


def stacked_dual_matvec(M: torch.Tensor, C: torch.Tensor,
                        storage_dtype=None):
    """Dual matvec over [M; C] stacked and stored in storage_dtype (None:
    M's dtype; torch.int8: quantized codes)."""
    MC = torch.cat([M, C], dim=0)
    if storage_dtype == torch.int8:
        MC = quantize_stacked(MC)
    elif storage_dtype is not None:
        MC = MC.to(storage_dtype)
    return make_stacked_matvec(MC, M.dtype)


def make_stacked_pool_matvec(MCs: torch.Tensor, out_dtype: torch.dtype):
    """Batched per-lane dual matvec over (P, 2m, m) stacked storage:
    ``bmv(idx, U)`` with lane b reading storage row idx[b] (row b when idx
    is None), U (B, m) or (B, K, m); outputs match U's shape.

    The counterpart of the JAX pool's per-lane ``MCs[problem_of[idx]]``
    matvec under vmap: a gather of each lane's rows and one batched
    matmul, plain PyTorch, as the JAX package left it to XLA."""
    m = MCs.shape[-1]

    def bmv(idx, U):
        MC = MCs if idx is None else MCs[idx.long()]
        mp = U.dim() == 3
        Y = stacked_products(MC, U.transpose(1, 2) if mp else U[..., None],
                             out_dtype)
        Y = Y.transpose(1, 2) if mp else Y[..., 0]
        return Y[..., :m], Y[..., m:]

    return bmv


def _nonzero_if_dsd(rounding: Rounding) -> Rounding:
    return Rounding.NONZERO if rounding == Rounding.DSD else rounding


def solve_batched(Ms: torch.Tensor, Cs: torch.Tensor, u0s: torch.Tensor,
                  params: Params = Params()) -> Solution:
    """B problems over (B, m, m) M and C, from u0s (B, m), through the
    flat solver in lock-step until every lane is done; DSD rounds
    NONZERO, as in the JAX package."""
    dtype = Ms.dtype
    bmv = make_stacked_pool_matvec(torch.cat([Ms, Cs], dim=-2), dtype)
    u0s = u0s.to(dtype)
    s = flat_init_batched(bmv, None, u0s, params)
    s, _ = drive(make_tick(bmv, params, dtype), None, s)
    mask = msrc.round_solution(s.u, s.F, _nonzero_if_dsd(params.rounding))
    return Solution(ifinal=s.i, mask=mask, u0=u0s, u=s.u, score=s.F)


def solve_multistart(M: torch.Tensor, C: torch.Tensor, u0s: torch.Tensor,
                     params: Params = Params()) -> Solution:
    """One problem from K inits u0s (K, m) in parallel (K lanes over the
    same full-precision [M; C], in lock-step); keeps the lane with the
    highest F (the first on a tie). DSD rounds NONZERO."""
    dtype = M.dtype
    mv = make_stacked_matvec(torch.cat([M, C], dim=0), dtype)

    def bmv(idx, U):
        MU, CU = mv(U.T)
        return MU.T, CU.T

    u0s = u0s.to(dtype)
    s = flat_init_batched(bmv, None, u0s, params)
    s, _ = drive(make_tick(bmv, params, dtype), None, s)
    best = int(torch.argmax(s.F))
    u, F = s.u[best], s.F[best]
    mask = msrc.round_solution(u, F, _nonzero_if_dsd(params.rounding))
    return Solution(ifinal=s.i[best], mask=mask, u0=u0s[best], u=u, score=F)
