"""Core MSRC solver: graduated projected gradient ascent, and its helpers.

Counterpart of ``clipper_tpu/solvers/msrc.py`` (reference:
src/clipper.cpp:172-323): thresholds, stall guard, rounding and the nested
solver (:func:`run_pga`, the reference-shaped triple loop of outer
homotopy, inner ascent and backtracking line search). The JAX package runs
the three loops as nested ``lax.while_loop``s; here they are host loops
that read each loop condition from the device. Working dtypes are explicit
``torch.dtype``s.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Tuple

import torch

from clipper_tpu_torch.types import Params, Rounding, Solution
from clipper_tpu_torch.utils import profiling


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
    boundary select the same vertices as the JAX package. The tracer's
    span ``facade.round`` (utils/profiling).
    """
    with profiling.annotate("facade.round"):
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


class PGAOperators(NamedTuple):
    """Pluggable linear operators for the PGA loop (see the JAX module)."""

    mv_M: Callable        # u -> M @ u
    mv_C: Callable        # u -> C @ u
    make_mv_Md: Callable  # d -> (u -> (M + d C) @ u), may precompute Md


def dense_operators(M: torch.Tensor, C: torch.Tensor,
                    fuse_md: bool = True) -> PGAOperators:
    """Operators over dense (m, m) M and C: plain matrix products.

    An f32 product on the card depends on
    torch.backends.cuda.matmul.allow_tf32; this raises when TF32 is on
    rather than change the process-wide flag."""
    if (M.is_cuda and M.dtype == torch.float32
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "dense_operators: f32 matrices on the card need "
            "torch.backends.cuda.matmul.allow_tf32 = False")
    if fuse_md:
        def make(d):
            Md = M + d * C
            return lambda u: Md @ u
    else:
        def make(d):
            # reference: src/clipper.cpp:219 operation order (2 matvecs)
            return lambda u: M @ u + (C @ u) * d
    return PGAOperators(mv_M=lambda u: M @ u, mv_C=lambda u: C @ u,
                        make_mv_Md=make)


def find_dense_clique(M: torch.Tensor, C: torch.Tensor, u0: torch.Tensor,
                      params: Params = Params(), *, fuse_md: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Graduated projected gradient ascent on dense (m, m) M and C (zero
    diagonals, implicit identity) from u0 (m,). fuse_md precomputes
    Md = M + d C once per outer iteration. Returns (u, F, ifinal)."""
    return run_pga(dense_operators(M, C, fuse_md), u0, params,
                   dtype=M.dtype)


def run_pga(ops: PGAOperators, u0: torch.Tensor, params: Params, *,
            dtype=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The PGA + homotopy loop over abstract matvec operators
    (reference: src/clipper.cpp:193-281). Each loop condition is one host
    read; the arithmetic is the JAX package's, step for step.

    While a profiler runs, the loop records the tracer's spans ``pga``,
    ``pga.outer`` (a pass of the outer loop), ``pga.inner`` (an inner
    step) and ``pga.line_search``, and publishes its counts once a solve:
    ``pga.host_reads`` (the loop-condition reads), ``pga.linesearch_steps``
    (trials, one (M + d C) u product each), ``pga.inner_steps``,
    ``pga.outer_steps`` and ``pga.read_wait_ns`` (the host's time blocked
    in those reads). See utils/profiling."""
    with profiling.annotate("pga"):
        return _run_pga(ops, u0, params, dtype or u0.dtype)


def _run_pga(ops: PGAOperators, u0: torch.Tensor, params: Params, dtype
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    u0 = u0.to(dtype)
    eps = params.eps
    on = profiling.tracing()
    reads = ls_steps = inner_steps = outer_steps = wait_ns = 0

    def read(flag: torch.Tensor) -> bool:
        # one loop condition on the host, timed only while tracing
        nonlocal reads, wait_ns
        reads += 1
        if not on:
            return bool(flag)
        t0 = time.perf_counter_ns()
        value = bool(flag)
        wait_ns += time.perf_counter_ns() - t0
        return value

    def grad_fn(u, d, mv_Md):
        return (1.0 + d) * u - d * u.sum() + mv_Md(u)

    def norm(x):
        return torch.linalg.vector_norm(x)

    # ---- initialization (reference: src/clipper.cpp:193-209) ----
    u = ops.mv_M(u0) + u0 if params.rescale_u0 else u0
    u = u / norm(u)

    def compute_d_terms(u):
        su = u.sum()
        Cbu = su - ops.mv_C(u) - u
        idxD = (Cbu > _eps_active(eps, su, dtype)) & (u > eps)
        ratio = (ops.mv_M(u) + u) / torch.where(idxD, Cbu, 1.0)
        return idxD, ratio

    idxD, ratio = compute_d_terms(u)
    d = torch.where(idxD.any(), _masked_mean(ratio, idxD), 0.0).to(dtype)

    # ---- line search (reference: src/clipper.cpp:234-252) ----
    def line_search(u, gradF, F, d, mv_Md):
        nonlocal ls_steps
        alpha = torch.ones((), dtype=dtype, device=u.device)
        unew, gradFnew, Fnew = u, gradF, F
        deltaF = torch.zeros((), dtype=dtype, device=u.device)
        for _ in range(params.maxlsiters):
            ls_steps += 1
            unew = torch.clamp(u + alpha * gradF, min=0.0)
            unew = unew / norm(unew)
            gradFnew = grad_fn(unew, d, mv_Md)
            Fnew = torch.dot(unew, gradFnew)
            deltaF = Fnew - F
            if not read(deltaF < -_eps_like(eps, torch.abs(F), dtype)):
                break
            alpha = alpha * params.beta
        return unew, gradFnew, Fnew, deltaF

    # ---- inner PGA loop (reference: src/clipper.cpp:226-261) ----
    tol_u = _eps_like(params.tol_u, 1.0, dtype)        # ||u|| = 1

    def inner_loop(u, gradF, F, d, mv_Md):
        nonlocal inner_steps
        u_in = u
        j = 0
        while j < params.maxiniters:
            with profiling.annotate("pga.inner"):
                inner_steps += 1
                with profiling.annotate("pga.line_search"):
                    unew, gradF, Fnew, deltaF = line_search(u, gradF, F, d,
                                                            mv_Md)
                deltau = norm(unew - u)
                tol_F = _eps_like(params.tol_F, torch.abs(Fnew), dtype)
                u, F = unew, Fnew
                j += 1
                if read((deltau < tol_u) | (torch.abs(deltaF) < tol_F)):
                    break
        # frozen: converged on the very first step without moving u (the
        # stalled-homotopy signature, see _STALL_OUTERS)
        frozen = j <= 1 and read(norm(u - u_in) < tol_u)
        return u, F, frozen

    # ---- outer homotopy loop (reference: src/clipper.cpp:218-281) ----
    stall_guard = _stall_guard_enabled(dtype)
    i, stall = 0, 0
    F = torch.zeros((), dtype=dtype, device=u.device)
    while i < params.maxoliters:
        with profiling.annotate("pga.outer"):
            outer_steps += 1
            mv_Md = ops.make_mv_Md(d)
            gradF = grad_fn(u, d, mv_Md)
            F = torch.dot(u, gradF)
            u, F, frozen = inner_loop(u, gradF, F, d, mv_Md)
            idxD, ratio = compute_d_terms(u)
            active = read(idxD.any())
            # ifinal: the reference's `break` leaves i at the index of the
            # terminating iteration (reference: src/clipper.cpp:278-280,318)
            if active:
                d = d + _masked_mean(torch.abs(ratio), idxD)
                i += 1
            stall = stall + 1 if frozen else 0
        if not active or (stall_guard and stall >= _STALL_OUTERS):
            break
    ifinal = torch.tensor(i, dtype=torch.int32, device=u.device)
    if on:
        profiling.count({"pga.host_reads": reads,
                         "pga.linesearch_steps": ls_steps,
                         "pga.inner_steps": inner_steps,
                         "pga.outer_steps": outer_steps,
                         "pga.read_wait_ns": wait_ns})
    return u, F, ifinal


def solve_msrc(M: torch.Tensor, C: torch.Tensor, u0: torch.Tensor,
               params: Params = Params(), *, fuse_md: bool = True) -> Solution:
    """Full dense solve: PGA + rounding (NONZERO / DSD_HEU; DSD rounds
    NONZERO here, as in the JAX package, whose facade reruns exact DSD)."""
    u, F, ifinal = find_dense_clique(M, C, u0, params, fuse_md=fuse_md)
    rounding = params.rounding
    if rounding == Rounding.DSD:
        rounding = Rounding.NONZERO
    mask = round_solution(u, F, rounding)
    return Solution(ifinal=ifinal, mask=mask, u0=u0, u=u, score=F)
