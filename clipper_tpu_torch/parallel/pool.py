"""Pool scheduler: lane compaction over flat-triangle storage.

Counterpart of the main-path subset of ``clipper_tpu/parallel/pool.py``
(:95-238, :241-336, :387-718) for ``layout="tri"``. A device-resident pool
of W prepared problems feeds B active lanes; the schedule alternates

  * ``window`` solver ticks on the B lanes (converged lanes freeze), and
  * a compaction step: finished lanes write their result out and take the
    next problem from the pool.

The JAX package runs this as one on-device ``while_loop``. Here it is a
host loop over windows: the ticks of a window and the compaction are
enqueued without host reads, and reading ``any(active)`` costs one host
synchronisation per window.
"""

from __future__ import annotations

import time
import warnings
from typing import Dict, Optional

import torch

from clipper_tpu_torch.invariants.base import PairwiseInvariant
from clipper_tpu_torch.ops import flattri
from clipper_tpu_torch.ops.affinity import distinctness_mask, gather_endpoints
from clipper_tpu_torch.solvers import msrc, msrc_flat
from clipper_tpu_torch.types import Params, Rounding, Solution, resolve_device


# the polish rebuilds F on the top-_SUPPORT entries of each u
_SUPPORT = 256


def _take(state: msrc_flat._FlatState, k: torch.Tensor) -> msrc_flat._FlatState:
    return msrc_flat._FlatState(*(a[k] for a in state))


def _pool_schedule(vtick, inits: msrc_flat._FlatState, m: int, *,
                   lanes: int, window: int, return_windows: bool = False):
    """The lane-compaction loop. vtick(idx, lane_states) advances every
    lane one probe tick (done lanes freeze themselves). Returns
    (u, F, ifinal) of shapes (W, m), (W,), (W,)."""
    W = inits.u.shape[0]
    B = min(lanes, W)
    dtype = inits.u.dtype
    dev = inits.u.device

    idx = torch.arange(B, dtype=torch.int32, device=dev)
    ls = _take(inits, idx.long())
    active = torch.ones(B, dtype=torch.bool, device=dev)
    next_ptr = torch.tensor(B, dtype=torch.int32, device=dev)
    # one spare row W takes the writes of lanes that did not finish
    u_out = torch.zeros(W + 1, m, dtype=dtype, device=dev)
    F_out = torch.zeros(W + 1, dtype=dtype, device=dev)
    i_out = torch.zeros(W + 1, dtype=torch.int32, device=dev)
    nwin = 0

    while bool(active.any()):
        safe_idx = torch.clamp(idx, 0, W - 1)
        for _ in range(window):
            ls = vtick(safe_idx, ls)

        finished = ls.done & active
        widx = torch.where(finished, idx, W).long()
        u_out[widx] = ls.u
        F_out[widx] = ls.F
        i_out[widx] = ls.i

        rank = torch.cumsum(finished.to(torch.int32), 0) - 1
        new_idx = next_ptr + rank.to(torch.int32)
        has_work = finished & (new_idx < W)
        idx = torch.where(has_work, new_idx, idx)
        active = torch.where(finished, has_work, active)
        next_ptr = next_ptr + finished.sum(dtype=torch.int32)

        fresh = _take(inits, torch.clamp(idx, 0, W - 1).long())
        ls = msrc_flat._FlatState(*(msrc_flat._where(has_work, f, o)
                                    for f, o in zip(fresh, ls)))
        ls = ls._replace(done=torch.where(has_work, False, ls.done))
        nwin += 1

    out = (u_out[:W], F_out[:W], i_out[:W])
    return out + (nwin,) if return_windows else out


def solve_pool_tri(tri: torch.Tensor, nt: int, inits: msrc_flat._FlatState,
                   params: Params = Params(), *, lanes: int = 128,
                   window: int = 8, warm_alpha: bool = False,
                   probes: int = 1, d_scale: float = 1.0,
                   return_windows: bool = False):
    """Solve W prepared lane instances over (P, 2t, S) flat-triangle
    storage with B=lanes compacted lanes; one batched tri matvec per tick
    (the CUDA kernel for storage on the card); lane instance w reads
    storage row w."""
    dtype = inits.u.dtype
    t = tri.shape[1] // 2
    m = nt * t
    bmv = flattri.make_tri_pool_matvec(tri, nt, dtype)
    if probes > 1:
        btick = msrc_flat.make_flat_tick_multiprobe_batched(
            bmv, params, dtype, probes, warm_alpha=warm_alpha,
            d_scale=d_scale)
    else:
        btick = msrc_flat.make_flat_tick_batched(
            bmv, params, dtype, warm_alpha=warm_alpha, d_scale=d_scale)
    return _pool_schedule(btick, inits, m, lanes=lanes, window=window,
                          return_windows=return_windows)


def _pool_rounding(params: Params) -> Rounding:
    """Exact DSD rounding needs the host solver: downgraded to NONZERO
    with a warning, as in the JAX package."""
    if params.rounding == Rounding.DSD:
        warnings.warn(
            "pool pipelines cannot run exact (host-side) DSD rounding; "
            "downgrading to Rounding.NONZERO", stacklevel=3)
        return Rounding.NONZERO
    return params.rounding


def support_objective(invariant: PairwiseInvariant, P1, P2, A, u,
                      affinityeps: float = 1e-4, k: int = 256,
                      include_identity: bool = True):
    """u'(M + I)u on u's top-k support, batched over leading dims:
    P1/P2 (..., m, d), A (..., m, 2), u (..., m). Exact when u has <= k
    nonzeros (callers guard; see :func:`make_pool_pipeline`)."""
    m = u.shape[-1]
    k = min(k, m)
    vals, idx = torch.topk(u, k, dim=-1, sorted=True)
    ix = idx[..., None]
    Ak = torch.gather(A, -2, ix.expand(*idx.shape, A.shape[-1]))
    P1k = torch.gather(P1, -2, ix.expand(*idx.shape, P1.shape[-1]))
    P2k = torch.gather(P2, -2, ix.expand(*idx.shape, P2.shape[-1]))
    scores = invariant.score_block(P1k, P1k, P2k, P2k)
    keep = distinctness_mask(Ak) & (scores > affinityeps)
    Mu_blk = torch.triu(torch.where(keep, scores, 0.0), diagonal=1)
    Mk = Mu_blk + Mu_blk.transpose(-1, -2)
    # elementwise products and sums, not a matmul: the result does not
    # depend on torch.backends.cuda.matmul.allow_tf32
    F = (vals * (Mk * vals[..., None, :]).sum(-1)).sum(-1)
    if include_identity:
        F = F + (u * u).sum(-1)
    return F


def exact_objective_rows(invariant: PairwiseInvariant, P1, P2, A, u,
                         affinityeps: float = 1e-4, chunk: int = 128):
    """F = u'(M + I)u rebuilt exactly, ``chunk`` rows at a time, batched
    over leading dims: exact at any clique width with (..., chunk, m)
    transient memory. Pad rows (A = -1) are masked explicitly."""
    m = u.shape[-1]
    ch = _divisor_at_most(m, chunk)
    acc_dtype = torch.promote_types(u.dtype, torch.float32)
    uf = u.to(acc_dtype)
    F = torch.zeros(u.shape[:-1], dtype=acc_dtype, device=u.device)
    real_c = (A >= 0).all(-1)
    for s in range(0, m, ch):
        Ar = A[..., s:s + ch, :]
        scores = invariant.score_block(P1[..., s:s + ch, :], P1,
                                       P2[..., s:s + ch, :], P2)
        distinct = ~((Ar[..., :, 0, None] == A[..., None, :, 0])
                     | (Ar[..., :, 1, None] == A[..., None, :, 1]))
        real = real_c[..., s:s + ch, None] & real_c[..., None, :]
        keep = distinct & real & (scores > affinityeps)
        Mr = torch.where(keep, scores, 0.0).to(acc_dtype)
        F = F + (uf[..., s:s + ch] * (Mr * uf[..., None, :]).sum(-1)).sum(-1)
    return F + (uf * uf).sum(-1)


def _divisor_at_most(n: int, k: int) -> int:
    k = max(1, min(n, k))
    while n % k:
        k -= 1
    return k


class StageClock:
    """Per-stage times: CUDA events on the card, the host clock on the CPU
    (where the times are host times, not device times)."""

    def __init__(self, dev: torch.device, out: Optional[Dict[str, float]]):
        self.dev, self.out, self.marks = dev, out, []

    def mark(self, name: str):
        if self.out is None:
            return
        if self.dev.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def finish(self):
        if self.out is None or not self.marks:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            self.out[name] = (a.elapsed_time(b) if self.dev.type == "cuda"
                              else (b - a) * 1e3)


def make_pool_pipeline(invariant: PairwiseInvariant,
                       params: Params = Params(),
                       affinityeps: float = 1e-4,
                       storage_dtype=torch.int8,
                       lanes: int = 128,
                       window: int = 8,
                       power_steps: int = 0,
                       mesh=None,
                       layout: str = "tri",
                       tri_probes: int = 1,
                       warm_alpha: bool = False,
                       d_scale: float = 1.0,
                       device="cuda"):
    """(D1, D2s, As, u0s) -> batched Solution through the pool engine.

    End to end: the flat-triangle [M; C] build (the CUDA build kernel for
    int8 storage on the card), power-init and flat-init through the
    batched tri matvec, the compacted pool solve, a polish of F = u'(M+I)u
    on the top-256 entries of u in the working dtype (the exact
    row-chunked rebuild when a support overflows), and rounding.

    Shapes: D1 (n1, d) shared by all problems or (W, n1, d), D2s
    (W, n2, d), As (W, m, 2), u0s (W, m); numpy arrays or tensors. The
    pipeline runs on ``device`` ("cuda" by default; raises if missing).
    ``layout="tri"`` only: m must divide by the tile (256 when it does,
    else 128). storage_dtype=None keeps full precision (plain build); on
    the card the kernels take int8 storage (and f32/f64 for the matvec),
    so bfloat16 storage raises there.
    """
    if layout != "tri":
        raise NotImplementedError(
            "layout='stacked' is not ported yet (ROADMAP.md Queue 1 item 10)")
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported yet (ROADMAP.md Queue 1 item 13)")
    dev = resolve_device(device)
    rounding = _pool_rounding(params)

    def tri_meta(m: int):
        t = 256 if m % 256 == 0 else 128
        if m % t:
            raise ValueError(
                f"pool layout='tri' needs m divisible by {t}; got m={m}")
        return t, m // t

    def as_tensor(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    def pipeline(D1, D2s, As, u0s, m_trues=None,
                 timings: Optional[Dict[str, float]] = None) -> Solution:
        """m_trues: optional (W,) per-problem true sizes (rows/cols >=
        m_true are inert). timings: optional dict filled with per-stage
        milliseconds (build, init, solve, polish)."""
        u0s = as_tensor(u0s)
        dtype = u0s.dtype
        D1 = as_tensor(D1, dtype)
        D2s = as_tensor(D2s, dtype)
        As = as_tensor(As, torch.int32)
        W, m, _ = As.shape
        t, nt = tri_meta(m)
        if m_trues is None:
            m_trues = torch.full((W,), m, dtype=torch.int32, device=dev)
        m_trues = as_tensor(m_trues, torch.int32)
        clock = StageClock(dev, timings)

        clock.mark("start")
        P1s, P2s = gather_endpoints(D1, D2s, As)
        if storage_dtype is None:
            tri = flattri.build_tri_plain(
                invariant, P1s, P2s, As, m_trues, t=t,
                affinityeps=affinityeps, storage_dtype=None)
        else:
            tri = flattri.build_tri(
                invariant, P1s, P2s, As, m_trues, t=t,
                affinityeps=affinityeps, storage_dtype=storage_dtype)
        clock.mark("build")

        bmv = flattri.make_tri_pool_matvec(tri, nt, dtype)
        idx = torch.arange(W, dtype=torch.int32, device=dev)
        u = u0s
        if power_steps:
            u = msrc_flat.power_init_batched(bmv, idx, u, power_steps)
        inits = msrc_flat.flat_init_batched(bmv, idx, u, params)
        clock.mark("init")

        u, F, ifinal = solve_pool_tri(
            tri, nt, inits, params, lanes=lanes, window=window,
            probes=tri_probes, warm_alpha=warm_alpha, d_scale=d_scale)
        clock.mark("solve")

        nnz_widest = int((u > 0).sum(-1).max())
        if nnz_widest > _SUPPORT:
            Fp = exact_objective_rows(invariant, P1s, P2s, As, u,
                                      affinityeps=affinityeps)
        else:
            Fp = support_objective(invariant, P1s, P2s, As, u,
                                   affinityeps=affinityeps, k=_SUPPORT)
        Fp = Fp.to(dtype)
        mask = msrc.round_solution(u, Fp, rounding)
        clock.mark("polish")
        clock.finish()
        return Solution(ifinal=ifinal, mask=mask, u0=u0s, u=u, score=Fp)

    return pipeline
