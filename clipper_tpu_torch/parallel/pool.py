"""Pool scheduler: lane compaction over stacked or flat-triangle storage.

Counterpart of ``clipper_tpu/parallel/pool.py``. A device-resident pool
of W prepared problems feeds B active lanes; the schedule alternates

  * ``window`` solver ticks on the B lanes (converged lanes freeze), and
  * a compaction step: finished lanes write their result out and take the
    next problem from the pool.

The JAX package runs this as one on-device ``while_loop``. Here it is a
host loop over windows: the ticks of a window and the compaction are
enqueued without host reads, and reading ``any(active)`` costs one host
synchronisation per window.

Two storage layouts, as in the JAX package: ``"stacked"`` keeps each
problem's dense (2m, m) [M; C] (any m; the build kernel
csrc/stored_build.cu on the card), and ``"tri"`` its flat upper triangle
(m divisible by 128; the kernels csrc/tri_build.cu and csrc/tri_matvec.cu).
:func:`solve_pool_tri` also solves over the triangle's tile-major form
(csrc/tri_tiles_matvec.cu). The build kernels compute any symmetric
invariant with a device score: the Euclidean and the point-normal
invariants, and a user's own (invariants.DeviceScore).
:func:`make_pool_multistart_pipeline` runs K restarts of each problem as
extra lanes over the stacked storage. ``mesh=`` splits the W problems
over a ``torch.distributed`` group, a compaction loop a rank.
"""

from __future__ import annotations

import time
import warnings
from typing import Dict, Optional

import torch
import torch.distributed as dist

from clipper_tpu_torch.invariants import kernel_builds
from clipper_tpu_torch.invariants.base import PairwiseInvariant
from clipper_tpu_torch.ops import affinity_pallas, flattri
from clipper_tpu_torch.ops.affinity import (distinctness_mask,
                                            gather_endpoints,
                                            pairwise_from_endpoints,
                                            stored_from_endpoints)
from clipper_tpu_torch.solvers import msrc, msrc_flat
from clipper_tpu_torch.types import Params, Rounding, Solution, resolve_device


def _take(state: msrc_flat._FlatState, k: torch.Tensor) -> msrc_flat._FlatState:
    return msrc_flat._FlatState(*(a[k] for a in state))


def _pool_schedule(vtick, inits: msrc_flat._FlatState, m: int, *,
                   lanes: int, window: int, return_windows: bool = False,
                   stats: Optional[Dict] = None):
    """The lane-compaction loop. vtick(idx, lane_states) advances every
    lane one probe tick (done lanes freeze themselves). Returns
    (u, F, ifinal) of shapes (W, m), (W,), (W,). stats, when given, gets
    "windows" and "ticks" (each problem's probe ticks, (W,))."""
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
    t_out = torch.zeros(W + 1, dtype=torch.int32, device=dev)
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
        t_out[widx] = ls.ticks

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

    if stats is not None:
        stats.update(windows=nwin, ticks=t_out[:W])
    out = (u_out[:W], F_out[:W], i_out[:W])
    return out + (nwin,) if return_windows else out


def solve_pool(MCs: torch.Tensor, inits: msrc_flat._FlatState,
               params: Params = Params(), *, lanes: int = 128,
               window: int = 8, problem_of: Optional[torch.Tensor] = None,
               return_windows: bool = False, stats: Optional[Dict] = None):
    """Solve W prepared lane instances over (P, 2m, m) stacked [M; C]
    storage (any storage dtype) with B=lanes compacted lanes, one
    single-probe tick at a time.

    problem_of: optional (W,) mapping of each init to its storage row, so
    several inits (multistart restarts) share one stored matrix; each tick
    gathers MCs[problem_of[idx]] for its lanes. Omitted, init w reads row
    w, and P must equal W. Returns (u, F, ifinal) of shapes (W, m), (W,),
    (W,)."""
    P, _, m = MCs.shape
    W = inits.u.shape[0]
    if problem_of is None and P != W:
        raise ValueError(
            f"solve_pool: {W} inits over {P} stored matrices requires an "
            f"explicit problem_of mapping (P == W only when omitted)")
    dtype = inits.u.dtype
    bmv = msrc_flat.make_stacked_pool_matvec(MCs, dtype)
    if problem_of is not None:
        rows = torch.as_tensor(problem_of, device=MCs.device).long()
        base = bmv

        def bmv(idx, U):
            return base(rows[idx.long()], U)

    btick = msrc_flat.make_flat_tick_batched(bmv, params, dtype)
    return _pool_schedule(btick, inits, m, lanes=lanes, window=window,
                          return_windows=return_windows, stats=stats)


def solve_pool_tri(tri: torch.Tensor, nt: int, inits: msrc_flat._FlatState,
                   params: Params = Params(), *, lanes: int = 128,
                   window: int = 8, matvec: str = "auto",
                   warm_alpha: bool = False, probes: int = 1,
                   stall_outers: int = 0, d_scale: float = 1.0,
                   return_windows: bool = False,
                   stats: Optional[Dict] = None):
    """Solve W prepared lane instances over (P, 2t, S) flat-triangle or
    (P, T, 2t, t) tile-major storage (ops/flattri.py) with B=lanes
    compacted lanes; one batched matvec per tick; lane instance w reads
    storage row w.

    matvec: 'auto' | 'tiles' | 'pallas' | 'xla'. 'tiles' is the tile-major
    matvec (csrc/tri_tiles_matvec.cu on the card), 'pallas' the flat one
    (csrc/tri_matvec.cu); either takes its plain version for CPU storage.
    'auto' picks by the storage's rank, 4-D 'tiles' and 3-D 'pallas'.
    'xla' is the plain version on every device. The JAX package's 'auto'
    raised for 4-D storage on the TPU only because Mosaic miscompiled the
    tile-major kernel there. The tile-major matvec takes one probe a lane,
    so 4-D storage with probes > 1 raises. stall_outers: the
    stalled-homotopy guard's count of frozen outers (0, the default:
    msrc._STALL_OUTERS)."""
    if matvec not in ("auto", "tiles", "pallas", "xla"):
        raise ValueError(f"unknown matvec {matvec!r}")
    dtype = inits.u.dtype
    tile_major = tri.dim() == 4
    if matvec == "auto":
        matvec = "tiles" if tile_major else "pallas"
    if (matvec == "tiles") != tile_major and matvec != "xla":
        raise ValueError(f"matvec={matvec!r} does not take "
                         f"{tri.dim()}-D storage")
    if tile_major and probes > 1:
        raise ValueError("the tile-major matvec takes one probe a lane; "
                         f"got probes={probes}")
    t = tri.shape[-1] if tile_major else tri.shape[1] // 2
    m = nt * t
    maker = {("tiles", True): flattri.make_tri_pool_matvec_tiles,
             ("xla", True): flattri.make_tri_pool_matvec_tiles_xla,
             ("pallas", False): flattri.make_tri_pool_matvec,
             ("xla", False): flattri.make_tri_pool_matvec_xla}
    bmv = maker[(matvec, tile_major)](tri, nt, dtype)
    btick = msrc_flat.make_tick(bmv, params, dtype, probes=probes,
                                warm_alpha=warm_alpha, d_scale=d_scale,
                                stall_outers=stall_outers)
    return _pool_schedule(btick, inits, m, lanes=lanes, window=window,
                          return_windows=return_windows, stats=stats)


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


def support_polish(invariant: PairwiseInvariant, D1, D2, A, u,
                   affinityeps: float = 1e-4, k: int = 256):
    """u'(M + I)u restricted to u's top-k support, from the datasets D1
    (n1, d), D2 (n2, d) and A (m, 2) (see :func:`support_objective`)."""
    P1, P2 = gather_endpoints(D1, D2, A)
    return support_objective(invariant, P1, P2, A, u,
                             affinityeps=affinityeps, k=k)


def _polish_batch(invariant: PairwiseInvariant, P1s, P2s, As, U,
                  support: Optional[int], affinityeps: float):
    """F = u'(M + I)u of every row of U, rebuilt from the endpoints in the
    working precision, for the pipelines' rounding (omega = round(F) needs
    F accurate to well under 0.5). U is (W, m), or (W, K, m) for K
    restarts of each of the W problems. The top-``support`` polish is
    exact only when every support fits, so a wider one (one host read of
    the widest) takes the exact row-chunked rebuild for the whole batch,
    as the JAX pipelines' in-graph branch does (pool.py:605-630);
    support=None rebuilds the full (m, m) M."""
    if U.dim() == 3:
        K = U.shape[1]
        P1s, P2s, As = (x[:, None].expand(-1, K, *x.shape[1:])
                        for x in (P1s, P2s, As))
    m = U.shape[-1]
    if support is None:
        M, _ = pairwise_from_endpoints(invariant, P1s, P2s, As,
                                       affinityeps=affinityeps)
        # elementwise products and sums: independent of the TF32 flag
        Fp = (U * ((M * U[..., None, :]).sum(-1) + U)).sum(-1)
    elif support < m and int((U > 0).sum(-1).max()) > support:
        Fp = exact_objective_rows(invariant, P1s, P2s, As, U,
                                  affinityeps=affinityeps)
    else:
        Fp = support_objective(invariant, P1s, P2s, As, U,
                               affinityeps=affinityeps, k=support)
    return Fp.to(U.dtype)


def _resolve_build(build: str, storage_dtype, invariant,
                   dev: torch.device) -> str:
    """'auto' -> 'pallas' (the build kernel) on the card for int8 or bf16
    storage and a symmetric invariant with a device score (the built-ins,
    or a user's own ``DeviceScore``: invariants.kernel_builds), else 'xla'
    (the plain build), mirroring the JAX package's pool.py:346-370, which
    takes its kernel for any symmetric invariant with ``score_block_t``.
    'pallas' takes the kernel on the card, which raises for an invariant
    without a device score, and its plain version on the CPU."""
    if build not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown build {build!r}")
    if build == "pallas" and storage_dtype is None:
        raise ValueError(
            "build='pallas' requires a direct-to-storage dtype "
            "(storage_dtype=torch.int8/torch.bfloat16); the fused kernel "
            "quantizes as it builds and has no dense full-precision output")
    if build == "auto":
        if (dev.type == "cuda"
                and storage_dtype in (torch.int8, torch.bfloat16)
                and kernel_builds(invariant)):
            return "pallas"
        return "xla"
    return build


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


def _as_tensor(dev):
    def conv(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=dev)
    return conv


def _build_stacked(invariant, P1s, P2s, As, m_trues, storage_dtype, build,
                   affinityeps):
    """(W, 2m, m) stacked [M; C] storage: full precision when
    storage_dtype is None, else int8 codes or a float storage dtype, by
    the build kernel ('pallas') or the plain build ('xla')."""
    if storage_dtype is None:
        M, C = pairwise_from_endpoints(invariant, P1s, P2s, As,
                                       affinityeps=affinityeps,
                                       m_true=m_trues)
        return torch.cat([M, C], dim=-2)
    if build == "pallas":
        return affinity_pallas.stored_build(
            invariant, P1s, P2s, As, m_trues, affinityeps=affinityeps,
            storage_dtype=storage_dtype)
    return stored_from_endpoints(invariant, P1s, P2s, As,
                                 affinityeps=affinityeps, m_true=m_trues,
                                 storage_dtype=storage_dtype)


def rank_rows(W: int, D: int, rank: int, what: str = "workload W") -> slice:
    """Rank ``rank``'s rows of W split over D ranks: [r W / D, (r + 1) W /
    D); raises when D does not divide W."""
    if W % D:
        raise ValueError(f"{what}={W} must be divisible by the mesh size {D}")
    return slice(rank * W // D, (rank + 1) * W // D)


def gather_rows(x: torch.Tensor, rows: slice, W: int, group) -> torch.Tensor:
    """This rank's rows ``rows`` of a (W, ...) result -> the whole (W, ...)
    on every rank of ``group``: an all-reduce of a buffer that is zero
    outside each rank's rows, exact (x + 0 = x), on NCCL and on gloo's
    CUDA tensors alike. A group of one rank makes no collective call."""
    if dist.get_world_size(group) == 1:
        return x
    buf = x.new_zeros((W,) + x.shape[1:])
    buf[rows] = x
    dist.all_reduce(buf, group=group)
    return buf


def make_pool_pipeline(invariant: PairwiseInvariant,
                       params: Params = Params(),
                       affinityeps: float = 1e-4,
                       storage_dtype=torch.int8,
                       lanes: int = 128,
                       window: int = 8,
                       support: Optional[int] = 256,
                       power_steps: int = 0,
                       mesh=None,
                       axis_name: str = "b",
                       build: str = "auto",
                       layout: str = "tri",
                       tri_tile: int = 0,
                       tri_probes: int = 1,
                       warm_alpha: bool = False,
                       stall_outers: int = 0,
                       d_scale: float = 1.0,
                       device="cuda"):
    """(D1, D2s, As, u0s) -> batched Solution through the pool engine.

    End to end: the [M; C] build into the pool's storage, power-init and
    flat-init through the same batched matvec the solve uses, the
    compacted pool solve, a polish of F = u'(M+I)u on the top-``support``
    entries of u in the working dtype (the exact row-chunked rebuild when
    a support is wider; support=None rebuilds the full (m, m) M), and
    rounding.

    layout: ``"tri"`` (the default here; the JAX package defaults to
    ``"stacked"``) stores the flat upper triangle, m divisible by the tile
    ``tri_tile`` (0, the default: 256 when it divides m, else 128; the
    card's kernels take any tile, by the routes of
    ``flattri.matvec_route``), with the K=tri_probes multiprobe
    tick and the warm_alpha, stall_outers and d_scale options. ``"stacked"`` stores the
    dense (2m, m) [M; C] of each problem, for any m, and runs the
    single-probe reference tick; the tri-only options raise there (the
    JAX package ignores them).

    storage_dtype: int8 (the default here; the JAX package's is bfloat16),
    bfloat16, or None for full precision (the plain build). build: 'auto'
    | 'pallas' | 'xla' (see :func:`_resolve_build`): 'auto' takes the
    build kernel on the card (csrc/tri_build.cu for int8 or bf16
    triangles, csrc/stored_build.cu for int8 or bf16 stacked storage) for
    any symmetric invariant with a device score: the Euclidean and
    point-normal invariants, and a user's own ``DeviceScore``, whose
    library is compiled at first use.

    Shapes: D1 (n1, d) shared by all problems or (W, n1, d), D2s
    (W, n2, d), As (W, m, 2), u0s (W, m); numpy arrays or tensors. The
    pipeline runs on ``device`` ("cuda" by default; raises if missing).

    mesh: optional ``torch.distributed`` ProcessGroup of D ranks for data
    parallelism (the JAX package's 1D mesh; ``axis_name`` only keeps its
    signature). Every rank calls the pipeline with the whole workload; W
    must divide by D. Each rank builds the storage of its W / D problems
    (rank r takes problems r W / D to (r + 1) W / D) and runs its own
    compaction loop, with no collective inside it; the ranks then gather
    u and ifinal once (an all-reduce of buffers that are zero outside
    each rank's rows: exact), and every rank polishes and rounds all W,
    so each returns the W-problem Solution that ``mesh=None`` gives.
    ``timings`` and ``stats`` then hold this rank's loop (``stats``: its
    windows and its problems' ticks) and the gather's ms.
    """
    if layout not in ("tri", "stacked"):
        raise ValueError(f"unknown layout {layout!r}")
    if mesh is not None and not isinstance(mesh, dist.ProcessGroup):
        raise TypeError("mesh must be a torch.distributed ProcessGroup "
                        f"(or None); got {type(mesh).__name__}")
    if layout == "stacked" and (tri_probes != 1 or warm_alpha
                                or d_scale != 1.0 or tri_tile
                                or stall_outers):
        raise ValueError("tri_tile, tri_probes, warm_alpha, stall_outers "
                         "and d_scale apply to layout='tri' only")
    dev = resolve_device(device)
    rounding = _pool_rounding(params)
    build = _resolve_build(build, storage_dtype, invariant, dev)
    as_tensor = _as_tensor(dev)

    def tri_meta(m: int):
        t = tri_tile or (256 if m % 256 == 0 else 128)
        if m % t:
            raise ValueError(
                f"pool layout='tri' needs m divisible by {t}; got m={m} "
                f"(use layout='stacked' or pad the workload)")
        return t, m // t

    def build_tri(P1s, P2s, As, m_trues, m):
        t, nt = tri_meta(m)
        fn = flattri.build_tri if build == "pallas" else \
            flattri.build_tri_plain
        return fn(invariant, P1s, P2s, As, m_trues, t=t,
                  affinityeps=affinityeps, storage_dtype=storage_dtype), nt

    def pipeline(D1, D2s, As, u0s, m_trues=None,
                 timings: Optional[Dict[str, float]] = None,
                 stats: Optional[Dict] = None) -> Solution:
        """m_trues: optional (W,) per-problem true sizes (rows/cols >=
        m_true are inert). timings: optional dict filled with per-stage
        milliseconds (build, init, solve, with a mesh gather, polish).
        stats: optional dict filled with the pool's windows and
        per-problem ticks."""
        u0s = as_tensor(u0s)
        dtype = u0s.dtype
        D1 = as_tensor(D1, dtype)
        D2s = as_tensor(D2s, dtype)
        As = as_tensor(As, torch.int32)
        W, m, _ = As.shape
        if m_trues is None:
            m_trues = torch.full((W,), m, dtype=torch.int32, device=dev)
        m_trues = as_tensor(m_trues, torch.int32)
        clock = StageClock(dev, timings)

        clock.mark("start")
        rows = slice(0, W)
        if mesh is not None:
            rows = rank_rows(W, dist.get_world_size(mesh),
                             dist.get_rank(mesh))
        D1r = D1[rows] if D1.dim() == 3 else D1
        P1s, P2s = gather_endpoints(D1r, D2s[rows], As[rows])
        if layout == "tri":
            store, nt = build_tri(P1s, P2s, As[rows], m_trues[rows], m)
            bmv = flattri.make_tri_pool_matvec(store, nt, dtype)
        else:
            store = _build_stacked(invariant, P1s, P2s, As[rows],
                                   m_trues[rows], storage_dtype, build,
                                   affinityeps)
            bmv = msrc_flat.make_stacked_pool_matvec(store, dtype)
        clock.mark("build")

        u = u0s[rows]
        if power_steps:
            u = msrc_flat.power_init_batched(bmv, None, u, power_steps)
        inits = msrc_flat.flat_init_batched(bmv, None, u, params)
        clock.mark("init")

        if layout == "tri":
            u, F, ifinal = solve_pool_tri(
                store, nt, inits, params, lanes=lanes, window=window,
                probes=tri_probes, warm_alpha=warm_alpha,
                stall_outers=stall_outers, d_scale=d_scale, stats=stats)
        else:
            u, F, ifinal = solve_pool(store, inits, params, lanes=lanes,
                                      window=window, stats=stats)
        clock.mark("solve")

        if mesh is not None:
            u, ifinal = (gather_rows(x, rows, W, mesh) for x in (u, ifinal))
            P1s, P2s = gather_endpoints(D1, D2s, As)
            clock.mark("gather")
        Fp = _polish_batch(invariant, P1s, P2s, As, u, support,
                               affinityeps)
        mask = msrc.round_solution(u, Fp, rounding)
        clock.mark("polish")
        clock.finish()
        return Solution(ifinal=ifinal, mask=mask, u0=u0s, u=u, score=Fp)

    return pipeline


def make_pool_multistart_pipeline(invariant: PairwiseInvariant,
                                  params: Params = Params(),
                                  restarts: int = 4,
                                  affinityeps: float = 1e-4,
                                  storage_dtype=torch.bfloat16,
                                  lanes: int = 128,
                                  window: int = 8,
                                  support: Optional[int] = 256,
                                  power_steps: int = 0,
                                  build: str = "auto",
                                  device="cuda"):
    """Pool pipeline with K = ``restarts`` inits per problem; keeps the
    densest cluster (reference: the local solver's init sensitivity,
    examples/matlab/ex3_planecloud.m:95-98, clipper.h:44-47).

    Each problem's stacked [M; C] is built once (``build`` and
    ``storage_dtype`` as in :func:`make_pool_pipeline`'s stacked layout);
    the W K restarts are pool lanes that share it through ``problem_of``.
    Each restart's F is polished as in :func:`make_pool_pipeline` and the
    restart with the highest polished F wins (the first on a tie).

    Call: pipeline(D1, D2s, As, u0s) with u0s (W, K, m); returns a
    Solution over the W problems, each the best restart's, with ``ifinal``
    the index of that restart (as the JAX package returns it) and ``u0``
    its init. Rounding.DSD downgrades to NONZERO with a warning. Runs on
    ``device`` ("cuda" by default; raises if missing).
    """
    K = int(restarts)
    dev = resolve_device(device)
    rounding = _pool_rounding(params)
    build = _resolve_build(build, storage_dtype, invariant, dev)
    as_tensor = _as_tensor(dev)

    def pipeline(D1, D2s, As, u0s,
                 timings: Optional[Dict[str, float]] = None,
                 stats: Optional[Dict] = None) -> Solution:
        """timings / stats: as in :func:`make_pool_pipeline`'s pipeline
        (the ticks per restart lane, (W K,))."""
        u0s = as_tensor(u0s)
        dtype = u0s.dtype
        As = as_tensor(As, torch.int32)
        W, m, _ = As.shape
        if tuple(u0s.shape) != (W, K, m):
            raise ValueError(f"u0s must be (W={W}, K={K}, m={m}); got "
                             f"{tuple(u0s.shape)}")
        D1 = as_tensor(D1, dtype)
        D2s = as_tensor(D2s, dtype)
        m_trues = torch.full((W,), m, dtype=torch.int32, device=dev)
        clock = StageClock(dev, timings)

        clock.mark("start")
        P1s, P2s = gather_endpoints(D1, D2s, As)
        MCs = _build_stacked(invariant, P1s, P2s, As, m_trues,
                             storage_dtype, build, affinityeps)
        clock.mark("build")

        # (W, K, m) -> W K lane instances over the W stored matrices
        problem_of = torch.arange(W, device=dev).repeat_interleave(K)
        bmv = msrc_flat.make_stacked_pool_matvec(MCs, dtype)
        u = u0s.reshape(W * K, m)
        if power_steps:
            u = msrc_flat.power_init_batched(bmv, problem_of, u,
                                             power_steps)
        inits = msrc_flat.flat_init_batched(bmv, problem_of, u, params)
        clock.mark("init")

        u, _, _ = solve_pool(MCs, inits, params, lanes=lanes, window=window,
                             problem_of=problem_of, stats=stats)
        clock.mark("solve")

        Us = u.reshape(W, K, m)
        Fp = _polish_batch(invariant, P1s, P2s, As, Us, support,
                               affinityeps)
        best = torch.argmax(Fp, dim=-1)
        w = torch.arange(W, device=dev)
        u, F = Us[w, best], Fp[w, best]
        mask = msrc.round_solution(u, F, rounding)
        clock.mark("polish")
        clock.finish()
        return Solution(ifinal=best.to(torch.int32), mask=mask,
                        u0=u0s[w, best], u=u, score=F)

    return pipeline
