"""The 2D block-sharded engine: one large problem over an (R, C) mesh.

Counterpart of ``clipper_tpu/parallel/sharded.py`` over
``torch.distributed``:

  * an (R, C) mesh of ranks (:class:`Mesh`); rank ri * C + ci holds the
    (m/R, m/C) block (ri, ci) of M and C, never the whole matrix;
  * each rank builds its block from the replicated, small gathered
    endpoints, with no communication;
  * the PGA matvec is the local block product, a sum over the rank's
    column group (the ranks that share ri), and a gather over its row
    group (the ranks that share ci), so every rank holds the whole
    (m,) result;
  * norms, sums and the line search run on the replicated (m,) iterate,
    O(m) redundant work against O(m^2 / (R C)) matvec work.

The two collectives live in :func:`_reduce_c` and :func:`_gather_r`. The
column sum adds the ranks' partial products in f64 and rounds once to
the working dtype (the JAX engine's psum adds f32 partials): every rank
gets the same bits, and at C = 1 the result is the single-device stacked
matvec's own. The row gather is an all-reduce of a buffer that is zero
outside this rank's segment, exact, and runs on NCCL and on gloo's CUDA
tensors alike (gloo's CUDA collectives are broadcast and all-reduce). A
group of one rank makes no collective call.

The block builds and the local product are plain PyTorch, as they were
plain XLA in the JAX package (no Pallas kernel there). The invariant's
score_block must be symmetric in its pair arguments (both built-ins are:
their differences and products are summed coordinate by coordinate), as
each rank scores both triangles of its block.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from clipper_tpu_torch.invariants.base import PairwiseInvariant
from clipper_tpu_torch.ops.affinity import gather_endpoints
from clipper_tpu_torch.ops.symstore import _quantize, _solve_flat, _tile_scores
from clipper_tpu_torch.parallel.pool import (StageClock, _divisor_at_most,
                                             gather_rows, support_objective)
from clipper_tpu_torch.solvers import msrc, msrc_flat
from clipper_tpu_torch.types import (Params, Rounding, Solution,
                                     as_association, resolve_device)


class Mesh:
    """An (R, C) mesh over the first R C ranks of the default process
    group, rank = ri C + ci (the JAX ``reshape(R, C)`` order).

    group: the mesh's ranks (the world when R C is its size; None without
    an initialized process group, where the mesh is one rank). col_group:
    this rank's column group, the C ranks that share ri (the matvec's
    sum); row_group: its row group, the R ranks that share ci (the
    gather). A group of one rank is None: it makes no collective call.
    member: whether this rank is in the mesh (ri and ci are None when it
    is not)."""

    def __init__(self, shape: Tuple[int, int], group, rank: int,
                 col_group, row_group):
        self.R, self.C = (int(s) for s in shape)
        self.group, self.rank = group, rank
        self.col_group, self.row_group = col_group, row_group
        self.member = rank < self.R * self.C
        self.ri, self.ci = (divmod(rank, self.C) if self.member
                            else (None, None))

    @property
    def shape(self) -> Tuple[int, int]:
        return self.R, self.C

    @property
    def size(self) -> int:
        return self.R * self.C


def _world() -> Tuple[int, int]:
    """(size, rank) of the default group; (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _squarest(n: int) -> Tuple[int, int]:
    r = int(math.isqrt(n))
    while n % r:
        r -= 1
    return r, n // r


def make_mesh(shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """An (R, C) mesh over the default group's first R C ranks; shape None
    takes the squarest factorisation of the world size (JAX
    sharded.py:53-58). Collective over the whole world: every rank calls
    it, with the same shape, and each creates every row and column group
    in the same order, its own or not (``dist.new_group`` is collective).
    Without an initialized process group the mesh is one rank with no
    collective."""
    world, rank = _world()
    R, C = _squarest(world) if shape is None else (int(s) for s in shape)
    n = R * C
    if R < 1 or C < 1 or n > world:
        raise ValueError(f"mesh {R}x{C} needs {n} ranks; the world has "
                         f"{world}")
    if world == 1:
        return Mesh((R, C), dist.group.WORLD if dist.is_initialized()
                    else None, rank, None, None)
    group = (dist.group.WORLD if n == world else
             dist.new_group(list(range(n))) if n > 1 else None)
    col_groups = [dist.new_group([ri * C + c for c in range(C)]) if C > 1
                  else None for ri in range(R)]
    row_groups = [dist.new_group([ri * C + ci for ri in range(R)]) if R > 1
                  else None for ci in range(C)]
    if rank >= n:
        return Mesh((R, C), None, rank, None, None)
    ri, ci = divmod(rank, C)
    return Mesh((R, C), group, rank, col_groups[ri], row_groups[ci])


def multihost_shape(world: int, n_local: int) -> Tuple[int, int]:
    """(world / n_local, n_local): one node's ranks in a block-row."""
    n_local = max(1, min(n_local, world))
    if world % n_local:
        raise ValueError(f"{world} ranks do not split into nodes of "
                         f"{n_local}")
    return world // n_local, n_local


def make_mesh_multihost() -> Mesh:
    """The mesh whose block-rows are nodes: C = the ranks of one node
    (``LOCAL_WORLD_SIZE``, as torchrun sets it; the whole world when
    unset), R = the nodes. The matvec's column sum then stays within a
    node, and only the row gather of the (m,) vectors crosses nodes."""
    world, _ = _world()
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return make_mesh(multihost_shape(world, n_local))


def _padded_size(m: int, r: int, c: int) -> int:
    block = math.lcm(r, c)
    return -(-m // block) * block


def pad_problem(P1, P2, u0, m_pad: int):
    """Zero-pad gathered endpoints and u0 to m_pad rows.

    Padding with u0 = 0 and no edges is exact for the PGA: padded entries
    start at 0, have strictly negative gradient once projected, never
    enter the d-update mask, and add nothing to sums or norms."""
    pad = m_pad - P1.shape[0]
    if pad == 0:
        return P1, P2, u0
    P1 = torch.nn.functional.pad(P1, (0, 0, 0, pad))
    P2 = torch.nn.functional.pad(P2, (0, 0, 0, pad))
    u0 = torch.nn.functional.pad(u0, (0, pad))
    return P1, P2, u0


# ----------------------------------------------------------------------
# the two collectives
# ----------------------------------------------------------------------

def _reduce_c(mesh: Mesh, part: torch.Tensor) -> torch.Tensor:
    """The sum of the column group's partial products: in f64, the same
    bits on every rank; the partial itself when C = 1."""
    if mesh.col_group is None:
        return part
    acc = part.to(torch.float64)
    dist.all_reduce(acc, group=mesh.col_group)
    return acc


def _gather_r(mesh: Mesh, y: torch.Tensor, m: int) -> torch.Tensor:
    """(mr, ...) row-block results -> (m, ...) on every rank of the row
    group, exactly (pool.gather_rows: an all-reduce of a buffer that is
    zero outside this rank's rows)."""
    if mesh.row_group is None:
        return y
    mr = y.shape[0]
    return gather_rows(y, slice(mesh.ri * mr, (mesh.ri + 1) * mr), m,
                       mesh.row_group)


# ----------------------------------------------------------------------
# the block builds
# ----------------------------------------------------------------------

def _rows(a: int, n: int, device) -> torch.Tensor:
    return torch.arange(a, a + n, device=device)


def _affinity_block(invariant: PairwiseInvariant, P1, P2, A, m_true: int,
                    mr: int, mc: int, affinityeps: float, ri: int, ci: int):
    """Block (ri, ci) of M and C, (mr, mc) each, in the endpoints' dtype:
    the distinctness, diagonal, padding and threshold masks in the JAX
    order (symstore._tile_scores; reference: src/clipper.cpp:35-55)."""
    scores, keep = _tile_scores(invariant, P1, P2, A,
                                _rows(ri * mr, mr, P1.device),
                                _rows(ci * mc, mc, P1.device), m_true,
                                affinityeps)
    return torch.where(keep, scores, 0.0), keep.to(scores.dtype)


def _affinity_block_stored(invariant: PairwiseInvariant, P1, P2, A,
                           m_true: int, mr: int, mc: int, affinityeps: float,
                           storage_dtype, ri: int, ci: int,
                           build_chunk: int = 512) -> torch.Tensor:
    """Block (ri, ci) as stacked (2 mr, mc) [M; C] storage, built straight
    into storage_dtype a chunk of rows at a time: int8 codes (those of
    msrc_flat.quantize_stacked) or the values cast to a float dtype. Only
    one (chunk, mc) tile is live in full precision (the whole f32 block
    at m = 65,536 on one rank would be 34 GB beside the 8.6 GB of int8
    storage)."""
    gc = _rows(ci * mc, mc, P1.device)
    chunk = _divisor_at_most(mr, build_chunk)
    buf = torch.empty((2 * mr, mc), dtype=storage_dtype, device=P1.device)
    for s in range(0, mr, chunk):
        scores, keep = _tile_scores(invariant, P1, P2, A,
                                    _rows(ri * mr + s, chunk, P1.device), gc,
                                    m_true, affinityeps)
        buf[s:s + chunk], buf[mr + s:mr + s + chunk] = _quantize(
            scores, keep, storage_dtype)
    return buf


def _block_quadform(invariant: PairwiseInvariant, P1, P2, A, u,
                    m_true: int, mr: int, mc: int, affinityeps: float,
                    ri: int, ci: int, build_chunk: int = 512) -> torch.Tensor:
    """This rank's exact partial of u'Mu, u_r' M_blk u_c, rebuilding the
    block a chunk of rows at a time, in f64: the caller sums the ranks'
    partials and rounds once. O(chunk, mc) memory and no cap on the
    support. Elementwise products and sums: independent of the TF32
    flag."""
    gc = _rows(ci * mc, mc, u.device)
    acc_dtype = torch.promote_types(u.dtype, torch.float32)
    uc = u[gc].to(acc_dtype)
    chunk = _divisor_at_most(mr, build_chunk)
    part = torch.zeros((), dtype=torch.float64, device=u.device)
    for s in range(0, mr, chunk):
        gr = _rows(ri * mr + s, chunk, u.device)
        scores, keep = _tile_scores(invariant, P1, P2, A, gr, gc, m_true,
                                    affinityeps)
        M_t = torch.where(keep, scores, 0.0).to(acc_dtype)
        q = (u[gr].to(acc_dtype) * (M_t * uc).sum(-1)).sum()
        part = part + q.to(torch.float64)
    return part


# ----------------------------------------------------------------------
# the operators
# ----------------------------------------------------------------------

def _check_tf32(blk: torch.Tensor, what: str) -> None:
    if (blk.is_cuda and blk.dtype == torch.float32
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(f"{what}: f32 blocks on the card need "
                           "torch.backends.cuda.matmul.allow_tf32 = False")


def sharded_operators(M_blk: torch.Tensor, C_blk: torch.Tensor, mc: int,
                      mesh: Mesh) -> msrc.PGAOperators:
    """PGA operators over this rank's (mr, mc) blocks of M and C for the
    nested solver (msrc.run_pga): the local product, the column sum and
    the row gather."""
    _check_tf32(M_blk, "sharded_operators")
    m = M_blk.shape[0] * mesh.R
    c0 = mesh.ci * mc

    def block_mv(blk, u):
        part = blk @ u[c0:c0 + mc]
        return _gather_r(mesh, _reduce_c(mesh, part).to(u.dtype), m)

    def make_mv_Md(d):
        Md_blk = M_blk + d * C_blk        # local, no communication
        return lambda u: block_mv(Md_blk, u)

    return msrc.PGAOperators(mv_M=lambda u: block_mv(M_blk, u),
                             mv_C=lambda u: block_mv(C_blk, u),
                             make_mv_Md=make_mv_Md)


def sharded_dual_matvec(MC_store: torch.Tensor, mr: int, mc: int, out_dtype,
                        mesh: Mesh, matvec_chunk: Optional[int] = None):
    """u -> (M u, C u) over this rank's stacked (2 mr, mc) [M; C] block in
    f64, f32, bf16 or int8 (quantize_stacked codes). Takes (m,) vectors
    or (m, K) candidate columns, replicated on every rank. The local
    product has msrc_flat.make_stacked_matvec's casts (stacked_partials),
    so a 1 x 1 mesh runs the dense flat engine's arithmetic; then one
    column sum and one row gather a call.

    matvec_chunk: take the block ``matvec_chunk`` rows at a time (a
    divisor of 2 mr at most that), so the cast of the stored rows to the
    accumulation dtype is never made for the whole block at once (34 GB
    of f32 for an int8 block at m = 65,536 on one rank). Each output row
    reads the same data either way."""
    m = mr * mesh.R
    c0 = mesh.ci * mc
    chunk = None if matvec_chunk is None else \
        _divisor_at_most(2 * mr, matvec_chunk)

    def local(u_c):
        if chunk is None:
            return msrc_flat.stacked_partials(MC_store, u_c, out_dtype)
        return torch.cat([msrc_flat.stacked_partials(
            MC_store[s:s + chunk], u_c, out_dtype)
            for s in range(0, 2 * mr, chunk)])

    def mv(u):
        U = u[:, None] if u.dim() == 1 else u
        y = _reduce_c(mesh, local(U[c0:c0 + mc]))
        y = msrc_flat.finish_stacked(y, MC_store.dtype, out_dtype)
        MC = _gather_r(mesh, y.reshape(2, mr, -1).transpose(0, 1), m)
        if u.dim() == 1:
            return MC[:, 0, 0], MC[:, 1, 0]
        return MC[:, 0], MC[:, 1]

    return mv


# ----------------------------------------------------------------------
# the pipeline
# ----------------------------------------------------------------------

def build_sharded_pipeline(invariant: PairwiseInvariant, mesh: Mesh,
                           params: Params = Params(),
                           affinityeps: float = 1e-4,
                           solver: str = "flat",
                           storage_dtype=None,
                           probes: int = 1,
                           power_steps: int = 0,
                           support: int = 512,
                           build_chunk: int = 512,
                           matvec_chunk: Optional[int] = None):
    """The sharded pipeline: endpoints -> this rank's block -> solve.

    Returns pipeline(P1, P2, A, u0, m_true, stats=None) -> (u, F, ifinal,
    mask) over padded arrays replicated on every rank of the mesh (P1/P2
    (m_pad, d) gathered endpoints, A (m_pad, 2) with -1 rows past m_true,
    u0 (m_pad,); see :func:`pad_problem`), m_pad a multiple of lcm(R, C).

    solver: "flat" (the per-lane state machine, the dense flat engine's
        trajectory) or "nested" (the reference-shaped loop).
    storage_dtype (flat only): None keeps the working dtype; torch.bfloat16
        or torch.int8 store the block reduced, built a chunk of rows at a
        time (:func:`_affinity_block_stored`), and F is then polished in
        full precision: on u's top-``support`` entries when u has no more
        nonzeros (every rank, no collective), else by the exact chunked
        block quadform, its f64 partials summed over the mesh. The branch
        is a host ``if`` on the replicated u, so every rank takes the
        same one.
    probes (flat only): the K-wide line search (msrc_flat
        flat_solve_single_multiprobe's ticks).
    matvec_chunk: see :func:`sharded_dual_matvec`.
    Rounding.DSD rounds NONZERO (the facade reruns DSD on the host).

    stats: optional dict filled with stage milliseconds (build, init,
    solve, polish; CUDA events on the card, host time on the CPU), ticks,
    nback, this rank's storage bytes, the mesh shape and the polish
    branch (polish_branch: "support", "exact", or None without reduced
    storage).
    """
    if solver not in ("flat", "nested"):
        raise ValueError(f"solver must be 'flat' or 'nested', got {solver!r}")
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} is not in the {mesh.R}x{mesh.C} "
                         "mesh")
    R, C = mesh.shape
    rounding = params.rounding
    if rounding == Rounding.DSD:
        rounding = Rounding.NONZERO

    def pipeline(P1, P2, A, u0, m_true: int,
                 stats: Optional[Dict] = None):
        m_pad = P1.shape[0]
        if m_pad % R or m_pad % C:
            raise ValueError(f"m_pad={m_pad} is not a multiple of the mesh "
                             f"{R}x{C}")
        mr, mc = m_pad // R, m_pad // C
        ri, ci = mesh.ri, mesh.ci
        clock = StageClock(P1.device, stats)
        clock.mark("start")
        info = dict(mesh=[R, C], polish_branch=None)
        if solver == "nested":
            M_blk, C_blk = _affinity_block(invariant, P1, P2, A, m_true, mr,
                                           mc, affinityeps, ri, ci)
            clock.mark("build")
            u, F, ifinal = msrc.run_pga(sharded_operators(M_blk, C_blk, mc,
                                                          mesh),
                                        u0, params, dtype=P1.dtype)
            clock.mark("solve")
            clock.finish()
            if stats is not None:
                stats.update(info, storage_bytes=2 * M_blk.numel()
                             * M_blk.element_size())
            return u, F, ifinal, msrc.round_solution(u, F, rounding)

        if storage_dtype is None:
            M_blk, C_blk = _affinity_block(invariant, P1, P2, A, m_true, mr,
                                           mc, affinityeps, ri, ci)
            store = torch.cat([M_blk, C_blk])
            del M_blk, C_blk
        else:
            store = _affinity_block_stored(invariant, P1, P2, A, m_true, mr,
                                           mc, affinityeps, storage_dtype,
                                           ri, ci, build_chunk)
        mv = sharded_dual_matvec(store, mr, mc, P1.dtype, mesh,
                                 matvec_chunk=matvec_chunk)
        clock.mark("build")
        s = _solve_flat(mv, u0.to(P1.dtype), params, probes, power_steps,
                        1.0, clock)
        u, F = s.u, s.F
        if storage_dtype is not None:
            # omega = round(F) needs F well within 0.5 of the exact value
            # (reference: src/clipper.cpp:305); the top-k polish is exact
            # only for supports of at most k
            k = min(support, m_pad)
            if int((u > 0).sum()) <= k:
                info["polish_branch"] = "support"
                F = support_objective(invariant, P1, P2, A, u,
                                      affinityeps=affinityeps, k=k)
            else:
                info["polish_branch"] = "exact"
                part = _block_quadform(invariant, P1, P2, A, u, m_true, mr,
                                       mc, affinityeps, ri, ci, build_chunk)
                if mesh.size > 1:
                    dist.all_reduce(part, group=mesh.group)
                acc = torch.promote_types(u.dtype, torch.float32)
                uu = u.to(acc)
                F = part.to(acc) + torch.dot(uu, uu)
            F = F.to(P1.dtype)
        clock.mark("polish")
        clock.finish()
        if stats is not None:
            stats.update(info, ticks=int(s.ticks), nback=int(s.nback),
                         storage_bytes=store.numel() * store.element_size())
        return u, F, s.i, msrc.round_solution(u, F, rounding)

    return pipeline


def solve_sharded(invariant: PairwiseInvariant, D1, D2, A, u0,
                  params: Params = Params(), mesh: Optional[Mesh] = None,
                  *, affinityeps: float = 1e-4, solver: str = "flat",
                  storage_dtype=None, probes: int = 1,
                  power_steps: int = 0, support: int = 512,
                  build_chunk: int = 512,
                  matvec_chunk: Optional[int] = None, device="cuda",
                  stats: Optional[Dict] = None) -> Solution:
    """One large problem end to end through the 2D sharded engine.

    Every rank of the mesh calls it with the same D1/D2 (n, d), A (m, 2)
    and u0 (m,) (numpy arrays or tensors), gets the same Solution, and
    holds one block. mesh: a :class:`Mesh` (default :func:`make_mesh`,
    the squarest over the default group, or one rank without a group).
    The working dtype is D1's, as in the JAX package. Runs on
    ``device`` ("cuda" by default: this process's current card; raises
    if missing). See :func:`build_sharded_pipeline` for the options."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if mesh is None:
        mesh = make_mesh()
    R, C = mesh.shape
    D1 = torch.as_tensor(D1, device=dev)
    dtype = D1.dtype
    A = as_association(A, device=dev)
    m = A.shape[0]
    P1, P2 = gather_endpoints(D1, torch.as_tensor(D2, dtype=dtype,
                                                  device=dev), A)
    u0 = torch.as_tensor(u0, dtype=dtype, device=dev)
    m_pad = _padded_size(m, R, C)
    P1, P2, u0p = pad_problem(P1, P2, u0, m_pad)
    A_pad = torch.nn.functional.pad(A, (0, 0, 0, m_pad - m), value=-1)
    pipeline = build_sharded_pipeline(
        invariant, mesh, params, affinityeps, solver=solver,
        storage_dtype=storage_dtype, probes=probes, power_steps=power_steps,
        support=support, build_chunk=build_chunk, matvec_chunk=matvec_chunk)
    u, F, ifinal, mask = pipeline(P1, P2, A_pad, u0p, m, stats=stats)
    return Solution(ifinal=ifinal, mask=mask[:m], u0=u0, u=u[:m], score=F)


__all__: List[str] = [
    "Mesh", "make_mesh", "make_mesh_multihost", "multihost_shape",
    "pad_problem", "sharded_operators", "sharded_dual_matvec",
    "build_sharded_pipeline", "solve_sharded"]
