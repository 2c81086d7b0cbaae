"""Batched engine: B independent problems in lock-step.

Counterpart of ``clipper_tpu/parallel/batched.py``. The JAX package vmaps
the whole pipeline (scoring, solver, rounding) over B problems, so its
while_loops run until the slowest problem converges. Here the B problems
are a leading dimension: the dense (B, m, m) build, then the flat
solver's batched ticks over every lane until all are done (converged
lanes freeze), one batched matvec a tick; the host reads ``done`` once
per msrc_flat._DONE_EVERY ticks. The pool engine (parallel/pool.py)
compacts lanes instead.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from clipper_tpu_torch.invariants.base import PairwiseInvariant
from clipper_tpu_torch.ops import fused_matvec
from clipper_tpu_torch.ops.affinity import score_pairwise_consistency
from clipper_tpu_torch.parallel.pool import rank_rows
from clipper_tpu_torch.solvers import msrc, msrc_flat
from clipper_tpu_torch.types import Params, Rounding, Solution, resolve_device

_STORAGE = {"stacked": None, "stacked_bf16": torch.bfloat16,
            "stacked_int8": torch.int8}


def _stack(sols) -> Solution:
    return Solution(*(torch.stack([getattr(s, f) for s in sols])
                      for f in ("ifinal", "mask", "u0", "u", "score")))


def _nested(Ms, Cs, u0s, params: Params, rounding: Rounding) -> Solution:
    """The reference-shaped nested solver, one problem at a time."""
    sols = []
    for M, C, u0 in zip(Ms, Cs, u0s):
        u, F, ifinal = msrc.find_dense_clique(M, C, u0, params)
        sols.append(Solution(ifinal=ifinal,
                             mask=msrc.round_solution(u, F, rounding),
                             u0=u0, u=u, score=F))
    return _stack(sols)


def make_batched_pipeline(invariant: PairwiseInvariant,
                          params: Params = Params(),
                          affinityeps: float = 1e-4,
                          solver: str = "flat",
                          matvec: str = "stacked",
                          probes: int = 1,
                          power_steps: int = 0,
                          device="cuda"):
    """(D1s, D2s, As, u0s) -> batched Solution.

    Shapes: D1s (B, n1, d), or (n1, d) shared by every problem (the JAX
    package's shared_d1=True, inferred here from the rank), D2s
    (B, n2, d), As (B, m, 2), u0s (B, m); numpy arrays or tensors. The
    working dtype is u0s'.

    solver: "flat" (the per-lane state machine, every lane in lock-step)
        or "nested" (the reference-shaped triple loop, one problem at a
        time).
    matvec, for the flat solver: "stacked" (the full-precision [M; C]),
        "stacked_bf16" / "stacked_int8" (reduced storage, f32 sums, and
        the final objective recomputed from the full-precision [M; C]
        before rounding), or "fused" (M u and C u from one read of M,
        csrc/pattern_matvec.cu on the card; C is the 0/1 pattern of M
        here).
    probes: the K-wide line search of the flat solver (not with "fused").
    power_steps: extra power-iteration steps on u0 (0: the reference).
    Rounding.DSD rounds NONZERO, as in the JAX package. Runs on
    ``device`` ("cuda" by default; raises if missing).
    """
    if solver not in ("flat", "nested"):
        raise ValueError(f"unknown solver {solver!r}")
    if matvec not in ("fused",) + tuple(_STORAGE):
        raise ValueError(f"unknown matvec {matvec!r}")
    if probes > 1 and matvec == "fused":
        raise ValueError("multiprobe needs the stacked matvec")
    dev = resolve_device(device)
    rounding = (Rounding.NONZERO if params.rounding == Rounding.DSD
                else params.rounding)

    def as_tensor(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    def pipeline(D1s, D2s, As, u0s,
                 stats: Optional[Dict] = None) -> Solution:
        """stats: optional dict; the flat solver puts its lock-step tick
        count under "ticks"."""
        u0s = as_tensor(u0s)
        dtype = u0s.dtype
        M, C = score_pairwise_consistency(
            invariant, as_tensor(D1s, dtype), as_tensor(D2s, dtype),
            as_tensor(As, torch.int32), affinityeps=affinityeps)
        if solver == "nested":
            return _nested(M, C, u0s, params, rounding)

        if matvec == "fused":
            def bmv(idx, U):
                Mu, Cu = fused_matvec.pattern_dual_matvec(M, U)
                return Mu.to(U.dtype), Cu.to(U.dtype)
            full = None
        else:
            full = torch.cat([M, C], dim=-2)
            store = full
            if matvec == "stacked_int8":
                store = msrc_flat.quantize_stacked(full)
            elif matvec == "stacked_bf16":
                store = full.to(torch.bfloat16)
            bmv = msrc_flat.make_stacked_pool_matvec(store, dtype)
        u = u0s
        if power_steps:
            u = msrc_flat.power_init_batched(bmv, None, u, power_steps)
        s = msrc_flat.flat_init_batched(bmv, None, u, params)
        s, ticks = msrc_flat.drive(
            msrc_flat.make_tick(bmv, params, dtype, probes=probes), None, s)
        if stats is not None:
            stats["ticks"] = ticks
        F = s.F
        if _STORAGE.get(matvec) is not None:
            # the full-precision objective u'(M + I)u before rounding
            Mu, _ = msrc_flat.make_stacked_pool_matvec(full, dtype)(None,
                                                                    s.u)
            F = (s.u * (Mu + s.u)).sum(-1)
        mask = msrc.round_solution(s.u, F, rounding)
        return Solution(ifinal=s.i, mask=mask, u0=u, u=s.u, score=F)

    return pipeline


def make_solve_pipeline(params: Params = Params()):
    """(Ms, Cs, u0s) -> batched Solution from prepared (B, m, m) matrices
    through the nested solver, on the tensors' device (params.rounding as
    given; DSD raises in rounding)."""

    def pipeline(Ms, Cs, u0s) -> Solution:
        return _nested(Ms, Cs, u0s.to(Ms.dtype), params, params.rounding)

    return pipeline


def shard_batch(tree, mesh, axis_name: str = "b", device="cuda"):
    """This rank's share of a batch: the slice [r B / D, (r + 1) B / D) of
    the leading axis of every array in ``tree`` (a tensor or numpy array,
    or a tuple, list or dict of them), as tensors on ``device`` ("cuda"
    by default: this process's current card; raises if missing).

    mesh: the ``torch.distributed`` ProcessGroup of D ranks the batch is
    split over (None: the default group, or one rank without one);
    ``axis_name`` only keeps the JAX signature. Raises when D does not
    divide B. Data parallelism over problems needs no collective: the
    caller runs :func:`make_batched_pipeline` on its slice and gets its
    B / D problems' Solution (the JAX ``device_put`` onto a sharding,
    whose pipeline returned global arrays, has no torch counterpart)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if mesh is None and dist.is_available() and dist.is_initialized():
        mesh = dist.group.WORLD
    D, rank = ((dist.get_world_size(mesh), dist.get_rank(mesh))
               if mesh is not None else (1, 0))

    def part(x):
        if isinstance(x, (tuple, list)):
            return type(x)(part(v) for v in x)
        if isinstance(x, dict):
            return {k: part(v) for k, v in x.items()}
        x = torch.as_tensor(x)
        return x[rank_rows(x.shape[0], D, rank, "batch B")].to(dev)

    return part(tree)
