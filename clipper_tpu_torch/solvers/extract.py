"""Successive dense-clique extraction for multi-object association.

Counterpart of ``clipper_tpu/solvers/extract.py``. The reference solves for
one densest cluster a call (reference: src/clipper.cpp:172-281) and leaves
multi-object scenes (k rigid objects, each with its own transform, so the
consistency graph is a disjoint union of k cliques) to the caller. The peel
loop here solves on the current subgraph, rounds, and suppresses the found
support with a keep mask applied inside the dual matvec, so the stored
[M; C] is never rewritten: k objects cost k solver runs over the same
device-resident storage, and the host reads u and one scalar a peel.

The JAX package draws each peel's u0 from ``jax.random``; here it comes
from an explicit ``torch.Generator`` (a CPU generator gives the same draws
for every device). To compare the two packages, hand :func:`_extract_step`
the same u0.
"""

from __future__ import annotations

import warnings
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from clipper_tpu_torch import utils
from clipper_tpu_torch.solvers import msrc, msrc_flat
from clipper_tpu_torch.types import Params, Rounding, resolve_device


class CliqueExtraction(NamedTuple):
    """One extracted cluster: bool mask (m,), objective F, solver iters."""
    mask: np.ndarray
    score: float
    ifinal: int


def masked_dual_matvec(mv, keep: torch.Tensor):
    """The dual matvec of the keep-subgraph: zeroing u's masked entries on
    the way in and (M u, C u)'s on the way out is the solver on the
    vertex-induced subgraph (suppressed vertices see no edges and add
    none, as padding does)."""
    def mv_masked(u):
        k = keep[:, None] if u.dim() == 2 else keep
        Mu, Cu = mv(u * k)
        return Mu * k, Cu * k

    return mv_masked


def _polish_bucket(nnz: int, m: int) -> int:
    """Smallest power-of-2 top-k size covering the support (>= 64, <= m)."""
    k = 64
    while k < nnz:
        k *= 2
    return min(k, m)


def _support_quadform(Mf: torch.Tensor, u: torch.Tensor, keep: torch.Tensor,
                      *, k: int) -> torch.Tensor:
    """u'(M + I)u of the unit keep-masked u on its top-k support, on the
    device: a gather of k rows and an O(k^2) quadratic form against the
    full-precision M, exact whenever nnz(u) <= k (M is nonnegative with a
    zero diagonal). The in-loop quantized objective is biased, so the
    rounding's omega = round(F) takes this one. Elementwise products and
    sums, so the value does not depend on the TF32 flag."""
    dtype = Mf.dtype
    un = u.to(dtype) * keep.to(dtype)
    un = un / torch.clamp(torch.linalg.vector_norm(un), min=1e-12)
    vals, idx = torch.topk(un, k)
    Mk = Mf[idx][:, idx]
    return (vals * (Mk * vals[None, :]).sum(-1)).sum() + 1.0


def _extract_step(MC_store: torch.Tensor, keep: torch.Tensor,
                  u0: torch.Tensor, *, params: Params, probes: int,
                  power_steps: int):
    """One peel: solve the keep-subgraph from u0. Returns (u, F, ifinal)."""
    dtype = u0.dtype
    mv = masked_dual_matvec(msrc_flat.make_stacked_matvec(MC_store, dtype),
                            keep.to(dtype))
    u0 = u0 * keep
    u0 = u0 / torch.clamp(torch.linalg.vector_norm(u0), min=1e-12)
    if power_steps:
        u0 = msrc_flat.power_init(mv, u0, power_steps)
    if probes > 1:
        return msrc_flat.flat_solve_single_multiprobe(mv, u0, params,
                                                      probes=probes)
    return msrc_flat.flat_solve_single(mv, u0, params)


def extract_cliques(M, C, generator: Optional[torch.Generator],
                    params: Optional[Params] = None, *,
                    max_cliques: int = 8, min_size: int = 3,
                    probes: int = 8, power_steps: int = 4,
                    storage_dtype=torch.int8, dtype=torch.float32,
                    device="cuda") -> List[CliqueExtraction]:
    """Peel up to ``max_cliques`` dense clusters from a consistency graph.

    M, C: (m, m) affinity and constraint matrices (numpy or tensors).
    generator: the per-peel inits' U[0.01, 1) draws (None: torch's default
    generator). min_size: stop when the newest clique has fewer vertices.
    storage_dtype: int8 (quantized hot loop, the pool engine's objective
    semantics), bf16, or None for f32. Runs on ``device`` ("cuda" by
    default; raises when CUDA is missing).

    Returns the cliques in extraction order. Their masks are disjoint:
    each is intersected with its peel's support, so no clique claims a
    vertex already extracted. Each peel is one reference-semantics MSRC
    solve on the subgraph of the vertices not yet extracted, rounded with
    a full-precision objective on the device.

    Rounding.DSD becomes DSD_HEU with a warning: exact DSD is a host max
    flow (reference: src/clipper.cpp:294-300); the Clipper facade runs it
    on one cluster.
    """
    params = params or Params()
    rounding = params.rounding
    if rounding == Rounding.DSD:
        warnings.warn(
            "extract_cliques cannot run exact (host-side) DSD rounding "
            "per peel; remapping to Rounding.DSD_HEU — use the Clipper "
            "facade for exact DSD", stacklevel=2)
        rounding = Rounding.DSD_HEU
    dev = resolve_device(device)
    Mf = torch.as_tensor(M).to(dev, torch.float32)
    MC = torch.cat([Mf, torch.as_tensor(C).to(dev, torch.float32)])
    if storage_dtype == torch.int8:
        MC_store = msrc_flat.quantize_stacked(MC)
    elif storage_dtype is not None:
        MC_store = MC.to(storage_dtype)
    else:
        MC_store = MC
    m = Mf.shape[0]
    keep = torch.ones(m, dtype=dtype, device=dev)
    keep_np = np.ones(m, bool)
    lo = torch.tensor(0.01, dtype=dtype)
    out: List[CliqueExtraction] = []
    for _ in range(max_cliques):
        u0 = lo + (1.0 - lo) * utils.randvec(generator, m, dtype=dtype)
        u, F, ifinal = _extract_step(MC_store, keep, u0.to(dev),
                                     params=params, probes=probes,
                                     power_steps=power_steps)
        u_np = u.cpu().numpy() * keep_np
        s = np.flatnonzero(u_np > 0)
        if s.size < min_size:
            break
        Fp = float(_support_quadform(Mf, u, keep,
                                     k=_polish_bucket(s.size, m)))
        mask_np = msrc.round_solution(torch.as_tensor(u_np),
                                      torch.tensor(Fp), rounding).numpy()
        # clamp to the current support: omega = round(F) can exceed the
        # support's size for M entries > 1, and the top-omega sort would
        # then tie-break into zero-valued (even extracted) vertices
        mask_np = mask_np & (u_np > 0)
        if int(mask_np.sum()) < min_size:
            break
        out.append(CliqueExtraction(mask=mask_np, score=Fp,
                                    ifinal=int(ifinal)))
        keep_np &= ~mask_np
        keep = torch.as_tensor(keep_np, dtype=dtype, device=dev)
    return out
