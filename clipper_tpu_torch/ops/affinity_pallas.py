"""Fused direct-to-storage affinity build: the stacked [M; C] pool storage.

Counterpart of ``clipper_tpu/ops/affinity_pallas.py:107-242``
(``score_consistency_stored_pallas``): the (2m, m) [M; C] storage of each
problem in int8 codes (C = 127) or bf16 (C = 1), both triangles, with the
distinctness, diagonal, epsilon and ``m_true`` masks (reference:
src/clipper.cpp:35-64), never materializing a full-precision (m, m).

For tensors on the card it launches the hand-written CUDA kernel
csrc/stored_build.cu; for CPU tensors it takes the plain version,
``ops.affinity.stored_from_endpoints`` (the JAX package holds its kernel
bit-equal to that function). A failed build or launch raises.
"""

from __future__ import annotations

import torch

from clipper_tpu_torch import _kernels
from clipper_tpu_torch.invariants.base import PairwiseInvariant
from clipper_tpu_torch.invariants.euclidean import EuclideanDistance
from clipper_tpu_torch.ops.affinity import (gather_endpoints,
                                            stored_from_endpoints)


def stored_build_cuda(invariant: PairwiseInvariant, P1s, P2s, As, m_trues,
                      *, affinityeps: float = 1e-4,
                      storage_dtype=torch.int8) -> torch.Tensor:
    """Launch csrc/stored_build.cu: P1s/P2s (W, m, 3) f32 gathered
    endpoints, As (W, m, 2), m_trues (W,) on the card -> (W, 2m, m)
    storage in int8 or bf16."""
    if not isinstance(invariant, EuclideanDistance):
        raise NotImplementedError(
            "the CUDA stored build is specific to EuclideanDistance; build "
            f"{type(invariant).__name__} on the CPU (ROADMAP.md Queue 2)")
    if storage_dtype not in (torch.int8, torch.bfloat16):
        raise NotImplementedError(
            f"the CUDA stored build writes int8 or bf16, not {storage_dtype}")
    if not (P1s.is_cuda and P2s.is_cuda and As.is_cuda):
        raise ValueError("stored build kernel: inputs must lie on the card")
    W, m, d = P1s.shape
    if (d != 3 or P2s.shape != P1s.shape or P1s.dtype != torch.float32
            or P2s.dtype != torch.float32 or tuple(As.shape) != (W, m, 2)):
        raise ValueError("stored build kernel takes (W, m, 3) float32 "
                         "endpoints and (W, m, 2) associations")
    p = invariant.params
    # held in locals until the launch: a temporary's memory could be
    # handed to the next input's copy before the kernel reads it
    P1c, P2c = P1s.contiguous(), P2s.contiguous()
    Ac = As.to(torch.int32).contiguous()
    mts = torch.as_tensor(m_trues, device=P1s.device).to(
        torch.int32).expand(W).contiguous()
    out = torch.empty(W, 2 * m, m, dtype=storage_dtype, device=P1s.device)
    lib = _kernels.lib("stored_build")
    fn = (lib.stored_build_int8 if storage_dtype == torch.int8
          else lib.stored_build_bf16)
    code = fn(P1c.data_ptr(), P2c.data_ptr(), Ac.data_ptr(), mts.data_ptr(),
              out.data_ptr(), W, m,
              float(p.sigma * p.sigma), float(p.epsilon), float(affinityeps),
              float(p.mindist), _kernels.stream_ptr(P1s.device))
    _kernels.check(code, "stored_build")
    _kernels.LAUNCHES["stored_build"] += 1
    return out


def stored_build(invariant: PairwiseInvariant, P1s, P2s, As, m_trues, *,
                 affinityeps: float = 1e-4,
                 storage_dtype=torch.int8) -> torch.Tensor:
    """Batched stacked [M; C] storage from gathered endpoints: the kernel
    for CUDA inputs, the plain version for CPU inputs."""
    if P1s.is_cuda:
        return stored_build_cuda(invariant, P1s, P2s, As, m_trues,
                                 affinityeps=affinityeps,
                                 storage_dtype=storage_dtype)
    return stored_from_endpoints(invariant, P1s, P2s, As,
                                 affinityeps=affinityeps, m_true=m_trues,
                                 storage_dtype=storage_dtype)


def score_consistency_stored_pallas(invariant: PairwiseInvariant, D1, D2, A,
                                    *, affinityeps: float = 1e-4,
                                    m_true=None,
                                    storage_dtype=torch.int8) -> torch.Tensor:
    """Stacked (2m, m) [M; C] storage, int8 or bf16, in one pass over the
    scores: the counterpart of ``ops.affinity.score_consistency_stored``
    for symmetric invariants. A (m, 2) gives one problem; A (W, m, 2) gives
    (W, 2m, m), with D1/D2 shared (n, d) or per problem (W, n, d). m_true:
    scalar or (W,) true sizes (rows and columns at or past it are zero).
    The JAX function's ``tile`` was a Mosaic tiling knob: the kernel
    bounds-checks its edge tiles instead of padding."""
    if not getattr(invariant, "symmetric", False):
        raise ValueError(
            "score_consistency_stored_pallas requires a symmetric "
            "invariant; use ops.affinity.score_consistency_stored")
    single = A.dim() == 2
    P1s, P2s = gather_endpoints(D1, D2, A)
    As = A
    if single:
        P1s, P2s, As = P1s[None], P2s[None], A[None]
    W, m = As.shape[:2]
    if m_true is None:
        m_true = m
    mts = torch.as_tensor(m_true, device=As.device).to(torch.int32)
    out = stored_build(invariant, P1s, P2s, As, mts.expand(W),
                       affinityeps=affinityeps, storage_dtype=storage_dtype)
    return out[0] if single else out


__all__ = ["stored_build", "stored_build_cuda",
           "score_consistency_stored_pallas"]
