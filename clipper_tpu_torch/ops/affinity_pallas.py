"""Fused affinity builds: the dense (M, C) and the stacked [M; C] storage.

Counterpart of ``clipper_tpu/ops/affinity_pallas.py``:

- :func:`build_affinity_pallas` (:42-104): one problem's dense (m, m) M
  (zero diagonal) and 0/1 C in the working precision, from gathered
  endpoints; csrc/affinity_build.cu on the card (each distinct pair
  scored once, :func:`dense_tile_pair` its placement), and
  ``ops.affinity.pairwise_from_endpoints`` as its plain version;
- :func:`score_consistency_stored_pallas` (:107-242): the (2m, m) [M; C]
  storage of each problem in int8 codes (C = 127) or bf16 (C = 1), both
  triangles, never materializing a full-precision (m, m);
  csrc/stored_build.cu on the card, ``ops.affinity.stored_from_endpoints``
  as its plain version (the JAX package holds its kernel bit-equal to
  that function).

Both apply the distinctness, diagonal and epsilon masks (reference:
src/clipper.cpp:35-64), the stored build also ``m_true``. The kernels
compute any symmetric invariant with a device score
(invariants.device_score): the two built-ins, and a user's own
``DeviceScore`` through its library, compiled at first use
(``_kernels.user_lib``; launches counted under ``stored_build_user`` and
``affinity_build_user``); tensors on the card launch them, CPU tensors
take the plain versions, which take any invariant. The JAX
functions' ``tile`` was a Mosaic tiling knob: the kernels bounds-check
their edge tiles instead of padding. A failed build or launch raises.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from clipper_tpu_torch import _kernels
from clipper_tpu_torch.invariants import device_score, kernel_score
from clipper_tpu_torch.invariants.base import PairwiseInvariant
from clipper_tpu_torch.ops.affinity import (gather_endpoints,
                                            pairwise_from_endpoints,
                                            stored_from_endpoints)

_TILE = 64      # rows and columns of the build kernels' tiles


def affinity_build_cuda(invariant: PairwiseInvariant, P1, P2, A, *,
                        affinityeps: float = 1e-4
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/affinity_build.cu (or the invariant's device score
    library's entry): P1/P2 (m, d) gathered endpoints in f32 or f64 and A
    (m, 2) on the card -> (M, C), each (m, m) in the endpoints' dtype."""
    kind, d, params = kernel_score(invariant)
    if not (P1.is_cuda and P2.is_cuda and A.is_cuda):
        raise ValueError("affinity build kernel: inputs must lie on the card")
    m = P1.shape[0]
    if (P1.dim() != 2 or P1.shape[1] != d or P2.shape != P1.shape
            or P1.dtype not in (torch.float32, torch.float64)
            or P2.dtype != P1.dtype or tuple(A.shape) != (m, 2)):
        raise ValueError(f"affinity build kernel takes (m, {d}) float32 or "
                         f"float64 endpoints and (m, 2) associations for "
                         f"{type(invariant).__name__}")
    # held in locals until the launch (see stored_build_cuda)
    P1c, P2c = P1.contiguous(), P2.contiguous()
    Ac = A.to(torch.int32).contiguous()
    M = torch.empty(m, m, dtype=P1.dtype, device=P1.device)
    C = torch.empty_like(M)
    fn, key = _kernels.score_entry(
        "affinity_build", "f32" if P1.dtype == torch.float32 else "f64",
        device_score(invariant))
    code = fn(P1c.data_ptr(), P2c.data_ptr(), Ac.data_ptr(), M.data_ptr(),
              C.data_ptr(), m, kind, *params, float(affinityeps),
              _kernels.stream_ptr(P1.device))
    _kernels.check(code, key)
    _kernels.LAUNCHES[key] += 1
    return M, C


def build_affinity_pallas(invariant: PairwiseInvariant, P1, P2, A, *,
                          affinityeps: float = 1e-4
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense symmetric (M, C) of one problem from gathered endpoints P1/P2
    (m, d) (P1[k] = D1[A[k, 0]], ...) and A (m, 2): (m, m) M with a zero
    diagonal and its 0/1 pattern C, in the endpoints' dtype. The kernel
    for CUDA inputs (an invariant with a device score), the plain version
    (``ops.affinity.pairwise_from_endpoints``) for CPU inputs."""
    if P1.is_cuda:
        return affinity_build_cuda(invariant, P1, P2, A,
                                   affinityeps=affinityeps)
    return pairwise_from_endpoints(invariant, P1, P2, A,
                                   affinityeps=affinityeps)


def stored_tile_pair(k: int, n: int) -> Tuple[int, int]:
    """Block k's unordered tile pair (I, J), I <= J, of n x n 64 x 64
    tiles in the stacked build kernel (csrc/stored_build.cu: tile_pair),
    step for step: row I of the upper triangle starts at off(I) = I n -
    I (I - 1) / 2, so I is the floor of ((2n + 1) - sqrt((2n + 1)^2 -
    8k)) / 2 in double, corrected by one step where the square root
    rounds across an integer."""
    b = 2.0 * n + 1.0
    i = int((b - math.sqrt(b * b - 8.0 * k)) * 0.5)
    if i * n - i * (i - 1) // 2 > k:
        i -= 1
    elif (i + 1) * n - (i + 1) * i // 2 <= k:
        i += 1
    return i, k - (i * n - i * (i - 1) // 2) + i


class SubPair(NamedTuple):
    """Where one pair of 64-row tiles goes in a build kernel's output
    (csrc/tri_pair_build.cuh: SubPair): ``rows`` of tile I by ``cols``
    of tile J starting at association ``gr0`` / ``gc0``; ``diag`` (I = J:
    its pairs i < j, both orders written); ``mirror`` (its transpose is
    written too); ``at`` / ``at_t``: flat offsets of (row 0, column 0)
    and of the transpose's in the M half (the flat triangle's (t, S), or
    the dense (m, m))."""
    rows: int
    cols: int
    gr0: int
    gc0: int
    diag: bool
    mirror: bool
    at: int
    at_t: int


def dense_tile_pair(k: int, m: int) -> SubPair:
    """Block k's tile pair in the dense build kernel (csrc/
    affinity_build.cu: dense_pair), step for step: the unordered pair (I
    <= J) of the n = ceil(m / 64) tiles a side (:func:`stored_tile_pair`),
    written in place and, off the diagonal, transposed into the (m, m) M
    and C."""
    n = -(-m // _TILE)
    i, j = stored_tile_pair(k, n)
    gr0, gc0 = i * _TILE, j * _TILE
    return SubPair(rows=min(_TILE, m - gr0), cols=min(_TILE, m - gc0),
                   gr0=gr0, gc0=gc0, diag=i == j, mirror=i != j,
                   at=gr0 * m + gc0, at_t=gc0 * m + gr0)


def stored_build_cuda(invariant: PairwiseInvariant, P1s, P2s, As, m_trues,
                      *, affinityeps: float = 1e-4,
                      storage_dtype=torch.int8) -> torch.Tensor:
    """Launch csrc/stored_build.cu (or the invariant's device score
    library's entry): P1s/P2s (W, m, d) f32 gathered endpoints (d = 3
    Euclidean, 6 point-normal, a device score's d), As (W, m, 2), m_trues
    (W,) on the card -> (W, 2m, m) storage in int8 or bf16."""
    kind, d, params = kernel_score(invariant)
    if storage_dtype not in (torch.int8, torch.bfloat16):
        raise NotImplementedError(
            f"the CUDA stored build writes int8 or bf16, not {storage_dtype}")
    if not (P1s.is_cuda and P2s.is_cuda and As.is_cuda):
        raise ValueError("stored build kernel: inputs must lie on the card")
    W, m, dp = P1s.shape
    if (dp != d or P2s.shape != P1s.shape or P1s.dtype != torch.float32
            or P2s.dtype != torch.float32 or tuple(As.shape) != (W, m, 2)):
        raise ValueError(f"stored build kernel takes (W, m, {d}) float32 "
                         "endpoints and (W, m, 2) associations for "
                         f"{type(invariant).__name__}")
    # held in locals until the launch: a temporary's memory could be
    # handed to the next input's copy before the kernel reads it
    P1c, P2c = P1s.contiguous(), P2s.contiguous()
    Ac = As.to(torch.int32).contiguous()
    mts = torch.as_tensor(m_trues, device=P1s.device).to(
        torch.int32).expand(W).contiguous()
    out = torch.empty(W, 2 * m, m, dtype=storage_dtype, device=P1s.device)
    fn, key = _kernels.score_entry(
        "stored_build", "int8" if storage_dtype == torch.int8 else "bf16",
        device_score(invariant))
    code = fn(P1c.data_ptr(), P2c.data_ptr(), Ac.data_ptr(), mts.data_ptr(),
              out.data_ptr(), W, m, kind, *params, float(affinityeps),
              _kernels.stream_ptr(P1s.device))
    _kernels.check(code, key)
    _kernels.LAUNCHES[key] += 1
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


__all__ = ["SubPair", "affinity_build_cuda", "build_affinity_pallas",
           "dense_tile_pair", "stored_build", "stored_build_cuda",
           "stored_tile_pair", "score_consistency_stored_pallas"]
