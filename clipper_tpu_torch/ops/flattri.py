"""Flat row-major triangle storage: the pool engine's half-traffic layout.

Counterpart of ``clipper_tpu/ops/flattri.py`` (:51-460, :463-680). M and
C are symmetric, so only the upper triangle TILES of [M; C] are stored,
packed per problem as one (2t, S) array with S = t * nt (nt + 1) / 2:

    row-block r's tiles (r, r), (r, r+1), ..., (r, nt-1) occupy the
    contiguous column span [off_r * t, (off_r + nt - r) * t) with
    off_r = r * nt - r (r - 1) / 2.

Rows 0:t hold the M tiles, rows t:2t the C tiles. The tile-major form
(P, T, 2t, t) holds the same T = nt (nt + 1) / 2 tiles as contiguous
(2t, t) blocks in :func:`tri_coords` order (:func:`repack_stacked_tiles`).

Each of these is a wrapper around a hand-written CUDA kernel (csrc/) with
a plain PyTorch version beside it:

- :func:`make_tri_pool_matvec` -> csrc/tri_matvec.cu, every solver tick;
- :func:`build_tri` -> csrc/tri_build.cu, once per problem;
- :func:`build_tri_pallas_fused` -> csrc/tri_build_fused.cu, the same
  output with one kernel block per problem (no pipeline selects it);
- :func:`make_tri_pool_matvec_tiles` -> csrc/tri_tiles_matvec.cu, the
  single-probe matvec over tile-major storage.

A wrapper launches its kernel for CUDA tensors and takes the plain version
only for CPU tensors; a failed build or launch raises. On the card the
builds compute any symmetric invariant with a device score
(invariants.device_score): the two built-ins, and a user's own
``DeviceScore``, whose library is compiled at first use
(``_kernels.user_lib``; its launches counted under ``tri_build_user`` and
``tri_build_fused_user``); an invariant without one raises there.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from clipper_tpu_torch import _kernels
from clipper_tpu_torch.invariants import device_score, kernel_score
from clipper_tpu_torch.invariants.base import PairwiseInvariant
from clipper_tpu_torch.ops.affinity_pallas import (SubPair,
                                                   stored_tile_pair)
from clipper_tpu_torch.ops.affinity import (pairwise_from_endpoints,
                                            stored_from_endpoints)
from clipper_tpu_torch.solvers.msrc_flat import _INT8_SCALE

# candidate rows one kernel launch takes (the mma A-tile height)
_KERNEL_ROWS = 16
# the tiles at which kernels 1 and 9 take int8 / bf16 storage on the
# tensor cores at their own tile (csrc/tri_matvec_mma.cuh: mma_tile); at
# every other multiple of _SUPER_ALIGN they take it over 128-row
# super-tiles (super_tile)
_MMA_TILES = (128, 256, 384, 512)
_SUPER_ALIGN = 16
# the largest t of the CUDA-core kernel (csrc/tri_matvec_core.cuh: kMaxT)
_CORE_MAX_T = 7680
# the builds' sub-tile: kernels 2 and 8 score pairs of 64-row sub-tiles
_SUB = 64


def tri_tile_offsets(nt: int) -> list:
    """off_r (in tiles) of row-block r's segment in the flat layout."""
    return [r * nt - r * (r - 1) // 2 for r in range(nt)]


def tri_ncols(nt: int, t: int) -> int:
    """S: total flat columns = t * (number of upper-triangle tiles)."""
    return t * (nt * (nt + 1) // 2)


def tri_coords(nt: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-tile (r, c, off) arrays in flat storage order (row-major)."""
    rs, cs, offs = [], [], []
    off = 0
    for r in range(nt):
        for c in range(r, nt):
            rs.append(r)
            cs.append(c)
            offs.append(off)
            off += 1
    return (np.asarray(rs, np.int32), np.asarray(cs, np.int32),
            np.asarray(offs, np.int32))


def repack_stacked(MC: torch.Tensor, t: int) -> torch.Tensor:
    """Dense stacked (..., 2m, m) [M; C] -> flat triangle (..., 2t, S)."""
    two_m, m = MC.shape[-2:]
    if two_m != 2 * m or m % t:
        raise ValueError(f"need stacked (..., 2m, m) with t | m; got "
                         f"{tuple(MC.shape)}, t={t}")
    nt = m // t
    segs = []
    for r in range(nt):
        Mseg = MC[..., r * t:(r + 1) * t, r * t:]
        Cseg = MC[..., m + r * t:m + (r + 1) * t, r * t:]
        segs.append(torch.cat([Mseg, Cseg], dim=-2))
    return torch.cat(segs, dim=-1).contiguous()


def _dtypes(storage: torch.dtype):
    """(compute dtype of u, accumulation dtype, output scale) for a
    storage dtype: int8 and bf16 contract in bf16 and accumulate in f32,
    f64 accumulates in f64."""
    is_int8 = storage == torch.int8
    cdt = torch.bfloat16 if is_int8 else storage
    acc = torch.float64 if storage == torch.float64 else torch.float32
    return cdt, acc, (1.0 / _INT8_SCALE if is_int8 else 1.0)


def _seg_matvec_lane(rows: torch.Tensor, U: torch.Tensor, nt: int, t: int):
    """Every lane's (M u, C u) from its gathered (B, 2t, S) triangle, as
    segment products: forward over tiles r..nt-1 of each row block, plus
    the transposed product of every strictly-upper tile. rows and U
    (B, K, m) are in the accumulation dtype. Returns (accM, accC), each
    (B, K, m)."""
    B, K, m = U.shape
    offs = tri_tile_offsets(nt)
    accM = torch.zeros(B, K, m, dtype=U.dtype, device=U.device)
    accC = torch.zeros_like(accM)
    for r in range(nt):
        L = nt - r
        c0 = offs[r] * t
        seg = rows[:, :, c0:c0 + L * t]                     # (B, 2t, L t)
        P = torch.bmm(U[:, :, r * t:], seg.transpose(1, 2))  # (B, K, 2t)
        accM[:, :, r * t:(r + 1) * t] += P[:, :, :t]
        accC[:, :, r * t:(r + 1) * t] += P[:, :, t:]
        if L > 1:
            u_r = U[:, :, r * t:(r + 1) * t]
            accM[:, :, (r + 1) * t:] += torch.bmm(u_r, seg[:, :t, t:])
            accC[:, :, (r + 1) * t:] += torch.bmm(u_r, seg[:, t:, t:])
    return accM, accC


def tri_pool_matvec_plain(tri: torch.Tensor, nt: int, idx: torch.Tensor,
                          U: torch.Tensor, out_dtype: torch.dtype):
    """Plain PyTorch version of the tri matvec (counterpart of the JAX
    package's make_tri_pool_matvec_xla): gathers each lane's triangle and
    contracts. U (B, K, m) -> (MU, CU) each (B, K, m) in out_dtype.

    int8 and bf16 codes and bf16 u are exact in TF32, so on the card only
    f32 storage depends on torch.backends.cuda.matmul.allow_tf32; it
    raises there when TF32 is on rather than change the flag."""
    t = tri.shape[1] // 2
    cdt, acc, scale = _dtypes(tri.dtype)
    if (tri.is_cuda and tri.dtype == torch.float32
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "tri_pool_matvec_plain: f32 storage on the card needs "
            "torch.backends.cuda.matmul.allow_tf32 = False")
    rows = tri[idx.long()].to(acc)
    Uc = U.to(cdt).to(acc)
    accM, accC = _seg_matvec_lane(rows, Uc, nt, t)
    s = torch.tensor(scale, dtype=acc)
    return (accM * s).to(out_dtype), (accC * s).to(out_dtype)


def matvec_route(t: int, dtype: torch.dtype) -> str:
    """The route by which csrc/tri_matvec.cu (kernel 1) and
    csrc/tri_tiles_matvec.cu (kernel 9) take storage of ``dtype`` at tile
    t, by t alone: for int8 / bf16, ``"mma"`` at t in 128, 256, 384, 512,
    the tensor-core kernel at the tile (csrc/tri_matvec_mma.cuh);
    ``"super"`` at every other multiple of 16, the same kernel over
    128-row super-tiles (tri_super_kernel); ``"core"`` at every
    other t, the CUDA-core kernel (csrc/tri_matvec_core.cuh); ``"float"``
    for f32 / f64 at every t (that CUDA-core kernel; kernel 9's warp-row
    kernel at t = 128 and 256). The host's copy of the dispatch's rule,
    for the shape checks: the wrappers count each launch by the route its
    C entry reports (``_kernels.call_routed``, ``_kernels.route_key``)."""
    if dtype in (torch.int8, torch.bfloat16):
        if t in _MMA_TILES:
            return "mma"
        return "super" if t % _SUPER_ALIGN == 0 else "core"
    return "float"


def check_tri_matvec(tri: torch.Tensor, nt: int, U: torch.Tensor) -> str:
    """The shape and storage check of :func:`tri_pool_matvec_cuda`, before
    any device check: (P, 2t, S) int8 / bf16 / f32 / f64 storage of nt
    t-tiles a side, any t >= 1 (at most _CORE_MAX_T on the CUDA-core
    routes), and U (B, K, m). Returns the kernel's route
    (:func:`matvec_route`)."""
    if tri.dtype not in (torch.int8, torch.bfloat16, torch.float32,
                         torch.float64):
        raise NotImplementedError(f"tri matvec kernel takes int8/bf16/f32/"
                                  f"f64 storage, not {tri.dtype}")
    P, two_t, S = tri.shape
    t = two_t // 2
    if (two_t != 2 * t or t < 1 or nt < 1 or S != tri_ncols(nt, t)
            or U.dim() != 3 or U.shape[2] != nt * t):
        raise ValueError(f"tri matvec kernel: storage {tuple(tri.shape)} "
                         f"and U {tuple(U.shape)} are not the flat triangle "
                         f"of nt={nt} tiles and its (B, K, m) rows")
    return _checked_route(t, tri.dtype, "tri matvec kernel")


def _checked_route(t: int, dtype: torch.dtype, what: str) -> str:
    """:func:`matvec_route`, refusing the tiles past the CUDA-core
    kernel's _CORE_MAX_T on its routes."""
    route = matvec_route(t, dtype)
    if route in ("core", "float") and t > _CORE_MAX_T:
        raise ValueError(f"{what}: route {route} takes t <= {_CORE_MAX_T}, "
                         f"not {t}")
    return route


def tri_pool_matvec_cuda(tri: torch.Tensor, nt: int, idx: torch.Tensor,
                         U: torch.Tensor, out_dtype: torch.dtype):
    """Launch csrc/tri_matvec.cu: U (B, K, m) on the card -> (MU, CU), by
    the route of :func:`matvec_route` (every t the shape check takes),
    each launch counted by the route the C entry reports."""
    route = check_tri_matvec(tri, nt, U)
    P, two_t, S = tri.shape
    t = two_t // 2
    m = nt * t
    B, K, _ = U.shape
    cdt, acc, scale = _dtypes(tri.dtype)
    if not (tri.is_cuda and idx.is_cuda and U.is_cuda
            and tri.is_contiguous()):
        raise ValueError("tri matvec kernel: storage, idx and U must lie on "
                         "the card, the storage contiguous")
    if route in ("mma", "super") and tri.data_ptr() % 16:
        raise ValueError("tri matvec kernel: the storage must be 16-byte "
                         "aligned (its bulk copies)")
    lib = _kernels.lib("tri_matvec")
    idx32 = idx.to(torch.int32).contiguous()
    Uc = U.to(cdt).contiguous()
    out = torch.empty(B, K, 2 * m, dtype=acc, device=tri.device)
    stream = _kernels.stream_ptr(tri.device)
    for k0 in range(0, K, _KERNEL_ROWS):
        k1 = min(K, k0 + _KERNEL_ROWS)
        Uk = Uc[:, k0:k1].contiguous()
        ok = out[:, k0:k1] if (k0, k1) == (0, K) else torch.empty(
            B, k1 - k0, 2 * m, dtype=acc, device=tri.device)
        ptrs = (tri.data_ptr(), idx32.data_ptr(), Uk.data_ptr(),
                ok.data_ptr())
        shape = (B, k1 - k0, nt, t, S)
        if tri.dtype == torch.int8:
            route = _kernels.call_routed(lib.tri_matvec_int8, "tri_matvec",
                                         *ptrs, P, *shape, scale, stream)
        elif tri.dtype == torch.bfloat16:
            route = _kernels.call_routed(lib.tri_matvec_bf16, "tri_matvec",
                                         *ptrs, P, *shape, stream)
        else:
            fn = (lib.tri_matvec_f32 if tri.dtype == torch.float32
                  else lib.tri_matvec_f64)
            _kernels.check(fn(*ptrs, *shape, stream), "tri_matvec")
        _kernels.LAUNCHES[_kernels.route_key("tri_matvec", route)] += 1
        if ok.data_ptr() != out.data_ptr():
            out[:, k0:k1] = ok
    out = out.to(out_dtype)
    return out[:, :, :m], out[:, :, m:]


def make_tri_pool_matvec(tri: torch.Tensor, nt: int, out_dtype: torch.dtype):
    """Batched per-lane dual matvec over (P, 2t, S) flat-triangle storage.

    Returns ``bmv(idx, U) -> (MU, CU)`` with idx (B,) lane -> pool row (or
    None: lane b reads row b) and U (B, m) (one row per lane) or (B, K, m)
    (K multiprobe candidates per lane); outputs match U's shape. CUDA
    storage launches the kernel, CPU storage takes the plain version.
    """
    return _flat_bmv(tri, nt, out_dtype, tri_pool_matvec_cuda
                     if tri.is_cuda else tri_pool_matvec_plain)


def make_tri_pool_matvec_xla(tri: torch.Tensor, nt: int,
                             out_dtype: torch.dtype):
    """:func:`make_tri_pool_matvec` through the plain version on every
    device (the JAX package's make_tri_pool_matvec_xla)."""
    return _flat_bmv(tri, nt, out_dtype, tri_pool_matvec_plain)


def _flat_bmv(tri, nt, out_dtype, fn):
    P, two_t, S = tri.shape
    t = two_t // 2
    if S != tri_ncols(nt, t):
        raise ValueError(f"storage has {S} columns; nt={nt}, t={t} needs "
                         f"{tri_ncols(nt, t)}")

    def bmv(idx, U):
        if idx is None:
            idx = torch.arange(U.shape[0], dtype=torch.int32,
                               device=tri.device)
        mp = U.dim() == 3
        MU, CU = fn(tri, nt, idx, U if mp else U[:, None, :], out_dtype)
        return (MU, CU) if mp else (MU[:, 0], CU[:, 0])

    return bmv


def build_tri_plain(invariant: PairwiseInvariant, P1s, P2s, As, m_trues, *,
                    t: int = 256, affinityeps: float = 1e-4,
                    storage_dtype=torch.int8, chunk: int = 64):
    """Plain PyTorch version of the build (counterpart of the JAX package's
    build_tri_xla): dense direct-to-storage [M; C] per problem, repacked to
    (W, 2t, S). P1s/P2s (W, m, d) gathered endpoints, As (W, m, 2),
    m_trues (W,). storage_dtype=None keeps the working precision. Problems
    go ``chunk`` at a time to bound the dense intermediates."""
    W = P1s.shape[0]
    mts = torch.as_tensor(m_trues, device=As.device)
    parts = []
    for s in range(0, W, chunk):
        sl = slice(s, s + chunk)
        if storage_dtype is None:
            M, C = pairwise_from_endpoints(
                invariant, P1s[sl], P2s[sl], As[sl],
                affinityeps=affinityeps, m_true=mts[sl])
            MC = torch.cat([M, C], dim=-2)
        else:
            MC = stored_from_endpoints(
                invariant, P1s[sl], P2s[sl], As[sl],
                affinityeps=affinityeps, m_true=mts[sl],
                storage_dtype=storage_dtype)
        parts.append(repack_stacked(MC, t))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def tri_sub_tiles(t: int) -> int:
    """q: 64-row sub-tiles a t-tile (the last shorter where 64 does not
    divide t)."""
    return -(-t // _SUB)


def tri_sub_pair(k: int, nt: int, t: int) -> SubPair:
    """Sub-tile pair k of a problem of nt t-tiles a side, as the build
    kernels place it (csrc/tri_pair_build.cuh: sub_pair), step for step:
    the unordered pair (I <= J) of the n = nt q sub-tiles a side
    (:func:`affinity_pallas.stored_tile_pair`'s closed form), in upper
    t-tile (I // q, J // q)."""
    q = tri_sub_tiles(t)
    S = tri_ncols(nt, t)
    i, j = stored_tile_pair(k, nt * q)
    r, a, c, b = i // q, i % q, j // q, j % q
    col = (r * nt - r * (r - 1) // 2 + c - r) * t
    return SubPair(rows=min(_SUB, t - a * _SUB), cols=min(_SUB, t - b * _SUB),
                   gr0=r * t + a * _SUB, gc0=c * t + b * _SUB, diag=i == j,
                   mirror=r == c and a != b, at=a * _SUB * S + col + b * _SUB,
                   at_t=b * _SUB * S + col + a * _SUB)


def tri_build_fused_whole(m: int, invariant: PairwiseInvariant,
                          storage_dtype=torch.int8) -> bool:
    """True where kernel 8 (csrc/tri_build_fused.cu) stages a problem's
    m endpoints whole in shared memory on the current card, False where
    each of its units stages the two sub-tiles of every pair it takes:
    the invariant's record bytes (``_kernels.record_bytes``) decide. Asks
    the card (the limit is the device's)."""
    code = _kernels.lib("tri_build_fused").tri_build_fused_whole(
        m, _kernels.record_bytes(device_score(invariant)),
        int(storage_dtype == torch.bfloat16))
    if code < 0:
        raise RuntimeError("tri_build_fused_whole: the device cannot be "
                           "asked")
    return bool(code)


def check_tri_build(invariant: PairwiseInvariant, P1s, P2s, t: int,
                    storage_dtype) -> Tuple[int, tuple, str]:
    """The input check of kernels 2 and 8 (:func:`build_tri_cuda`,
    :func:`build_tri_fused_cuda`), before any device check: an invariant
    with a device score (a built-in or its own), int8 or bf16 storage,
    (W, m, d) f32 endpoints and any tile t >= 1 dividing m. Returns the
    score's (kind, params) and the storage suffix of the C entry
    points."""
    kind, d, params = kernel_score(invariant)
    suffix = {torch.int8: "int8", torch.bfloat16: "bf16"}.get(storage_dtype)
    if suffix is None:
        raise NotImplementedError(f"the CUDA tri builds write int8 or bf16 "
                                  f"storage, not {storage_dtype}")
    W, m, dp = P1s.shape
    if (dp != d or P2s.shape != P1s.shape or P1s.dtype != torch.float32
            or P2s.dtype != torch.float32):
        raise ValueError(f"the tri build kernels take (W, m, {d}) float32 "
                         f"endpoints for {type(invariant).__name__}")
    if t < 1 or m % t:
        raise ValueError(f"the tri build kernels need a tile t >= 1 "
                         f"dividing m; got m={m}, t={t}")
    return kind, params, suffix


def _launch_tri_build(kernel: str, invariant: PairwiseInvariant, P1s, P2s,
                      As, m_trues, t: int, affinityeps: float,
                      storage_dtype) -> torch.Tensor:
    """Launch csrc/<kernel>.cu, or the invariant's device score library's
    entry: (W, 2t, S) int8 or bf16 storage on the card, at any tile t >= 1
    dividing m."""
    kind, params, suffix = check_tri_build(invariant, P1s, P2s, t,
                                           storage_dtype)
    if not (P1s.is_cuda and P2s.is_cuda and As.is_cuda):
        raise ValueError(f"{kernel} kernel: inputs must lie on the card")
    W, m, _ = P1s.shape
    nt = m // t
    S = tri_ncols(nt, t)
    # held in locals until the launch (see stored_build_cuda)
    P1c = P1s.contiguous()
    P2c = P2s.contiguous()
    Ac = As.to(torch.int32).contiguous()
    mts = torch.as_tensor(m_trues, device=P1s.device).to(
        torch.int32).expand(W).contiguous()
    out = torch.empty(W, 2 * t, S, dtype=storage_dtype, device=P1s.device)
    fn, key = _kernels.score_entry(kernel, suffix, device_score(invariant))
    code = fn(P1c.data_ptr(), P2c.data_ptr(), Ac.data_ptr(), mts.data_ptr(),
              out.data_ptr(), W, m, t, S, kind, *params, float(affinityeps),
              _kernels.stream_ptr(P1s.device))
    _kernels.check(code, key)
    _kernels.LAUNCHES[key] += 1
    return out


def build_tri_cuda(invariant: PairwiseInvariant, P1s, P2s, As, m_trues, *,
                   t: int = 256, affinityeps: float = 1e-4,
                   storage_dtype=torch.int8):
    """Launch csrc/tri_build.cu (one kernel block per sub-tile pair):
    (W, 2t, S) int8 or bf16 storage on the card, for any invariant with a
    device score."""
    return _launch_tri_build("tri_build", invariant, P1s, P2s, As, m_trues,
                             t, affinityeps, storage_dtype)


def build_tri_fused_cuda(invariant: PairwiseInvariant, P1s, P2s, As,
                         m_trues, *, t: int = 256, affinityeps: float = 1e-4,
                         storage_dtype=torch.int8):
    """Launch csrc/tri_build_fused.cu (one kernel block per problem): the
    same bytes as :func:`build_tri_cuda`."""
    return _launch_tri_build("tri_build_fused", invariant, P1s, P2s, As,
                             m_trues, t, affinityeps, storage_dtype)


def build_tri(invariant: PairwiseInvariant, P1s, P2s, As, m_trues, *,
              t: int = 256, affinityeps: float = 1e-4,
              storage_dtype=torch.int8):
    """Batched fused build into flat-triangle storage (counterpart of the
    JAX package's build_tri_pallas): one upper tile's scores, masks and
    quantization per kernel block. CUDA inputs launch the kernel, CPU
    inputs take the plain version."""
    fn = build_tri_cuda if P1s.is_cuda else build_tri_plain
    return fn(invariant, P1s, P2s, As, m_trues, t=t,
              affinityeps=affinityeps, storage_dtype=storage_dtype)


def build_tri_pallas_fused(invariant: PairwiseInvariant, P1s, P2s, As,
                           m_trues, *, t: int = 256,
                           affinityeps: float = 1e-4,
                           storage_dtype=torch.int8):
    """:func:`build_tri` with one kernel block per problem looping over
    its T upper tiles (the JAX package's one-program-per-problem variant):
    the same bytes. No pipeline selects it, as in the JAX package, which
    measured it a wash against the per-tile grid. CUDA inputs launch the
    kernel, CPU inputs take the plain version."""
    fn = build_tri_fused_cuda if P1s.is_cuda else build_tri_plain
    return fn(invariant, P1s, P2s, As, m_trues, t=t,
              affinityeps=affinityeps, storage_dtype=storage_dtype)


# ---------------------------------------------------------------------------
# tile-major (P, T, 2t, t) storage and its single-probe matvec
# ---------------------------------------------------------------------------


def repack_stacked_tiles(MC: torch.Tensor, t: int) -> torch.Tensor:
    """Dense stacked (..., 2m, m) [M; C] -> tile-major (..., T, 2t, t):
    tile k (row r_k, column c_k in :func:`tri_coords` order) is the
    stacked pair [M[r t:(r+1) t, c t:(c+1) t]; C[...]]."""
    two_m, m = MC.shape[-2:]
    if two_m != 2 * m or m % t:
        raise ValueError(f"need stacked (..., 2m, m) with t | m; got "
                         f"{tuple(MC.shape)}, t={t}")
    rs, cs, _ = tri_coords(m // t)
    tiles = [torch.cat([MC[..., r * t:(r + 1) * t, c * t:(c + 1) * t],
                        MC[..., m + r * t:m + (r + 1) * t,
                           c * t:(c + 1) * t]], dim=-2)
             for r, c in zip(rs.tolist(), cs.tolist())]
    return torch.stack(tiles, dim=-3).contiguous()


def _tile_assembly(nt: int, dtype, device=None):
    """0/1 assembly operators mapping per-tile products to output blocks:
    fwd[r, k] = 1 iff tile k lives in row r; trn[c, k] = 1 iff tile k is
    strictly upper in column c (a diagonal tile's content is complete in
    its forward product)."""
    rs, cs, _ = tri_coords(nt)
    k = torch.arange(len(rs))
    fwd = torch.zeros(nt, len(rs), dtype=dtype)
    trn = torch.zeros(nt, len(rs), dtype=dtype)
    fwd[torch.from_numpy(rs).long(), k] = 1
    upper = torch.from_numpy(rs != cs)
    trn[torch.from_numpy(cs).long()[upper], k[upper]] = 1
    return fwd.to(device), trn.to(device)


def tri_tiles_matvec_plain(tri: torch.Tensor, nt: int, idx: torch.Tensor,
                           U: torch.Tensor, out_dtype: torch.dtype):
    """Plain PyTorch version of the tile-major matvec (the JAX package's
    make_tri_pool_matvec_tiles_xla): gathers each lane's (T, 2t, t) tiles,
    runs the three tile-batched contractions and assembles them into
    output blocks. U (B, m) -> (MU, CU) each (B, m) in out_dtype. f32
    storage on the card raises when TF32 is on, as for
    :func:`tri_pool_matvec_plain`."""
    P, T, two_t, t = tri.shape
    B = U.shape[0]
    m = nt * t
    cdt, acc, scale = _dtypes(tri.dtype)
    if (tri.is_cuda and tri.dtype == torch.float32
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "tri_tiles_matvec_plain: f32 storage on the card needs "
            "torch.backends.cuda.matmul.allow_tf32 = False")
    rs, cs, _ = tri_coords(nt)
    rs = torch.from_numpy(rs).long().to(tri.device)
    cs = torch.from_numpy(cs).long().to(tri.device)
    tr = tri[idx.long()].to(acc)                         # (B, T, 2t, t)
    Ub = U.to(cdt).to(acc).reshape(B, nt, t)
    of = torch.einsum("bkot,bkt->bko", tr, Ub[:, cs])    # (B, T, 2t)
    ugr = Ub[:, rs]
    om = torch.einsum("bkst,bks->bkt", tr[:, :, :t], ugr)  # (B, T, t)
    oc = torch.einsum("bkst,bks->bkt", tr[:, :, t:], ugr)
    fwd, trn = _tile_assembly(nt, acc, tri.device)
    yf = torch.einsum("rk,bko->bro", fwd, of)            # (B, nt, 2t)
    ym = torch.einsum("ck,bko->bco", trn, om)            # (B, nt, t)
    yc = torch.einsum("ck,bko->bco", trn, oc)
    s = torch.tensor(scale, dtype=acc)
    MU = (yf[:, :, :t] + ym).reshape(B, m)
    CU = (yf[:, :, t:] + yc).reshape(B, m)
    return (MU * s).to(out_dtype), (CU * s).to(out_dtype)


def check_tri_tiles_matvec(tri: torch.Tensor, nt: int,
                           U: torch.Tensor) -> str:
    """The shape and storage check of :func:`tri_tiles_matvec_cuda`, before
    any device check: (P, T, 2t, t) int8 / bf16 / f32 / f64 tile-major
    storage of nt t-tiles a side, any t >= 1 (at most _CORE_MAX_T on the
    CUDA-core routes), and U (B, m). Returns the kernel's route
    (:func:`matvec_route`)."""
    if tri.dtype not in (torch.int8, torch.bfloat16, torch.float32,
                         torch.float64):
        raise NotImplementedError(f"tiles matvec kernel takes int8/bf16/f32/"
                                  f"f64 storage, not {tri.dtype}")
    P, T, two_t, t = tri.shape
    if (two_t != 2 * t or t < 1 or nt < 1 or T != nt * (nt + 1) // 2
            or U.dim() != 2 or U.shape[1] != nt * t):
        raise ValueError(f"tiles matvec kernel: storage {tuple(tri.shape)} "
                         f"and U {tuple(U.shape)} are not the tile-major "
                         f"triangle of nt={nt} tiles and its (B, m) rows")
    return _checked_route(t, tri.dtype, "tiles matvec kernel")


def tri_tiles_matvec_cuda(tri: torch.Tensor, nt: int, idx: torch.Tensor,
                          U: torch.Tensor, out_dtype: torch.dtype):
    """Launch csrc/tri_tiles_matvec.cu: U (B, m) on the card -> (MU, CU),
    by the route of :func:`matvec_route` (every t the shape check takes),
    the launch counted by the route the C entry reports."""
    route = check_tri_tiles_matvec(tri, nt, U)
    P, T, two_t, t = tri.shape
    m = nt * t
    B = U.shape[0]
    cdt, acc, scale = _dtypes(tri.dtype)
    if not (tri.is_cuda and idx.is_cuda and U.is_cuda
            and tri.is_contiguous()):
        raise ValueError("tiles matvec kernel: storage, idx and U must lie "
                         "on the card, the storage contiguous")
    # int8 / bf16 on the tensor cores: the tensor map's base (16 bytes);
    # f32 / f64: the warp-row kernel's vector loads
    align = (64 if route == "float" else 16 if route in ("mma", "super")
             else 1)
    if tri.data_ptr() % align:
        raise ValueError(f"tiles matvec kernel: the storage must be "
                         f"{align}-byte aligned")
    idx32 = idx.to(torch.int32).contiguous()
    Uc = U.to(cdt).contiguous()
    out = torch.empty(B, 2 * m, dtype=acc, device=tri.device)
    lib = _kernels.lib("tri_tiles_matvec")
    ptrs = (tri.data_ptr(), idx32.data_ptr(), Uc.data_ptr(), out.data_ptr())
    args = (*ptrs, B, nt, t)
    stream = _kernels.stream_ptr(tri.device)
    if tri.dtype == torch.int8:
        route = _kernels.call_routed(lib.tri_tiles_matvec_int8,
                                     "tri_tiles_matvec", *ptrs, P, B, nt, t,
                                     scale, stream)
    elif tri.dtype == torch.bfloat16:
        route = _kernels.call_routed(lib.tri_tiles_matvec_bf16,
                                     "tri_tiles_matvec", *ptrs, P, B, nt, t,
                                     stream)
    else:
        fn = (lib.tri_tiles_matvec_f32 if tri.dtype == torch.float32
              else lib.tri_tiles_matvec_f64)
        _kernels.check(fn(*args, stream), "tri_tiles_matvec")
    _kernels.LAUNCHES[_kernels.route_key("tri_tiles_matvec", route)] += 1
    out = out.to(out_dtype)
    return out[:, :m], out[:, m:]


def make_tri_pool_matvec_tiles(tri: torch.Tensor, nt: int,
                               out_dtype: torch.dtype):
    """Batched per-lane dual matvec over (P, T, 2t, t) tile-major storage,
    one probe a lane: ``bmv(idx, U) -> (MU, CU)`` with idx (B,) lane ->
    pool row (or None: lane b reads row b) and U (B, m). CUDA storage
    launches the kernel, CPU storage takes the plain version. (The TPU
    kernel miscompiled under Mosaic; the card's kernel is held to an f64
    oracle and to the flat kernel.)"""
    return _tiles_bmv(tri, nt, out_dtype, tri_tiles_matvec_cuda
                      if tri.is_cuda else tri_tiles_matvec_plain)


def make_tri_pool_matvec_tiles_xla(tri: torch.Tensor, nt: int,
                                   out_dtype: torch.dtype):
    """:func:`make_tri_pool_matvec_tiles` through the plain version on
    every device (the JAX package's make_tri_pool_matvec_tiles_xla)."""
    return _tiles_bmv(tri, nt, out_dtype, tri_tiles_matvec_plain)


def _tiles_bmv(tri, nt, out_dtype, fn):
    P, T, two_t, t = tri.shape
    if T != nt * (nt + 1) // 2 or two_t != 2 * t:
        raise ValueError(f"tile-major storage {tuple(tri.shape)} does not "
                         f"hold the (2t, t) upper tiles of nt={nt} blocks")

    def bmv(idx, U):
        if U.dim() != 2:
            raise ValueError("the tile-major matvec takes one probe a lane: "
                             f"U (B, m), got shape {tuple(U.shape)}")
        if idx is None:
            idx = torch.arange(U.shape[0], dtype=torch.int32,
                               device=tri.device)
        return fn(tri, nt, idx, U, out_dtype)

    return bmv


def dense_stacked(tri: torch.Tensor, nt: int) -> torch.Tensor:
    """Flat triangle (..., 2t, S) -> dense stacked (..., 2m, m) [M; C]:
    the inverse of :func:`repack_stacked` (both triangles filled)."""
    t = tri.shape[-2] // 2
    m = nt * t
    out = torch.zeros(tri.shape[:-2] + (2 * m, m), dtype=tri.dtype,
                      device=tri.device)
    rs, cs, offs = tri_coords(nt)
    for r, c, off in zip(rs.tolist(), cs.tolist(), offs.tolist()):
        blk = tri[..., :, off * t:(off + 1) * t]
        for h in range(2):
            tile = blk[..., h * t:(h + 1) * t, :]
            out[..., h * m + r * t:h * m + (r + 1) * t, c * t:(c + 1) * t] = tile
            if r != c:
                out[..., h * m + c * t:h * m + (c + 1) * t,
                    r * t:(r + 1) * t] = tile.transpose(-1, -2)
    return out


__all__ = ["tri_tile_offsets", "tri_ncols", "tri_coords", "repack_stacked",
           "matvec_route", "check_tri_matvec", "check_tri_tiles_matvec",
           "check_tri_build", "tri_pool_matvec_plain", "tri_pool_matvec_cuda",
           "make_tri_pool_matvec", "make_tri_pool_matvec_xla",
           "build_tri_plain", "build_tri_cuda", "build_tri_fused_cuda",
           "build_tri", "build_tri_pallas_fused", "SubPair", "tri_sub_tiles",
           "tri_sub_pair", "tri_build_fused_whole", "repack_stacked_tiles",
           "tri_tiles_matvec_plain", "tri_tiles_matvec_cuda",
           "make_tri_pool_matvec_tiles", "make_tri_pool_matvec_tiles_xla",
           "dense_stacked"]
