"""Symmetric-triangle storage: the single-problem capacity engine.

Counterpart of ``clipper_tpu/ops/symstore.py`` (:47-158, :427-532,
:539-625, :653-772) on its row-chunked layout. M and C are symmetric, so
only the upper-triangle TILES of [M; C] are stored (m^2 + O(m t) bytes in
int8, half of dense stacked storage):

    row-block r owns tiles (r, r), (r, r+1), ..., (r, nt-1), stored
    contiguously as ceil((nt - r) / G) chunks of G tiles side by side;
    a chunk is one (2t, G t) array, rows 0:t the M tiles, rows t:2t the C
    tiles; a short row's last chunk is padded with zero tiles.

Chunk k holds row ``chunk_r[k]`` from column block ``chunk_c0[k]`` on
(:func:`row_chunk_coords`); row r's first chunk is
:func:`row_first_chunk`'s closed form, which the CUDA kernel computes too.

The per-tick dual matvec is a wrapper around a hand-written CUDA kernel
(csrc/sym_rows_matvec.cu) with a plain PyTorch version beside it: CUDA
storage launches the kernel, CPU storage takes the plain version; a
failed build or launch raises. Everything else here is plain PyTorch, as
it was XLA in the JAX package. Left out (ROADMAP.md): the tile-list
layout (``build_symtiles``, ``make_sym_dual_matvec`` and its Pallas
kernel) and the sharded engine.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from clipper_tpu_torch import _kernels
from clipper_tpu_torch.invariants.base import PairwiseInvariant
from clipper_tpu_torch.parallel.pool import StageClock, support_objective
from clipper_tpu_torch.solvers import msrc_flat
from clipper_tpu_torch.types import Params, as_association

# candidate columns one kernel launch takes (the mma A-tile height)
_KERNEL_ROWS = 16


def tile_coords(nt: int) -> Tuple[np.ndarray, np.ndarray]:
    """(rows, cols) block coordinates of the upper triangle: the nt
    diagonal tiles first, then the strictly-upper tiles row-major."""
    rows = list(range(nt))
    cols = list(range(nt))
    for r in range(nt):
        for c in range(r + 1, nt):
            rows.append(r)
            cols.append(c)
    return np.asarray(rows, np.int32), np.asarray(cols, np.int32)


def _tile_scores(invariant: PairwiseInvariant, P1, P2, A, gr, gc, m_true,
                 affinityeps: float):
    """Masked full-precision scores between the row ids gr (b, tr) and the
    column ids gc (b, tc) of padded endpoints P1/P2 (n, d) and A (n, 2):
    the (b, tr, tc) score tiles and their keep masks (reference:
    src/clipper.cpp:35-55). Shared by the build and the exact objective,
    so both see the same score values."""
    scores = invariant.score_block(P1[gr], P1[gc], P2[gr], P2[gc])
    Ar, Ac = A[gr], A[gc]
    distinct = ~((Ar[..., :, 0, None] == Ac[..., None, :, 0])
                 | (Ar[..., :, 1, None] == Ac[..., None, :, 1]))
    gr_, gc_ = gr[..., :, None], gc[..., None, :]
    keep = (distinct & (gr_ != gc_) & (gr_ < m_true) & (gc_ < m_true)
            & (scores > affinityeps))
    return scores, keep


def exact_objective(invariant: PairwiseInvariant, P1, P2, A, u, m_true,
                    tile: int = 128, affinityeps: float = 1e-4,
                    chunk: int = 256) -> torch.Tensor:
    """F = u'(M + I)u in f32, rebuilt exactly ``chunk`` tiles at a time:
    the polish when u's support is wider than the top-k window. O(chunk
    t^2) transient memory. Elementwise products and sums, no matmul, so
    the result does not depend on torch.backends.cuda.matmul.allow_tf32."""
    m_pad = P1.shape[0]
    t = int(tile)
    nt = m_pad // t
    rows_np, cols_np = tile_coords(nt)
    rows = torch.as_tensor(rows_np, device=u.device).long()
    cols = torch.as_tensor(cols_np, device=u.device).long()
    Ub = u.to(torch.float32).reshape(nt, t)
    ar = torch.arange(t, device=u.device)
    F = torch.zeros((), dtype=torch.float32, device=u.device)
    for s in range(0, len(rows_np), chunk):
        r, c = rows[s:s + chunk], cols[s:s + chunk]
        scores, keep = _tile_scores(invariant, P1, P2, A, r[:, None] * t + ar,
                                    c[:, None] * t + ar, m_true, affinityeps)
        Mt = torch.where(keep, scores, 0.0).to(torch.float32)
        q = (Ub[r] * (Mt * Ub[c][:, None, :]).sum(-1)).sum(-1)
        # an off-diagonal tile stands for itself and its transpose
        F = F + torch.where(r == c, q, 2.0 * q).sum()
    # identity term on the f32 blocks, not u's working dtype
    return F + (Ub * Ub).sum()


def row_chunk_coords(nt: int, G: int):
    """Chunk descriptors of the row-chunked layout: (chunk_r, chunk_c0),
    each (NC,), and the flat per-tile (rows, cols), each (NC * G,), with
    the inert coordinate nt for a short row's pad tiles."""
    chunk_r, chunk_c0, rows, cols = [], [], [], []
    for r in range(nt):
        for c in range(r, nt, G):
            chunk_r.append(r)
            chunk_c0.append(c)
            for g in range(G):
                cc = c + g
                rows.append(r if cc < nt else nt)
                cols.append(cc if cc < nt else nt)
    return (np.asarray(chunk_r, np.int32), np.asarray(chunk_c0, np.int32),
            np.asarray(rows, np.int32), np.asarray(cols, np.int32))


def row_first_chunk(nt: int, G: int) -> np.ndarray:
    """Index of each row block's first chunk, (nt + 1,) with the chunk
    count NC last: first[r] = S(nt) - S(nt - r) with
    S(n) = sum_{s<=n} ceil(s / G) = G q (q + 1) / 2 + (n - q G)(q + 1),
    q = n // G. csrc/sym_rows_matvec.cu computes the same closed form."""
    def S(n):
        q = n // G
        return G * q * (q + 1) // 2 + (n - q * G) * (q + 1)

    return np.asarray([S(nt) - S(nt - r) for r in range(nt + 1)], np.int64)


def build_symchunks(invariant: PairwiseInvariant, P1, P2, A, m_true,
                    tile: int = 128, G: int = 32, affinityeps: float = 1e-4,
                    storage_dtype=torch.int8,
                    build_chunk: int = 8) -> torch.Tensor:
    """(NC, 2t, G t) row-chunked triangle storage, built ``build_chunk``
    chunks per step straight into the storage dtype: int8 codes
    clip(round_half_even(127 s), 0, 127) and C = 127, or the raw values in
    a float storage dtype. No f32 (m, m) is ever made.

    P1/P2 (m_pad, d) gathered endpoints and A (m_pad, 2) associations,
    padded to a multiple of the tile (pad endpoints 0, pad associations
    -1); rows and columns >= m_true are inert. Requires a symmetric
    invariant. Reference semantics: masks from src/clipper.cpp:35-55,
    C = pattern(M) from src/clipper.cpp:63-64.
    """
    m_pad, d = P1.shape
    t = int(tile)
    if m_pad % t:
        raise ValueError(f"build_symchunks: m_pad={m_pad} is not a multiple "
                         f"of the tile {t}")
    nt = m_pad // t
    chunk_r, chunk_c0, _, _ = row_chunk_coords(nt, G)
    NC = len(chunk_r)
    dev = P1.device
    # pad tiles' columns run up to (nt + G) t: extend the endpoints so their
    # gathers stay in bounds (m_true masks them)
    ext = (nt + G) * t

    def extend(X, fill):
        out = torch.full((ext,) + tuple(X.shape[1:]), fill, dtype=X.dtype,
                         device=dev)
        out[:m_pad] = X
        return out

    P1e, P2e, Ae = extend(P1, 0), extend(P2, 0), extend(A, -1)
    crs = torch.as_tensor(chunk_r, device=dev).long()
    cc0s = torch.as_tensor(chunk_c0, device=dev).long()
    ar_t = torch.arange(t, device=dev)
    ar_g = torch.arange(G * t, device=dev)
    is_int8 = storage_dtype == torch.int8
    buf = torch.empty(NC, 2 * t, G * t, dtype=storage_dtype, device=dev)
    for s in range(0, NC, build_chunk):
        gr = crs[s:s + build_chunk, None] * t + ar_t
        gc = cc0s[s:s + build_chunk, None] * t + ar_g
        scores, keep = _tile_scores(invariant, P1e, P2e, Ae, gr, gc, m_true,
                                    affinityeps)
        if is_int8:
            Mq = torch.clamp(torch.round(torch.where(keep, scores, 0.0)
                                         * msrc_flat._INT8_SCALE),
                             0, 127).to(torch.int8)
            Cq = torch.where(keep, int(msrc_flat._INT8_SCALE), 0).to(
                torch.int8)
        else:
            Mq = torch.where(keep, scores, 0.0).to(storage_dtype)
            Cq = keep.to(storage_dtype)
        buf[s:s + build_chunk, :t] = Mq
        buf[s:s + build_chunk, t:] = Cq
    return buf


def _layout(chunks: torch.Tensor, nt: int):
    """(t, G, first) of (NC, 2t, G t) storage, checked against nt."""
    NC, two_t, Gt = chunks.shape
    t = two_t // 2
    G = Gt // t
    first = row_first_chunk(nt, G)
    if Gt != G * t or two_t != 2 * t or NC != first[-1]:
        raise ValueError(f"storage {tuple(chunks.shape)} is not the "
                         f"row-chunked layout of nt={nt}")
    return t, G, first


def sym_rows_matvec_plain(chunks: torch.Tensor, nt: int,
                          U: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the rows matvec: U (K, m) -> the scaled f32
    (K, 2m) [M U'; C U']'. One row block at a time: its chunks are one
    contiguous (2t, n G t) segment, applied forward (into row block r) and
    transposed (into the blocks after r; the diagonal tile is complete in
    the forward product).

    As in the JAX kernel, int8 storage contracts int8 codes with
    bf16-rounded u and scales by 1/127 at the end, and every storage type
    gives an f32 result, f64 included. Unlike the JAX kernel, which sums
    in an f32 accumulator, the sums are taken in f64, where the products
    are exact, and rounded once to f32: at m = 65,536 an output sums 512
    tiles, and the CUDA kernel's f32 sums once sat 8.5e-3 from this
    version on outputs near 70, where 1e-4 is about 10 ulps. The kernel
    sums the same way, so the two agree to about an ulp; against the JAX
    kernel both differ by its f32 accumulation error."""
    t, G, first = _layout(chunks, nt)
    m = nt * t
    K = U.shape[0]
    f64 = torch.float64
    if chunks.dtype == torch.int8:
        Uc, scale = U.to(torch.bfloat16), 1.0 / msrc_flat._INT8_SCALE
    elif chunks.dtype in (torch.float32, torch.float64):
        Uc, scale = U.to(chunks.dtype), 1.0
    else:
        raise NotImplementedError(f"rows matvec: storage {chunks.dtype}")
    m_ext = (nt + G) * t
    Ue = torch.zeros(K, m_ext, dtype=f64, device=chunks.device)
    Ue[:, :m] = Uc
    acc = torch.zeros(K, 2, m_ext, dtype=f64, device=chunks.device)
    for r in range(nt):
        a, b = int(first[r]), int(first[r + 1])
        w = (b - a) * G * t
        seg = chunks[a:b].permute(1, 0, 2).reshape(2 * t, w).to(f64)
        P = Ue[:, r * t:r * t + w] @ seg.T                    # (K, 2t)
        acc[:, 0, r * t:(r + 1) * t] += P[:, :t]
        acc[:, 1, r * t:(r + 1) * t] += P[:, t:]
        if w > t:
            u_r = Ue[:, r * t:(r + 1) * t]
            acc[:, 0, (r + 1) * t:r * t + w] += u_r @ seg[:t, t:]
            acc[:, 1, (r + 1) * t:r * t + w] += u_r @ seg[t:, t:]
    s = torch.tensor(scale, dtype=torch.float32, device=chunks.device)
    return (acc[:, :, :m].to(torch.float32) * s).reshape(K, 2 * m)


def sym_rows_matvec_cuda(chunks: torch.Tensor, nt: int,
                         U: torch.Tensor) -> torch.Tensor:
    """Launch csrc/sym_rows_matvec.cu: U (K, m) on the card -> the scaled
    f32 (K, 2m), K split into launches of at most 16 columns."""
    t, G, _ = _layout(chunks, nt)
    m = nt * t
    K = U.shape[0]
    if chunks.dtype not in (torch.int8, torch.float32, torch.float64):
        raise NotImplementedError(
            f"rows matvec kernel takes int8/f32/f64 storage, not "
            f"{chunks.dtype}")
    if chunks.dtype == torch.int8 and t != 128:
        raise NotImplementedError(
            f"int8 rows matvec kernel needs t = 128, got {t}")
    if not (chunks.is_cuda and U.is_cuda and chunks.is_contiguous()):
        raise ValueError("rows matvec kernel: storage and U must lie on the "
                         "card, the storage contiguous")
    if U.shape[1] != m:
        raise ValueError(f"U has {U.shape[1]} columns, storage m={m}")
    lib = _kernels.lib("sym_rows_matvec")
    cdt = torch.bfloat16 if chunks.dtype == torch.int8 else chunks.dtype
    Uc = U.to(cdt).contiguous()
    out = torch.empty(K, 2 * m, dtype=torch.float32, device=chunks.device)
    stream = _kernels.stream_ptr(chunks.device)
    for k0 in range(0, K, _KERNEL_ROWS):
        k1 = min(K, k0 + _KERNEL_ROWS)
        args = (chunks.data_ptr(), Uc[k0:k1].data_ptr(), out[k0:k1].data_ptr(),
                k1 - k0, nt, t, G)
        if chunks.dtype == torch.int8:
            code = lib.sym_rows_matvec_int8(
                *args, 1.0 / msrc_flat._INT8_SCALE, stream)
        elif chunks.dtype == torch.float32:
            code = lib.sym_rows_matvec_f32(*args, stream)
        else:
            code = lib.sym_rows_matvec_f64(*args, stream)
        _kernels.check(code, "sym_rows_matvec")
        _kernels.LAUNCHES["sym_rows_matvec"] += 1
    return out


def make_sym_dual_matvec_rows(chunks: torch.Tensor, nt: int, out_dtype):
    """u -> (M u, C u) over (NC, 2t, G t) row-chunked storage (the
    counterpart of the JAX package's make_sym_dual_matvec_pallas_rows).

    Takes (m,) vectors or (m, K) candidate columns and returns the same
    shape in out_dtype, with f32 results for every storage type. CUDA
    storage launches the kernel, CPU storage takes the plain version."""
    t, _, _ = _layout(chunks, nt)
    m = nt * t
    fn = sym_rows_matvec_cuda if chunks.is_cuda else sym_rows_matvec_plain

    def mv(u):
        vec = u.dim() == 1
        U = u[:, None] if vec else u
        y = fn(chunks, nt, U.T).to(out_dtype)
        Mu, Cu = y[:, :m].T, y[:, m:].T
        return (Mu[:, 0], Cu[:, 0]) if vec else (Mu, Cu)

    return mv


def solve_single(invariant: PairwiseInvariant, D1, D2, A, u0,
                 params: Optional[Params] = None, *, tile: int = 128,
                 affinityeps: float = 1e-4, storage_dtype=torch.int8,
                 probes: int = 1, power_steps: int = 0, support: int = 512,
                 build_chunk: int = 256, d_scale: float = 1.0,
                 stats: Optional[Dict[str, float]] = None,
                 wrap_matvec: Optional[Callable] = None):
    """One problem end to end over row-chunked triangle storage: gather and
    pad to a multiple of the tile, build the storage (G = min(32, nt)
    tiles per chunk, build_chunk // G chunks per step), power-init and
    flat-init, the flat solve (multiprobe at probes > 1), the f32 polish
    on u's top-``support`` entries (the tile-chunked exact objective when
    the support is wider), and return (u, F, ifinal), u unpadded to m.

    D1/D2 are (n, d) row-major tensors, A (m, 2), u0 (m,); everything runs
    on D1's device. stats: optional dict filled with the stage
    milliseconds (build, init, solve, polish; CUDA events on the card,
    host time on the CPU), the solve's probe ticks and rejected probes
    (ticks, nback) and the storage bytes (storage_bytes). wrap_matvec:
    optional mv -> mv' applied to the rows matvec before init and solve
    use it, to measure how the solve responds to perturbed matvecs.
    """
    if not (isinstance(D1, torch.Tensor) and isinstance(D2, torch.Tensor)):
        raise TypeError("solve_single takes D1/D2 as tensors: their device "
                        "is where it runs (the Clipper facade moves data)")
    params = params or Params()
    dev = D1.device
    A = as_association(A, device=dev)
    m = A.shape[0]
    t = int(tile)
    m_pad = -(-m // t) * t
    Al = A.long()
    P1, P2 = D1[Al[:, 0]], D2[Al[:, 1]]
    u0 = torch.as_tensor(u0, dtype=P1.dtype, device=dev)
    pad = m_pad - m
    if pad:
        P1 = torch.nn.functional.pad(P1, (0, 0, 0, pad))
        P2 = torch.nn.functional.pad(P2, (0, 0, 0, pad))
        u0 = torch.nn.functional.pad(u0, (0, pad))
        A = torch.nn.functional.pad(A, (0, 0, 0, pad), value=-1)
    nt = m_pad // t
    G = min(32, nt)
    clock = StageClock(dev, stats)

    clock.mark("start")
    chunks = build_symchunks(invariant, P1, P2, A, m, tile=t, G=G,
                             affinityeps=affinityeps,
                             storage_dtype=storage_dtype,
                             build_chunk=max(1, build_chunk // G))
    clock.mark("build")
    mv = make_sym_dual_matvec_rows(chunks, nt, u0.dtype)
    if wrap_matvec is not None:
        mv = wrap_matvec(mv)
    if power_steps:
        u0 = msrc_flat.power_init(mv, u0, power_steps)
    s = msrc_flat.flat_init(mv, u0, params)
    clock.mark("init")
    s = msrc_flat.flat_solve_state(mv, s, params, probes=probes,
                                   d_scale=d_scale)
    u = s.u
    clock.mark("solve")
    # f32 polish (omega = round(F) needs F well within 0.5; the int8
    # in-loop F is biased). The top-k polish is exact only for supports
    # <= k; a wider support takes the tile-chunked exact rebuild.
    k = min(support, m_pad)
    if int((u > 0).sum()) > k:
        F = exact_objective(invariant, P1, P2, A, u, m, tile=t,
                            affinityeps=affinityeps,
                            chunk=build_chunk).to(u.dtype)
    else:
        F = support_objective(invariant, P1, P2, A, u,
                              affinityeps=affinityeps, k=k)
    clock.mark("polish")
    clock.finish()
    if stats is not None:
        stats.update(ticks=int(s.ticks), nback=int(s.nback),
                     storage_bytes=chunks.numel() * chunks.element_size())
    return u[:m], F, s.i


__all__ = ["tile_coords", "exact_objective", "row_chunk_coords",
           "row_first_chunk", "build_symchunks", "sym_rows_matvec_plain",
           "sym_rows_matvec_cuda", "make_sym_dual_matvec_rows",
           "solve_single"]
