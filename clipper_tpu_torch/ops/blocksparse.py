"""Block-sparse (occupied-tile) storage for the dual matvec.

Counterpart of ``clipper_tpu/ops/blocksparse.py``. Structured association
workloads (multi-object scenes, maps merged from several traversals,
batched loop-closure candidates) put the consistent pairs in blocks:
associations of object k are consistent only with associations of object
k, so most tiles of M are exactly zero. This storage keeps only the
occupied (row, column) tiles of the stacked [M; C], gathers the u slice
of each tile, runs one batched (2t, t) x (t, K) product and sums each
tile row's products. M and C share their off-diagonal pattern (C is M's
keep mask), so a tile of [M; C] is zero exactly when its M tile is; at
high occupancy the build functions hand back dense stacked storage
instead (``info["dense"]``).

The JAX package computes this product in plain JAX, outside any Pallas
kernel, so it is plain PyTorch here too. Two departures keep it exact and
reproducible:

  * the JAX scatter-add of the tile products (``.at[rows].add``) becomes a
    fixed-order sum: the build functions order the tiles by row (row-major,
    as the JAX ones do), :func:`_pack` records each tile row's tiles in
    ``slots`` once, and the matvec adds them in that order. On the card
    ``index_add_`` would use float atomics, and a rerun would not
    reproduce a lane's trajectory;
  * the JAX product multiplies bf16 (or storage-dtype) operands with f32
    accumulation; ``torch.bmm`` of bf16 tensors rounds its output to bf16,
    so the bf16-rounded operands are cast to f32 (f64 for f64 storage) and
    multiplied there, with TF32 off on the card (the call raises when it
    is on), then rounded to f32 as the JAX product is.

The build functions and :func:`solve_single` run on ``device`` ("cuda" by
default; raises when CUDA is missing); the solvers run on the storage's
device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from clipper_tpu_torch.solvers import msrc_flat
from clipper_tpu_torch.types import Params, resolve_device


class BlockSparseMC(NamedTuple):
    """Occupied tiles of the stacked [M; C] matrix.

    tiles: (T, 2t, t) storage: tile k holds rows [rows[k] t, rows[k] t + t)
        of M stacked over the same rows of C, columns [cols[k] t, ...).
    rows, cols: (T,) int64 tile coordinates (tile units), rows ascending.
    slots: (nt, L) int64: tile row r's tiles in order, padded with T (a
        zero product), L the most tiles a row holds.
    """
    tiles: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    slots: torch.Tensor

    @property
    def tile(self) -> int:
        return self.tiles.shape[2]


def _store(X: torch.Tensor, storage_dtype) -> torch.Tensor:
    """f32 [M; C] values in the storage dtype (int8: quantized codes)."""
    if storage_dtype == torch.int8:
        return msrc_flat.quantize_stacked(X)
    if storage_dtype is not None:
        return X.to(storage_dtype)
    return X


def _pack(tiles: torch.Tensor, rows: np.ndarray, cols: np.ndarray,
          nt: int) -> BlockSparseMC:
    """BlockSparseMC over tiles already ordered by row (``rows``
    ascending), with each row's slots recorded once."""
    T = len(rows)
    counts = np.bincount(rows, minlength=nt)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slots = np.full((nt, max(1, int(counts.max(initial=0)))), T, np.int64)
    slots[rows, np.arange(T) - start[rows]] = np.arange(T)
    dev = tiles.device
    return BlockSparseMC(tiles=tiles,
                         rows=torch.as_tensor(rows, device=dev),
                         cols=torch.as_tensor(cols, device=dev),
                         slots=torch.as_tensor(slots, device=dev))


def _pad_to_tiles(X: torch.Tensor, t: int) -> torch.Tensor:
    pad = -X.shape[0] % t
    return torch.nn.functional.pad(X, (0, pad, 0, pad)) if pad else X


def from_dense(M, C, tile: int = 128, storage_dtype=torch.int8,
               max_occupancy: float = 0.5, device="cuda"
               ) -> Tuple[Optional[BlockSparseMC], dict]:
    """Dense (M, C) (numpy or tensors) -> occupied-tile storage on
    ``device``, or, above ``max_occupancy``, (None, info) with the dense
    stacked storage in ``info["dense"]`` in the same storage dtype (where
    the gather costs more than the bytes it saves). info always carries
    {"occupancy", "n_tiles", "nt", "m", "m_pad"}. The values pass through
    f32, as in the JAX package, whatever the storage dtype."""
    dev = resolve_device(device)
    M = torch.as_tensor(M).to(dev, torch.float32)
    C = torch.as_tensor(C).to(dev, torch.float32)
    m = M.shape[0]
    t = int(tile)
    Mp, Cp = _pad_to_tiles(M, t), _pad_to_tiles(C, t)
    m_pad = Mp.shape[0]
    nt = m_pad // t
    # the scan reads M only: an all-zero M tile has an all-zero C tile
    occ = (Mp.reshape(nt, t, nt, t) != 0).any(3).any(1)
    rows, cols = (x.cpu().numpy() for x in torch.nonzero(occ, as_tuple=True))
    occupancy = float(len(rows)) / (nt * nt)
    info = {"occupancy": occupancy, "n_tiles": int(len(rows)), "nt": nt,
            "m": m, "m_pad": m_pad}
    if occupancy > max_occupancy:
        info["dense"] = _store(torch.cat([Mp, Cp]), storage_dtype)
        return None, info
    r = torch.as_tensor(rows, device=dev)
    c = torch.as_tensor(cols, device=dev)

    def gather(X):
        return X.reshape(nt, t, nt, t).permute(0, 2, 1, 3)[r, c]

    tiles = torch.cat([gather(Mp), gather(Cp)], dim=1)
    return _pack(_store(tiles, storage_dtype), rows, cols, nt), info


def from_scipy(M, C, tile: int = 128, storage_dtype=torch.int8,
               max_occupancy: float = 0.5, device="cuda"
               ) -> Tuple[Optional[BlockSparseMC], dict]:
    """scipy.sparse (M, C) -> occupied-tile storage on ``device``, scattered
    from the COO triplets on the host, so no dense (m, m) is made: host
    memory is O(nnz + T t^2). The product path behind
    ``Clipper.set_sparse_matrix_data`` (reference:
    include/clipper/clipper.h:139-143, src/clipper.cpp:61-64).

    M, C: FULL symmetric with zero diagonal (the facade symmetrizes the
    reference's upper-triangle input). Occupied tiles are the union of M's
    and C's tile patterns; above ``max_occupancy`` the dense stacked
    storage comes back in ``info["dense"]`` as in :func:`from_dense`."""
    import scipy.sparse as sp

    dev = resolve_device(device)
    M = sp.coo_matrix(M)
    C = sp.coo_matrix(C)
    m = M.shape[0]
    t = int(tile)
    m_pad = -(-m // t) * t
    nt = m_pad // t

    def tile_ids(X):
        return (X.row // t).astype(np.int64) * nt + (X.col // t)

    occ_ids = np.unique(np.concatenate([tile_ids(M), tile_ids(C)]))
    T = len(occ_ids)
    occupancy = float(T) / (nt * nt)
    info = {"occupancy": occupancy, "n_tiles": T, "nt": nt,
            "m": m, "m_pad": m_pad}

    if occupancy > max_occupancy:
        stacked = np.zeros((2 * m_pad, m_pad), np.float32)
        stacked[:m, :m] = M.toarray()
        stacked[m_pad:m_pad + m, :m] = C.toarray()
        info["dense"] = _store(torch.as_tensor(stacked, device=dev),
                               storage_dtype)
        return None, info

    tiles = np.zeros((T, 2 * t, t), np.float32)
    for X, half in ((M, 0), (C, 1)):
        slot = np.searchsorted(occ_ids, tile_ids(X))
        tiles[slot, half * t + X.row % t, X.col % t] = X.data
    tiles = _store(torch.as_tensor(tiles, device=dev), storage_dtype)
    # occ_ids ascend, so the tiles are ordered by row
    return _pack(tiles, occ_ids // nt, occ_ids % nt, nt), info


def make_matvec(bs: BlockSparseMC, nt: int, out_dtype):
    """Dual matvec u -> (M u, C u) over occupied-tile storage, the
    counterpart of :func:`msrc_flat.make_stacked_matvec` over the PADDED
    size m_pad = nt t (padded entries of u must be zero: they have no
    edges). u is (m_pad,) or (m_pad, K) candidate columns."""
    t = bs.tiles.shape[2]
    m = nt * t
    is_int8 = bs.tiles.dtype == torch.int8
    cdt = torch.bfloat16 if is_int8 else bs.tiles.dtype
    acc = torch.float64 if bs.tiles.dtype == torch.float64 else torch.float32
    if (bs.tiles.is_cuda and acc == torch.float32
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "block-sparse matvec: the tile products on the card need "
            "torch.backends.cuda.matmul.allow_tf32 = False")
    # a 0-d CPU tensor enters a CUDA op as a host scalar
    scale = torch.tensor(1.0 / msrc_flat._INT8_SCALE, dtype=torch.float32)
    L = bs.slots.shape[1]

    def mv(u):
        vec = u.dim() == 1
        U = u[:, None] if vec else u
        K = U.shape[1]
        ug = U.reshape(nt, t, K)[bs.cols]                  # (T, t, K)
        prod = torch.bmm(bs.tiles.to(acc),
                         ug.to(cdt).to(acc)).to(torch.float32)
        if is_int8:
            prod = prod * scale
        prod = torch.cat([prod, prod.new_zeros(1, 2 * t, K)])
        y = prod[bs.slots[:, 0]]
        for j in range(1, L):                 # each row's tiles in order
            y = y + prod[bs.slots[:, j]]
        y = y.to(out_dtype)
        yM = y[:, :t].reshape(m, K)
        yC = y[:, t:].reshape(m, K)
        return (yM[:, 0], yC[:, 0]) if vec else (yM, yC)

    return mv


def _lanes(mv):
    """A batched dual matvec over a column matvec: the rows of U (B, m)
    or (B, K, m) become its columns."""
    def bmv(idx, U):
        cols = U.reshape(-1, U.shape[-1]).T
        MU, CU = mv(cols)
        return MU.T.reshape(U.shape), CU.T.reshape(U.shape)

    return bmv


def _run_lanes(bmv, U0, params: Params, probes: int, power_steps: int):
    """The flat solver over B lanes from U0 (B, m) in lock-step: power
    init, then the single-probe or K-wide multiprobe tick until every lane
    is done. Returns (u, F, ifinal), each with the lanes first."""
    if power_steps:
        U0 = msrc_flat.power_init_batched(bmv, None, U0, power_steps)
    s = msrc_flat.flat_init_batched(bmv, None, U0, params)
    s, _ = msrc_flat.drive(msrc_flat.make_tick(bmv, params, U0.dtype,
                                               probes=probes), None, s)
    return s.u, s.F, s.i


def solve_single(M, C, u0, params: Optional[Params] = None, *,
                 tile: int = 128, storage_dtype=torch.int8,
                 max_occupancy: float = 0.5, probes: int = 1,
                 power_steps: int = 0, device="cuda"):
    """One problem end to end over block-sparse (or, at high occupancy,
    dense) storage: pad, build the tiles, run the flat solver, unpad.
    Returns (u, F, ifinal, info) with info from :func:`from_dense`. F is
    the solver's objective in the storage precision; polish it in full
    precision before rounding, as the dense pipelines do."""
    bs, info = from_dense(M, C, tile=tile, storage_dtype=storage_dtype,
                          max_occupancy=max_occupancy, device=device)
    u, F, ifinal = solve_prepared(bs, info, u0, params, probes=probes,
                                  power_steps=power_steps)
    return u, F, ifinal, info


def solve_prepared(bs: Optional[BlockSparseMC], info: dict, u0,
                   params: Optional[Params] = None, *, probes: int = 1,
                   power_steps: int = 0):
    """The flat solver over prepared tile (or dense) storage from
    :func:`from_dense` / :func:`from_scipy`: build once, solve many times.
    u0 (m,) in the working dtype. Returns (u, F, ifinal)."""
    u, F, ifinal = solve_prepared_multi(bs, info, torch.as_tensor(u0)[None],
                                        params, probes=probes,
                                        power_steps=power_steps)
    return u[0], F[0], ifinal[0]


def solve_prepared_multi(bs: Optional[BlockSparseMC], info: dict, u0s,
                         params: Optional[Params] = None, *, probes: int = 1,
                         power_steps: int = 0):
    """K restarts u0s (K, m) over prepared storage as K lanes of one
    lock-step solve (each lane's arithmetic is its own). Returns (us, Fs,
    ifinals) with us (K, m)."""
    params = params or Params()
    store = info["dense"] if bs is None else bs.tiles
    u0s = torch.as_tensor(u0s, device=store.device)
    m, m_pad = info["m"], info["m_pad"]
    U0 = torch.nn.functional.pad(u0s, (0, m_pad - m))
    mv = (msrc_flat.make_stacked_matvec(store, U0.dtype) if bs is None
          else make_matvec(bs, info["nt"], U0.dtype))
    bmv = _lanes(mv)
    us, Fs, ifinals = _run_lanes(bmv, U0, params, probes, power_steps)
    return us[:, :m], Fs, ifinals
