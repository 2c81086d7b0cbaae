"""Symmetric-triangle storage: the single-problem capacity engines.

Counterpart of ``clipper_tpu/ops/symstore.py``. M and C are symmetric, so
only the upper-triangle TILES of [M; C] are stored (m^2 + O(m t) bytes in
int8, half of dense stacked storage), in one of two layouts:

- the **tile list** (:func:`build_symtiles`): (T, 2t, t), tile k the block
  (rows[k], cols[k]), the nt diagonal tiles first, then the strictly-upper
  tiles row-major (:func:`tile_coords`); rows 0:t of a tile hold M, rows
  t:2t C. An inert slot (nt, nt) is a zero tile (:func:`shard_tile_coords`
  pads the list with them so it splits evenly over D ranks);
- the **row-chunked** layout (:func:`build_symchunks`): row block r owns
  tiles (r, r), ..., (r, nt-1), stored contiguously as ceil((nt - r) / G)
  chunks of G tiles side by side, one (2t, G t) array each, a short row's
  last chunk padded with zero tiles. Chunk k holds row ``chunk_r[k]`` from
  column block ``chunk_c0[k]`` on (:func:`row_chunk_coords`); row r's first
  chunk is :func:`row_first_chunk`'s closed form, from which the CUDA
  kernel's plan (:func:`rows_plan`) places every tile.

Each layout's per-tick dual matvec wraps a hand-written CUDA kernel
(csrc/sym_tiles_matvec.cu, csrc/sym_rows_matvec.cu) with a plain PyTorch
version beside it: CUDA storage launches the kernel, CPU storage takes the
plain version; a failed build or launch, or a storage the kernel does not
take, raises. Both sum the exact products in f64 and round once to f32.
For int8 and bf16 storage both kernels walk a host-built plan
(:func:`unit_plan`: the stored tiles cut into units of up to 8 row
blocks by 32 column blocks, each read once a call; :func:`tiles_plan`,
:func:`rows_plan`, cached by the layout), made once a storage by the
closures, and a second kernel sums the units' partials (its launches
counted under ``sym_tiles_reduce`` / ``sym_rows_reduce``).
Everything else here is plain PyTorch, as it was XLA in the JAX package.

:func:`solve_single` solves one problem on one device in either layout;
:func:`solve_sharded_sym` splits either layout's list over the ranks of a
``torch.distributed`` process group, one all-reduce of the matvec's f64
sums a tick.
"""

from __future__ import annotations

import functools
import warnings
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from clipper_tpu_torch import _kernels
from clipper_tpu_torch.invariants.base import PairwiseInvariant
from clipper_tpu_torch.parallel.pool import StageClock, support_objective
from clipper_tpu_torch.solvers import msrc, msrc_flat
from clipper_tpu_torch.types import Params, Rounding, Solution, as_association

# candidate columns one kernel block takes (two mma n8 groups)
_KERNEL_ROWS = 16
# a work unit of the int8 / bf16 kernels: R row blocks (their f64 sums live
# in registers; csrc/sym_tile_mma.cuh's kUnitRows) by S column blocks
_UNIT_ROWS = 8
_UNIT_COLS = 32
# the unit kernel's tile (csrc/sym_tile_mma.cuh's kT): a stored tile of any
# multiple of it is walked as its _UNIT_T-row tiles, and at any other
# multiple of 16 the kernel's entries are _UNIT_T-row super-tiles of the
# matrix made of the storage's _SUB_TILES-row tiles (unit_tile)
_UNIT_T = 128
_SUB_TILES = (64, 32, 16)
# the CUDA-core route's unit (csrc/sym_core.cuh, core_shape): about
# _CORE_ROWS rows of row blocks by _CORE_COLS of column blocks
_CORE_ROWS = 4096
_CORE_COLS = 4096
# a plan entry's meta bits (csrc/sym_tile_mma.cuh): the unit row in bits
# 0-3, then these flags, the column's slot in the kernel's ring of
# _COL_RING blocks of u (bits 8-11), and its sum's workspace slot
_META_TRANSPOSED = 1 << 4
_META_COL_START = 1 << 5
_META_COL_END = 1 << 6
_META_COL_WRITE = 1 << 7
_META_RING_SHIFT = 8
_META_SLOT_SHIFT = 12
_COL_RING = 8


def tile_coords(nt: int) -> Tuple[np.ndarray, np.ndarray]:
    """(rows, cols) block coordinates of the upper triangle: the nt
    diagonal tiles first, then the strictly-upper tiles row-major."""
    diag = np.arange(nt)
    ur, uc = np.triu_indices(nt, 1)
    return (np.concatenate([diag, ur]).astype(np.int32),
            np.concatenate([diag, uc]).astype(np.int32))


@functools.lru_cache(maxsize=4)
def _canonical_coords(nt: int) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`tile_coords`, made once an nt: the wrappers' default
    coordinates, whose check a call skips."""
    return tile_coords(nt)


def shard_tile_coords(nt: int, D: int) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`tile_coords` padded to a multiple of D with the inert
    coordinate (nt, nt), so the list splits into D equal contiguous
    slices. An inert slot's rows and columns are >= m_pad: the build's
    validity mask zeroes its tile and the matvec skips it."""
    rows, cols = tile_coords(nt)
    pad = -len(rows) % D
    if pad:
        rows = np.concatenate([rows, np.full(pad, nt, np.int32)])
        cols = np.concatenate([cols, np.full(pad, nt, np.int32)])
    return rows, cols


def _tile_scores(invariant: PairwiseInvariant, P1, P2, A, gr, gc, m_true,
                 affinityeps: float):
    """Masked full-precision scores between the row ids gr (b, tr) and the
    column ids gc (b, tc) of padded endpoints P1/P2 (n, d) and A (n, 2):
    the (b, tr, tc) score tiles and their keep masks (reference:
    src/clipper.cpp:35-55). Shared by the builds and the exact objective,
    so all of them see the same score values."""
    scores = invariant.score_block(P1[gr], P1[gc], P2[gr], P2[gc])
    Ar, Ac = A[gr], A[gc]
    distinct = ~((Ar[..., :, 0, None] == Ac[..., None, :, 0])
                 | (Ar[..., :, 1, None] == Ac[..., None, :, 1]))
    gr_, gc_ = gr[..., :, None], gc[..., None, :]
    keep = (distinct & (gr_ != gc_) & (gr_ < m_true) & (gc_ < m_true)
            & (scores > affinityeps))
    return scores, keep


def _extend(P1, P2, A, n: int):
    """The endpoints and associations padded to n rows (endpoints 0,
    associations -1), so that the gathers of inert and pad tiles stay in
    bounds; their rows are >= m_true and the keep mask drops them."""
    def ext(X, fill):
        out = torch.full((n,) + tuple(X.shape[1:]), fill, dtype=X.dtype,
                         device=X.device)
        out[:X.shape[0]] = X
        return out
    return ext(P1, 0), ext(P2, 0), ext(A, -1)


def _quantize(scores, keep, storage_dtype):
    """(M, C) tiles in the storage dtype: int8 codes
    clip(round_half_even(127 s), 0, 127) and C = 127, or the raw values."""
    if storage_dtype == torch.int8:
        Mq = torch.clamp(torch.round(torch.where(keep, scores, 0.0)
                                     * msrc_flat._INT8_SCALE), 0, 127)
        Cq = torch.where(keep, int(msrc_flat._INT8_SCALE), 0)
        return Mq.to(torch.int8), Cq.to(torch.int8)
    return (torch.where(keep, scores, 0.0).to(storage_dtype),
            keep.to(storage_dtype))


def _identity_term(u: torch.Tensor, nt: int, t: int) -> torch.Tensor:
    """u'u on the f32 blocks, not u's working dtype."""
    Ub = u.to(torch.float32).reshape(nt, t)
    return (Ub * Ub).sum()


def exact_objective(invariant: PairwiseInvariant, P1, P2, A, u, m_true,
                    tile: int = 128, affinityeps: float = 1e-4,
                    chunk: int = 256, rows=None, cols=None,
                    partial: bool = False) -> torch.Tensor:
    """F = u'(M + I)u in f32, rebuilt exactly ``chunk`` tiles at a time:
    the polish when u's support is wider than the top-k window. O(chunk
    t^2) transient memory. Elementwise products and sums, no matmul, so
    the result does not depend on torch.backends.cuda.matmul.allow_tf32.

    rows/cols: explicit tile coordinates (default :func:`tile_coords`), as
    a rank of the sharded engine sums only its slice; inert (nt, nt) slots
    add 0. partial=True returns that sum without the identity term, for
    the caller to reduce across ranks and add u'u once."""
    m_pad = P1.shape[0]
    t = int(tile)
    nt = m_pad // t
    if rows is None:
        rows, cols = tile_coords(nt)
    P1e, P2e, Ae = _extend(P1, P2, A, (nt + 1) * t)
    rows = torch.as_tensor(np.asarray(rows), device=u.device).long()
    cols = torch.as_tensor(np.asarray(cols), device=u.device).long()
    Ub = torch.zeros(nt + 1, t, dtype=torch.float32, device=u.device)
    Ub[:nt] = u.to(torch.float32).reshape(nt, t)
    ar = torch.arange(t, device=u.device)
    F = torch.zeros((), dtype=torch.float32, device=u.device)
    for s in range(0, len(rows), chunk):
        r, c = rows[s:s + chunk], cols[s:s + chunk]
        scores, keep = _tile_scores(invariant, P1e, P2e, Ae,
                                    r[:, None] * t + ar, c[:, None] * t + ar,
                                    m_true, affinityeps)
        Mt = torch.where(keep, scores, 0.0).to(torch.float32)
        q = (Ub[r] * (Mt * Ub[c][:, None, :]).sum(-1)).sum(-1)
        # an off-diagonal tile stands for itself and its transpose
        F = F + torch.where(r == c, q, 2.0 * q).sum()
    return F if partial else F + _identity_term(u, nt, t)


# ----------------------------------------------------------------------
# the int8 / bf16 kernels' plan: units of the stored triangle
# ----------------------------------------------------------------------

class UnitPlan(NamedTuple):
    """The walk of the int8 / bf16 kernels over one storage (or a rank's
    slice of it), built on the host by :func:`unit_plan`; int32 arrays.

    entries (E, 4): one stored tile each, (x, y, c, meta): its element
    column and row in the storage's 2-D view (the row of its M half), its
    column block c, and meta: the unit row i = r - r0 (bits 0-3),
    _META_TRANSPOSED when r != c, _META_COL_START / _META_COL_END at the
    column's first / last tile in its unit, _META_COL_WRITE where the
    column's transposed sum is written, into slot meta >> _META_SLOT_SHIFT,
    and the column's ordinal in its unit modulo _COL_RING (its block of u's
    slot in the kernel's ring) in bits _META_RING_SHIFT on.
    units (U, 4): (e0, e1, r0, 0), a unit's entries [e0, e1) and its first
    row block r0, the largest unit first (the launch order).
    fslots (U, _UNIT_ROWS): the slot of each unit row's forward sum, -1
    for a row with no tile in the unit.
    red_off (nt + 1,), red_slots (n_slots,): output block j is the sum of
    slots red_slots[red_off[j]:red_off[j + 1]], in that order.
    slot_block (n_slots,): the output block each slot adds to."""
    entries: np.ndarray
    units: np.ndarray
    fslots: np.ndarray
    red_off: np.ndarray
    red_slots: np.ndarray
    slot_block: np.ndarray
    # the sub-tiled walk (:func:`super_plan`): each entry a super-tile of
    # _UNIT_T rows whose x indexes subs, (E P^2, 2) int32 (x, y) of its P x P
    # sub-tiles of ``sub`` rows (P = _UNIT_T // sub), row-major; sub =
    # _UNIT_T and no subs otherwise
    subs: np.ndarray = np.zeros((0, 2), np.int32)
    sub: int = _UNIT_T

    @property
    def n_slots(self) -> int:
        return len(self.slot_block)


def unit_plan(nt: int, r, c, x, y, R: Optional[int] = None,
              S: Optional[int] = None, tr=None) -> UnitPlan:
    """The plan over the stored tiles (r[k], c[k]), c >= r, which sit at
    (x[k], y[k]) in the storage's 2-D view. Unit (b, s) holds the tiles
    with r // R == b and c // S == s (R = _UNIT_ROWS, S = _UNIT_COLS by
    default), walked column by column (c outer, r inner). It writes one
    forward partial for each of its rows and one transposed partial for
    each of its columns with a tile applied transposed (tr: per tile,
    default r != c); each output block sums its partials in slot order."""
    R = _UNIT_ROWS if R is None else R
    S = _UNIT_COLS if S is None else S
    r, c, x, y = (np.asarray(a, np.int64).ravel() for a in (r, c, x, y))
    tr = r != c if tr is None else np.asarray(tr, bool).ravel()
    if len(y) and y.max() >= (1 << 31) - 256:
        raise ValueError("the storage's 2-D view has more rows than the "
                         "kernel's int32 copy coordinates reach")
    key = (r // R) * (-(-nt // S)) + c // S
    order = np.lexsort((r, c, key))
    r, c, x, y, key, tr = (a[order] for a in (r, c, x, y, key, tr))
    n = len(r)
    i = r % R
    # column runs: the entries of one unit and column
    start = np.ones(n, bool)
    start[1:] = (key[1:] != key[:-1]) | (c[1:] != c[:-1])
    end = np.ones(n, bool)
    end[:-1] = start[1:]
    run = np.cumsum(start) - 1
    unit_start = np.ones(n, bool)
    unit_start[1:] = key[1:] != key[:-1]
    first_run = np.maximum.accumulate(np.where(unit_start, run, 0))
    run_tr = np.bincount(run, weights=tr,
                         minlength=run[-1] + 1 if n else 0) > 0
    # slots: a unit's rows (forward sums), then its columns' transposed sums
    fkey = key * R + i
    funiq, ffirst = np.unique(fkey, return_index=True)
    n_f = len(funiq)
    col_runs = np.flatnonzero(run_tr)
    run_slot = np.full(len(run_tr), -1, np.int64)
    run_slot[col_runs] = n_f + np.arange(len(col_runs))
    slot_block = np.concatenate([r[ffirst], c[start][col_runs]])
    n_slots = len(slot_block)
    if n_slots >= 1 << (31 - _META_SLOT_SHIFT):
        raise ValueError(f"{n_slots} partial slots: the plan's meta holds "
                         f"fewer than {1 << (31 - _META_SLOT_SHIFT)}")
    write = end & run_tr[run]
    meta = (i | tr * _META_TRANSPOSED | start * _META_COL_START
            | end * _META_COL_END
            | (run - first_run) % _COL_RING << _META_RING_SHIFT
            | write * (_META_COL_WRITE
                       | np.maximum(run_slot[run], 0) << _META_SLOT_SHIFT))
    entries = np.stack([x, y, c, meta], 1)
    ukeys, ustart, ucount = np.unique(key, return_index=True,
                                      return_counts=True)
    fslots = np.full((len(ukeys), R), -1, np.int64)
    fslots[np.searchsorted(ukeys, funiq // R), funiq % R] = np.arange(n_f)
    launch = np.lexsort((ukeys, -ucount))
    units = np.stack([ustart, ustart + ucount, (ukeys // (-(-nt // S))) * R,
                      np.zeros_like(ukeys)], 1)[launch]
    red = np.lexsort((np.arange(n_slots), slot_block))
    red_off = np.searchsorted(slot_block[red], np.arange(nt + 1))
    return UnitPlan(*(a.astype(np.int32) for a in (
        entries, units, fslots[launch], red_off, red, slot_block)))


def unit_tile(t: int) -> int:
    """The tile of a plan's grid over stored t-tiles: the largest of
    _UNIT_T and _SUB_TILES (128, 64, 32, 16) dividing t (the unit kernel's
    route, :func:`matvec_route`; below 128 the tiles of its super-tiles,
    :func:`super_plan`), else t (the CUDA-core route)."""
    for u in (_UNIT_T, *_SUB_TILES):
        if t % u == 0:
            return u
    return t


def core_shape(t: int) -> Tuple[int, int, int]:
    """(kg, R, S) of the CUDA-core route at tile t (csrc/sym_core.cuh):
    the candidates a block takes (symcore::core_group) and the unit's row
    and column blocks, sized by rows: R t about _CORE_ROWS / kg (the
    unit's f64 row sums in shared memory), S t about _CORE_COLS."""
    if t > 4096:
        raise ValueError(f"the CUDA-core route takes t <= 4096, not {t}")
    kg = (16 if t <= 256 else 8 if t <= 512 else 4 if t <= 1024
          else 2 if t <= 2048 else 1)
    R = min(8, max(1, _CORE_ROWS // (t * kg)))
    return kg, R, max(1, _CORE_COLS // t)


def unit_grid(r, c, x, y, t: int):
    """Stored t-tiles (r, c) at (x, y) in the storage's 2-D view as the
    tiles of the grid of :func:`unit_tile` (u = unit_tile(t), q = t / u):
    tile (r, c) is the q x q tiles (r q + a, c q + b) at (x + b u, y + a u),
    and a diagonal t-tile only its upper ones, a <= b (the kernel applies
    the a < b ones transposed too, which covers their mirrors). Returns
    the four arrays of the grid's tiles, in the order of (r, c), then
    (a, b)."""
    u = unit_tile(t)
    q = t // u
    r, c, x, y = (np.asarray(v, np.int64).ravel() for v in (r, c, x, y))
    if q == 1:
        return r, c, x, y
    a, b = (v.ravel() for v in np.meshgrid(np.arange(q), np.arange(q),
                                           indexing="ij"))
    keep = (r[:, None] != c[:, None]) | (a <= b)[None, :]
    return ((r[:, None] * q + a)[keep], (c[:, None] * q + b)[keep],
            (x[:, None] + b * u)[keep], (y[:, None] + a * u)[keep])


def super_plan(nt_g: int, r, c, x, y, g: int, view_rows: int) -> UnitPlan:
    """:func:`unit_plan` over the super-tiles of _UNIT_T rows that the
    g-row grid tiles (r, c) at (x, y) make (g in _SUB_TILES, P = _UNIT_T
    // g of them a side; nt_g of them a side of the matrix, which the
    last super-tile may overrun): super-tile (R, C) holds the tiles with
    r // P == R and c // P == C at sub-position (r % P, c % P), and every
    super-tile is applied transposed (a diagonal one its off-diagonal
    sub-tiles: the kernel leaves out its diagonal sub-tiles' rows). Its
    entries' x index the plan's subs; a sub-tile the storage does not
    hold points at row view_rows, past the view's last, whose copy is
    zeros."""
    P = _UNIT_T // g
    r, c, x, y = (np.asarray(v, np.int64).ravel() for v in (r, c, x, y))
    if view_rows + 2 * g >= (1 << 31) - 256:
        raise ValueError("the storage's 2-D view has more rows than the "
                         "kernel's int32 copy coordinates reach")
    nts = -(-nt_g // P)
    key = (r // P) * nts + c // P
    uniq, inv = np.unique(key, return_inverse=True)
    subs = np.zeros((len(uniq), P * P, 2), np.int64)
    subs[:, :, 1] = view_rows
    at = (r % P) * P + c % P
    subs[inv, at, 0] = x
    subs[inv, at, 1] = y
    n = len(uniq)
    plan = unit_plan(nts, uniq // nts, uniq % nts, np.arange(n),
                     np.zeros(n), tr=np.ones(n, bool))
    return plan._replace(subs=subs.reshape(-1, 2).astype(np.int32), sub=g)


def core_plan(nt: int, r, c, x, y, t: int) -> UnitPlan:
    """:func:`unit_plan` over the stored t-tiles themselves, in units of
    :func:`core_shape`'s R x S (the CUDA-core route, csrc/sym_core.cuh)."""
    _, R, S = core_shape(t)
    return unit_plan(nt, r, c, x, y, R, S)


def _grid_plan(nt: int, r, c, x, y, t: int, view_rows: int,
               kernel: str) -> UnitPlan:
    """The plan of ``kernel`` ("units" or "core") over the stored t-tiles
    (r, c) at (x, y): the unit kernel over the grid of :func:`unit_tile`
    (super-tiles below _UNIT_T), the CUDA-core kernel over the t-grid."""
    if kernel == "core":
        return core_plan(nt, r, c, x, y, t)
    g = unit_tile(t)
    grid = unit_grid(r, c, x, y, t)
    if g == _UNIT_T:
        return unit_plan(nt * t // g, *grid)
    return super_plan(nt * t // g, *grid, g, view_rows)


def plan_kernel(t: int, dtype=torch.int8) -> str:
    """The kernel whose plan storage of ``dtype`` at tile t walks: "units"
    on the "units" route, else "core" (the int8 / bf16 "core" route and
    the float kinds; :func:`matvec_route`)."""
    return "units" if matvec_route(t, dtype) == "units" else "core"


def tiles_plan(nt: int, rows, cols, t: int = 128,
               kernel: Optional[str] = None) -> UnitPlan:
    """The plan of ``kernel`` (default :func:`plan_kernel` of int8 at t)
    over tile-list storage (T, 2t, t) at coordinates (rows, cols), viewed
    as T 2t rows of t: tile k's M half starts at row 2t k
    (:func:`_grid_plan`). Inert slots (nt, nt) are in no unit. The plan
    depends on the layout alone: it is cached by it, so a warm solve
    reuses it."""
    return _tiles_plan(nt, np.asarray(rows, np.int32).tobytes(),
                       np.asarray(cols, np.int32).tobytes(), t,
                       kernel or plan_kernel(t), _UNIT_ROWS, _UNIT_COLS)


# R, S: the unit shape (_UNIT_ROWS, _UNIT_COLS) a cached plan was made
# with, a part of its key
@functools.lru_cache(maxsize=8)
def _tiles_plan(nt, rows, cols, t, kernel, R, S) -> UnitPlan:
    rows = np.frombuffer(rows, np.int32).astype(np.int64)
    cols = np.frombuffer(cols, np.int32).astype(np.int64)
    k = np.flatnonzero(rows < nt)
    return _grid_plan(nt, rows[k], cols[k], np.zeros_like(k), 2 * t * k, t,
                      2 * t * len(rows), kernel)


def rows_plan(nt: int, G: int, n: int, chunk_base: int = 0,
              t: int = 128, kernel: Optional[str] = None) -> UnitPlan:
    """The plan of ``kernel`` (as :func:`tiles_plan`) over the chunk slice
    [chunk_base, chunk_base + n) of row-chunked storage, viewed as n 2t
    rows of G t: tile (r, c) sits in chunk first(r) + (c - r) // G
    (:func:`row_first_chunk`) at column ((c - r) % G) t. Tiles outside
    the slice, pad tiles and pad chunks are in no unit. Cached by the
    layout, as :func:`tiles_plan` is."""
    return _rows_plan(nt, G, n, chunk_base, t, kernel or plan_kernel(t),
                      _UNIT_ROWS, _UNIT_COLS)


@functools.lru_cache(maxsize=8)
def _rows_plan(nt, G, n, chunk_base, t, kernel, R, S) -> UnitPlan:
    r, c = np.triu_indices(nt)
    k = row_first_chunk(nt, G)[r] + (c - r) // G
    keep = (k >= chunk_base) & (k < chunk_base + n)
    r, c, k = r[keep], c[keep], k[keep]
    return _grid_plan(nt, r, c, (c - r) % G * t, (k - chunk_base) * 2 * t,
                      t, 2 * t * n, kernel)


class DevicePlan:
    """A :class:`UnitPlan` on the card, with the kernel's workspace of f64
    partials: allocated with torch.empty at the first call that needs it
    and kept for the next (a closure's plan caches it). t: the positions of
    a partial (_UNIT_T for the unit kernel, the tile on the CUDA-core
    route); group: the candidates a block takes (16, or core_shape's)."""

    def __init__(self, plan: UnitPlan, t: int, device, group: int = 16):
        self.plan = plan
        self.t = t
        self.group = group
        self.arrays = [torch.as_tensor(a, device=device) for a in (
            plan.entries, plan.units, plan.fslots, plan.red_off,
            plan.red_slots, plan.subs)]
        self._ws = None

    def workspace(self, K: int) -> torch.Tensor:
        """The partials of K candidates: ceil(K / group) groups of n_slots
        x 2 halves x min(K, group) x t doubles."""
        n = (-(-K // self.group) * self.plan.n_slots * 2
             * min(K, self.group) * self.t)
        if self._ws is None or self._ws.numel() < max(n, 1):
            self._ws = None
            self._ws = torch.empty(max(n, 1), dtype=torch.float64,
                                   device=self.arrays[0].device)
        return self._ws

    def args(self) -> tuple:
        """The unit kernel's plan arguments: entries, units, fslots, the
        unit count, red_off, red_slots, the slot count."""
        e, u, f, ro, rs = (a.data_ptr() for a in self.arrays[:5])
        return (e, u, f, len(self.plan.units), ro, rs, self.plan.n_slots)

    def sub_args(self) -> tuple:
        """The sub-tiled unit kernel's: args(), then subs and the sub-tile."""
        return (*self.args(), self.arrays[5].data_ptr(), self.plan.sub)

    def core_args(self) -> tuple:
        """The CUDA-core kernel's: entries, units, fslots, the unit count,
        the unit's rows R (fslots' width), red_off, red_slots, the slot
        count."""
        e, u, f, ro, rs = (a.data_ptr() for a in self.arrays[:5])
        return (e, u, f, len(self.plan.units), self.plan.fslots.shape[1],
                ro, rs, self.plan.n_slots)



def _device_plan(plan: UnitPlan, t: int, kernel: str, device) -> DevicePlan:
    """A plan of ``kernel`` on the card, with its workspace's shape."""
    if kernel == "units":
        return DevicePlan(plan, _UNIT_T, device)
    return DevicePlan(plan, t, device, core_shape(t)[0])


# ----------------------------------------------------------------------
# the tile list
# ----------------------------------------------------------------------

def build_symtiles(invariant: PairwiseInvariant, P1, P2, A, m_true,
                   tile: int = 128, affinityeps: float = 1e-4,
                   storage_dtype=torch.int8,
                   build_chunk: int = 256) -> torch.Tensor:
    """(T, 2t, t) upper-triangle tile list, built ``build_chunk`` tiles per
    step straight into the storage dtype (int8, bf16, f32 or f64; see
    :func:`_quantize`). No f32 (m, m) is ever made.

    P1/P2 (m_pad, d) gathered endpoints and A (m_pad, 2) associations,
    padded to a multiple of the tile (pad endpoints 0, pad associations
    -1); rows and columns >= m_true are inert. Requires a symmetric
    invariant: the matrix it stands for is tile(r, c) + tile(c, r)'.
    Reference semantics: masks from src/clipper.cpp:35-55, C = pattern(M)
    from src/clipper.cpp:63-64.
    """
    m_pad = P1.shape[0]
    t = int(tile)
    if m_pad % t:
        raise ValueError(f"build_symtiles: m_pad={m_pad} is not a multiple "
                         f"of the tile {t}")
    rows, cols = tile_coords(m_pad // t)
    return _build_tiles_at(invariant, P1, P2, A, rows, cols, m_true, t,
                           affinityeps, storage_dtype, build_chunk)


def _build_tiles_at(invariant, P1, P2, A, rows, cols, m_true, t,
                    affinityeps, storage_dtype, build_chunk):
    """The stacked tiles at explicit (rows, cols) block coordinates: the
    core of the whole-list build and of a sharded rank's slice. Inert
    (nt, nt) coordinates give zero tiles through the validity mask."""
    nt = P1.shape[0] // t
    dev = P1.device
    P1e, P2e, Ae = _extend(P1, P2, A, (nt + 1) * t)
    rows = torch.as_tensor(np.asarray(rows), device=dev).long()
    cols = torch.as_tensor(np.asarray(cols), device=dev).long()
    ar = torch.arange(t, device=dev)
    buf = torch.empty(len(rows), 2 * t, t, dtype=storage_dtype, device=dev)
    for s in range(0, len(rows), build_chunk):
        scores, keep = _tile_scores(
            invariant, P1e, P2e, Ae, rows[s:s + build_chunk, None] * t + ar,
            cols[s:s + build_chunk, None] * t + ar, m_true, affinityeps)
        buf[s:s + build_chunk, :t], buf[s:s + build_chunk, t:] = _quantize(
            scores, keep, storage_dtype)
    return buf


def _tiles_layout(tiles: torch.Tensor, nt: int, rows, cols):
    """(t, rows, cols) of (T, 2t, t) storage, the coordinates defaulting to
    :func:`tile_coords` and checked against the storage."""
    T, two_t, t = tiles.shape
    canonical = rows is None
    if canonical:
        rows, cols = _canonical_coords(nt)
    rows = np.asarray(rows, np.int32)
    cols = np.asarray(cols, np.int32)
    if (two_t != 2 * t or len(rows) != T or len(cols) != T
            or (T and not canonical
                and (rows.max() > nt or cols.max() > nt))):
        raise ValueError(f"storage {tuple(tiles.shape)} is not a tile list "
                         f"of nt={nt} at the given coordinates")
    return t, rows, cols


def _scale(storage_dtype) -> float:
    """The output scale: int8 codes are scaled by 1/127 at the end."""
    return 1.0 / msrc_flat._INT8_SCALE if storage_dtype == torch.int8 else 1.0


def _operand(storage_dtype, U: torch.Tensor):
    """(U in the storage's contraction dtype, the output scale): int8 codes
    meet bf16-rounded u."""
    if storage_dtype == torch.int8:
        return U.to(torch.bfloat16), _scale(storage_dtype)
    if storage_dtype in (torch.bfloat16, torch.float32, torch.float64):
        return U.to(storage_dtype), _scale(storage_dtype)
    raise NotImplementedError(f"symmetric-triangle matvec: storage "
                              f"{storage_dtype}")


def _finish(acc: torch.Tensor, scale: float) -> torch.Tensor:
    """The f64 sums rounded once to f32, then scaled in f32: the kernels'
    own last step."""
    s = torch.tensor(scale, dtype=torch.float32, device=acc.device)
    return acc.to(torch.float32) * s


def matvec_route(t: int, dtype) -> str:
    """The route by which the capacity kernels (csrc/sym_rows_matvec.cu,
    csrc/sym_tiles_matvec.cu) take storage of ``dtype`` at tile t, by t
    alone: ``"units"`` for int8 / bf16 at t a multiple of 16 (the
    tensor-core unit kernel over the plan's 128-grid: the storage's own
    128-row tiles where 128 divides t, else super-tiles of its 64-, 32- or
    16-row tiles, :func:`unit_tile`; its reduction beside it);
    ``"core"`` for int8 / bf16 at every other t (the CUDA-core kernel of
    csrc/sym_core.cuh on the codes, counted under ``<kernel>_core``);
    ``"float"`` for f32 / f64 at every t (that kernel in f64)."""
    if dtype in (torch.int8, torch.bfloat16):
        return "units" if t % _SUB_TILES[-1] == 0 else "core"
    return "float"


def _check_kernel_storage(what: str, item: int, dtype):
    if dtype not in (torch.int8, torch.bfloat16, torch.float32,
                     torch.float64):
        raise NotImplementedError(f"{what} kernel takes int8/bf16/f32/f64 "
                                  f"storage, not {dtype} (ROADMAP.md Queue "
                                  f"2 item {item})")


def _check_operand(U: torch.Tensor, m: int):
    if U.dim() != 2 or U.shape[1] != m:
        raise ValueError(f"U {tuple(U.shape)} is not (K, m) for m={m}")


def check_tiles_kernel(tiles: torch.Tensor, nt: int, U: torch.Tensor,
                       rows=None, cols=None):
    """The shape and storage check of :func:`sym_tiles_matvec_cuda`,
    before any device check: (T, 2t, t) int8 / bf16 / f32 / f64 tile-list
    storage at any t >= 1 and U (K, m). Returns (route, t, rows, cols),
    the route of :func:`matvec_route`."""
    t, rows, cols = _tiles_layout(tiles, nt, rows, cols)
    _check_kernel_storage("tile-list matvec", 7, tiles.dtype)
    _check_operand(U, nt * t)
    return matvec_route(t, tiles.dtype), t, rows, cols


def check_rows_kernel(chunks: torch.Tensor, nt: int, U: torch.Tensor,
                      chunk_base: Optional[int] = None):
    """The shape and storage check of :func:`sym_rows_matvec_cuda`,
    before any device check: (n, 2t, G t) int8 / bf16 / f32 / f64
    row-chunked storage (or a chunk slice) at any t >= 1 and U (K, m).
    Returns (route, t, G), the route of :func:`matvec_route`."""
    t, G, _ = _layout(chunks, nt, chunk_base)
    _check_kernel_storage("rows matvec", 3, chunks.dtype)
    _check_operand(U, nt * t)
    return matvec_route(t, chunks.dtype), t, G


def _count_route(name: str, route: str, plan) -> None:
    """Count one C call's launches by its route (the wrapper picks the C
    entry by it): the first pass under ``_kernels.route_key`` ("units"
    and "float" under ``name``, "core" under ``<name>_core``; not launched
    when the plan has no unit), and the fixed-order reduction under its
    own key."""
    if len(plan.plan.units):
        _kernels.LAUNCHES[_kernels.route_key(name, route)] += 1
    _kernels.LAUNCHES[_kernels.REDUCTIONS[name]] += 1


def sym_tiles_matvec_plain(tiles: torch.Tensor, nt: int, U: torch.Tensor,
                           rows=None, cols=None, raw: bool = False,
                           chunk: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of the tile-list matvec: U (K, m) -> the
    scaled f32 (K, 2m) [M U'; C U']', or with raw=True the unscaled f64
    sums (for a sum across ranks before the one rounding). ``chunk`` tiles
    at a time: each tile applied forward into its row block and, off the
    diagonal, transposed into its column block; inert slots add nothing.

    int8 storage contracts the codes with bf16-rounded u and scales by
    1/127 at the end; every storage type gives an f32 result. The products
    are summed in f64 (exact for int8, bf16 and f32 storage) and rounded
    once, as the CUDA kernel does; the JAX tile matvec sums in an f32
    accumulator (ROADMAP.md Queue 3)."""
    t, rows, cols = _tiles_layout(tiles, nt, rows, cols)
    K = U.shape[0]
    dev = tiles.device
    f64 = torch.float64
    Uc, scale = _operand(tiles.dtype, U)
    Ub = torch.zeros(nt + 1, t, K, dtype=f64, device=dev)   # block nt: inert
    Ub[:nt] = Uc.to(f64).T.reshape(nt, t, K)
    acc = torch.zeros(nt + 1, 2 * t, K, dtype=f64, device=dev)
    r_all = torch.as_tensor(rows, device=dev).long()
    c_all = torch.as_tensor(cols, device=dev).long()
    for s in range(0, len(rows), chunk):
        tl = tiles[s:s + chunk].to(f64)
        r, c = r_all[s:s + chunk], c_all[s:s + chunk]
        acc.index_add_(0, r, tl @ Ub[c])
        off = r != c
        Q = (tl[off].view(-1, 2, t, t).transpose(-1, -2)
             @ Ub[r[off]][:, None])                           # (n, 2, t, K)
        acc.index_add_(0, c[off], Q.reshape(-1, 2 * t, K))
    y = acc[:nt].view(nt, 2, t, K).permute(3, 1, 0, 2).reshape(K, 2 * nt * t)
    return y if raw else _finish(y, scale)


def tiles_device_plan(tiles: torch.Tensor, nt: int, rows=None, cols=None):
    """The walk of csrc/sym_tiles_matvec.cu over this tile list, on its
    device: a :class:`DevicePlan` of :func:`tiles_plan` for the kernel of
    its route (:func:`plan_kernel`)."""
    t, rows, cols = _tiles_layout(tiles, nt, rows, cols)
    kernel = plan_kernel(t, tiles.dtype)
    return _device_plan(tiles_plan(nt, rows, cols, t, kernel), t, kernel,
                        tiles.device)


def sym_tiles_matvec_cuda(tiles: torch.Tensor, nt: int, U: torch.Tensor,
                          rows=None, cols=None, raw: bool = False,
                          plan=None) -> torch.Tensor:
    """Launch csrc/sym_tiles_matvec.cu: U (K, m) on the card -> (K, 2m),
    f32 scaled or (raw=True) the f64 sums, from one C call, by the route
    of :func:`matvec_route` (every t >= 1): the unit kernel ("units",
    each stored tile read once per 16 columns of U) or the CUDA-core
    kernel ("core", "float"; each tile read once per core_shape's group
    of columns), then the fixed-order reduction, two launches. plan:
    :func:`tiles_device_plan` of this storage (made here when not
    given)."""
    route, t, rows, cols = check_tiles_kernel(tiles, nt, U, rows, cols)
    m = nt * t
    K = U.shape[0]
    if not (tiles.is_cuda and U.is_cuda and tiles.is_contiguous()):
        raise ValueError("tile-list matvec kernel: storage and U must lie on "
                         "the card, the storage contiguous")
    if plan is None:
        plan = tiles_device_plan(tiles, nt, rows, cols)
    lib = _kernels.lib("sym_tiles_matvec")
    Uc, scale = _operand(tiles.dtype, U)
    Uc = Uc.contiguous()
    out = torch.empty(K, 2 * m, dtype=torch.float64 if raw else torch.float32,
                      device=tiles.device)
    code = _launch(lib, "sym_tiles_matvec", route, tiles, t, t, plan, Uc,
                   out, plan.workspace(K), K, nt, raw, scale)
    _kernels.check(code, "sym_tiles_matvec")
    _count_route("sym_tiles_matvec", route, plan)
    return out


def _launch(lib, name: str, route: str, store: torch.Tensor, t: int,
            ld: int, plan: DevicePlan, Uc, out, ws, K: int, nt: int,
            raw: bool, scale: float) -> int:
    """One C call of ``name`` by ``route`` over ``store`` viewed as rows of
    ld elements: the unit kernel (its own 128-row tiles, or super-tiles of
    the plan's subs) or the CUDA-core kernel, each with its reduction.
    Returns the call's code."""
    stream = _kernels.stream_ptr(store.device)
    kind = {torch.int8: "int8", torch.bfloat16: "bf16", torch.float32: "f32",
            torch.float64: "f64"}[store.dtype]
    tail = (Uc.data_ptr(), out.data_ptr(), ws.data_ptr(), K, nt, t,
            int(raw))
    if route == "units":
        view = (store.data_ptr(), store.numel() // ld, ld)
        if plan.plan.sub == _UNIT_T:
            fn, args = f"{name}_{kind}", (*view, *plan.args(), *tail)
        else:
            fn, args = f"{name}_sub_{kind}", (*view, *plan.sub_args(), *tail)
    else:
        fn = f"{name}_core_{kind}"
        args = (store.data_ptr(), ld, *plan.core_args(), *tail)
    if kind == "int8":
        args = (*args, scale)
    return getattr(lib, fn)(*args, stream)


def _dual_matvec(fn, m: int, out_dtype, scale: float, group):
    """u -> (M u, C u) from fn(U (K, m), raw) -> (K, 2m). With a process
    group, each rank's f64 sums are all-reduced before the one rounding, so
    D ranks give the single-rank f32 result."""
    def mv(u):
        vec = u.dim() == 1
        U = u[:, None] if vec else u
        if group is None:
            y = fn(U.T, False)
        else:
            acc = fn(U.T, True)
            dist.all_reduce(acc, group=group)
            y = _finish(acc, scale)
        y = y.to(out_dtype)
        Mu, Cu = y[:, :m].T, y[:, m:].T
        return (Mu[:, 0], Cu[:, 0]) if vec else (Mu, Cu)

    return mv


def make_sym_dual_matvec(tiles: torch.Tensor, nt: int, out_dtype, rows=None,
                         cols=None, group=None):
    """u -> (M u, C u) over (T, 2t, t) tile-list storage: the counterpart
    of the JAX package's make_sym_dual_matvec (XLA, explicit coordinates)
    and make_sym_dual_matvec_pallas (its one-read kernel). Its mv_chunk and
    tiles_block shaped only XLA's loop and the Mosaic grid.

    Takes (m,) vectors or (m, K) candidate columns and returns the same
    shape in out_dtype, with f32 results for every storage type. CUDA
    storage launches csrc/sym_tiles_matvec.cu (its plan built once, here,
    and its workspace kept with it), CPU storage takes the plain version.
    rows/cols: the storage's coordinates (default :func:`tile_coords`).
    group: the process group over whose ranks the tile list is split (see
    :func:`solve_sharded_sym`); u must be the same on every rank."""
    t, rows, cols = _tiles_layout(tiles, nt, rows, cols)
    if tiles.is_cuda:
        plan = tiles_device_plan(tiles, nt, rows, cols)

        def fn(U, raw):
            return sym_tiles_matvec_cuda(tiles, nt, U, rows, cols, raw, plan)
    else:
        def fn(U, raw):
            return sym_tiles_matvec_plain(tiles, nt, U, rows, cols, raw)
    return _dual_matvec(fn, nt * t, out_dtype, _scale(tiles.dtype), group)


# ----------------------------------------------------------------------
# the row-chunked layout
# ----------------------------------------------------------------------

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
    q = n // G; :func:`rows_plan` places every tile of the CUDA kernel's
    walk by it."""
    def S(n):
        q = n // G
        return G * q * (q + 1) // 2 + (n - q * G) * (q + 1)

    return np.asarray([S(nt) - S(nt - r) for r in range(nt + 1)], np.int64)


def build_symchunks(invariant: PairwiseInvariant, P1, P2, A, m_true,
                    tile: int = 128, G: int = 32, affinityeps: float = 1e-4,
                    storage_dtype=torch.int8, build_chunk: int = 8,
                    chunk_coords=None) -> torch.Tensor:
    """(NC, 2t, G t) row-chunked triangle storage, built ``build_chunk``
    chunks per step straight into the storage dtype, with the same scores
    and codes as :func:`build_symtiles`. No f32 (m, m) is ever made.

    P1/P2 and A as for :func:`build_symtiles`. chunk_coords: explicit
    (chunk_r, chunk_c0) descriptors, as a sharded rank builds only its
    slice of the chunk list (inert (nt, nt) descriptors give zero chunks);
    default the whole list of :func:`row_chunk_coords`.
    """
    m_pad = P1.shape[0]
    t = int(tile)
    if m_pad % t:
        raise ValueError(f"build_symchunks: m_pad={m_pad} is not a multiple "
                         f"of the tile {t}")
    nt = m_pad // t
    if chunk_coords is None:
        chunk_coords = row_chunk_coords(nt, G)[:2]
    dev = P1.device
    # pad tiles' columns run up to (nt + G) t: extend the endpoints so their
    # gathers stay in bounds (m_true masks them)
    P1e, P2e, Ae = _extend(P1, P2, A, (nt + G) * t)
    crs, cc0s = (torch.as_tensor(np.asarray(x), device=dev).long()
                 for x in chunk_coords)
    ar_t = torch.arange(t, device=dev)
    ar_g = torch.arange(G * t, device=dev)
    buf = torch.empty(len(crs), 2 * t, G * t, dtype=storage_dtype, device=dev)
    for s in range(0, len(crs), build_chunk):
        scores, keep = _tile_scores(
            invariant, P1e, P2e, Ae, crs[s:s + build_chunk, None] * t + ar_t,
            cc0s[s:s + build_chunk, None] * t + ar_g, m_true, affinityeps)
        buf[s:s + build_chunk, :t], buf[s:s + build_chunk, t:] = _quantize(
            scores, keep, storage_dtype)
    return buf


def _layout(chunks: torch.Tensor, nt: int, chunk_base: Optional[int] = None):
    """(t, G, first) of (n, 2t, G t) storage: the whole list of nt
    (chunk_base None), or the slice of it from chunk chunk_base on."""
    NC, two_t, Gt = chunks.shape
    t = two_t // 2
    G = Gt // t
    first = row_first_chunk(nt, G)
    whole = chunk_base is None and NC == first[-1]
    part = chunk_base is not None and 0 <= chunk_base <= first[-1]
    if Gt != G * t or two_t != 2 * t or not (whole or part):
        raise ValueError(f"storage {tuple(chunks.shape)} is not the "
                         f"row-chunked layout of nt={nt}")
    return t, G, first


def sym_rows_matvec_plain(chunks: torch.Tensor, nt: int, U: torch.Tensor,
                          chunk_base: Optional[int] = None,
                          raw: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the rows matvec: U (K, m) -> the scaled f32
    (K, 2m) [M U'; C U']', or with raw=True the unscaled f64 sums. One row
    block at a time: its chunks are one contiguous (2t, n G t) segment,
    applied forward (into row block r) and transposed (into the blocks
    after r; the diagonal tile is complete in the forward product).

    chunk_base: the storage is the slice [chunk_base, chunk_base + n) of
    the canonical list (pad chunks past NC are skipped), and the result is
    that slice's share.

    As in the JAX kernel, int8 storage contracts int8 codes with
    bf16-rounded u and scales by 1/127 at the end, and every storage type
    gives an f32 result, f64 included. Unlike the JAX kernel, which sums
    in an f32 accumulator, the sums are taken in f64, where the products
    are exact, and rounded once to f32: at m = 65,536 an output sums 512
    tiles, and the CUDA kernel's f32 sums once sat 8.5e-3 from this
    version on outputs near 70, where 1e-4 is about 10 ulps. The kernel
    sums the same way, so the two agree to about an ulp; against the JAX
    kernel both differ by its f32 accumulation error."""
    t, G, first = _layout(chunks, nt, chunk_base)
    base = chunk_base or 0
    m = nt * t
    K = U.shape[0]
    f64 = torch.float64
    Uc, scale = _operand(chunks.dtype, U)
    m_ext = (nt + G) * t
    Ue = torch.zeros(K, m_ext, dtype=f64, device=chunks.device)
    Ue[:, :m] = Uc
    acc = torch.zeros(K, 2, m_ext, dtype=f64, device=chunks.device)
    for r in range(nt):
        a = max(int(first[r]), base)
        b = min(int(first[r + 1]), base + chunks.shape[0])
        if a >= b:
            continue
        w = (b - a) * G * t
        c0 = (r + (a - int(first[r])) * G) * t     # the segment's 1st column
        seg = chunks[a - base:b - base].permute(1, 0, 2).reshape(2 * t, w)
        seg = seg.to(f64)
        P = Ue[:, c0:c0 + w] @ seg.T                          # (K, 2t)
        acc[:, 0, r * t:(r + 1) * t] += P[:, :t]
        acc[:, 1, r * t:(r + 1) * t] += P[:, t:]
        skip = t if c0 == r * t else 0
        if w > skip:
            u_r = Ue[:, r * t:(r + 1) * t]
            acc[:, 0, c0 + skip:c0 + w] += u_r @ seg[:t, skip:]
            acc[:, 1, c0 + skip:c0 + w] += u_r @ seg[t:, skip:]
    y = acc[:, :, :m].reshape(K, 2 * m)
    return y if raw else _finish(y, scale)


def rows_device_plan(chunks: torch.Tensor, nt: int,
                     chunk_base: Optional[int] = None):
    """The walk of csrc/sym_rows_matvec.cu over this storage (or chunk
    slice), on its device: a :class:`DevicePlan` of :func:`rows_plan` for
    the kernel of its route (:func:`plan_kernel`)."""
    t, G, _ = _layout(chunks, nt, chunk_base)
    kernel = plan_kernel(t, chunks.dtype)
    return _device_plan(rows_plan(nt, G, chunks.shape[0], chunk_base or 0, t,
                                  kernel), t, kernel, chunks.device)


def sym_rows_matvec_cuda(chunks: torch.Tensor, nt: int, U: torch.Tensor,
                         chunk_base: Optional[int] = None,
                         raw: bool = False, plan=None) -> torch.Tensor:
    """Launch csrc/sym_rows_matvec.cu: U (K, m) on the card -> (K, 2m),
    f32 scaled or (raw=True) the f64 sums, K split into launches of at most
    16 columns (each reads the storage again), by the route of
    :func:`matvec_route` (every t >= 1); chunk_base as for
    :func:`sym_rows_matvec_plain`. plan: :func:`rows_device_plan` of this
    storage and slice (made here when not given)."""
    route, t, G = check_rows_kernel(chunks, nt, U, chunk_base)
    m = nt * t
    K = U.shape[0]
    if not (chunks.is_cuda and U.is_cuda and chunks.is_contiguous()):
        raise ValueError("rows matvec kernel: storage and U must lie on the "
                         "card, the storage contiguous")
    if plan is None:
        plan = rows_device_plan(chunks, nt, chunk_base)
    lib = _kernels.lib("sym_rows_matvec")
    Uc, scale = _operand(chunks.dtype, U)
    Uc = Uc.contiguous()
    out = torch.empty(K, 2 * m, dtype=torch.float64 if raw else torch.float32,
                      device=chunks.device)
    for k0 in range(0, K, _KERNEL_ROWS):
        k1 = min(K, k0 + _KERNEL_ROWS)
        code = _launch(lib, "sym_rows_matvec", route, chunks, t, G * t, plan,
                       Uc[k0:k1], out[k0:k1], plan.workspace(k1 - k0),
                       k1 - k0, nt, raw, scale)
        _kernels.check(code, "sym_rows_matvec")
        _count_route("sym_rows_matvec", route, plan)
    return out


def make_sym_dual_matvec_rows(chunks: torch.Tensor, nt: int, out_dtype,
                              chunk_base: Optional[int] = None, group=None):
    """u -> (M u, C u) over (NC, 2t, G t) row-chunked storage (the
    counterpart of the JAX package's make_sym_dual_matvec_pallas_rows).

    Takes (m,) vectors or (m, K) candidate columns and returns the same
    shape in out_dtype, with f32 results for every storage type. CUDA
    storage launches the kernel (its plan built once, here), CPU storage
    takes the plain version. chunk_base and group: a sharded rank's slice
    of the chunk list and the process group that sums the slices (see
    :func:`make_sym_dual_matvec`)."""
    t, _, _ = _layout(chunks, nt, chunk_base)
    if chunks.is_cuda:
        plan = rows_device_plan(chunks, nt, chunk_base)

        def fn(U, raw):
            return sym_rows_matvec_cuda(chunks, nt, U, chunk_base, raw, plan)
    else:
        def fn(U, raw):
            return sym_rows_matvec_plain(chunks, nt, U, chunk_base, raw)
    return _dual_matvec(fn, nt * t, out_dtype, _scale(chunks.dtype), group)


# ----------------------------------------------------------------------
# single-device solve
# ----------------------------------------------------------------------

def _gather_padded(D1, D2, A, u0, t: int):
    """(P1, P2, A, u0, m, nt): endpoints gathered on D1's device and padded
    to a multiple of the tile (pad endpoints 0, associations -1, u0 0)."""
    if not (isinstance(D1, torch.Tensor) and isinstance(D2, torch.Tensor)):
        raise TypeError("the capacity engines take D1/D2 as tensors: their "
                        "device is where they run (the Clipper facade moves "
                        "data)")
    dev = D1.device
    A = as_association(A, device=dev)
    m = A.shape[0]
    Al = A.long()
    P1, P2 = D1[Al[:, 0]], D2[Al[:, 1]]
    u0 = torch.as_tensor(u0, dtype=P1.dtype, device=dev)
    pad = -m % t
    if pad:
        P1 = torch.nn.functional.pad(P1, (0, 0, 0, pad))
        P2 = torch.nn.functional.pad(P2, (0, 0, 0, pad))
        u0 = torch.nn.functional.pad(u0, (0, pad))
        A = torch.nn.functional.pad(A, (0, 0, 0, pad), value=-1)
    return P1, P2, A, u0, m, (m + pad) // t


def _solve_flat(mv, u0, params: Params, probes: int, power_steps: int,
                d_scale: float, clock: StageClock):
    """Power-init, flat-init and the flat solve (multiprobe at probes > 1)
    of one problem through mv; returns the final state."""
    if power_steps:
        u0 = msrc_flat.power_init(mv, u0, power_steps)
    s = msrc_flat.flat_init(mv, u0, params)
    clock.mark("init")
    s = msrc_flat.flat_solve_state(mv, s, params, probes=probes,
                                   d_scale=d_scale)
    clock.mark("solve")
    return s


def _record(stats, s, store: torch.Tensor, layout: str, **extra):
    if stats is not None:
        stats.update(ticks=int(s.ticks), nback=int(s.nback),
                     storage_bytes=store.numel() * store.element_size(),
                     layout=layout, **extra)


def solve_single(invariant: PairwiseInvariant, D1, D2, A, u0,
                 params: Optional[Params] = None, *, tile: int = 128,
                 affinityeps: float = 1e-4, storage_dtype=torch.int8,
                 probes: int = 1, power_steps: int = 0, support: int = 512,
                 build_chunk: int = 256, matvec: str = "auto",
                 d_scale: float = 1.0,
                 stats: Optional[Dict[str, float]] = None,
                 wrap_matvec: Optional[Callable] = None):
    """One problem end to end over triangle storage: gather and pad to a
    multiple of the tile, build the storage, power-init and flat-init, the
    flat solve (multiprobe at probes > 1), the f32 polish on u's
    top-``support`` entries (the tile-chunked exact objective when the
    support is wider), and return (u, F, ifinal), u unpadded to m.

    matvec: the JAX package's values, each naming a layout.
    'pallas' is the row-chunked layout (G = min(32, nt) tiles a chunk,
    build_chunk // G chunks a build step) with csrc/sym_rows_matvec.cu on
    the card; 'xla' the tile list (build_chunk tiles a step) with
    csrc/sym_tiles_matvec.cu. 'auto' is the row-chunked layout on every
    device, the faster of the two kernels; the JAX package's 'auto' takes
    the tile list off the TPU, where its Pallas kernels would run
    interpreted.

    D1/D2 are (n, d) row-major tensors, A (m, 2), u0 (m,); everything runs
    on D1's device. stats: optional dict filled with the stage
    milliseconds (build, init, solve, polish; CUDA events on the card,
    host time on the CPU), the solve's probe ticks and rejected probes
    (ticks, nback), the storage bytes (storage_bytes) and the layout
    ('row-chunked' or 'tile-list'). wrap_matvec: optional mv -> mv'
    applied to the matvec before init and solve use it, to measure how the
    solve responds to perturbed matvecs.
    """
    if matvec not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown matvec {matvec!r}")
    params = params or Params()
    t = int(tile)
    P1, P2, A, u0, m, nt = _gather_padded(D1, D2, A, u0, t)
    clock = StageClock(P1.device, stats)

    clock.mark("start")
    if matvec == "xla":
        layout = "tile-list"
        store = build_symtiles(invariant, P1, P2, A, m, tile=t,
                               affinityeps=affinityeps,
                               storage_dtype=storage_dtype,
                               build_chunk=build_chunk)
        mv = make_sym_dual_matvec(store, nt, u0.dtype)
    else:
        layout = "row-chunked"
        G = min(32, nt)
        store = build_symchunks(invariant, P1, P2, A, m, tile=t, G=G,
                                affinityeps=affinityeps,
                                storage_dtype=storage_dtype,
                                build_chunk=max(1, build_chunk // G))
        mv = make_sym_dual_matvec_rows(store, nt, u0.dtype)
    clock.mark("build")
    if wrap_matvec is not None:
        mv = wrap_matvec(mv)
    s = _solve_flat(mv, u0, params, probes, power_steps, d_scale, clock)
    u = s.u
    # f32 polish (omega = round(F) needs F well within 0.5; the int8
    # in-loop F is biased). The top-k polish is exact only for supports
    # <= k; a wider support takes the tile-chunked exact rebuild.
    k = min(support, nt * t)
    if int((u > 0).sum()) > k:
        F = exact_objective(invariant, P1, P2, A, u, m, tile=t,
                            affinityeps=affinityeps,
                            chunk=build_chunk).to(u.dtype)
    else:
        F = support_objective(invariant, P1, P2, A, u,
                              affinityeps=affinityeps, k=k)
    clock.mark("polish")
    clock.finish()
    _record(stats, s, store, layout)
    return u[:m], F, s.i


# ----------------------------------------------------------------------
# the triangle-sharded engine: the list split over a process group
# ----------------------------------------------------------------------

def _mesh(mesh):
    """(group, D, rank) of a 1D mesh: a ProcessGroup, or None for the
    default group when one is initialized and else a single rank with no
    collective (group None)."""
    if mesh is None:
        if not (dist.is_available() and dist.is_initialized()):
            return None, 1, 0
        mesh = dist.group.WORLD
    return mesh, dist.get_world_size(mesh), dist.get_rank(mesh)


def _shard_coords(nt: int, D: int, rank: int, matvec: str, G: int):
    """This rank's contiguous slice of the padded coordinates: (rows, cols)
    of the tile list in 'xla' mode; in 'pallas' mode (chunk_base, chunk_r,
    chunk_c0, rows, cols) of the chunk list padded to a multiple of D with
    inert (nt, nt) chunks, rows/cols its flat per-tile coordinates."""
    if matvec == "xla":
        rows, cols = shard_tile_coords(nt, D)
        n = len(rows) // D
        return rows[rank * n:(rank + 1) * n], cols[rank * n:(rank + 1) * n]
    crs, cc0s, rows, cols = row_chunk_coords(nt, G)
    pad = -len(crs) % D
    if pad:
        crs, cc0s = (np.concatenate([x, np.full(pad, nt, np.int32)])
                     for x in (crs, cc0s))
        rows, cols = (np.concatenate([x, np.full(pad * G, nt, np.int32)])
                      for x in (rows, cols))
    n = len(crs) // D
    a, b = rank * n, (rank + 1) * n
    return a, crs[a:b], cc0s[a:b], rows[a * G:b * G], cols[a * G:b * G]


def build_symshard_pipeline(invariant: PairwiseInvariant, mesh=None,
                            params: Optional[Params] = None, *,
                            tile: int = 128, affinityeps: float = 1e-4,
                            storage_dtype=torch.int8, probes: int = 1,
                            power_steps: int = 0, support: int = 1024,
                            build_chunk: int = 64, matvec: str = "auto",
                            G: int = 32, d_scale: float = 1.0):
    """The triangle-sharded pipeline over a 1D mesh of D ranks.

    mesh: a ``torch.distributed`` ProcessGroup (D its size, the rank its
    position), or None for the default group when one is initialized and
    else one rank with no collective. Every rank holds the same padded
    problem (the JAX P() specs) and builds only its contiguous slice of
    the padded coordinates (~m^2 / D storage bytes). A tick's matvec is
    the rank's local matvec over its slice, then one all-reduce of its f64
    (K, 2m) sums before the f32 rounding: every rank gets bitwise the same
    result, equal to one rank's, and takes the same solver decisions.

    matvec: 'xla' splits the tile list (csrc/sym_tiles_matvec.cu on the
    card); 'pallas' the chunk list of the row-chunked layout with G tiles
    a chunk (csrc/sym_rows_matvec.cu over a chunk range); 'auto' is
    'pallas' on every device (see :func:`solve_single`).

    The polish branches on the replicated u: the exact branch sums each
    rank's slice (:func:`exact_objective` with partial=True) and
    all-reduces; the top-k branch computes the same support objective on
    every rank with no collective (the JAX body's Fs / D and psum only
    added rounding). Rounding.DSD is downgraded to NONZERO with a warning,
    as in the JAX package.

    Returns pipeline(P1, P2, A, u0, m_true, stats=None) -> (u, F, ifinal,
    mask) over padded arrays (m_pad a multiple of the tile); stats as for
    :func:`solve_single`, with the rank count (ranks) and this rank's
    storage bytes. Use :func:`solve_sharded_sym` for the end-to-end
    wrapper.
    """
    if matvec not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown matvec {matvec!r}")
    matvec = "pallas" if matvec == "auto" else matvec
    params = params or Params()
    group, D, rank = _mesh(mesh)
    t = int(tile)
    rounding = params.rounding
    if rounding == Rounding.DSD:
        warnings.warn(
            "solve_sharded_sym cannot run exact (host-side) DSD rounding "
            "in-graph; downgrading to Rounding.NONZERO", stacklevel=2)
        rounding = Rounding.NONZERO

    def pipeline(P1, P2, A, u0, m_true, stats=None):
        nt = P1.shape[0] // t
        clock = StageClock(P1.device, stats)
        clock.mark("start")
        coords = _shard_coords(nt, D, rank, matvec, G)
        if matvec == "pallas":
            base, crs, cc0s, rows, cols = coords
            store = build_symchunks(invariant, P1, P2, A, m_true, tile=t, G=G,
                                    affinityeps=affinityeps,
                                    storage_dtype=storage_dtype,
                                    build_chunk=max(1, build_chunk // G),
                                    chunk_coords=(crs, cc0s))
            mv = make_sym_dual_matvec_rows(store, nt, u0.dtype,
                                           chunk_base=base, group=group)
        else:
            rows, cols = coords
            store = _build_tiles_at(invariant, P1, P2, A, rows, cols, m_true,
                                    t, affinityeps, storage_dtype,
                                    build_chunk)
            mv = make_sym_dual_matvec(store, nt, u0.dtype, rows=rows,
                                      cols=cols, group=group)
        clock.mark("build")
        s = _solve_flat(mv, u0, params, probes, power_steps, d_scale, clock)
        u = s.u
        k = min(support, nt * t)
        if int((u > 0).sum()) <= k:
            F = support_objective(invariant, P1, P2, A, u,
                                  affinityeps=affinityeps, k=k)
        else:
            part = exact_objective(invariant, P1, P2, A, u, m_true, tile=t,
                                   affinityeps=affinityeps, chunk=build_chunk,
                                   rows=rows, cols=cols, partial=True)
            part = part.to(torch.float64)
            if group is not None:
                dist.all_reduce(part, group=group)
            F = (part.to(torch.float32)
                 + _identity_term(u, nt, t)).to(u.dtype)
        clock.mark("polish")
        clock.finish()
        _record(stats, s, store,
                "row-chunked" if matvec == "pallas" else "tile-list",
                ranks=D)
        return u, F, s.i, msrc.round_solution(u, F, rounding)

    return pipeline


def solve_sharded_sym(invariant: PairwiseInvariant, D1, D2, A, u0,
                      params: Optional[Params] = None, mesh=None, *,
                      tile: int = 128, affinityeps: float = 1e-4,
                      storage_dtype=torch.int8, probes: int = 1,
                      power_steps: int = 0, support: int = 1024,
                      build_chunk: int = 64, matvec: str = "auto",
                      G: int = 32, d_scale: float = 1.0,
                      stats: Optional[Dict[str, float]] = None) -> Solution:
    """One problem end to end through the triangle-sharded engine (see
    :func:`build_symshard_pipeline`). Every rank calls it with the same
    D1/D2 (n, d) tensors on its own device, A (m, 2) and u0 (m,), and gets
    the same Solution, mask and u unpadded to m."""
    t = int(tile)
    P1, P2, A, u0, m, _ = _gather_padded(D1, D2, A, u0, t)
    pipeline = build_symshard_pipeline(
        invariant, mesh, params, tile=t, affinityeps=affinityeps,
        storage_dtype=storage_dtype, probes=probes, power_steps=power_steps,
        support=support, build_chunk=build_chunk, matvec=matvec, G=G,
        d_scale=d_scale)
    u, F, ifinal, mask = pipeline(P1, P2, A, u0, m, stats=stats)
    return Solution(ifinal=ifinal, mask=mask[:m], u0=u0[:m], u=u[:m],
                    score=F)


__all__ = ["tile_coords", "shard_tile_coords", "exact_objective",
           "UnitPlan", "unit_plan", "tiles_plan", "rows_plan", "DevicePlan",
           "build_symtiles", "sym_tiles_matvec_plain",
           "tiles_device_plan", "sym_tiles_matvec_cuda",
           "make_sym_dual_matvec", "row_chunk_coords", "row_first_chunk",
           "build_symchunks", "sym_rows_matvec_plain", "rows_device_plan",
           "sym_rows_matvec_cuda", "make_sym_dual_matvec_rows",
           "solve_single", "build_symshard_pipeline", "solve_sharded_sym"]
