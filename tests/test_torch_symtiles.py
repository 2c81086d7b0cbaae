"""Port parity: the tile-list layout of the symmetric-triangle storage.

The same numpy inputs through clipper_tpu.ops.symstore and
clipper_tpu_torch.ops.symstore (CPU: the plain versions): the layout
helpers, build_symtiles, the tile-list dual matvec against the JAX
package's XLA tile matvec and its Pallas kernel (interpret mode), slices
of the list as the sharded engine splits it, the exact objective over a
slice, and solve_single(matvec="xla"). The scenes are
tests/test_symstore.py's and the bunny's, m <= 256 with t = 32.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import clipper_tpu as ct
from clipper_tpu.bench import harness as jharness
from clipper_tpu.ops import symstore as jsym
from clipper_tpu.solvers import msrc as jmsrc
from clipper_tpu_torch import interop
from clipper_tpu_torch.bench import harness
from clipper_tpu_torch.ops import symstore
from clipper_tpu_torch.solvers import msrc
from clipper_tpu_torch.types import Params, Rounding

from test_symstore import make_problem

JINV = jharness.default_invariant()
INV = harness.default_invariant()
STORAGE = {"int8": (jnp.int8, torch.int8, np.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, np.float32),
           "float32": (jnp.float32, torch.float32, np.float32),
           "float64": (jnp.float64, torch.float64, np.float64)}


def _scene(m, seed, dt=np.float32):
    """Gathered (P1, P2, A) of tests/test_symstore.py's scene."""
    D1, D2, A = make_problem(np.random.default_rng(seed), n=300,
                             n_inliers=60, m=m)
    A = np.asarray(A)
    return (np.asarray(D1)[A[:, 0]].astype(dt),
            np.asarray(D2)[A[:, 1]].astype(dt), A.astype(np.int32))


def _bunny(m, rho, seed, dt=np.float32):
    pcd0 = harness.load_bunny()
    pcd1, A, Agt = harness.make_problem(pcd0, m, rho,
                                        np.random.default_rng(seed))
    return (pcd0[A[:, 0]].astype(dt), pcd1[A[:, 1]].astype(dt),
            A.astype(np.int32), pcd0.astype(dt), pcd1.astype(dt), Agt)


def _jax_tiles(P1, P2, A, m, t, storage):
    return np.asarray(jsym.build_symtiles(
        JINV, jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(A), m, tile=t,
        storage_dtype=storage, build_chunk=3))


def _torch(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


@pytest.mark.parametrize("nt,D", [(4, 8), (5, 3)])
def test_shard_tile_coords_match_jax(nt, D):
    rows, cols = symstore.shard_tile_coords(nt, D)
    jrows, jcols = jsym.shard_tile_coords(nt, D)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(cols, jcols)
    assert len(rows) % D == 0 and rows.dtype == np.int32
    T = nt * (nt + 1) // 2
    assert (rows[T:] == nt).all() and (cols[T:] == nt).all()


@pytest.mark.parametrize("storage", ["int8", "float32", "float64"])
@pytest.mark.parametrize("m,t", [(96, 32), (256, 32)])
def test_build_symtiles_matches_jax(storage, m, t):
    """C exact; int8 M codes differ by at most one on at most 0.5% of the
    stored edges (a score a few ulps away moves a code by one where 127 s
    sits at a half); f32 and f64 scores within a few ulps of the distances,
    on the same support."""
    jst, tst, dt = STORAGE[storage]
    P1, P2, A = _scene(m, seed=m, dt=dt)
    ref = _jax_tiles(P1, P2, A, m, t, jst)
    got = symstore.build_symtiles(INV, *_torch(P1, P2, A), m, tile=t,
                                  storage_dtype=tst, build_chunk=5).numpy()
    nt = m // t
    assert got.shape == ref.shape == (nt * (nt + 1) // 2, 2 * t, t)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got[:, t:], ref[:, t:])
    n_edges = int((ref[:, t:] != 0).sum())
    assert n_edges > 0
    if storage == "int8":
        dM = np.abs(got[:, :t].astype(int) - ref[:, :t].astype(int))
        assert dM.max() <= 1 and (dM > 0).sum() <= 5e-3 * n_edges
    else:
        # PyTorch's vectorized CPU sqrt sits 1-2 ulps from the IEEE sqrt
        # that numpy and XLA take, and |l1 - l2| cancels most digits of
        # the two distances: scores move by up to 1.4e-5 (f32) and 1.6e-14
        # (f64) here (ROADMAP.md Queue 3)
        atol = 3e-5 if storage == "float32" else 1e-13
        np.testing.assert_allclose(got[:, :t], ref[:, :t], rtol=0, atol=atol)
        np.testing.assert_array_equal(got[:, :t] != 0, ref[:, :t] != 0)
    # the interop round trip carries the JAX tiles across unchanged
    back = interop.tiles_to_torch(ref)
    assert back.dtype == tst and back.is_contiguous()
    np.testing.assert_array_equal(interop.to_numpy(back), ref)
    with pytest.raises(ValueError):
        interop.tiles_to_torch(ref[0])


@pytest.mark.parametrize("storage", ["int8", "bfloat16", "float32",
                                     "float64"])
@pytest.mark.parametrize("K", [1, 4])
def test_tiles_matvec_plain_matches_jax(storage, K):
    """The plain tile-list matvec on the JAX package's own tiles against
    its XLA tile matvec and its one-read Pallas kernel (interpret mode),
    within 2e-5 (the bar of the rows tests): the same products, summed
    exactly here and in f32 there."""
    m, t = 256, 32
    nt = m // t
    jst, _, dt = STORAGE[storage]
    P1, P2, A, *_ = _bunny(m, 0.8, seed=3, dt=dt)
    tiles = _jax_tiles(P1, P2, A, m, t, jst)
    u = np.random.default_rng(K).random((m, K)).astype(dt)
    mv = symstore.make_sym_dual_matvec(interop.tiles_to_torch(tiles), nt,
                                       torch.from_numpy(u).dtype)
    jx = jsym.make_sym_dual_matvec(jnp.asarray(tiles), nt,
                                   jnp.asarray(u).dtype, mv_chunk=7)
    jp = jsym.make_sym_dual_matvec_pallas(jnp.asarray(tiles), nt,
                                          jnp.asarray(u).dtype, tiles_block=4)
    for x in (u, u[:, 0]):
        got = mv(torch.from_numpy(x))
        for jmv in (jx, jp):
            for a, b in zip(got, jmv(jnp.asarray(x))):
                assert a.shape == b.shape and a.dtype == torch.from_numpy(
                    x).dtype
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                           atol=2e-5)


def _dense_from_tiles(tiles, rows, cols, nt, t):
    M = np.zeros((nt * t, nt * t))
    for k, (r, c) in enumerate(zip(rows, cols)):
        if r < nt:
            M[r * t:(r + 1) * t, c * t:(c + 1) * t] = tiles[k, :t]
            if r != c:
                M[c * t:(c + 1) * t, r * t:(r + 1) * t] = tiles[k, :t].T
    return M


@pytest.mark.parametrize("K", [1, 4, 16])
def test_tiles_matvec_f64_storage_rounds_once(K):
    """f64 storage: the port's M u is the exact f64 product rounded once to
    f32, as for the rows matvec (ROADMAP.md Queue 3)."""
    m, t = 256, 32
    nt = m // t
    P1, P2, A, *_ = _bunny(m, 0.8, seed=3, dt=np.float64)
    tiles = _jax_tiles(P1, P2, A, m, t, jnp.float64)
    Mc = _dense_from_tiles(tiles, *symstore.tile_coords(nt), nt, t)
    u = np.random.default_rng(K).random((m, K))
    rounded = (Mc @ u).astype(np.float32).astype(np.float64)
    got = symstore.make_sym_dual_matvec(interop.tiles_to_torch(tiles), nt,
                                        torch.float64)(torch.from_numpy(u))
    np.testing.assert_array_equal(got[0].numpy(), rounded)


@pytest.mark.parametrize("D", [2, 3, 8])
def test_tile_slices_sum_to_whole(D):
    """The D slices of shard_tile_coords (inert slots included), each built
    at its coordinates and applied on its own, summed, give the whole
    list's matvec within 1e-6; the inert tiles are zero."""
    m, t = 160, 32
    nt = m // t
    P1, P2, A, *_ = _bunny(m, 0.7, seed=4)
    args = (INV, *_torch(P1, P2, A))
    whole = symstore.build_symtiles(*args, m, tile=t)
    U = torch.from_numpy(np.random.default_rng(D).random((4, m)).astype(
        np.float32))
    ref = symstore.sym_tiles_matvec_plain(whole, nt, U)
    rows, cols = symstore.shard_tile_coords(nt, D)
    n = len(rows) // D
    acc = 0
    for rank in range(D):
        r, c = rows[rank * n:(rank + 1) * n], cols[rank * n:(rank + 1) * n]
        tl = symstore._build_tiles_at(*args, r, c, m, t, 1e-4, torch.int8, 3)
        assert not tl[torch.from_numpy(r == nt)].any()
        acc = acc + symstore.sym_tiles_matvec_plain(tl, nt, U, r, c, raw=True)
    got = symstore._finish(acc, symstore._scale(torch.int8))
    assert float((got - ref).abs().max()) <= 1e-6


@pytest.mark.parametrize("storage", ["int8", "float64"])
def test_tiles_match_rows(storage):
    """The plain tile-list and rows matvecs on the same problem (the same
    codes in two layouts) agree within 1e-6."""
    m, t = 256, 32
    nt = m // t
    _, tst, dt = STORAGE[storage]
    P1, P2, A, *_ = _bunny(m, 0.8, seed=6, dt=dt)
    args = (INV, *_torch(P1, P2, A), m)
    tiles = symstore.build_symtiles(*args, tile=t, storage_dtype=tst)
    chunks = symstore.build_symchunks(*args, tile=t, G=3, storage_dtype=tst)
    U = torch.from_numpy(np.random.default_rng(6).random((16, m)).astype(dt))
    a = symstore.sym_tiles_matvec_plain(tiles, nt, U)
    b = symstore.sym_rows_matvec_plain(chunks, nt, U)
    assert float((a - b).abs().max()) <= 1e-6


@pytest.mark.parametrize("D", [2, 3])
def test_rows_matvec_slices_match_jax(D):
    """Kernel 3's plain version over a rank's chunk slice against the JAX
    rows kernel (interpret mode) on the same slice, as the JAX sharded
    engine calls it (its row table encodes the slice's offset), within
    2e-5; the slices sum to the whole list's matvec within 1e-6."""
    m, t, G = 256, 32, 2
    nt = m // t
    P1, P2, A, *_ = _bunny(m, 0.8, seed=7)
    U = np.random.default_rng(D).random((m, 4)).astype(np.float32)
    whole = symstore.build_symchunks(INV, *_torch(P1, P2, A), m, tile=t, G=G)
    ref = symstore.sym_rows_matvec_plain(whole, nt, torch.from_numpy(U.T))
    acc = 0
    for rank in range(D):
        base, crs, cc0, _, _ = symstore._shard_coords(nt, D, rank, "pallas",
                                                      G)
        jch = jsym.build_symchunks(JINV, jnp.asarray(P1), jnp.asarray(P2),
                                   jnp.asarray(A), m, tile=t, G=G,
                                   storage_dtype=jnp.int8, build_chunk=2,
                                   chunk_coords=(crs, cc0))
        ch = symstore.build_symchunks(INV, *_torch(P1, P2, A), m, tile=t,
                                      G=G, chunk_coords=(crs, cc0))
        assert int((ch.numpy() != np.asarray(jch)).sum()) <= 2
        jmv = jsym.make_sym_dual_matvec_pallas_rows(
            jch, crs, cc0, nt, jnp.float32,
            table=jnp.asarray(jsym.row_chunk_table(crs, cc0, nt)))
        mv = symstore.make_sym_dual_matvec_rows(
            interop.chunks_to_torch(jch), nt, torch.float32, chunk_base=base)
        for a, b in zip(mv(torch.from_numpy(U)), jmv(jnp.asarray(U))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=2e-5)
        acc = acc + symstore.sym_rows_matvec_plain(
            ch, nt, torch.from_numpy(U.T), chunk_base=base, raw=True)
    got = symstore._finish(acc, symstore._scale(torch.int8))
    assert float((got - ref).abs().max()) <= 1e-6


def unit_shape(monkeypatch, R, S):
    """Plan units of R x S blocks for the rest of a test (the kernel's
    are symstore._UNIT_ROWS x _UNIT_COLS); plans are cached by the shape."""
    monkeypatch.setattr(symstore, "_UNIT_ROWS", R)
    monkeypatch.setattr(symstore, "_UNIT_COLS", S)


def emulate_plan(view, plan, U, nt, t):
    """The int8 / bf16 kernels' two passes in plain f64, as ``plan`` walks
    the storage's 2-D ``view`` (numpy, f64): each unit's row sums and
    column sums, tile by tile in entry order, written to their slots at
    the unit's end and the column's end; then each output block's slots
    added in list order. U (K, m) f64, the kernel's operand. Returns the
    raw (K, 2m) sums."""
    K = U.shape[0]
    Ub = U.reshape(K, nt, t)
    ws = np.full((plan.n_slots, 2, K, t), np.nan)
    for n_unit, (e0, e1, r0, _) in enumerate(plan.units):
        fwd = np.zeros((plan.fslots.shape[1], 2, K, t))
        col = np.zeros((2, K, t))
        for x, y, c, meta in plan.entries[e0:e1]:
            i = meta & 0xF
            tile = view[y:y + 2 * t, x:x + t].reshape(2, t, t)
            fwd[i] += Ub[:, c] @ tile.transpose(0, 2, 1)
            if meta & symstore._META_TRANSPOSED:
                col += Ub[:, r0 + i] @ tile
            if meta & symstore._META_COL_END:
                if meta & symstore._META_COL_WRITE:
                    ws[meta >> symstore._META_SLOT_SHIFT] = col
                col = np.zeros((2, K, t))
        for i, slot in enumerate(plan.fslots[n_unit]):
            if slot >= 0:
                ws[slot] = fwd[i]
    out = np.zeros((K, 2, nt, t))
    for j in range(nt):
        for slot in plan.red_slots[plan.red_off[j]:plan.red_off[j + 1]]:
            out[:, :, j] += ws[slot].transpose(1, 0, 2)
    assert not np.isnan(out).any()
    return out.reshape(K, 2 * nt * t)


def plan_tiles(plan):
    """(r, c) of every entry of a plan, in entry order."""
    r = np.concatenate([r0 + (plan.entries[e0:e1, 3] & 0xF)
                        for e0, e1, r0, _ in plan.units]) if len(
                            plan.units) else np.zeros(0, int)
    order = np.concatenate([np.arange(e0, e1) for e0, e1, _, _ in
                            plan.units]) if len(plan.units) else r
    rr = np.empty(len(plan.entries), int)
    rr[order] = r
    return rr, plan.entries[:, 2].astype(int)


def check_slot_lists(plan, nt):
    """Every slot is written once (a unit row's forward sum or a column's
    transposed sum) and listed once, in the list of the block it adds to;
    each tile's row has its unit row's slot in its list, and an
    off-diagonal tile's column has its column's slot in its list; the
    lists are in slot order; every entry names its column's ring slot."""
    fs = plan.fslots[plan.fslots >= 0]
    meta = plan.entries[:, 3]
    wr = meta[(meta & symstore._META_COL_WRITE) > 0] >> \
        symstore._META_SLOT_SHIFT
    written = np.sort(np.concatenate([fs, wr]))
    np.testing.assert_array_equal(written, np.arange(plan.n_slots))
    np.testing.assert_array_equal(np.sort(plan.red_slots),
                                  np.arange(plan.n_slots))
    listed = {j: list(plan.red_slots[plan.red_off[j]:plan.red_off[j + 1]])
              for j in range(nt)}
    for j, slots in listed.items():
        assert slots == sorted(slots)
        assert all(plan.slot_block[s] == j for s in slots)
    for n_unit, (e0, e1, r0, _) in enumerate(plan.units):
        ordinal = -1
        for x, y, c, m in plan.entries[e0:e1]:
            i = m & 0xF
            assert plan.fslots[n_unit, i] in listed[r0 + i]
            if m & symstore._META_COL_START:
                tr = False
                ordinal += 1
            # the column's block of u: its ordinal's slot in the ring
            assert (m >> symstore._META_RING_SHIFT) & 0xF == \
                ordinal % symstore._COL_RING
            tr |= bool(m & symstore._META_TRANSPOSED)
            if m & symstore._META_COL_END:
                assert bool(m & symstore._META_COL_WRITE) == tr
                if tr:
                    slot = m >> symstore._META_SLOT_SHIFT
                    assert slot in listed[c]


def test_plan_meta_bits_match_kernel():
    """The plan's meta bits and unit height are the kernel's
    (csrc/sym_tile_mma.cuh), and a plan's row slots are the kernel's."""
    import re
    from clipper_tpu_torch import _kernels
    src = (_kernels.CSRC / "sym_tile_mma.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", src))
    assert eval(consts["kMetaTransposed"]) == symstore._META_TRANSPOSED
    assert eval(consts["kMetaColStart"]) == symstore._META_COL_START
    assert eval(consts["kMetaColEnd"]) == symstore._META_COL_END
    assert eval(consts["kMetaColWrite"]) == symstore._META_COL_WRITE
    assert int(consts["kMetaSlotShift"]) == symstore._META_SLOT_SHIFT
    assert int(consts["kMetaRingShift"]) == symstore._META_RING_SHIFT
    assert int(consts["kColSlots"]) == symstore._COL_RING
    assert int(consts["kMetaRow"], 16) == 0xF
    assert symstore._UNIT_ROWS == int(consts["kUnitRows"]) <= 16
    assert int(consts["kMaxK"]) == symstore._KERNEL_ROWS
    plan = symstore.tiles_plan(4, *symstore.tile_coords(4))
    assert plan.fslots.shape == (len(plan.units), int(consts["kUnitRows"]))


@pytest.mark.parametrize("R,S", [(8, 32), (2, 3)])
@pytest.mark.parametrize("nt", [5, 9])
@pytest.mark.parametrize("D", [1, 2, 3, 8])
def test_tiles_plan_covers_each_tile_once(nt, D, R, S, monkeypatch):
    """Every real tile of a slice of shard_tile_coords(nt, D) lies in
    exactly one unit, at its own place in the (T 2t, t) view; inert slots
    lie in none; a unit's tiles are one unit's (r // R, c // S), column by
    column, rows ascending; the slot lists cover every contribution. The
    kernel's unit shape (8, 32), and a small one (set on the module) that
    cuts these lists into many units."""
    unit_shape(monkeypatch, R, S)
    t = 32
    rows, cols = symstore.shard_tile_coords(nt, D)
    n = len(rows) // D
    seen = []
    for rank in range(D):
        r_sl = rows[rank * n:(rank + 1) * n]
        c_sl = cols[rank * n:(rank + 1) * n]
        plan = symstore.tiles_plan(nt, r_sl, c_sl, t)
        r, c = plan_tiles(plan)
        k = plan.entries[:, 1] // (2 * t)
        assert (plan.entries[:, 1] % (2 * t) == 0).all()
        assert (plan.entries[:, 0] == 0).all()
        np.testing.assert_array_equal(r_sl[k], r)
        np.testing.assert_array_equal(c_sl[k], c)
        assert sorted(k) == list(np.flatnonzero(r_sl < nt))
        for e0, e1, r0, _ in plan.units:
            assert len({(a // R, b // S) for a, b in zip(r[e0:e1],
                                                         c[e0:e1])}) == 1
            assert r0 == r[e0] // R * R
            walk = list(zip(c[e0:e1], r[e0:e1]))
            assert walk == sorted(walk)
        sizes = plan.units[:, 1] - plan.units[:, 0]
        assert (np.diff(sizes) <= 0).all()     # the largest unit first
        check_slot_lists(plan, nt)
        seen += list(zip(r, c))
    assert sorted(seen) == sorted(zip(*symstore.tile_coords(nt)))


@pytest.mark.parametrize("R,S", [(8, 32), (2, 3)])
@pytest.mark.parametrize("storage", ["int8", "float64"])
@pytest.mark.parametrize("m", [160, 288])
def test_tiles_plan_emulation_matches_plain(m, storage, R, S, monkeypatch):
    """The two passes as the plan walks them, emulated in f64, equal
    sym_tiles_matvec_plain's raw sums within 1e-12 relative (the same
    exact products summed in another order), on the whole list and on its
    D=3 slices summed; the unit shape as in the test above."""
    unit_shape(monkeypatch, R, S)
    t, D = 32, 3
    nt = m // t
    _, tst, dt = STORAGE[storage]
    P1, P2, A, *_ = _bunny(m, 0.7, seed=m, dt=dt)
    args = (INV, *_torch(P1, P2, A))
    U = torch.from_numpy(np.random.default_rng(m).random((5, m)).astype(dt))
    Uc, _ = symstore._operand(tst, U)
    U64 = Uc.double().numpy()
    rows, cols = symstore.shard_tile_coords(nt, D)
    n = len(rows) // D
    whole = symstore.build_symtiles(*args, m, tile=t, storage_dtype=tst)
    ref = symstore.sym_tiles_matvec_plain(whole, nt, U, raw=True).numpy()
    scale = np.abs(ref).max()
    parts = [(whole, *symstore.tile_coords(nt))]
    for rank in range(D):
        r, c = rows[rank * n:(rank + 1) * n], cols[rank * n:(rank + 1) * n]
        parts.append((symstore._build_tiles_at(*args, r, c, m, t, 1e-4, tst,
                                               7), r, c))
    acc = 0
    for d, (tl, r, c) in enumerate(parts):
        plan = symstore.tiles_plan(nt, r, c, t)
        view = tl.double().numpy().reshape(-1, t)
        got = emulate_plan(view, plan, U64, nt, t)
        if d == 0:
            assert np.abs(got - ref).max() <= 1e-12 * scale
        else:
            acc = acc + got
    assert np.abs(acc - ref).max() <= 1e-12 * scale


def test_tile_walks():
    """Each output block's walk holds its row's forward tiles, then its
    column's transposed tiles, in increasing k; inert slots are in none."""
    nt = 5
    rows, cols = symstore.shard_tile_coords(nt, 4)
    walks, offsets = symstore.tile_walks(nt, rows, cols)
    assert offsets[0] == 0 and offsets[-1] == len(walks) == 2 * 15 - nt
    for j in range(nt):
        got = [tuple(w) for w in walks[offsets[j]:offsets[j + 1]]]
        fwd = [(k, 2 * cols[k]) for k in range(len(rows)) if rows[k] == j]
        tr = [(k, 2 * rows[k] + 1) for k in range(len(rows))
              if cols[k] == j and rows[k] != j]
        assert got == fwd + tr


def test_exact_objective_slices_match_jax():
    """exact_objective over a rank's slice (partial=True) against the JAX
    package's on the same coordinates; the partials plus u'u give the
    whole-list value."""
    m, t, D = 250, 32, 3
    P1, P2, A, *_ = _bunny(m, 0.7, seed=5)
    pad = 256 - m
    P1 = np.pad(P1, ((0, pad), (0, 0)))
    P2 = np.pad(P2, ((0, pad), (0, 0)))
    A = np.pad(A, ((0, pad), (0, 0)), constant_values=-1)
    u = np.random.default_rng(6).random(256).astype(np.float32)
    u[m:] = 0.0
    targs = _torch(P1, P2, A, u)
    jargs = [jnp.asarray(x) for x in (P1, P2, A, u)]
    whole = float(symstore.exact_objective(INV, *targs, m, tile=t))
    rows, cols = symstore.shard_tile_coords(256 // t, D)
    n = len(rows) // D
    total = 0.0
    for rank in range(D):
        r, c = rows[rank * n:(rank + 1) * n], cols[rank * n:(rank + 1) * n]
        got = symstore.exact_objective(INV, *targs, m, tile=t, chunk=4,
                                       rows=r, cols=c, partial=True)
        ref = float(jsym.exact_objective(JINV, *jargs, m, tile=t, chunk=4,
                                         rows=jnp.asarray(r),
                                         cols=jnp.asarray(c), partial=True))
        assert got.dtype == torch.float32
        assert abs(float(got) - ref) <= 1e-5 * abs(ref)
        total += float(got)
    assert abs(total + float((u * u).sum()) - whole) <= 1e-5 * whole


@pytest.mark.parametrize("storage", ["float64", "int8"])
def test_solve_single_xla_matches_jax(storage):
    """solve_single(matvec="xla") against the JAX package's on the same
    numpy f32 data and u0: m=100 padded to 128, tile=32, probes=16,
    power_steps=4. f64 storage: equal ifinal and masks, F within 1e-6
    relative; int8: equal masks and F within 1e-4 relative.

    The working precision is f32 in both cases. In f64 working precision
    the JAX solve_single does not trace (its polish's lax.cond pairs an f32
    and an f64 branch), and the f64 solve on f32-rounded matvecs is chaotic
    in both packages (ROADMAP.md Queue 3)."""
    m = 100
    jst, tst, _ = STORAGE[storage]
    _, _, A, D1, D2, _ = _bunny(m, 0.9, seed=7)
    u0 = np.random.default_rng(8).random(m).astype(np.float32)
    opts = dict(tile=32, probes=16, power_steps=4, support=64)
    u_j, F_j, i_j = jsym.solve_single(
        JINV, jnp.asarray(D1), jnp.asarray(D2), jnp.asarray(A),
        jnp.asarray(u0), ct.Params(), storage_dtype=jst, matvec="xla",
        **opts)
    mask_j = np.asarray(jmsrc.round_solution(u_j, F_j, ct.Rounding.DSD_HEU))
    stats = {}
    u, F, i = symstore.solve_single(
        INV, *_torch(D1, D2, A, u0), Params(), storage_dtype=tst,
        matvec="xla", stats=stats, **opts)
    mask = msrc.round_solution(u, F, Rounding.DSD_HEU).numpy()
    assert u.shape == (m,) and u.dtype == torch.float32
    np.testing.assert_array_equal(mask, mask_j)
    assert mask.sum() > 0
    rtol = 1e-6 if storage == "float64" else 1e-4
    if storage == "float64":
        assert int(i) == int(i_j)
    assert abs(float(F) - float(F_j)) <= rtol * abs(float(F_j))
    assert stats["layout"] == "tile-list"
    assert stats["storage_bytes"] == 10 * 64 * 32 * tst.itemsize


def test_tiles_matvec_rejects():
    tiles = torch.zeros(3, 64, 32, dtype=torch.int8)
    with pytest.raises(ValueError, match="tile list"):
        symstore.make_sym_dual_matvec(tiles, 3, torch.float32)
    with pytest.raises(ValueError, match="tile list"):
        symstore.sym_tiles_matvec_plain(torch.zeros(3, 64, 64), 2,
                                        torch.zeros(1, 64))
    with pytest.raises(NotImplementedError, match="t = 128"):
        symstore.sym_tiles_matvec_cuda(tiles, 2, torch.zeros(1, 64))
    with pytest.raises(NotImplementedError, match="Queue 2 item 7"):
        symstore.sym_tiles_matvec_cuda(tiles.bfloat16(), 2,
                                       torch.zeros(1, 64))
    with pytest.raises(ValueError, match="on the card"):
        symstore.sym_tiles_matvec_cuda(torch.zeros(1, 256, 128,
                                                   dtype=torch.int8), 1,
                                       torch.zeros(1, 128))
    with pytest.raises(ValueError, match="unknown matvec"):
        symstore.solve_single(INV, torch.zeros(4, 3), torch.zeros(4, 3),
                              np.zeros((2, 2), np.int32), np.ones(2),
                              matvec="tiles")
