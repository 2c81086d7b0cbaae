"""Port parity: the row-chunked symmetric-triangle capacity engine.

The same numpy inputs through clipper_tpu.ops.symstore and
clipper_tpu_torch.ops.symstore (CPU: the plain versions). The JAX side's
rows kernel runs in interpret mode, as tests/test_symstore.py runs it.
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
from clipper_tpu_torch.invariants.euclidean import EuclideanDistance
from clipper_tpu_torch.ops import symstore
from clipper_tpu_torch.solvers import msrc
from clipper_tpu_torch.types import Params, Rounding

from test_symstore import make_problem
from test_torch_symtiles import (check_slot_lists, emulate_plan, grid_tiles,
                                  plan_blocks, plan_tiles, unit_shape)

JINV = jharness.default_invariant()
INV = harness.default_invariant()


def _bunny(m, rho, seed, dtype=np.float32):
    """Gathered (P1, P2, A) of one bunny problem, and its ground truth."""
    pcd0 = harness.load_bunny()
    pcd1, A, Agt = harness.make_problem(pcd0, m, rho,
                                        np.random.default_rng(seed))
    return (pcd0[A[:, 0]].astype(dtype), pcd1[A[:, 1]].astype(dtype),
            A.astype(np.int32), pcd0.astype(dtype), pcd1.astype(dtype), Agt)


def _jax_chunks(P1, P2, A, m, t, G, storage):
    return np.asarray(jsym.build_symchunks(
        JINV, jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(A), m, tile=t,
        G=G, storage_dtype=storage, build_chunk=2))


def test_layout_helpers_match_jax():
    for nt, G in ((1, 1), (3, 2), (8, 4), (13, 5), (64, 32)):
        cr, cc0, rows, cols = symstore.row_chunk_coords(nt, G)
        jcr, jcc0, jrows, jcols = jsym.row_chunk_coords(nt, G)
        for a, b in ((cr, jcr), (cc0, jcc0), (rows, jrows), (cols, jcols)):
            np.testing.assert_array_equal(a, b)
        # the closed form the kernel uses gives each row's first chunk
        first = symstore.row_first_chunk(nt, G)
        np.testing.assert_array_equal(
            first, np.searchsorted(cr, np.arange(nt + 1), side="left"))
    for nt in (1, 4, 9):
        for a, b in zip(symstore.tile_coords(nt), jsym.tile_coords(nt)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("m,t,G", [(96, 32, 2), (256, 32, 4)])
def test_build_symchunks_matches_jax(m, t, G):
    """int8 storage on tests/test_symstore.py's scene: C exact, M codes
    differing on at most 1e-3 of the stored edges (0 expected; XLA's
    vectorized exp can move a score by a few ulps, and a code by one where
    127 s sits at a half)."""
    D1, D2, A = make_problem(np.random.default_rng(m), n=300, n_inliers=60,
                             m=m)
    A = np.asarray(A)
    P1 = np.asarray(D1)[A[:, 0]].astype(np.float32)
    P2 = np.asarray(D2)[A[:, 1]].astype(np.float32)
    ref = np.asarray(jsym.build_symchunks(
        ct.EuclideanDistance(), jnp.asarray(P1), jnp.asarray(P2),
        jnp.asarray(A), m, tile=t, G=G, storage_dtype=jnp.int8,
        build_chunk=2))
    got = symstore.build_symchunks(
        EuclideanDistance(), torch.from_numpy(P1), torch.from_numpy(P2),
        torch.from_numpy(A), m, tile=t, G=G, storage_dtype=torch.int8,
        build_chunk=3).numpy()
    assert got.shape == ref.shape == (symstore.row_first_chunk(m // t, G)[-1],
                                      2 * t, G * t)
    np.testing.assert_array_equal(got[:, t:], ref[:, t:])
    n_edges = int((ref[:, t:] != 0).sum())
    n_diff = int((got[:, :t] != ref[:, :t]).sum())
    assert n_edges > 0 and n_diff <= 1e-3 * n_edges
    # the interop round trip carries the JAX chunks across unchanged
    back = interop.chunks_to_torch(ref)
    assert back.dtype == torch.int8 and back.is_contiguous()
    np.testing.assert_array_equal(interop.to_numpy(back), ref)
    with pytest.raises(ValueError):
        interop.chunks_to_torch(ref[0])


@pytest.mark.parametrize("storage", ["int8", "bfloat16", "float32",
                                     "float64"])
@pytest.mark.parametrize("K", [1, 4, 16])
def test_rows_matvec_plain_matches_jax(storage, K):
    """sym_rows_matvec_plain on the JAX package's own chunks against its
    rows kernel (interpret mode), within 2e-5. Both give f32 results, f64
    storage included; the JAX kernel sums in f32 and the port sums
    exactly and rounds once (test_rows_matvec_f64_storage_rounds_once)."""
    m, t, G = 256, 32, 4
    nt = m // t
    dt = np.float64 if storage == "float64" else np.float32
    P1, P2, A, *_ = _bunny(m, 0.8, seed=3, dtype=dt)
    jst = {"int8": jnp.int8, "bfloat16": jnp.bfloat16,
           "float32": jnp.float32, "float64": jnp.float64}[storage]
    chunks = _jax_chunks(P1, P2, A, m, t, G, jst)
    cr, cc0, _, _ = jsym.row_chunk_coords(nt, G)
    u = np.random.default_rng(K).random((m, K)).astype(dt)
    jmv = jsym.make_sym_dual_matvec_pallas_rows(jnp.asarray(chunks), cr, cc0,
                                                nt, jnp.asarray(u).dtype)
    mv = symstore.make_sym_dual_matvec_rows(interop.chunks_to_torch(chunks),
                                            nt, torch.from_numpy(u).dtype)
    for x in (u, u[:, 0]):
        ref = jmv(jnp.asarray(x))
        got = mv(torch.from_numpy(x))
        for a, b in zip(got, ref):
            assert a.shape == b.shape and a.dtype == torch.from_numpy(x).dtype
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=2e-5)


@pytest.mark.parametrize("K", [1, 4, 16])
def test_rows_matvec_f64_storage_rounds_once(K):
    """f64 storage: the port's M u is the exact f64 product rounded once to
    f32 (its sums are exact), while the JAX rows kernel's f32 accumulator
    leaves some outputs an ulp or more from that rounding. The port departs
    from the reference here on purpose (ROADMAP.md Queue 3)."""
    m, t, G = 256, 32, 4
    nt = m // t
    P1, P2, A, *_ = _bunny(m, 0.8, seed=3, dtype=np.float64)
    chunks = _jax_chunks(P1, P2, A, m, t, G, jnp.float64)
    cr, cc0, rows, cols = jsym.row_chunk_coords(nt, G)
    Mc = np.zeros((m, m))
    for k, (r, c) in enumerate(zip(rows, cols)):
        if r < nt:
            blk = chunks[k // G, :t, (k % G) * t:(k % G + 1) * t]
            Mc[r * t:(r + 1) * t, c * t:(c + 1) * t] = blk
            if r != c:
                Mc[c * t:(c + 1) * t, r * t:(r + 1) * t] = blk.T
    u = np.random.default_rng(K).random((m, K))
    rounded = (Mc @ u).astype(np.float32).astype(np.float64)
    got = symstore.make_sym_dual_matvec_rows(
        interop.chunks_to_torch(chunks), nt, torch.float64)(
            torch.from_numpy(u))[0].numpy()
    ref = np.asarray(jsym.make_sym_dual_matvec_pallas_rows(
        jnp.asarray(chunks), cr, cc0, nt, jnp.float64)(jnp.asarray(u))[0])
    np.testing.assert_array_equal(got, rounded)
    assert np.abs(ref - rounded).max() > 0


def test_rows_matvec_rejects_bad_layout():
    with pytest.raises(ValueError, match="row-chunked layout"):
        symstore.make_sym_dual_matvec_rows(
            torch.zeros(3, 64, 64, dtype=torch.int8), 3, torch.float32)
    with pytest.raises(ValueError, match="on the card"):
        symstore.sym_rows_matvec_cuda(torch.zeros(1, 256, 128, dtype=torch.int8),
                                      1, torch.zeros(1, 128))
    with pytest.raises(ValueError, match="on the card"):
        symstore.sym_rows_matvec_cuda(torch.zeros(2, 64, 64, dtype=torch.int8),
                                      2, torch.zeros(1, 64))
    with pytest.raises(TypeError, match="tensors"):
        symstore.solve_single(INV, np.zeros((4, 3)), np.zeros((4, 3)),
                              np.zeros((2, 2), np.int32), np.ones(2))


def _chunk_slices(nt, G, D):
    """(base, n) of each rank's chunk slice in the sharded 'pallas' mode
    (D = 1: the whole list)."""
    if D == 1:
        return [(0, int(symstore.row_first_chunk(nt, G)[-1]))]
    out = []
    for rank in range(D):
        base, crs, _, _, _ = symstore._shard_coords(nt, D, rank, "pallas", G)
        out.append((base, len(crs)))
    return out


@pytest.mark.parametrize("R,S", [(8, 32), (2, 3)])
@pytest.mark.parametrize("nt,G", [(5, 2), (9, 3)])
@pytest.mark.parametrize("D", [1, 2, 3, 8])
def test_rows_plan_covers_each_tile_once(nt, G, D, R, S, monkeypatch):
    """Every tile (r, c) of the triangle whose chunk lies in a rank's slice
    lies in exactly one unit of that slice's plan, at its place in the
    (n 2t, G t) view (chunk first(r) + (c - r) // G, lanes (c - r) % G);
    pad tiles and pad chunks lie in none; a unit's tiles are one unit's,
    column by column; the slot lists cover every contribution; at the
    kernel's unit shape and a small one (set on the module)."""
    unit_shape(monkeypatch, R, S)
    t = 32
    first = symstore.row_first_chunk(nt, G)
    seen = []
    for base, n in _chunk_slices(nt, G, D):
        plan = symstore.rows_plan(nt, G, n, base, t)
        # t = 32: super-tiles of 128 rows made of the stored 32-row tiles
        assert plan.sub == t
        x, y, r, c = grid_tiles(plan, n * 2 * t)
        assert (y % (2 * t) == 0).all() and (x % t == 0).all()
        np.testing.assert_array_equal(y // (2 * t) + base,
                                      first[r] + (c - r) // G)
        np.testing.assert_array_equal(x // t, (c - r) % G)
        assert ((y // (2 * t) < n) & (c >= r) & (c < nt)).all()
        er, ec = plan_tiles(plan)
        for e0, e1, r0, _ in plan.units:
            assert len({(a // R, b // S) for a, b in zip(er[e0:e1],
                                                         ec[e0:e1])}) == 1
            walk = list(zip(ec[e0:e1], er[e0:e1]))
            assert walk == sorted(walk)
        check_slot_lists(plan, plan_blocks(plan, nt * t))
        seen += list(zip(r, c))
    assert sorted(seen) == sorted(zip(*np.triu_indices(nt)))


@pytest.mark.parametrize("R,S", [(8, 32), (2, 3)])
@pytest.mark.parametrize("storage", [torch.int8, torch.float64])
@pytest.mark.parametrize("m,G", [(160, 2), (288, 4)])
def test_rows_plan_emulation_matches_plain(m, G, storage, R, S,
                                           monkeypatch):
    """The two passes as the rows plan walks them, emulated in f64, equal
    sym_rows_matvec_plain's raw sums within 1e-12 relative, on the whole
    list and on the D=3 chunk slices summed; the unit shape as above."""
    unit_shape(monkeypatch, R, S)
    t, D = 32, 3
    nt = m // t
    dt = np.float64 if storage == torch.float64 else np.float32
    P1, P2, A, *_ = _bunny(m, 0.7, seed=m, dtype=dt)
    args = (INV, *[torch.from_numpy(x) for x in (P1, P2, A)], m)
    U = torch.from_numpy(np.random.default_rng(G).random((5, m)).astype(dt))
    U64 = symstore._operand(storage, U)[0].double().numpy()
    whole = symstore.build_symchunks(*args, tile=t, G=G, storage_dtype=storage)
    ref = symstore.sym_rows_matvec_plain(whole, nt, U, raw=True).numpy()
    scale = np.abs(ref).max()
    plan = symstore.rows_plan(nt, G, whole.shape[0], 0, t)
    got = emulate_plan(whole.double().numpy().reshape(-1, G * t), plan, U64,
                       nt, t)
    assert np.abs(got - ref).max() <= 1e-12 * scale
    acc = 0
    for rank in range(D):
        base, crs, cc0, _, _ = symstore._shard_coords(nt, D, rank, "pallas",
                                                      G)
        ch = symstore.build_symchunks(*args, tile=t, G=G,
                                      storage_dtype=storage,
                                      chunk_coords=(crs, cc0))
        plan = symstore.rows_plan(nt, G, len(crs), base, t)
        acc = acc + emulate_plan(ch.double().numpy().reshape(-1, G * t), plan,
                                 U64, nt, t)
    assert np.abs(acc - ref).max() <= 1e-12 * scale


def test_plans_are_cached_by_layout(monkeypatch):
    """A layout's plan is made once: the same layout returns the same
    plan (a warm solve builds none), another slice, coordinates or unit
    shape another one."""
    nt, G, t = 9, 3, 32
    a = symstore.rows_plan(nt, G, 12, 0, t)
    assert symstore.rows_plan(nt, G, 12, 0, t) is a
    assert symstore.rows_plan(nt, G, 6, 6, t) is not a
    rows, cols = symstore.tile_coords(nt)
    b = symstore.tiles_plan(nt, rows, cols, t)
    assert symstore.tiles_plan(nt, rows.copy(), list(cols), t) is b
    assert symstore.tiles_plan(nt, rows[::-1], cols[::-1], t) is not b
    # the whole list's super-tiles (t = 32: three 128-row blocks a side)
    NC = int(symstore.row_first_chunk(nt, G)[-1])
    whole = symstore.rows_plan(nt, G, NC, 0, t)
    unit_shape(monkeypatch, 2, 3)
    small = symstore.rows_plan(nt, G, NC, 0, t)
    assert small is not whole and len(small.units) > len(whole.units)


def test_exact_objective_matches_jax():
    m, t = 250, 32
    P1, P2, A, *_ = _bunny(m, 0.7, seed=5)
    pad = 256 - m
    P1 = np.pad(P1, ((0, pad), (0, 0)))
    P2 = np.pad(P2, ((0, pad), (0, 0)))
    A = np.pad(A, ((0, pad), (0, 0)), constant_values=-1)
    u = np.random.default_rng(6).random(256).astype(np.float32)
    u[m:] = 0.0
    ref = float(jsym.exact_objective(JINV, jnp.asarray(P1), jnp.asarray(P2),
                                     jnp.asarray(A), jnp.asarray(u), m,
                                     tile=t, chunk=7))
    targs = [torch.from_numpy(x) for x in (P1, P2, A, u)]
    got = symstore.exact_objective(INV, *targs, m, tile=t, chunk=11)
    assert got.dtype == torch.float32
    assert abs(float(got) - ref) <= 1e-5 * abs(ref)


@pytest.mark.parametrize("support", [64, 8])
def test_solve_single_matches_jax(support):
    """m=100 padded to 128, tile=32, int8, probes=16, power_steps=4 from
    the same numpy u0. The JAX side runs its rows kernel in interpret mode
    (matvec='pallas'). support=8 takes the exact tile-chunked polish.
    Equal ifinal and masks; u within 1e-5 and F within 1e-4 relative (f32
    sums in another order)."""
    m = 100
    _, _, A, D1, D2, _ = _bunny(m, 0.9, seed=7)
    u0 = np.random.default_rng(8).random(m).astype(np.float32)
    opts = dict(tile=32, probes=16, power_steps=4, support=support)
    u_j, F_j, i_j = jsym.solve_single(
        JINV, jnp.asarray(D1), jnp.asarray(D2), jnp.asarray(A),
        jnp.asarray(u0), ct.Params(), storage_dtype=jnp.int8,
        matvec="pallas", **opts)
    mask_j = np.asarray(jmsrc.round_solution(u_j, F_j, ct.Rounding.DSD_HEU))
    stats = {}
    u, F, i = symstore.solve_single(
        INV, torch.from_numpy(D1), torch.from_numpy(D2), torch.from_numpy(A),
        torch.from_numpy(u0), Params(), storage_dtype=torch.int8,
        stats=stats, **opts)
    mask = msrc.round_solution(u, F, Rounding.DSD_HEU).numpy()
    assert u.shape == (m,) and u.dtype == torch.float32
    assert int(i) == int(i_j) and int(i) >= 1
    np.testing.assert_array_equal(mask, mask_j)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), rtol=0, atol=1e-5)
    assert abs(float(F) - float(F_j)) <= 1e-4 * abs(float(F_j))
    assert (int((u > 0).sum()) > support) == (support == 8)
    assert set(stats) == {"build", "init", "solve", "polish", "ticks",
                          "nback", "storage_bytes", "layout"}
    assert stats["ticks"] > 0 and stats["storage_bytes"] == 4 * 64 * 128
    assert stats["layout"] == "row-chunked"


def test_solve_single_wrap_matvec():
    """wrap_matvec sees the rows matvec before init and solve: a wrapper
    that only counts calls leaves the result unchanged, and one that
    scales every output by 2 changes it."""
    m = 100
    _, _, A, D1, D2, _ = _bunny(m, 0.9, seed=7)
    u0 = np.random.default_rng(8).random(m).astype(np.float32)
    args = (INV, torch.from_numpy(D1), torch.from_numpy(D2),
            torch.from_numpy(A), torch.from_numpy(u0), Params())
    opts = dict(tile=32, probes=16, power_steps=4)
    u, F, i = symstore.solve_single(*args, **opts)
    calls = []

    def counting(mv):
        def wrapped(x):
            calls.append(x.shape)
            return mv(x)
        return wrapped

    def doubled(mv):
        return lambda x: tuple(2 * y for y in mv(x))

    stats = {}
    u_c, F_c, i_c = symstore.solve_single(*args, wrap_matvec=counting,
                                          stats=stats, **opts)
    assert torch.equal(u, u_c) and torch.equal(F, F_c) and int(i) == int(i_c)
    assert len(calls) > stats["ticks"] and calls[-1] == (128, 16)
    u_d, _, _ = symstore.solve_single(*args, wrap_matvec=doubled, **opts)
    assert not torch.equal(u, u_d)
