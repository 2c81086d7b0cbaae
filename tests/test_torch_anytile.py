"""Port parity at every tile the JAX package takes (any t dividing the
padded m), not only the t = 128 and 256 of the card's first kernels.

The tri pool at tri_tile 64 and 384 and the capacity engine's
solve_single at tile 16, 64 and 256 are held to the JAX package from the
same numpy inputs and u0; the int8 / bf16 kernels' unit plans are emulated
at t = 16, 64, 100, 256, 512 against the plain matvecs; each CUDA
wrapper's shape check (which runs before its device check) takes those
tiles, and the Python routes are the CUDA dispatch's. The card's own
checks of these kernels are in test_torch_cuda.py (marker ``cuda``).
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import clipper_tpu as ct
from clipper_tpu.bench import harness as jharness
from clipper_tpu.ops import symstore as jsym
from clipper_tpu.parallel import pool as jpool
from clipper_tpu.solvers import msrc as jmsrc
from clipper_tpu_torch import _kernels
from clipper_tpu_torch.bench import harness
from clipper_tpu_torch.ops import flattri, symstore
from clipper_tpu_torch.parallel import pool
from clipper_tpu_torch.solvers import msrc
from clipper_tpu_torch.types import Params, Rounding

INV = harness.default_invariant()
JINV = jharness.default_invariant()
W, M_POOL = 16, 768          # 768 = 12 x 64 = 2 x 384
ENGINE = dict(lanes=4, window=2, power_steps=4, layout="tri", tri_probes=16,
              d_scale=0.15)
NEW_TILES = (16, 64, 100, 384, 512)
PLAN_TILES = (16, 32, 48, 64, 96, 100, 192, 256, 512)


@pytest.fixture(scope="module")
def problems():
    pcd0 = harness.load_bunny()
    rng = np.random.default_rng(31)
    probs = [harness.make_problem(pcd0, M_POOL, 0.9, rng) for _ in range(W)]
    D2s = np.stack([p[0] for p in probs])
    As = np.stack([p[1] for p in probs]).astype(np.int32)
    u0 = np.random.default_rng(32).random((W, M_POOL))
    return pcd0, D2s, As, u0


def _pools(problems, dt, storage_t, storage_j, w, tri_tile):
    pcd0, D2s, As, u0 = problems
    engine = dict(ENGINE, tri_tile=tri_tile)
    jp = jpool.make_pool_pipeline(JINV, ct.Params(), storage_dtype=storage_j,
                                  **engine)
    sj = jp(jnp.asarray(pcd0, dt), jnp.asarray(D2s[:w], dt),
            jnp.asarray(As[:w]), jnp.asarray(u0[:w], dt))
    tp = pool.make_pool_pipeline(INV, Params(), storage_dtype=storage_t,
                                 device="cpu", **engine)
    st = tp(pcd0.astype(dt), D2s[:w].astype(dt), As[:w], u0[:w].astype(dt))
    return sj, st


@pytest.mark.parametrize("tri_tile", [64, 384])
def test_tri_pool_f64_at_tile_matches_jax(problems, tri_tile):
    """Full-precision storage at tri_tile 64 and 384, 8 problems of
    m=768: masks and ifinal equal to the JAX pool's on every problem."""
    sj, st = _pools(problems, np.float64, None, None, 8, tri_tile)
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    np.testing.assert_array_equal(st.ifinal.numpy(), np.asarray(sj.ifinal))


@pytest.mark.parametrize("tri_tile", [64, 384])
def test_tri_pool_int8_at_tile_matches_jax(problems, tri_tile):
    """int8 storage at tri_tile 64 and 384, 16 problems of m=768: masks
    equal to the JAX pool's on at least 15 of 16 (the f32 pools' bar)."""
    sj, st = _pools(problems, np.float32, torch.int8, jnp.int8, W, tri_tile)
    same = (st.mask.numpy() == np.asarray(sj.mask)).all(1)
    assert same.sum() >= W - 1


def _bunny(m, seed):
    """(A, D1, D2) of one bunny problem: the associations and the two
    (n, 3) point clouds, f32."""
    pcd0 = harness.load_bunny()
    pcd1, A, _ = harness.make_problem(pcd0, m, 0.9,
                                      np.random.default_rng(seed))
    return A.astype(np.int32), pcd0.astype(np.float32), \
        pcd1.astype(np.float32)


def _solve_both(m, tile, matvec, seed):
    """symstore.solve_single in int8 at ``tile`` (m padded to it) in the
    ``matvec`` layout, and the JAX package's tile-list solve, from the same
    numpy u0: (mask, ifinal) of each."""
    A, D1, D2 = _bunny(m, seed=seed)
    u0 = np.random.default_rng(seed + 1).random(m).astype(np.float32)
    opts = dict(tile=tile, probes=16, power_steps=4, support=64)
    u_j, F_j, i_j = jsym.solve_single(
        JINV, jnp.asarray(D1), jnp.asarray(D2), jnp.asarray(A),
        jnp.asarray(u0), ct.Params(), storage_dtype=jnp.int8, matvec="xla",
        **opts)
    mask_j = np.asarray(jmsrc.round_solution(u_j, F_j, ct.Rounding.DSD_HEU))
    u, F, i = symstore.solve_single(
        INV, torch.from_numpy(D1), torch.from_numpy(D2), torch.from_numpy(A),
        torch.from_numpy(u0), Params(), storage_dtype=torch.int8,
        matvec=matvec, **opts)
    mask = msrc.round_solution(u, F, Rounding.DSD_HEU).numpy()
    return mask, int(i), mask_j, int(i_j)


@pytest.mark.parametrize("matvec", ["pallas", "xla"])
@pytest.mark.parametrize("tile", [64, 48])
def test_solve_single_at_sub_tiles_matches_jax(tile, matvec):
    """symstore.solve_single in int8 at tile 64 and 48 (m=1000, padded to
    1024 and 1008: the unit kernel's sub-tiled routes on the card, whose
    plain versions run here), row-chunked ('pallas') and tile list
    ('xla'), against the JAX package's solve_single
    (clipper_tpu/ops/symstore.py:427) at the same tile from the same numpy
    u0: equal masks and ifinal."""
    mask, i, mask_j, i_j = _solve_both(1000, tile, matvec, seed=tile + 5)
    assert mask.sum() > 0
    assert i == i_j
    np.testing.assert_array_equal(mask, mask_j)


@pytest.mark.parametrize("matvec", ["pallas", "xla"])
@pytest.mark.parametrize("tile", [16, 64, 256])
def test_solve_single_int8_at_tile_matches_jax(tile, matvec):
    """symstore.solve_single in int8 at tile 16, 64 and 256 (m=300, padded
    to the tile), row-chunked ('pallas') and tile list ('xla'), against
    the JAX package's tile-list solve from the same numpy u0: equal masks
    and ifinal."""
    m = 300
    A, D1, D2 = _bunny(m, seed=tile)
    u0 = np.random.default_rng(tile + 1).random(m).astype(np.float32)
    opts = dict(tile=tile, probes=16, power_steps=4, support=64)
    u_j, F_j, i_j = jsym.solve_single(
        JINV, jnp.asarray(D1), jnp.asarray(D2), jnp.asarray(A),
        jnp.asarray(u0), ct.Params(), storage_dtype=jnp.int8, matvec="xla",
        **opts)
    mask_j = np.asarray(jmsrc.round_solution(u_j, F_j, ct.Rounding.DSD_HEU))
    u, F, i = symstore.solve_single(
        INV, torch.from_numpy(D1), torch.from_numpy(D2), torch.from_numpy(A),
        torch.from_numpy(u0), Params(), storage_dtype=torch.int8,
        matvec=matvec, **opts)
    mask = msrc.round_solution(u, F, Rounding.DSD_HEU).numpy()
    assert int(i) == int(i_j)
    np.testing.assert_array_equal(mask, mask_j)


def _emulate(view, plan, U, m, u, t):
    """The kernel's two passes in plain f64 as ``plan`` walks the storage's
    2-D ``view`` (numpy f64): an entry's M tile at (x, y) in the view, u
    rows a side (symstore.unit_tile, or t on the CUDA-core route), its C
    tile the stored tile's t rows below; or, in a sub-tiled plan
    (plan.sub < 128), a super-tile of 128 rows assembled from the plan's
    subs (a sub-tile at row view.shape[0] zeros), whose transposed product
    leaves out its diagonal sub-tiles on the matrix's diagonal. Row and
    column sums are written to their slots, then each output block's
    slots added in list order. U (K, m) f64. Returns the raw (K, 2m)
    sums."""
    K = U.shape[0]
    g = plan.sub
    P = symstore._UNIT_T // g if g < symstore._UNIT_T else 1
    w = u if P == 1 else symstore._UNIT_T
    nb = -(-m // w)
    Ub = np.zeros((K, nb * w))
    Ub[:, :m] = U
    Ub = Ub.reshape(K, nb, w)

    def tile(x, y):
        if P == 1:
            return np.stack([view[y:y + w, x:x + w],
                             view[y + t:y + t + w, x:x + w]])
        X = np.zeros((2, w, w))
        for q, (sx, sy) in enumerate(plan.subs[x * P * P:(x + 1) * P * P]):
            if sy < view.shape[0]:
                a, b = divmod(q, P)
                for h in (0, 1):
                    X[h, a * g:(a + 1) * g, b * g:(b + 1) * g] = \
                        view[sy + h * t:sy + h * t + g, sx:sx + g]
        return X

    ws = np.full((plan.n_slots, 2, K, w), np.nan)
    for n_unit, (e0, e1, r0, _) in enumerate(plan.units):
        fwd = np.zeros((plan.fslots.shape[1], 2, K, w))
        col = np.zeros((2, K, w))
        for x, y, c, meta in plan.entries[e0:e1]:
            i = meta & 0xF
            X = tile(x, y)
            fwd[i] += Ub[:, c] @ X.transpose(0, 2, 1)
            if meta & symstore._META_TRANSPOSED:
                if P > 1 and r0 + i == c:
                    X = X.copy()
                    for a in range(P):
                        X[:, a * g:(a + 1) * g, a * g:(a + 1) * g] = 0
                col += Ub[:, r0 + i] @ X
            if meta & symstore._META_COL_END:
                if meta & symstore._META_COL_WRITE:
                    ws[meta >> symstore._META_SLOT_SHIFT] = col
                col = np.zeros((2, K, w))
        for i, slot in enumerate(plan.fslots[n_unit]):
            if slot >= 0:
                ws[slot] = fwd[i]
    out = np.zeros((K, 2, nb, w))
    for j in range(nb):
        for slot in plan.red_slots[plan.red_off[j]:plan.red_off[j + 1]]:
            out[:, :, j] += ws[slot].transpose(1, 0, 2)
    assert not np.isnan(out).any()
    return out.reshape(K, 2, nb * w)[:, :, :m].reshape(K, 2 * m)


def _grid_tiles(plan, view_rows):
    """The (x, y) of every tile a plan reads: its entries', or a sub-tiled
    plan's sub-tiles that the storage holds."""
    if plan.sub < symstore._UNIT_T:
        xy = plan.subs[plan.subs[:, 1] < view_rows]
    else:
        xy = plan.entries[:, :2]
    return [tuple(v) for v in xy]


def _storage(layout, t, storage=torch.int8):
    """(storage, nt, m) of one bunny problem at m = t (1024 // t) in
    ``layout`` ("tiles" or "rows", G=3)."""
    m = t * (1024 // t)
    A, D1, D2 = _bunny(m, seed=t)
    args = (INV, torch.from_numpy(D1[A[:, 0]]), torch.from_numpy(D2[A[:, 1]]),
            torch.from_numpy(A), m)
    if layout == "tiles":
        store = symstore.build_symtiles(*args, tile=t, storage_dtype=storage)
    else:
        store = symstore.build_symchunks(*args, tile=t, G=3,
                                         storage_dtype=storage)
    return store, m // t, m


@pytest.mark.parametrize("layout", ["tiles", "rows"])
@pytest.mark.parametrize("t", PLAN_TILES)
def test_unit_plan_emulation_at_tile(layout, t):
    """The int8 / bf16 kernels' plan at t = 16, 32, 48, 64, 96, 100, 192,
    256, 512 (m = t (1024 // t)): symstore.unit_tile(t) the largest of
    128, 64, 32, 16 dividing t (the unit kernel; below 128 over
    super-tiles of 128 rows made of those tiles), else t (the CUDA-core
    kernel's own grid); every stored t-tile's grid tiles read once (a
    diagonal t-tile's upper ones), and the plan's two passes emulated in
    f64 equal to the plain matvec's raw sums within 1e-12 relative, on the
    whole storage and on D=3 slices summed (the tile list's
    shard_tile_coords slices; the rows layout's chunk ranges)."""
    store, nt, m = _storage(layout, t)
    u = symstore.unit_tile(t)
    units = t % 16 == 0
    assert u == next((g for g in (128, 64, 32, 16) if t % g == 0), t)
    assert symstore.matvec_route(t, torch.int8) == (
        "units" if units else "core")
    kernel = symstore.plan_kernel(t)
    assert kernel == ("units" if units else "core")
    U = torch.from_numpy(np.random.default_rng(t).random((5, m)).astype(
        np.float32))
    Uc, _ = symstore._operand(torch.int8, U)
    U64 = Uc.double().numpy()
    D = 3
    if layout == "tiles":
        ref = symstore.sym_tiles_matvec_plain(store, nt, U, raw=True).numpy()
        rows, cols = symstore.shard_tile_coords(nt, D)
        n = len(rows) // D
        parts = [(store, *symstore.tile_coords(nt))]
        T = store.shape[0]
        for d in range(D):
            a, b = d * n, (d + 1) * n
            part = store[a:min(b, T)]
            if b > T:
                part = torch.cat([part, part.new_zeros(
                    (b - max(a, T),) + tuple(part.shape[1:]))])
            parts.append((part, rows[a:b], cols[a:b]))
        plans = [(p, symstore.tiles_plan(nt, r, c, t)) for p, r, c in parts]
        views = [p.double().numpy().reshape(-1, t) for p, _ in plans]
    else:
        ref = symstore.sym_rows_matvec_plain(store, nt, U, raw=True).numpy()
        NC = store.shape[0]
        n = -(-NC // D)
        parts = [(0, store)]
        for d in range(D):
            a, b = d * n, (d + 1) * n
            part = store[a:min(b, NC)]
            if b > NC:
                part = torch.cat([part, part.new_zeros(
                    (b - max(a, NC),) + tuple(part.shape[1:]))])
            parts.append((a, part))
        plans = [(p, symstore.rows_plan(nt, 3, p.shape[0], base, t))
                 for base, p in parts]
        views = [p.double().numpy().reshape(-1, 3 * t) for p, _ in plans]
    scale = np.abs(ref).max()
    acc = 0
    read = []
    for d, ((_, plan), view) in enumerate(zip(plans, views)):
        assert plan.sub == (u if units and u < 128 else 128)
        # a stored t-tile is (t / u)^2 grid tiles, a diagonal one its upper
        # (t / u)(t / u + 1) / 2
        q = t // u
        tiles = _grid_tiles(plan, view.shape[0])
        if d == 0:
            assert len(tiles) == len(set(tiles)) == \
                nt * q * (q + 1) // 2 + nt * (nt - 1) // 2 * q * q
            w = u if plan.sub == 128 else 128
            assert plan.entries[:, 2].max() < -(-m // w)
        else:
            read += tiles
        got = _emulate(view, plan, U64, m, u, t)
        if d == 0:
            assert np.abs(got - ref).max() <= 1e-12 * scale
        else:
            acc = acc + got
    assert len(read) == nt * q * (q + 1) // 2 + nt * (nt - 1) // 2 * q * q
    assert np.abs(acc - ref).max() <= 1e-12 * scale


@pytest.mark.parametrize("t", NEW_TILES)
def test_wrapper_shape_checks_take_every_tile(t):
    """Each CUDA wrapper's shape check (kernels 1, 2, 3, 7, 8 and 9, int8
    and bf16) takes t = 16, 64, 100, 384, 512 and names its route; the
    wrapper then raises only for the CPU tensors (its device check), never
    for the tile."""
    nt = 2
    m = nt * t
    S = flattri.tri_ncols(nt, t)
    T = nt * (nt + 1) // 2
    idx = torch.zeros(1, dtype=torch.int32)
    f32 = torch.float32
    mma = "mma" if t in (384, 512) else "core"
    for storage in (torch.int8, torch.bfloat16):
        tri = torch.zeros(1, 2 * t, S, dtype=storage)
        assert flattri.check_tri_matvec(tri, nt, torch.zeros(1, 3, m)) == mma
        with pytest.raises(ValueError, match="on the card"):
            flattri.tri_pool_matvec_cuda(tri, nt, idx, torch.zeros(1, 3, m),
                                         f32)
        tiles = torch.zeros(1, T, 2 * t, t, dtype=storage)
        assert flattri.check_tri_tiles_matvec(tiles, nt,
                                              torch.zeros(1, m)) == mma
        with pytest.raises(ValueError, match="on the card"):
            flattri.tri_tiles_matvec_cuda(tiles, nt, idx, torch.zeros(1, m),
                                          f32)
        units = "units" if t % 16 == 0 else "core"
        tl = torch.zeros(T, 2 * t, t, dtype=storage)
        assert symstore.check_tiles_kernel(tl, nt, torch.zeros(4, m))[0] \
            == units
        with pytest.raises(ValueError, match="on the card"):
            symstore.sym_tiles_matvec_cuda(tl, nt, torch.zeros(4, m))
        G = 2
        NC = int(symstore.row_first_chunk(nt, G)[-1])
        ch = torch.zeros(NC, 2 * t, G * t, dtype=storage)
        assert symstore.check_rows_kernel(ch, nt, torch.zeros(4, m))[0] \
            == units
        with pytest.raises(ValueError, match="on the card"):
            symstore.sym_rows_matvec_cuda(ch, nt, torch.zeros(4, m))
        P = torch.zeros(1, m, 3)
        A = torch.zeros(1, m, 2, dtype=torch.int32)
        kind, _, suffix = flattri.check_tri_build(INV, P, P, t, storage)
        assert kind == 0 and suffix in ("int8", "bf16")
        for build in (flattri.build_tri_cuda, flattri.build_tri_fused_cuda):
            with pytest.raises(ValueError, match="on the card"):
                build(INV, P, P, A, torch.tensor([m]), t=t,
                      storage_dtype=storage)
    # the float kinds have one route at every tile, counted under the
    # kernel's own key
    for dt in (torch.float32, torch.float64):
        assert flattri.matvec_route(t, dt) == "float"
        assert _kernels.route_key("tri_matvec", "float") == "tri_matvec"
    # a tile that does not divide m is refused by the shape check alone
    with pytest.raises(ValueError, match="dividing m"):
        flattri.check_tri_build(INV, torch.zeros(1, m + 1, 3),
                                torch.zeros(1, m + 1, 3), t, torch.int8)


def test_routes_match_the_cuda_dispatch():
    """The tiles of flattri.matvec_route's "mma" route are mma_tile's in
    csrc/tri_matvec_mma.cuh, which the dispatch of csrc/tri_matvec.cu and
    csrc/tri_tiles_matvec.cu calls and reports (kRouteMma, kRouteCore:
    _kernels.ROUTES, the last argument of their int8 / bf16 entries);
    symstore's unit tile is csrc/sym_tile_mma.cuh's kT; every route has
    its launch key."""
    src = (_kernels.CSRC / "tri_matvec_mma.cuh").read_text()
    body = re.search(r"bool mma_tile\(int t\) \{ return ([^;]+); \}",
                     src).group(1)
    assert tuple(int(x) for x in re.findall(r"t == (\d+)", body)) == \
        flattri._MMA_TILES
    for i, route in enumerate(_kernels.ROUTES):
        assert f"constexpr int kRoute{route.capitalize()} = {i};" in src
    for name in ("tri_matvec", "tri_tiles_matvec"):
        src = (_kernels.CSRC / f"{name}.cu").read_text()
        assert ("if (!mma_tile(t)) {  // route \"core\"\n"
                "    *route = kRouteCore;") in src
        assert "*route = kRouteMma;  // route \"mma\"" in src
        for kind in ("int8", "bf16"):
            assert _kernels._SIGNATURES[f"{name}_{kind}"][-1] is _kernels._IP
            assert f"void* stream, int* route) {{" in src
    src = (_kernels.CSRC / "sym_tile_mma.cuh").read_text()
    assert int(re.search(r"constexpr int kT = (\d+);", src).group(1)) == \
        symstore._UNIT_T
    # the unit kernel's sub-tiles: the dispatch of launch_units and the
    # entries it accepts
    body = src[src.index("int launch_units("):]
    cases = [int(x) for x in re.findall(r"case (\d+):", body)]
    assert tuple(cases) == symstore._SUB_TILES[:-1]
    assert "default:\n        err = launch_unit_nk<S, 8>" in body
    ok = re.search(r"const bool sub_ok = g == kT \|\| \(\(([^)]*)\)", body)
    assert tuple(int(x) for x in re.findall(r"g == (\d+)", ok.group(1))) \
        == symstore._SUB_TILES
    assert "t % 16 == 0" in body
    for t in range(1, 1025):
        for dt in (torch.int8, torch.bfloat16):
            r = flattri.matvec_route(t, dt)
            assert (r == "mma") == (t in (128, 256, 384, 512))
            assert _kernels.route_key("tri_matvec", r) in _kernels.LAUNCHES
            r = symstore.matvec_route(t, dt)
            assert (r == "units") == (t % 16 == 0)
            g = symstore.unit_tile(t)
            assert (g in (128, *symstore._SUB_TILES)) == (r == "units")
            assert symstore.plan_kernel(t, dt) == (
                "units" if r == "units" else "core")
        assert symstore.matvec_route(t, torch.float32) == "float"
        assert symstore.plan_kernel(t, torch.float64) == "core"
    for key in _kernels.CORE_ROUTES.values():
        assert key in _kernels.LAUNCHES
