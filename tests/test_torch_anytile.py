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
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import clipper_tpu as ct
from clipper_tpu.bench import harness as jharness
from clipper_tpu.ops import flattri as jflat
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
    mma = ("mma" if t in (384, 512) else "super" if t % 16 == 0
           else "core")
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


@pytest.mark.parametrize("dtype,t", [(torch.int8, 7679), (torch.bfloat16, 7679),
                                     (torch.float32, 7680),
                                     (torch.float64, 7680)])
def test_core_routes_take_t_to_their_limit(dtype, t):
    """The CUDA-core kernel (routes "core" and "float") takes every t up to
    flattri._CORE_MAX_T = 7680, where an f64 block fills an SM's shared
    memory at one candidate (kernel 1's and kernel 9's shape checks, on
    storage of no size), and refuses the tiles past it; the tensor-core
    routes have no such limit."""
    route = "core" if dtype in (torch.int8, torch.bfloat16) else "float"
    for tt, ok in ((t, True), (t + 2, False)):
        flat = torch.empty(1, 2 * tt, tt, dtype=dtype, device="meta")
        tiles = torch.empty(1, 1, 2 * tt, tt, dtype=dtype, device="meta")
        checks = ((flattri.check_tri_matvec, flat,
                   torch.empty(1, 16, tt, device="meta")),
                  (flattri.check_tri_tiles_matvec, tiles,
                   torch.empty(1, tt, device="meta")))
        for check, store, U in checks:
            if ok:
                assert check(store, 1, U) == route
            else:
                with pytest.raises(ValueError, match="takes t <= 7680"):
                    check(store, 1, U)
    if route == "core":
        store = torch.empty(1, 2 * 7696, 7696, dtype=dtype, device="meta")
        assert flattri.check_tri_matvec(
            store, 1, torch.empty(1, 16, 7696, device="meta")) == "super"


def test_routes_match_the_cuda_dispatch():
    """The tiles of flattri.matvec_route's "mma" route are mma_tile's in
    csrc/tri_matvec_mma.cuh and those of its "super" route super_tile's
    (every other multiple of 16, stripes of super_stripe's rows), which
    the dispatch of csrc/tri_matvec.cu and csrc/tri_tiles_matvec.cu calls
    and reports (kRouteMma, kRouteCore, kRouteSuper: _kernels.ROUTES, the
    last argument of their int8 / bf16 entries); symstore's unit tile is
    csrc/sym_tile_mma.cuh's kT; every route has its launch key."""
    src = (_kernels.CSRC / "tri_matvec_mma.cuh").read_text()
    body = re.search(r"bool mma_tile\(int t\) \{ return ([^;]+); \}",
                     src).group(1)
    assert tuple(int(x) for x in re.findall(r"t == (\d+)", body)) == \
        flattri._MMA_TILES
    assert ("bool super_tile(int t) { return t % "
            f"{flattri._SUPER_ALIGN} == 0 && !mma_tile(t); }}") in src
    stripe = re.search(r"return (t % 64 == 0 \? 64 : [^;]+);", src).group(1)
    assert tuple(int(x) for x in re.findall(r"\? (\d+)", stripe)) + (16,) \
        == SUPER_STRIPES
    for i, route in enumerate(_kernels.ROUTES):
        assert f"constexpr int kRoute{route.capitalize()} = {i};" in src
    core = (_kernels.CSRC / "tri_matvec_core.cuh").read_text()
    assert f"constexpr int kMaxT = {flattri._CORE_MAX_T};" in core
    for name in ("tri_matvec", "tri_tiles_matvec"):
        src = (_kernels.CSRC / f"{name}.cu").read_text()
        assert ("if (!mma_tile(t)) {  // route \"core\"\n"
                "    *route = kRouteCore;") in src
        assert ("if (super_tile(t)) {  // route \"super\"\n"
                "    *route = kRouteSuper;") in src
        assert src.index("super_tile(t)") < src.index("!mma_tile(t)")
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
            assert (r == "super") == (t % 16 == 0 and r != "mma")
            if r == "super":
                assert _super_stripe(t) == max(
                    g for g in (16, 32, 64) if t % g == 0)
            for name in ("tri_matvec", "tri_tiles_matvec"):
                assert _kernels.route_key(name, r) in _kernels.LAUNCHES
            assert (_kernels.route_key("tri_matvec", r)
                    == {"core": "tri_matvec_core",
                        "super": "tri_matvec_super"}.get(r, "tri_matvec"))
            r = symstore.matvec_route(t, dt)
            assert (r == "units") == (t % 16 == 0)
            g = symstore.unit_tile(t)
            assert (g in (128, *symstore._SUB_TILES)) == (r == "units")
            assert symstore.plan_kernel(t, dt) == (
                "units" if r == "units" else "core")
        assert symstore.matvec_route(t, torch.float32) == "float"
        assert symstore.plan_kernel(t, torch.float64) == "core"
    for name, routes in _kernels.ROUTED.items():
        for r in (*routes, "mma", "units", "float"):
            assert _kernels.route_key(name, r) in _kernels.LAUNCHES


SUPER_TILES = ((16, 13), (32, 9), (48, 5), (64, 5), (96, 3), (144, 3),
               (48, 16), (16, 41))
SUPER_TOL = 1e-5   # relative to the largest |output|: f64 walk vs f32 sums
SUPER_STRIPES = (64, 32, 16)   # csrc/tri_matvec_mma.cuh: super_stripe


def _super_stripe(t):
    """kG: the rows of the stripes of t-tiles that route "super" reads,
    the largest of 64, 32, 16 dividing t (a stripe never straddles a
    t-block)."""
    return next(g for g in SUPER_STRIPES if t % g == 0)


class SuperPlan(NamedTuple):
    """Route "super"'s walk of one problem's half, as tri_super_kernel
    (csrc/tri_matvec_mma.cuh: FlatSuper, TileSuper) computes it on the
    card. Super-tile e = (R[e], C[e]), in walk order, is assembled from
    ``boxes[e]``: rows (row0, col0, x, y) of the stage (its 128 x 128
    elements) and of the storage's 2-D view (half 0 of problem 0), each
    ``box`` = (rows, columns) in size; y = -1 marks a box past the view
    (zeros). ``fwd[e, w]`` = [lo, hi): the columns the forward product of
    the 16 rows 16 w.. keeps (none where lo >= hi; rows past m have
    none); ``trn[e, w]``: the transposed product of the 16 columns 16 w..
    keeps the super-tile's rows [0, trn) (none where <= 0): those of row
    blocks r < c, and off the diagonal super-tile also r == c, whose
    mirror lies in the lower super-tile that is not walked."""
    g: int
    ns: int
    box: tuple
    R: np.ndarray
    C: np.ndarray
    boxes: np.ndarray
    fwd: np.ndarray
    trn: np.ndarray


def _super_plan(nt, t, itemsize, layout):
    """Route "super" of kernels 1 ("flat", (P, 2t, S) storage of
    ``itemsize`` bytes an element: 128-byte runs of a row block's stored
    columns) and 9 ("tiles", (P, T, 2t, t): (kG, kG) sub-tile boxes): the
    128-row super-tiles (R, C), C >= R, of the m = nt t matrix in
    row-major order, the boxes that assemble each one's stage, and each
    16-row block's masks."""
    g = _super_stripe(t)
    m = nt * t
    ns = -(-m // 128)
    offs = flattri.tri_tile_offsets(nt)
    if layout == "flat":
        bw = 128 * itemsize // 128            # 128-byte boxes a stripe
        box = (g, 128 // itemsize)
    else:
        bw = 128 // g
        box = (g, g)
    Rs, Cs, boxes, fwd, trn = [], [], [], [], []
    w16 = np.arange(8) * 16
    for R in range(ns):
        for C in range(R, ns):
            Rs.append(R)
            Cs.append(C)
            bx = []
            for a in range(128 // g):
                i0 = 128 * R + a * g
                r = i0 // t
                for b in range(bw):
                    x, y = 0, -1
                    if layout == "flat":
                        col0 = b * box[1]
                        if i0 < m and 128 * C + 128 > r * t:
                            x = offs[r] * t + 128 * C - r * t + col0
                            y = i0 - r * t
                    else:
                        col0 = b * g
                        j0 = 128 * C + col0
                        c = j0 // t
                        if i0 < m and j0 < m and c >= r:
                            x = j0 - c * t
                            y = (offs[r] + c - r) * 2 * t + i0 - r * t
                    bx.append((a * g, col0, x, y))
            boxes.append(bx)
            i = 128 * R + w16
            r = i // t
            lo = np.maximum(r * t - 128 * C, 0)
            hi = np.full_like(lo, min(m - 128 * C, 128))
            lo = np.where(i < m, lo, hi)
            fwd.append(np.stack([lo, hi], 1))
            j = 128 * C + w16
            trn.append(np.where(j < m, (j // t + (C > R)) * t - 128 * R, 0))
    return SuperPlan(g, ns, box, np.asarray(Rs), np.asarray(Cs),
                     np.asarray(boxes, np.int64), np.asarray(fwd, np.int64),
                     np.asarray(trn, np.int64))


def _super_walk(store, nt, t, idx, U, layout):
    """Route "super"'s walk of kernels 1 ("flat") and 9 ("tiles") on the
    host, from _super_plan alone: each super-tile's stage is
    assembled from its boxes of the storage's 2-D view (past the view:
    zeros, as the copies; an absent box, y = -1: NaN, which a kept
    fragment would carry into the output), u past m is NaN too, and the
    forward and transposed products keep only the plan's masks. f64 sums
    of int8 codes and bf16-rounded u; returns (MU, CU) each (B, K, m)."""
    P = store.shape[0]
    m = nt * t
    plan = _super_plan(nt, t, store.element_size(), layout)
    view = store.double().numpy().reshape(-1, store.shape[-1])
    rows_q = view.shape[0] // P
    g, w = plan.box
    B, K, _ = U.shape
    n = plan.ns * 128
    Ub = np.full((B, K, n), np.nan)
    Ub[:, :, :m] = U.bfloat16().double().numpy()
    out = np.zeros((B, K, 2, n))
    for b in range(B):
        for h in range(2):
            acc = out[b, :, h]
            for e in range(len(plan.R)):
                R, C = int(plan.R[e]), int(plan.C[e])
                stage = np.zeros((128, 128))
                for row0, col0, x, y in plan.boxes[e]:
                    if y < 0:
                        stage[row0:row0 + g, col0:col0 + w] = np.nan
                        continue
                    y0 = int(idx[b]) * rows_q + h * t + y
                    blk = view[y0:y0 + g, x:x + w]
                    stage[row0:row0 + g, col0:col0 + blk.shape[1]] = blk
                uc = Ub[b, :, 128 * C:128 * C + 128]
                ur = Ub[b, :, 128 * R:128 * R + 128]
                for v in range(8):
                    lo, hi = plan.fwd[e, v]
                    if lo < hi:
                        acc[:, 128 * R + 16 * v:128 * R + 16 * v + 16] += \
                            uc[:, lo:hi] @ stage[16 * v:16 * v + 16,
                                                 lo:hi].T
                    keep = plan.trn[e, v]
                    if keep > 0:
                        acc[:, 128 * C + 16 * v:128 * C + 16 * v + 16] += \
                            ur[:, :keep] @ stage[:keep, 16 * v:16 * v + 16]
    out = out[..., :m] / (127.0 if store.dtype == torch.int8 else 1.0)
    return out[:, :, 0], out[:, :, 1]


@pytest.mark.parametrize("layout", ["flat", "tiles"])
@pytest.mark.parametrize("t,nt", SUPER_TILES)
def test_super_plan_walk_matches_plain_and_jax(t, nt, layout):
    """Route "super" of kernels 1 and 9 (t a multiple of 16 outside 128,
    256, 384, 512) walked on the host from _super_plan: the
    128-row super-tiles, their boxes (kernel 1's 128-byte runs of a row
    block's stored columns, left of r t and past m included; kernel 9's
    sub-tile boxes), the absent boxes and the masks (forward columns from
    r t to m, transposed rows below c t) give, on seeded random int8
    content and u, the plain matvec and the JAX package's
    make_tri_pool_matvec_xla (flat) or make_tri_pool_matvec_tiles_xla
    (tiles) within SUPER_TOL of the largest output; nt t is not a multiple
    of 128 in most cases, and no absent box or u past m reaches a kept
    fragment (they are NaN here)."""
    rng = np.random.default_rng(t * 100 + nt)
    P, B = 2, 3
    K = 3 if layout == "flat" else 1
    m = nt * t
    M = np.triu(np.where(rng.random((P, m, m)) > 0.9,
                         rng.integers(1, 128, (P, m, m)), 0), 1)
    M = M + M.transpose(0, 2, 1) + np.eye(m, dtype=M.dtype) * 127
    C = (M > 0) * 127
    MC = torch.from_numpy(np.concatenate([M, C], 1).astype(np.int8))
    tri = flattri.repack_stacked(MC, t)
    U = torch.from_numpy(rng.random((B, K, m)).astype(np.float32))
    idx = torch.tensor([1, 0, 1], dtype=torch.int32)
    if layout == "flat":
        store = tri
        plain = flattri.tri_pool_matvec_plain(tri, nt, idx, U, torch.float32)
        jfn = jflat.make_tri_pool_matvec_xla(jnp.asarray(tri.numpy()), nt,
                                             jnp.float32)
        jref = jfn(jnp.asarray(idx.numpy()), jnp.asarray(U.numpy()))
    else:
        T = nt * (nt + 1) // 2
        store = tri.view(P, 2 * t, T, t).permute(0, 2, 1, 3).contiguous()
        plain = flattri.tri_tiles_matvec_plain(store, nt, idx, U[:, 0],
                                               torch.float32)
        plain = tuple(x[:, None] for x in plain)
        jfn = jflat.make_tri_pool_matvec_tiles_xla(
            jnp.asarray(store.numpy()), nt, jnp.float32)
        jref = tuple(x[:, None] for x in jfn(jnp.asarray(idx.numpy()),
                                             jnp.asarray(U[:, 0].numpy())))
    got = _super_walk(store, nt, t, idx, U, layout)
    for x, y, z in zip(got, plain, jref):
        assert np.isfinite(x).all()
        scale = float(np.abs(x).max())
        assert np.abs(x - y.double().numpy()).max() <= SUPER_TOL * scale
        assert np.abs(x - np.asarray(z, np.float64)).max() <= \
            SUPER_TOL * scale
    # the plan: every super-tile of the upper triangle once, in row-major
    # order; kernel 9's boxes read each stored sub-tile of a walked
    # super-tile once, and nothing else
    plan = _super_plan(nt, t, 1, layout)
    ns = -(-m // 128)
    assert list(zip(plan.R, plan.C)) == [(R, C) for R in range(ns)
                                          for C in range(R, ns)]
    if layout == "tiles":
        g = plan.g
        at = plan.boxes[plan.boxes[..., 3] >= 0][:, 2:]
        assert len({tuple(v) for v in at.tolist()}) == len(at)
        n = m // g
        assert len(at) == sum(
            1 for I in range(n) for J in range(n)
            if J * g // t >= I * g // t and J * g // 128 >= I * g // 128)
