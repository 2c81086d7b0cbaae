"""The port's CUDA kernels: build plumbing, and kernel-vs-plain on a GPU.

This file imports no JAX, so on a machine with a GPU and no JAX it runs
without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tests marked ``cuda`` skip where torch.cuda.is_available() is false.
"""

import shutil

import numpy as np
import pytest
import torch

from clipper_tpu_torch import _kernels
from clipper_tpu_torch.bench import build_probe, harness
from clipper_tpu_torch.ops import (affinity_pallas, flattri, fused_matvec,
                                   symstore)
from clipper_tpu_torch.ops.affinity import gather_endpoints
from clipper_tpu_torch.parallel import pool
from clipper_tpu_torch.types import Params


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _problems(W, m, seed):
    rng = np.random.default_rng(seed)
    pcd0 = harness.load_bunny().astype(np.float32)
    probs = [harness.make_problem(pcd0, m, 0.9, rng) for _ in range(W)]
    return (pcd0, np.stack([p[0] for p in probs]).astype(np.float32),
            np.stack([p[1] for p in probs]).astype(np.int32),
            [p[2] for p in probs])


def test_every_source_is_built():
    on_disk = {p.stem for p in _kernels.CSRC.glob("*.cu")}
    assert on_disk == set(_kernels.SOURCES)
    # every source's launches are counted, and the capacity matvecs'
    # reductions, the matvecs' CUDA-core routes and kernels 1 and 9's
    # super-tile route under their own keys
    assert set(_kernels.REDUCTIONS) <= set(_kernels.SOURCES)
    assert set(_kernels.ROUTED) <= set(_kernels.SOURCES)
    assert set(_kernels.LAUNCHES) == (set(_kernels.SOURCES)
                                      | set(_kernels.REDUCTIONS.values())
                                      | {f"{k}_{r}" for k, rs in
                                         _kernels.ROUTED.items()
                                         for r in rs})
    # the build kernels are compiled without FMA contraction
    for name in ("tri_build", "tri_build_fused", "stored_build",
                 "affinity_build", "build_probe"):
        assert "--fmad=false" in _kernels.SOURCES[name]
    names = {_kernels._target(n).name for n in _kernels.SOURCES}
    assert len(names) == len(_kernels.SOURCES)
    assert all(_kernels._target(n).parent == _kernels.BUILD_DIR
               for n in _kernels.SOURCES)


def test_wrappers_reject_cpu_tensors():
    tri = torch.zeros(1, 256, 128, dtype=torch.int8)
    with pytest.raises(ValueError, match="on the card"):
        flattri.tri_pool_matvec_cuda(tri, 1, torch.zeros(1, dtype=torch.int32),
                                     torch.zeros(1, 1, 128), torch.float32)
    P = torch.zeros(1, 128, 3)
    with pytest.raises(ValueError, match="on the card"):
        flattri.build_tri_cuda(harness.default_invariant(), P, P,
                               torch.zeros(1, 128, 2, dtype=torch.int32),
                               torch.tensor([128]), t=128)
    with pytest.raises(NotImplementedError, match="EuclideanDistance"):
        flattri.build_tri_cuda(object(), P, P, None, None)


def test_tri_matvec_probe_edits_apply():
    """The kernel 1 probe's variants are edits of the current kernel body
    (the header kernels 1 and 9 share): each applies, and each differs
    from the kernel as built."""
    from clipper_tpu_torch.bench import tri_matvec_probe
    src = tri_matvec_probe.variant_sources()
    assert set(src) == set(tri_matvec_probe.VARIANTS)
    assert src["full"] == (_kernels.CSRC / "tri_matvec_mma.cuh").read_text()
    assert '#include "tri_matvec_mma.cuh"' in (
        _kernels.CSRC / "tri_matvec.cu").read_text()
    for name in ("nocompute", "noforward", "notransposed"):
        assert src[name] != src["full"]
    assert src["nocompute"].count("if (false) {") == 2
    for name in ("noforward", "notransposed"):
        assert src[name].count("if (false) {") == 1


def test_tri_matvec_route_probe_edits_apply():
    """The probe's ``--routes`` variants (kernel 1's super-tile and
    CUDA-core routes) are edits of the current headers: each but ``full``
    edits one header, which differs from the package's."""
    from clipper_tpu_torch.bench import tri_matvec_probe
    src = tri_matvec_probe.route_sources()
    assert {n.split("-")[0] for n in src} == {"super", "core"}
    for name, files in src.items():
        assert len(files) == (0 if name.endswith("-full") else 1)
        for fname, text in files.items():
            assert text != (_kernels.CSRC / fname).read_text()
            assert fname == ("tri_matvec_mma.cuh" if name.startswith("super")
                             else "tri_matvec_core.cuh")


def test_sym_unit_probe_edits_apply():
    """The capacity kernels' probe variants are edits of the current
    header: each applies, and each differs from the header as built."""
    from clipper_tpu_torch.bench import sym_unit_probe
    src = sym_unit_probe.variant_sources()
    assert set(src) == set(sym_unit_probe.VARIANTS) and src["full"] == {}
    for name in sym_unit_probe.VARIANTS[1:]:
        (fname, text), = src[name].items()
        assert text != (_kernels.CSRC / fname).read_text()
    header = {name: files.get("sym_tile_mma.cuh", "")
              for name, files in src.items()}
    assert header["nocompute"].count("if (false) bf16mma::") == 2
    for name in ("noforward", "notransposed"):
        assert header[name].count("if (false) bf16mma::") == 1
    assert header["nof64"].count("== -1e30f)") == 2
    assert header["reduceonly"].count("if (false) {") == 1
    assert "0x43434343u" not in src["noconv"]["bf16_mma.cuh"]


def test_parent_ab_refuses_a_checkout_without_the_sources(tmp_path):
    """The parent comparison of kernel 9 and the build kernels stops
    before any build where the other checkout lacks their sources."""
    from clipper_tpu_torch.bench import parent_ab
    with pytest.raises(SystemExit, match="lacks"):
        parent_ab.build_parent(str(tmp_path))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    if shutil.which("nvcc"):
        pytest.skip("nvcc is installed here")
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "CUDA_BIN", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build_all()


@pytest.mark.cuda
@pytest.mark.parametrize("m,t", [(512, 256), (384, 128)])
def test_kernels_match_plain(cuda, m, t):
    W = 4
    pcd0, D2s, As, _ = _problems(W, m, seed=4)
    P1, P2 = gather_endpoints(torch.from_numpy(pcd0).to(cuda),
                              torch.from_numpy(D2s).to(cuda),
                              torch.from_numpy(As).to(cuda))
    A = torch.from_numpy(As).to(cuda)
    mts = torch.tensor([m, m, 300, m], device=cuda)
    inv = harness.default_invariant()
    launches = dict(_kernels.LAUNCHES)
    tk = flattri.build_tri(inv, P1, P2, A, mts, t=t)
    tp = flattri.build_tri_plain(inv, P1, P2, A, mts, t=t)
    assert torch.equal(tk[:, t:], tp[:, t:])
    # the kernel takes the plain build's IEEE f32 steps (no FMA
    # contraction, round half to even): no M code may differ
    assert int((tk[:, :t].int() != tp[:, :t].int()).sum()) == 0
    gen = torch.Generator(device=cuda).manual_seed(0)
    for K in (1, 16, 20):
        U = torch.rand(8, K, m, generator=gen, device=cuda)
        U /= torch.linalg.vector_norm(U, dim=-1, keepdim=True)
        idx = torch.randint(0, W, (8,), generator=gen, device=cuda,
                            dtype=torch.int32)
        a = flattri.make_tri_pool_matvec(tk, m // t, torch.float32)(idx, U)
        b = flattri.tri_pool_matvec_plain(tk, m // t, idx, U, torch.float32)
        for x, y in zip(a, b):
            assert float((x - y).abs().max()) <= 1e-4
        # a rerun reproduces the output bit for bit (no atomics)
        again = flattri.make_tri_pool_matvec(tk, m // t, torch.float32)(idx,
                                                                        U)
        assert all(torch.equal(x, y) for x, y in zip(a, again))
    assert _kernels.LAUNCHES["tri_build"] == launches["tri_build"] + 1
    assert _kernels.LAUNCHES["tri_matvec"] > launches["tri_matvec"]


@pytest.mark.cuda
def test_pipeline_cuda_matches_cpu(cuda):
    W, m = 8, 512
    pcd0, D2s, As, _ = _problems(W, m, seed=5)
    u0 = np.random.default_rng(6).random((W, m)).astype(np.float32)
    out = {}
    for dev in (cuda, "cpu"):
        pipe = pool.make_pool_pipeline(
            harness.default_invariant(), Params(), lanes=4, window=2,
            power_steps=4, tri_probes=16, d_scale=0.15, device=dev)
        out[str(dev)] = pipe(pcd0, D2s, As, u0).mask.cpu().numpy()
    masks = list(out.values())
    assert (masks[0] == masks[1]).all(1).sum() >= W - 1


# the capacity kernels' shapes: nt = 8, 5, 9 and 36 (none but 8 a multiple
# of the unit's R = 8 row blocks; 36 past its S = 32 column blocks)
SYM_SHAPES = [(1024, 8), (640, 2), (1152, 4), (4608, 32)]


def _unit_rows(gen, K, m, dtype=torch.float32):
    U = torch.rand(K, m, generator=gen, device=gen.device, dtype=dtype)
    return U / torch.linalg.vector_norm(U, dim=-1, keepdim=True)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("m,G", SYM_SHAPES)
def test_sym_rows_kernel_matches_plain(cuda, m, G, storage):
    """Kernel 3 against its plain version on bunny storage, int8 and bf16,
    at K = 1, 5, 16 and 20 (two launches), within 1e-4; a rerun (its device
    plan made anew) is bit-identical; one launch per 16 columns, and as
    many of the reduction. With int8, the f32 and f64 storage kinds too."""
    t = 128
    nt = m // t
    inv = harness.default_invariant()
    P1, P2, A = _capacity_endpoints(cuda, m, seed=7)
    chunks = symstore.build_symchunks(inv, P1, P2, A, m, tile=t, G=G,
                                      storage_dtype=storage)
    plan = symstore.rows_device_plan(chunks, nt)
    gen = torch.Generator(device=cuda).manual_seed(0)
    before = _kernels.LAUNCHES["sym_rows_matvec"]
    before_red = _kernels.LAUNCHES["sym_rows_reduce"]
    for K in (1, 5, 16, 20):
        U = _unit_rows(gen, K, m)
        a = symstore.sym_rows_matvec_cuda(chunks, nt, U, plan=plan)
        b = symstore.sym_rows_matvec_plain(chunks, nt, U)
        assert a.dtype == torch.float32 and a.shape == (K, 2 * m)
        assert float((a - b).abs().max()) <= 1e-4
        assert torch.equal(a, symstore.sym_rows_matvec_cuda(chunks, nt, U))
    assert _kernels.LAUNCHES["sym_rows_matvec"] == before + 2 * (1 + 1 + 1 + 2)
    assert _kernels.LAUNCHES["sym_rows_reduce"] == (before_red
                                                    + 2 * (1 + 1 + 1 + 2))
    if storage != torch.int8:
        return
    for dtype in (torch.float32, torch.float64):
        cf = symstore.build_symchunks(inv, P1.to(dtype), P2.to(dtype), A, m,
                                      tile=t, G=G, storage_dtype=dtype)
        U = _unit_rows(gen, 4, m, dtype)
        a = symstore.sym_rows_matvec_cuda(cf, nt, U)
        b = symstore.sym_rows_matvec_plain(cf, nt, U)
        assert float((a - b).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("m", [256, 200])
@pytest.mark.parametrize("storage", [torch.int8, torch.bfloat16])
def test_stored_build_kernel_matches_plain(cuda, m, storage):
    """Kernel 4 against its plain version, m_true < m on one problem:
    every code equal (the same IEEE f32 steps), the output equal to its
    transpose, one launch."""
    W = 3
    pcd0, D2s, As, _ = _problems(W, m, seed=8)
    P1, P2 = gather_endpoints(torch.from_numpy(pcd0).to(cuda),
                              torch.from_numpy(D2s).to(cuda),
                              torch.from_numpy(As).to(cuda))
    A = torch.from_numpy(As).to(cuda)
    mts = torch.tensor([m, m - 37, m], device=cuda)
    inv = harness.default_invariant()
    before = _kernels.LAUNCHES["stored_build"]
    got = affinity_pallas.stored_build(inv, P1, P2, A, mts,
                                       storage_dtype=storage)
    assert _kernels.LAUNCHES["stored_build"] == before + 1
    ref = affinity_pallas.stored_build(inv, P1.cpu(), P2.cpu(), A.cpu(),
                                       mts.cpu(), storage_dtype=storage)
    assert got.shape == (W, 2 * m, m) and got.dtype == storage
    assert torch.equal(got[:, m:].cpu(), ref[:, m:])
    assert int((got[:, :m].cpu() != ref[:, :m]).sum()) == 0
    for half in (got[:, :m], got[:, m:]):
        assert torch.equal(half, half.transpose(1, 2))
    # sliced (non-contiguous) inputs build as their contiguous copies do
    k = m - 8
    mk = torch.full((W,), k, device=cuda)
    a = affinity_pallas.stored_build(inv, P1[:, :k], P2[:, :k], A[:, :k], mk,
                                     storage_dtype=storage)
    b = affinity_pallas.stored_build(inv, P1[:, :k].contiguous(),
                                     P2[:, :k].contiguous(),
                                     A[:, :k].contiguous(), mk,
                                     storage_dtype=storage)
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [256, 203])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pattern_matvec_kernel_matches_plain(cuda, m, dtype):
    """Kernel 5 against its plain version within 1e-4 (f32 sums in another
    fixed order), on aligned rows and on m = 203, whose rows are not
    16-byte aligned; a rerun is bit-identical."""
    B = 4
    gen = torch.Generator(device=cuda).manual_seed(1)
    M = torch.rand(B, m, m, generator=gen, device=cuda)
    M = torch.where(M > 0.8, M, 0.0).to(dtype)
    u = torch.rand(B, m, generator=gen, device=cuda)
    before = _kernels.LAUNCHES["pattern_matvec"]
    a = fused_matvec.pattern_dual_matvec(M, u)
    assert _kernels.LAUNCHES["pattern_matvec"] == before + 1
    b = fused_matvec.pattern_dual_matvec_plain(M, u)
    for x, y in zip(a, b):
        assert x.dtype == torch.float32
        assert float((x - y).abs().max()) <= 1e-4
    again = fused_matvec.pattern_dual_matvec(M, u)
    assert all(torch.equal(x, y) for x, y in zip(a, again))


def _capacity_endpoints(cuda, m, seed, dtype=torch.float32):
    pcd0, D2s, As, _ = _problems(1, m, seed=seed)
    P1, P2 = gather_endpoints(torch.from_numpy(pcd0).to(cuda, dtype),
                              torch.from_numpy(D2s[0]).to(cuda, dtype),
                              torch.from_numpy(As[0]).to(cuda))
    return P1, P2, torch.from_numpy(As[0]).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.int8, torch.bfloat16,
                                     torch.float32, torch.float64])
@pytest.mark.parametrize("m", [m for m, _ in SYM_SHAPES])
def test_sym_tiles_kernel_matches_plain(cuda, m, storage):
    """Kernel 7 against its plain version at t=128, K = 1, 5, 16 and 20
    (two column groups), on the whole list and on D=3 slices (their raw
    sums added, then rounded once), within 1e-4; a rerun (its device plan
    made anew) is bit-identical; one launch a call, and one of the
    reduction (the float kinds' CUDA-core kernel has one too)."""
    t = 128
    nt = m // t
    inv = harness.default_invariant()
    fdt = torch.float64 if storage == torch.float64 else torch.float32
    P1, P2, A = _capacity_endpoints(cuda, m, seed=9, dtype=fdt)
    tiles = symstore.build_symtiles(inv, P1, P2, A, m, tile=t,
                                    storage_dtype=storage)
    plan = symstore.tiles_device_plan(tiles, nt)
    slices = []
    for rank in range(3):
        rows, cols = symstore._shard_coords(nt, 3, rank, "xla", 32)
        tl = symstore._build_tiles_at(inv, P1, P2, A, rows, cols, m, t, 1e-4,
                                      storage, 64)
        slices.append((tl, rows, cols,
                       symstore.tiles_device_plan(tl, nt, rows, cols)))
    gen = torch.Generator(device=cuda).manual_seed(2)
    for K in (1, 5, 16, 20):
        U = _unit_rows(gen, K, m, fdt)
        before = _kernels.LAUNCHES["sym_tiles_matvec"]
        before_red = _kernels.LAUNCHES["sym_tiles_reduce"]
        a = symstore.sym_tiles_matvec_cuda(tiles, nt, U, plan=plan)
        assert _kernels.LAUNCHES["sym_tiles_matvec"] == before + 1
        assert _kernels.LAUNCHES["sym_tiles_reduce"] == before_red + 1
        b = symstore.sym_tiles_matvec_plain(tiles, nt, U)
        assert a.dtype == torch.float32 and a.shape == (K, 2 * m)
        assert float((a - b).abs().max()) <= 1e-4
        assert torch.equal(a, symstore.sym_tiles_matvec_cuda(tiles, nt, U))
        acc = sum(symstore.sym_tiles_matvec_cuda(tl, nt, U, r, c, raw=True,
                                                 plan=p)
                  for tl, r, c, p in slices)
        summed = symstore._finish(acc, symstore._scale(storage))
        assert float((summed - b).abs().max()) <= 1e-4


def _dense_rows_oracle(chunks, nt, U):
    """The rows matvec in f64 through the dense [M; C] of row-chunked
    storage (int8 codes times bf16-rounded u over 127, bf16 values
    exactly)."""
    NC, two_t, Gt = chunks.shape
    t = two_t // 2
    m = nt * t
    first = symstore.row_first_chunk(nt, Gt // t)
    D = torch.zeros(2 * m, m, dtype=torch.float64, device=chunks.device)
    for r in range(nt):
        seg = chunks[int(first[r]):int(first[r + 1])].permute(1, 0, 2)
        seg = seg.reshape(two_t, -1)[:, :(nt - r) * t].double()
        for h in range(2):
            half = seg[h * t:(h + 1) * t]
            D[h * m + r * t:h * m + (r + 1) * t, r * t:] = half
            D[h * m + (r + 1) * t:h * m + m, r * t:(r + 1) * t] = \
                half[:, t:].T
    Uc, scale = symstore._operand(chunks.dtype, U)
    return (Uc.double() @ D.T) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("t", [7, 16, 32, 48, 64, 96, 100, 192, 256, 512])
def test_capacity_kernels_every_tile(cuda, storage, t):
    """Kernels 3 and 7 at t = 16, 32, 48, 64, 96, 192 (the unit kernel over
    super-tiles of 64-, 32- and 16-row tiles), 256, 512 (over 128-row
    tiles) and 7, 100 (the CUDA-core kernel of csrc/sym_core.cuh), one
    problem of m = t (1024 // t), rows at G=3, K = 16, 1, 5 and 17 (two
    groups): within 1e-4 of the plain versions, 1.1e-5 of an f64 oracle,
    raw sums (rounded once) likewise, on the whole storage and over D=3
    slices summed; reruns bit-identical; launches under the route's key
    (the rows wrapper one a 16 columns, the tile list one a call) and as
    many of the reduction. At t = 64 the f32 and f64 storage kinds too."""
    m = t * (1024 // t)
    nt = m // t
    G = 3
    inv = harness.default_invariant()
    P1, P2, A = _capacity_endpoints(cuda, m, seed=t)
    chunks = symstore.build_symchunks(inv, P1, P2, A, m, tile=t, G=G,
                                      storage_dtype=storage)
    tiles = symstore.build_symtiles(inv, P1, P2, A, m, tile=t,
                                    storage_dtype=storage)
    route = symstore.matvec_route(t, storage)
    assert route == ("units" if t % 16 == 0 else "core")
    scale = symstore._scale(storage)
    gen = torch.Generator(device=cuda).manual_seed(t)
    for K in (16, 1, 5, 17):
        U = _unit_rows(gen, K, m)
        oracle = _dense_rows_oracle(chunks, nt, U)
        for name, run, plain, calls in (
                ("sym_rows_matvec",
                 lambda **kw: symstore.sym_rows_matvec_cuda(chunks, nt, U,
                                                            **kw),
                 symstore.sym_rows_matvec_plain(chunks, nt, U), -(-K // 16)),
                ("sym_tiles_matvec",
                 lambda **kw: symstore.sym_tiles_matvec_cuda(tiles, nt, U,
                                                             **kw),
                 symstore.sym_tiles_matvec_plain(tiles, nt, U), 1)):
            key = _kernels.route_key(name, route)
            other = _kernels.route_key(name, "core" if route == "units"
                                       else "units")
            red = _kernels.REDUCTIONS[name]
            before = {k: _kernels.LAUNCHES[k] for k in (key, other, red)}
            a = run()
            assert _kernels.LAUNCHES[key] == before[key] + calls
            assert _kernels.LAUNCHES[red] == before[red] + calls
            assert _kernels.LAUNCHES[other] == before[other]
            assert a.dtype == torch.float32 and a.shape == (K, 2 * m)
            assert float((a - plain).abs().max()) <= 1e-4
            assert torch.equal(a, run())
            assert float((a.double() - oracle).abs().max()) <= 1.1e-5
            raw = run(raw=True)
            assert raw.dtype == torch.float64
            assert torch.equal(symstore._finish(raw, scale), a)
        # D=3 slices: the tile list's shard slices, the chunk ranges
        acc = 0
        for rank in range(3):
            rows, cols = symstore._shard_coords(nt, 3, rank, "xla", 32)
            tl = symstore._build_tiles_at(inv, P1, P2, A, rows, cols, m, t,
                                          1e-4, storage, 64)
            acc = acc + symstore.sym_tiles_matvec_cuda(tl, nt, U, rows, cols,
                                                       raw=True)
        summed = symstore._finish(acc, scale)
        assert float((summed - plain).abs().max()) <= 1e-4
        acc = 0
        for rank in range(3):
            base, crs, cc0, _, _ = symstore._shard_coords(nt, 3, rank,
                                                          "pallas", G)
            ch = symstore.build_symchunks(inv, P1, P2, A, m, tile=t, G=G,
                                          storage_dtype=storage,
                                          chunk_coords=(crs, cc0))
            acc = acc + symstore.sym_rows_matvec_cuda(ch, nt, U, base,
                                                      raw=True)
        summed = symstore._finish(acc, scale)
        ref = symstore.sym_rows_matvec_plain(chunks, nt, U)
        assert float((summed - ref).abs().max()) <= 1e-4
    if t != 64 or storage != torch.int8:
        return
    for dtype in (torch.float32, torch.float64):
        Pf1, Pf2 = P1.to(dtype), P2.to(dtype)
        for store, run, plain in (
                (symstore.build_symchunks(inv, Pf1, Pf2, A, m, tile=t, G=G,
                                          storage_dtype=dtype),
                 symstore.sym_rows_matvec_cuda,
                 symstore.sym_rows_matvec_plain),
                (symstore.build_symtiles(inv, Pf1, Pf2, A, m, tile=t,
                                         storage_dtype=dtype),
                 symstore.sym_tiles_matvec_cuda,
                 symstore.sym_tiles_matvec_plain)):
            U = _unit_rows(gen, 17, m, dtype)
            a = run(store, nt, U)
            assert float((a - plain(store, nt, U)).abs().max()) <= 1e-4
            assert torch.equal(a, run(store, nt, U))


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.int8, torch.bfloat16,
                                     torch.float64])
@pytest.mark.parametrize("m,G", [(1024, 8), (1152, 4)])
def test_sym_rows_kernel_on_slices(cuda, storage, m, G):
    """Kernel 3 over D=3 chunk slices against its plain version on the same
    slices, and their raw sums against the whole list's (kernel and plain),
    within 1e-4 after the one rounding; reruns bit-identical."""
    t = 128
    nt = m // t
    inv = harness.default_invariant()
    fdt = torch.float64 if storage == torch.float64 else torch.float32
    P1, P2, A = _capacity_endpoints(cuda, m, seed=10, dtype=fdt)
    whole = symstore.build_symchunks(inv, P1, P2, A, m, tile=t, G=G,
                                     storage_dtype=storage)
    gen = torch.Generator(device=cuda).manual_seed(3)
    U = _unit_rows(gen, 16, m, fdt)
    ref = symstore.sym_rows_matvec_plain(whole, nt, U)
    raw_whole = symstore.sym_rows_matvec_cuda(whole, nt, U, raw=True)
    scale = symstore._scale(storage)
    acc = 0
    for rank in range(3):
        base, crs, cc0, _, _ = symstore._shard_coords(nt, 3, rank, "pallas", G)
        ch = symstore.build_symchunks(inv, P1, P2, A, m, tile=t, G=G,
                                      storage_dtype=storage,
                                      chunk_coords=(crs, cc0))
        k = symstore.sym_rows_matvec_cuda(ch, nt, U, base, raw=True)
        assert torch.equal(k, symstore.sym_rows_matvec_cuda(ch, nt, U, base,
                                                            raw=True))
        p = symstore.sym_rows_matvec_plain(ch, nt, U, base, raw=True)
        assert k.dtype == torch.float64
        err = symstore._finish(k, scale) - symstore._finish(p, scale)
        assert float(err.abs().max()) <= 1e-4
        acc = acc + k
    summed = symstore._finish(acc, scale)
    assert float((summed - ref).abs().max()) <= 1e-4
    assert float((summed - symstore._finish(raw_whole, scale)).abs().max()) \
        <= 1e-4


def _pointnormal_problems(W, m, seed):
    """W point-normal problems (per-problem datasets), float32."""
    rng = np.random.default_rng(seed)
    probs = [harness.make_pointnormal_problem(rng, n=400, m=m, rho=0.9)
             for _ in range(W)]
    return tuple(np.stack([p[i] for p in probs]).astype(
        np.float32 if i < 2 else np.int32) for i in range(3))


@pytest.mark.cuda
def test_pointnormal_builds_match_plain(cuda):
    """Kernels 2, 8 and 4 on point-normal problems (m=256, t=128; m_true <
    m on one) equal to their plain versions on the card (the same IEEE
    steps and CUDA library functions); the fused build byte-equal to the
    per-tile build; one launch each."""
    W, m, t = 3, 256, 128
    D1s, D2s, As = _pointnormal_problems(W, m, seed=11)
    P1, P2 = gather_endpoints(torch.from_numpy(D1s).to(cuda),
                              torch.from_numpy(D2s).to(cuda),
                              torch.from_numpy(As).to(cuda))
    A = torch.from_numpy(As).to(cuda)
    mts = torch.tensor([m, 200, m], device=cuda)
    inv = harness.pointnormal_invariant()
    before = dict(_kernels.LAUNCHES)
    tk = flattri.build_tri(inv, P1, P2, A, mts, t=t)
    tf = flattri.build_tri_pallas_fused(inv, P1, P2, A, mts, t=t)
    sk = affinity_pallas.stored_build(inv, P1, P2, A, mts)
    for name in ("tri_build", "tri_build_fused", "stored_build"):
        assert _kernels.LAUNCHES[name] == before[name] + 1
    assert torch.equal(tk, tf)
    for got, ref, half in (
            (tk, flattri.build_tri_plain(inv, P1, P2, A, mts, t=t), t),
            (sk, affinity_pallas.stored_from_endpoints(
                inv, P1, P2, A, m_true=mts), m)):
        assert bool(ref[:, half:].any()) and torch.equal(got, ref)
    for h in (sk[:, :m], sk[:, m:]):
        assert torch.equal(h, h.transpose(1, 2))


def _bits(x):
    """A float tensor's bits, for byte equality (-0.0 and NaN included)."""
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["euclidean", "pointnormal"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [1, 63, 64, 65, 203, 256, 1000])
def test_affinity_build_kernel_matches_plain(cuda, kind, dtype, m):
    """Kernel 6 against its plain version on the card, M and C byte-equal
    (the same IEEE steps and CUDA library functions), a zero diagonal,
    one launch a call, a rerun bit-identical: on the gate-edge plants in
    the working precision (harness.gate_boundary_endpoints) and, from
    m=203, on a bunny or point-normal problem, with affinityeps 1e-4, 0
    and -1 (C = 1 on the zero-score distinct pairs); m=1, 63, 64, 65 and
    203 put the tiles' edges and the unaligned rows (m % 4, m odd) to
    work."""
    if kind == "euclidean":
        inv = harness.default_invariant()
    else:
        inv = harness.pointnormal_invariant()
    P1, P2, A, plants = harness.gate_boundary_endpoints(
        inv, 1, m, 12 + m, dtype=np.float64 if dtype == torch.float64
        else np.float32)
    inputs = [tuple(torch.from_numpy(x[0]).to(cuda) for x in (P1, P2, A))]
    if m >= 203:
        if kind == "euclidean":
            pcd0, D2s, As, _ = _problems(1, m, seed=12)
            D1, D2, A = pcd0, D2s[0], As[0]
        else:
            D1s, D2s, As = _pointnormal_problems(1, m, seed=12)
            D1, D2, A = D1s[0], D2s[0], As[0]
        At = torch.from_numpy(A).to(cuda)
        inputs.append(gather_endpoints(torch.from_numpy(D1).to(cuda, dtype),
                                       torch.from_numpy(D2).to(cuda, dtype),
                                       At) + (At,))
    for P1, P2, At in inputs:
        for affeps in (1e-4, 0.0, -1.0):
            before = _kernels.LAUNCHES["affinity_build"]
            M, C = affinity_pallas.build_affinity_pallas(
                inv, P1, P2, At, affinityeps=affeps)
            assert _kernels.LAUNCHES["affinity_build"] == before + 1
            Mp, Cp = affinity_pallas.pairwise_from_endpoints(
                inv, P1, P2, At, affinityeps=affeps)
            assert M.dtype == C.dtype == dtype and M.shape == (m, m)
            assert torch.equal(_bits(C), _bits(Cp))
            assert torch.equal(_bits(M), _bits(Mp))
            assert not M.diagonal().any() and not C.diagonal().any()
            if m >= 203:
                assert int((C > 0).sum()) > m
            M2, C2 = affinity_pallas.affinity_build_cuda(
                inv, P1, P2, At, affinityeps=affeps)
            assert torch.equal(_bits(M2), _bits(M))
            assert torch.equal(_bits(C2), _bits(C))
    assert m < 203 or len(plants) >= 10


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.int8, torch.bfloat16,
                                     torch.float32, torch.float64])
@pytest.mark.parametrize("t", [256, 128, 16, 64, 512])
def test_tri_tiles_kernel_matches_plain(cuda, storage, t):
    """Kernel 9 against its plain version and against kernel 1 on the
    same content (the flat storage's tile-major view), within 1e-4 (1e-12
    for f64 storage, summed in f64); a rerun is bit-identical; one launch
    a call, under its route's key (flattri.matvec_route)."""
    W, m = 4, 512
    nt = m // t
    pcd0, D2s, As, _ = _problems(W, m, seed=13)
    fdt = torch.float64 if storage == torch.float64 else torch.float32
    P1, P2 = gather_endpoints(torch.from_numpy(pcd0).to(cuda, fdt),
                              torch.from_numpy(D2s).to(cuda, fdt),
                              torch.from_numpy(As).to(cuda))
    A = torch.from_numpy(As).to(cuda)
    inv = harness.default_invariant()
    flat = flattri.build_tri_plain(
        inv, P1, P2, A, torch.full((W,), m, device=cuda), t=t,
        storage_dtype=(storage if storage in (torch.int8, torch.bfloat16)
                       else None))
    T = nt * (nt + 1) // 2
    tiles = flat.view(W, 2 * t, T, t).permute(0, 2, 1, 3).contiguous()
    gen = torch.Generator(device=cuda).manual_seed(4)
    U = torch.rand(6, m, generator=gen, device=cuda, dtype=fdt)
    U /= torch.linalg.vector_norm(U, dim=-1, keepdim=True)
    idx = torch.tensor([3, 0, 1, 3, 2, 0], device=cuda, dtype=torch.int32)
    key = _kernels.route_key("tri_tiles_matvec",
                              flattri.matvec_route(t, storage))
    before = _kernels.LAUNCHES[key]
    a = flattri.make_tri_pool_matvec_tiles(tiles, nt, fdt)(idx, U)
    assert _kernels.LAUNCHES[key] == before + 1
    b = flattri.tri_tiles_matvec_plain(tiles, nt, idx, U, fdt)
    c = flattri.make_tri_pool_matvec(flat, nt, fdt)(idx, U)
    tol = 1e-12 if storage == torch.float64 else 1e-4
    for x, y, z in zip(a, b, c):
        assert x.dtype == fdt and x.shape == (6, m)
        assert float((x - y).abs().max()) <= tol
        assert float((x - z).abs().max()) <= tol
    again = flattri.make_tri_pool_matvec_tiles(tiles, nt, fdt)(idx, U)
    assert all(torch.equal(x, y) for x, y in zip(a, again))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [65, 1000, 1024])
def test_build_probe_kernel_matches_plain(cuda, m):
    """The five variants of the build probe at B=4 (m=65 and 1000: edge
    tiles, rows of no 16-byte multiple): full byte-equal to kernel 4 and
    to its plain version, writeonly all zeros, and every variant with the
    C half byte-equal to its plain version and M codes within one (0
    expected: the same IEEE f32 steps); one launch a call."""
    B = 4
    P1, P2, A = (torch.from_numpy(x).to(cuda)
                 for x in build_probe.make_inputs(B, m, seed=2))
    ref = affinity_pallas.stored_build_cuda(
        harness.default_invariant(), P1, P2, A,
        torch.full((B,), m, device=cuda))
    for variant in build_probe.VARIANTS:
        before = _kernels.LAUNCHES["build_probe"]
        got = build_probe.build_probe(variant, P1, P2, A)
        assert _kernels.LAUNCHES["build_probe"] == before + 1
        assert got.shape == (B, 2 * m, m) and got.dtype == torch.int8
        plain = build_probe.build_probe_plain(variant, P1, P2, A)
        assert torch.equal(got[:, m:], plain[:, m:])
        assert int((got[:, :m].int() - plain[:, :m].int()).abs().max()) <= 1
        if variant == "full":
            assert torch.equal(got, ref) and torch.equal(got, plain)
        if variant == "writeonly":
            assert not got.any()
        else:
            assert bool(got[:, m:].any())


def _random_tri(P, t, nt, storage, cuda, seed):
    """(P, 2t, S) storage of random symmetric [M; C] content at 10%
    density: int8 codes 0..127 (C 127) or bf16 values in (0, 1] (C 1)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    m = t * nt
    M = torch.rand(P, m, m, generator=g, device=cuda)
    M = torch.triu(torch.where(M > 0.9, M, 0.0), 1)
    M = M + M.transpose(1, 2)
    C = (M > 0).float()
    if storage == torch.int8:
        M, C = torch.round(M * 127), C * 127
    return flattri.repack_stacked(torch.cat([M, C], 1), t).to(storage)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("t,nt", [(128, 1), (256, 1), (128, 4), (256, 4),
                                  (128, 9), (256, 9), (128, 16),
                                  (256, 16), (16, 8), (64, 4), (100, 5),
                                  (384, 3), (512, 1), (512, 4), (32, 9),
                                  (48, 5), (144, 3)])
def test_tri_matvec_kernel_every_shape(cuda, storage, t, nt):
    """Kernel 1 at every tile and width the pool uses (nt up to 16: m <=
    2048 at t=128, m <= 4096 at t=256) and at tiles of its other routes
    (16, 32, 48, 64, 144: tensor cores over 128-row super-tiles, m not a
    multiple of 128 at 32, 48 and 144; 100: CUDA cores; 384, 512: tensor
    cores at the tile), K = 1, 5, 16 and 17 (two launches): within 1e-4
    of its plain version and 1.1e-5 of an f64 oracle on the same content
    and bf16-rounded u; a rerun is bit identical; one launch a 16
    candidates, under its route's key."""
    P, B = 3, 5
    m = t * nt
    tri = _random_tri(P, t, nt, storage, cuda, seed=nt)
    scale = 1 / 127 if storage == torch.int8 else 1.0
    gen = torch.Generator(device=cuda).manual_seed(7)
    idx = torch.tensor([2, 0, 1, 2, 0], device=cuda, dtype=torch.int32)
    for K in (1, 5, 16, 17):
        U = torch.rand(B, K, m, generator=gen, device=cuda)
        U /= torch.linalg.vector_norm(U, dim=-1, keepdim=True)
        key = _kernels.route_key("tri_matvec",
                                  flattri.matvec_route(t, storage))
        before = _kernels.LAUNCHES[key]
        a = flattri.tri_pool_matvec_cuda(tri, nt, idx, U, torch.float32)
        assert _kernels.LAUNCHES[key] == before + (K + 15) // 16
        b = flattri.tri_pool_matvec_plain(tri, nt, idx, U, torch.float32)
        o = flattri.tri_pool_matvec_plain(tri.double(), nt, idx,
                                          U.bfloat16().double(),
                                          torch.float64)
        for x, y, z in zip(a, b, o):
            assert x.shape == (B, K, m) and x.dtype == torch.float32
            assert float((x - y).abs().max()) <= 1e-4
            assert float((x.double() - z * scale).abs().max()) <= 1.1e-5
        again = flattri.tri_pool_matvec_cuda(tri, nt, idx, U, torch.float32)
        assert all(torch.equal(x, y) for x, y in zip(a, again))


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.float32, torch.float64])
@pytest.mark.parametrize("t,nt", [(64, 4), (100, 5)])
def test_tri_matvecs_float_kinds(cuda, storage, t, nt):
    """Kernels 1 (K = 1, 5, 16 and 17) and 9 over f32 and f64 storage at
    t = 64 and 100 (their CUDA-core kernel, route "float"): within 1e-4 of
    their plain versions (f32; f64: 1e-12) and 1.1e-5 of an f64 oracle on
    the same content (TF32 off); reruns bit-identical; kernel 9 bit-equal
    to kernel 1 at K=1; one launch a 16 candidates, under the kernel's
    own key."""
    P, B = 3, 5
    m = t * nt
    T = nt * (nt + 1) // 2
    tri = _random_tri(P, t, nt, torch.bfloat16, cuda,
                      seed=t + nt).to(storage)
    tiles = tri.view(P, 2 * t, T, t).permute(0, 2, 1, 3).contiguous()
    tol = 1e-12 if storage == torch.float64 else 1e-4
    gen = torch.Generator(device=cuda).manual_seed(11)
    idx = torch.tensor([2, 0, 1, 2, 0], device=cuda, dtype=torch.int32)
    assert flattri.matvec_route(t, storage) == "float"
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for K in (1, 5, 16, 17):
            U = torch.rand(B, K, m, generator=gen, device=cuda,
                           dtype=storage)
            U /= torch.linalg.vector_norm(U, dim=-1, keepdim=True)
            before = _kernels.LAUNCHES["tri_matvec"]
            a = flattri.tri_pool_matvec_cuda(tri, nt, idx, U, storage)
            assert _kernels.LAUNCHES["tri_matvec"] == before + (K + 15) // 16
            b = flattri.tri_pool_matvec_plain(tri, nt, idx, U, storage)
            o = flattri.tri_pool_matvec_plain(tri.double(), nt, idx,
                                              U.double(), torch.float64)
            for x, y, z in zip(a, b, o):
                assert x.shape == (B, K, m) and x.dtype == storage
                assert float((x - y).abs().max()) <= tol
                assert float((x.double() - z).abs().max()) <= 1.1e-5
            again = flattri.tri_pool_matvec_cuda(tri, nt, idx, U, storage)
            assert all(torch.equal(x, y) for x, y in zip(a, again))
            if K != 1:
                continue
            before = _kernels.LAUNCHES["tri_tiles_matvec"]
            c = flattri.tri_tiles_matvec_cuda(tiles, nt, idx, U[:, 0],
                                              storage)
            assert _kernels.LAUNCHES["tri_tiles_matvec"] == before + 1
            d = flattri.tri_tiles_matvec_plain(tiles, nt, idx, U[:, 0],
                                               storage)
            for x, y, z in zip(c, a, d):
                assert torch.equal(x, y[:, 0])
                assert float((x - z).abs().max()) <= tol
            again = flattri.tri_tiles_matvec_cuda(tiles, nt, idx, U[:, 0],
                                                  storage)
            assert all(torch.equal(x, y) for x, y in zip(c, again))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.cuda
@pytest.mark.parametrize("storage,t,nt", [(torch.int8, 2500, 2),
                                          (torch.bfloat16, 2500, 2),
                                          (torch.float32, 4800, 1),
                                          (torch.float64, 7680, 1)])
def test_tri_matvecs_core_past_2048(cuda, storage, t, nt):
    """The CUDA-core kernel of kernels 1 and 9 past t = 2048 (one candidate
    a block, the rest of a u block loaded after the products; t = 7680 is
    its limit, an f64 block filling an SM's shared memory), K = 1 and 16:
    within 1e-4 of the plain versions (f64: 1e-12) and 1.1e-5 of an f64
    oracle; reruns bit-identical; kernel 9 bit-equal to kernel 1 at K=1;
    one launch each, under the route's key."""
    P, B = 2, 3
    m = t * nt
    T = nt * (nt + 1) // 2
    codes = storage in (torch.int8, torch.bfloat16)
    tri = _random_tri(P, t, nt, storage if codes else torch.bfloat16, cuda,
                      seed=t).to(storage)
    tiles = tri.view(P, 2 * t, T, t).permute(0, 2, 1, 3).contiguous()
    out = torch.float32 if codes else storage
    tol = 1e-12 if storage == torch.float64 else 1e-4
    scale = 1 / 127 if storage == torch.int8 else 1.0
    route = flattri.matvec_route(t, storage)
    assert route == ("core" if codes else "float")
    gen = torch.Generator(device=cuda).manual_seed(13)
    idx = torch.tensor([1, 0, 1], device=cuda, dtype=torch.int32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for K in (1, 16):
            U = torch.rand(B, K, m, generator=gen, device=cuda,
                           dtype=out)
            U /= torch.linalg.vector_norm(U, dim=-1, keepdim=True)
            Uo = (U.bfloat16() if codes else U).double()
            for name, fn, store, u in (
                    ("tri_matvec", flattri.tri_pool_matvec_cuda, tri, U),
                    ("tri_tiles_matvec", flattri.tri_tiles_matvec_cuda,
                     tiles, U[:, 0])):
                if name == "tri_tiles_matvec" and K != 1:
                    continue
                key = _kernels.route_key(name, route)
                before = _kernels.LAUNCHES[key]
                got = fn(store, nt, idx, u, out)
                assert _kernels.LAUNCHES[key] == before + 1
                again = fn(store, nt, idx, u, out)
                assert all(torch.equal(x, y) for x, y in zip(got, again))
                if name == "tri_matvec":
                    a = got
                    b = flattri.tri_pool_matvec_plain(tri, nt, idx, U, out)
                    o = flattri.tri_pool_matvec_plain(tri.double(), nt, idx,
                                                      Uo, torch.float64)
                    for x, y, z in zip(a, b, o):
                        assert x.shape == (B, K, m) and x.dtype == out
                        assert float((x - y).abs().max()) <= tol
                        assert float((x.double() - z * scale).abs().max()) \
                            <= 1.1e-5
                else:
                    d = flattri.tri_tiles_matvec_plain(tiles, nt, idx,
                                                       U[:, 0], out)
                    for x, y, z in zip(got, a, d):
                        assert torch.equal(x, y[:, 0])
                        assert float((x - z).abs().max()) <= tol
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["euclidean", "pointnormal"])
def test_tri_builds_bf16_match_plain(cuda, kind):
    """Kernels 2 and 8 writing bf16 storage (m=512, t=256 and t=128; m_true
    < m on one problem): equal to the plain build (C exact, 0 M values
    differing: the same f32 score rounded once to bf16) and to each
    other; one launch each."""
    W, m = 3, 512
    if kind == "euclidean":
        D1, D2s, As, _ = _problems(W, m, seed=14)
        inv = harness.default_invariant()
    else:
        D1, D2s, As = _pointnormal_problems(W, m, seed=14)
        inv = harness.pointnormal_invariant()
    P1, P2 = gather_endpoints(torch.from_numpy(D1).to(cuda),
                              torch.from_numpy(D2s).to(cuda),
                              torch.from_numpy(As).to(cuda))
    A = torch.from_numpy(As).to(cuda)
    mts = torch.tensor([m, 300, m], device=cuda)
    for t in (256, 128):
        before = dict(_kernels.LAUNCHES)
        tk = flattri.build_tri(inv, P1, P2, A, mts, t=t,
                               storage_dtype=torch.bfloat16)
        tf = flattri.build_tri_pallas_fused(inv, P1, P2, A, mts, t=t,
                                            storage_dtype=torch.bfloat16)
        for name in ("tri_build", "tri_build_fused"):
            assert _kernels.LAUNCHES[name] == before[name] + 1
        tp = flattri.build_tri_plain(inv, P1, P2, A, mts, t=t,
                                     storage_dtype=torch.bfloat16)
        assert tk.dtype == torch.bfloat16 and tk.shape == tp.shape
        assert bool(tp[:, t:].any()) and torch.equal(tk[:, t:], tp[:, t:])
        assert int((tk[:, :t] != tp[:, :t]).sum()) == 0
        assert torch.equal(tk, tf)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("t,nt", [(128, 4), (256, 4), (128, 9), (256, 9),
                                  (16, 8), (64, 4), (100, 5), (384, 3),
                                  (512, 2), (32, 9), (48, 5), (144, 3)])
def test_tri_tiles_kernel_equals_tri_matvec_k1(cuda, storage, t, nt):
    """Kernel 9 runs kernel 1's kernel over the tile-major address map (on
    either route): on the tile-major form of some content its output is
    bit-equal to kernel 1's at K=1 on the flat form, within 1e-4 of its
    plain version and 1.1e-5 of an f64 oracle on the same content and
    bf16-rounded u; one launch a call."""
    P, B = 3, 7
    m = t * nt
    T = nt * (nt + 1) // 2
    tri = _random_tri(P, t, nt, storage, cuda, seed=t + nt)
    tiles = tri.view(P, 2 * t, T, t).permute(0, 2, 1, 3).contiguous()
    scale = 1 / 127 if storage == torch.int8 else 1.0
    gen = torch.Generator(device=cuda).manual_seed(9)
    U = torch.rand(B, m, generator=gen, device=cuda)
    U /= torch.linalg.vector_norm(U, dim=-1, keepdim=True)
    idx = torch.tensor([2, 0, 1, 2, 0, 1, 1], device=cuda, dtype=torch.int32)
    key = _kernels.route_key("tri_tiles_matvec",
                              flattri.matvec_route(t, storage))
    before = _kernels.LAUNCHES[key]
    a = flattri.tri_tiles_matvec_cuda(tiles, nt, idx, U, torch.float32)
    assert _kernels.LAUNCHES[key] == before + 1
    c = flattri.tri_pool_matvec_cuda(tri, nt, idx, U[:, None],
                                     torch.float32)
    b = flattri.tri_tiles_matvec_plain(tiles, nt, idx, U, torch.float32)
    o = flattri.tri_pool_matvec_plain(tri.double(), nt, idx,
                                      U.bfloat16().double()[:, None],
                                      torch.float64)
    for x, y, z, w in zip(a, c, b, o):
        assert x.shape == (B, m) and x.dtype == torch.float32
        assert torch.equal(x, y[:, 0])
        assert float((x - z).abs().max()) <= 1e-4
        assert float((x.double() - w[:, 0] * scale).abs().max()) <= 1.1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("kind", ["euclidean", "pointnormal"])
@pytest.mark.parametrize("m", [1000, 1024])
def test_stored_build_kernel_edge_tiles(cuda, kind, storage, m):
    """Kernel 4, each unordered pair scored once, at m=1000 (no 64-row
    tile divides it; in int8 no 16-byte chunk either) and m=1024, with
    m_true < m on three problems: C exact, no M value differing from the
    plain build, the output equal to its transpose; one launch."""
    W = 4
    if kind == "euclidean":
        pcd0, D2s, As, _ = _problems(W, m, seed=14)
        D1 = torch.from_numpy(pcd0).to(cuda)
        inv = harness.default_invariant()
    else:
        D1s, D2s, As = _pointnormal_problems(W, m, seed=14)
        D1 = torch.from_numpy(D1s).to(cuda)
        inv = harness.pointnormal_invariant()
    A = torch.from_numpy(As).to(cuda)
    P1, P2 = gather_endpoints(D1, torch.from_numpy(D2s).to(cuda), A)
    mts = torch.tensor([m, m - 1, 700, 513], device=cuda)
    before = _kernels.LAUNCHES["stored_build"]
    got = affinity_pallas.stored_build(inv, P1, P2, A, mts,
                                       storage_dtype=storage)
    assert _kernels.LAUNCHES["stored_build"] == before + 1
    ref = affinity_pallas.stored_from_endpoints(inv, P1, P2, A, m_true=mts,
                                                storage_dtype=storage)
    assert got.shape == (W, 2 * m, m) and got.dtype == storage
    assert bool(ref[:, m:].any()) and torch.equal(got[:, m:], ref[:, m:])
    assert int((got[:, :m] != ref[:, :m]).sum()) == 0
    for half in (got[:, :m], got[:, m:]):
        assert torch.equal(half, half.transpose(1, 2))


def _endpoints(kind, W, m, seed, cuda):
    """(invariant, P1, P2, A) on the card: W bunny problems at rho=0.9 or
    point-normal ones (per-problem datasets)."""
    if kind == "euclidean":
        pcd0, D2s, As, _ = _problems(W, m, seed)
        D1 = torch.from_numpy(pcd0).to(cuda)
        inv = harness.default_invariant()
    else:
        D1s, D2s, As = _pointnormal_problems(W, m, seed)
        D1 = torch.from_numpy(D1s).to(cuda)
        inv = harness.pointnormal_invariant()
    A = torch.from_numpy(As).to(cuda)
    P1, P2 = gather_endpoints(D1, torch.from_numpy(D2s).to(cuda), A)
    return inv, P1, P2, A


def _hold_tri_builds(inv, P1, P2, A, mts, t, storage):
    """Kernels 2 and 8, one launch each, against the plain build (C exact,
    no M value differing) and byte-equal to each other. Returns kernel
    2's output."""
    before = dict(_kernels.LAUNCHES)
    tk = flattri.build_tri(inv, P1, P2, A, mts, t=t, storage_dtype=storage)
    tf = flattri.build_tri_pallas_fused(inv, P1, P2, A, mts, t=t,
                                        storage_dtype=storage)
    for name in ("tri_build", "tri_build_fused"):
        assert _kernels.LAUNCHES[name] == before[name] + 1
    tp = flattri.build_tri_plain(inv, P1, P2, A, mts, t=t,
                                 storage_dtype=storage)
    assert tk.dtype == storage and tk.shape == tp.shape
    assert bool(tp[:, t:].any()) and torch.equal(tk[:, t:], tp[:, t:])
    assert int((tk[:, :t] != tp[:, :t]).sum()) == 0
    assert torch.equal(tk, tf)
    return tk


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("kind", ["euclidean", "pointnormal"])
@pytest.mark.parametrize("t,nt", [(64, 8), (128, 4), (256, 2), (256, 4),
                                  (200, 5), (100, 5), (16, 6), (384, 3),
                                  (512, 2), (320, 3)])
def test_tri_builds_every_tile(cuda, kind, storage, t, nt):
    """Kernels 2 and 8, each distinct pair scored once over 64-row
    sub-tiles, at t a multiple of 64 and not (t=200 and 100 leave a short
    sub-tile; t=100 and 16 give int8 rows that are no 16-byte multiple,
    written value by value), and past t=256 (384, 512, 320), m_true < m
    on two problems: equal to the plain build and to each other."""
    W, m = 3, t * nt
    inv, P1, P2, A = _endpoints(kind, W, m, t + nt, cuda)
    mts = torch.tensor([m, m - 1, m // 2 + 7], device=cuda)
    _hold_tri_builds(inv, P1, P2, A, mts, t, storage)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("kind", ["euclidean", "pointnormal"])
@pytest.mark.parametrize("t,m", [(200, 1000), (128, 512)])
def test_tri_builds_at_the_gate(cuda, kind, storage, t, m):
    """Kernels 2 and 8 on pairs planted at the score gate's edges
    (harness.gate_boundary_endpoints: the gate's difference at its f32
    bound and one ulp either side, with one length 0 and with both
    non-zero, coincident endpoints, normals whose dot is -1 or rounds
    above 1), m_true < m on one problem: equal to the plain build and to
    each other, the plants kept or dropped as planted."""
    inv = (harness.default_invariant() if kind == "euclidean"
           else harness.pointnormal_invariant())
    P1, P2, A, plants = harness.gate_boundary_endpoints(inv, 3, m, 9)
    P1, P2, A = (torch.from_numpy(x).to(cuda) for x in (P1, P2, A))
    mts = torch.tensor([m, m, m - 3], device=cuda)
    tk = _hold_tri_builds(inv, P1, P2, A, mts, t, storage)
    C = flattri.dense_stacked(tk, m // t)[:, m:]
    kept = {"below", "below_both", "coincident", "antiparallel", "clamp"}
    for i, j, what in plants:
        for w in range(2):
            assert bool(C[w, i, j] > 0) == (what in kept), what
            assert bool(C[w, j, i] > 0) == (what in kept), what


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("kind", ["euclidean", "pointnormal"])
def test_tri_build_fused_stages_by_tile(cuda, kind, storage):
    """Kernel 8's other branch: where a problem's endpoints do not fit in
    shared memory beside its units' stages, each unit stages the two
    sub-tiles of every pair it takes. At the smallest m a multiple of 256
    past the card's limit (m_true < m on one problem), equal to the plain
    build and to kernel 2; at m=1024 the endpoints are staged whole."""
    inv = (harness.default_invariant() if kind == "euclidean"
           else harness.pointnormal_invariant())
    assert flattri.tri_build_fused_whole(1024, inv, storage)
    m = 256
    while flattri.tri_build_fused_whole(m, inv, storage):
        m += 256
    inv, P1, P2, A = _endpoints(kind, 2, m, 3, cuda)
    mts = torch.tensor([m, m - 200], device=cuda)
    _hold_tri_builds(inv, P1, P2, A, mts, 256, storage)


def test_tri_build_probe_edits_apply():
    """The build probe's variants are edits of the current body of
    kernels 2 and 8: each applies, differs from the body as built, and
    keeps its braces balanced."""
    from clipper_tpu_torch.bench import tri_build_probe
    src = tri_build_probe.variant_sources()
    assert set(src) == set(tri_build_probe.VARIANTS)
    assert src["full"] == (_kernels.CSRC / "tri_pair_build.cuh").read_text()
    for name in ("firstpass", "nowrite"):
        assert src[name] != src["full"]
        assert src[name].count("{") == src[name].count("}")
    assert "__shfl_sync" not in src["firstpass"]
    assert "write_staged<T, kStream>(here" not in src["nowrite"]
    for cu in ("tri_build", "tri_build_fused"):
        # the entries include their launch template, which runs the body
        assert f'#include "{cu}.cuh"' in (_kernels.CSRC
                                          / f"{cu}.cu").read_text()
        assert '#include "tri_pair_build.cuh"' in (_kernels.CSRC
                                                   / f"{cu}.cuh").read_text()


def test_dense_build_probe_edits_apply():
    """Kernel 6's probe variants are the body's edits, in the header the
    kernel builds from."""
    from clipper_tpu_torch.bench import tri_build_probe
    files = tri_build_probe.dense_variant_files()
    assert set(files) == set(tri_build_probe.VARIANTS)
    cu = (_kernels.CSRC / "affinity_build.cu").read_text()
    assert '#include "affinity_build.cuh"' in cu
    assert '#include "tri_pair_build.cuh"' in (
        _kernels.CSRC / "affinity_build.cuh").read_text()
    body = (_kernels.CSRC / "tri_pair_build.cuh").read_text()
    assert files["full"] == {"tri_pair_build.cuh": body}
    for name in ("firstpass", "nowrite"):
        assert files[name]["tri_pair_build.cuh"] != body


def _block_scene(m, k, rho, seed):
    from clipper_tpu_torch.bench import blocksparse_bench
    pcd0 = harness.load_bunny().astype(np.float32)
    return blocksparse_bench.build_scene(pcd0, m, k, rho,
                                         np.random.default_rng(seed))


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.int8, torch.bfloat16])
def test_blocksparse_matvec_on_the_card(cuda, storage):
    """The occupied-tile matvec on the card, m=2048, k=4 objects, t=128:
    within 1.1e-5 of an f64 oracle over the same stored values (f32
    products of exact operands, summed in f32), within 1e-4 of the dense
    stacked matvec over the same codes, and a rerun bit-identical (the
    row sums run in a fixed order, no atomics)."""
    from clipper_tpu_torch.ops import blocksparse
    from clipper_tpu_torch.ops.affinity import score_pairwise_consistency
    from clipper_tpu_torch.solvers import msrc_flat
    D1, D2, A, _ = _block_scene(2048, 4, 0.9, seed=0)
    M, C = score_pairwise_consistency(
        harness.default_invariant(), torch.as_tensor(D1, device=cuda),
        torch.as_tensor(D2, device=cuda),
        torch.as_tensor(A, dtype=torch.int32, device=cuda))
    bs, info = blocksparse.from_dense(M, C, tile=128, storage_dtype=storage,
                                      device=cuda)
    assert bs is not None and info["occupancy"] <= 0.5
    _, dense = blocksparse.from_dense(M, C, tile=128, storage_dtype=storage,
                                      max_occupancy=-1.0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    U = torch.rand(info["m_pad"], 16, generator=gen, device=cuda)
    U = U / torch.linalg.vector_norm(U, dim=0)
    mv = blocksparse.make_matvec(bs, info["nt"], torch.float32)
    Mu, Cu = mv(U)
    Mu2, Cu2 = mv(U)
    assert torch.equal(Mu, Mu2) and torch.equal(Cu, Cu2)
    Md, Cd = msrc_flat.make_stacked_matvec(dense["dense"], torch.float32)(U)
    assert float((Mu - Md).abs().max()) <= 1e-4
    assert float((Cu - Cd).abs().max()) <= 1e-4
    scale = 1.0 / 127 if storage == torch.int8 else 1.0
    MC = dense["dense"].double() * scale
    Ur = U.to(torch.bfloat16).double()
    m = info["m_pad"]
    ref = MC @ Ur
    assert float((Mu.double() - ref[:m]).abs().max()) <= 1.1e-5
    assert float((Cu.double() - ref[m:]).abs().max()) <= 1.1e-5


@pytest.mark.cuda
def test_kcore_on_the_card_equals_native(cuda):
    """kcore.core_numbers on the card equals the native host peel, on a
    random graph and on the bunny's constraint graph at m=1024."""
    from clipper_tpu_torch.ops import kcore
    from clipper_tpu_torch.ops.affinity import score_pairwise_consistency
    from clipper_tpu_torch.solvers import maxclique
    adj = np.random.default_rng(3).uniform(size=(500, 500)) < 0.2
    adj = np.triu(adj, 1)
    adj = adj | adj.T
    pcd0, D2s, As, _ = _problems(1, 1024, seed=0)
    _, C = score_pairwise_consistency(
        harness.default_invariant(), torch.as_tensor(pcd0, device=cuda),
        torch.as_tensor(D2s[0], device=cuda),
        torch.as_tensor(As[0], device=cuda))
    for g in (torch.as_tensor(adj, device=cuda), C):
        core = kcore.core_numbers(g)
        assert core.is_cuda
        np.testing.assert_array_equal(core.cpu().numpy(),
                                      maxclique.core_numbers(g.cpu().numpy()))
        mask, _ = kcore.kcore_prune_mask(g)
        assert list(np.flatnonzero(mask.cpu().numpy())) == maxclique.solve(
            g, maxclique.Params(method=maxclique.Method.KCORE))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gathered_block_dsd_equals_host_copy(cuda, dtype):
    """The facade's exact DSD on the card, M[S, S] gathered on the device,
    gives the node set of the DSD of the whole M copied to the host with
    the same support S (bunny m=1024, rho=0.9)."""
    from clipper_tpu_torch import Clipper
    from clipper_tpu_torch.solvers import dsd
    from clipper_tpu_torch.types import Rounding
    pcd0, D2s, As, _ = _problems(1, 1024, seed=4)
    u0 = np.random.default_rng(4).random(1024)
    c = Clipper(harness.default_invariant(), Params(rounding=Rounding.DSD),
                dtype=dtype, device=cuda)
    c.score_pairwise_consistency(pcd0.T, D2s[0].T, As[0])
    sol = c.solve(u0=u0)
    S = np.flatnonzero(sol.u.cpu().numpy() > 0)
    full = dsd.solve(c._M.cpu().numpy(), list(S))
    np.testing.assert_array_equal(sol.nodes, full)


def _planted_sdr(n=40, seed=0):
    rng = np.random.default_rng(seed)
    W = np.triu(rng.uniform(0, 0.2, size=(n, n)) *
                (rng.uniform(size=(n, n)) < 0.2), 1)
    clique = [4, 11, 19, 26, 33, 38]
    for a in range(len(clique)):
        for b in range(a + 1, len(clique)):
            W[clique[a], clique[b]] = 1.0
    M = W + W.T + np.eye(n)
    return M, (M > 0).astype(float), clique


@pytest.mark.cuda
@pytest.mark.parametrize("z_rank", [0, 8])
def test_sdr_on_the_card_equals_cpu(cuda, z_rank):
    """The SDR in f64 on the card and on the CPU (the planted clique of
    tests/test_sdp.py, exact and rank-r Z-steps): equal iterations and
    nodes, pobj and dobj within 1e-9; tensors stay on the card."""
    from clipper_tpu_torch.solvers import sdp
    M, C, clique = _planted_sdr()
    p = sdp.Params(z_rank=z_rank)
    on_card = sdp.solve(M, C, p, device=cuda)
    on_cpu = sdp.solve(M, C, p, device="cpu")
    assert on_card.X.is_cuda and on_card.evec1.is_cuda
    assert on_card.iters == on_cpu.iters
    assert on_card.nodes == on_cpu.nodes == clique
    assert abs(on_card.pobj - on_cpu.pobj) <= 1e-9
    assert abs(on_card.dobj - on_cpu.dobj) <= 1e-9


@pytest.mark.cuda
def test_sdr_refuses_tf32_on_the_card(cuda):
    """An f32 SDR on the card raises while TF32 matmuls are allowed, and
    leaves the flag as it found it."""
    from clipper_tpu_torch.solvers import sdp
    M, C, _ = _planted_sdr()
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            sdp.solve(M.astype(np.float32), C.astype(np.float32),
                      device=cuda)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@pytest.fixture
def nccl_rank(cuda):
    """A 1-rank NCCL group on the card, met through an in-memory store."""
    import torch.distributed as dist
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("m", [1000, 1024])
def test_sharded_block_equals_kernel4_storage(cuda, m, storage):
    """The 2D engine's 1x1 stored block (plain, 64 rows a chunk) is
    byte-equal to kernel 4's stacked storage and to the plain build."""
    from clipper_tpu_torch.ops.affinity import stored_from_endpoints
    from clipper_tpu_torch.parallel import sharded
    pcd0, D2s, As, _ = _problems(1, m, seed=7)
    inv = harness.default_invariant()
    A = torch.as_tensor(As[0], device=cuda)
    P1, P2 = gather_endpoints(torch.as_tensor(pcd0, device=cuda),
                              torch.as_tensor(D2s[0], device=cuda), A)
    blk = sharded._affinity_block_stored(inv, P1, P2, A, m, m, m, 1e-4,
                                         storage, 0, 0, 64)
    k4 = affinity_pallas.stored_build(
        inv, P1[None], P2[None], A[None],
        torch.full((1,), m, dtype=torch.int32, device=cuda),
        storage_dtype=storage)[0]
    assert torch.equal(blk, k4)
    assert torch.equal(blk, stored_from_endpoints(inv, P1, P2, A,
                                                  storage_dtype=storage))


@pytest.mark.cuda
def test_sharded_engine_one_rank_nccl(nccl_rank):
    """The 2D engine on a 1-rank NCCL group (a 1x1 mesh), int8 at m=1024:
    unchunked, its u bit-equal to the flat solver's over kernel 4's
    storage and make_stacked_matvec (the dense flat engine's arithmetic);
    its matvec 256 rows at a time within JAX's chunking tolerance
    (rtol=1e-6, atol=1e-8: cuBLAS may sum a row block in another order);
    the chunked solve's and the CPU run's masks within IoU 0.95."""
    from clipper_tpu_torch.parallel import sharded
    from clipper_tpu_torch.solvers import msrc_flat
    dev = nccl_rank
    m = 1024
    pcd0, D2s, As, _ = _problems(1, m, seed=3)
    u0 = np.random.default_rng(3).random(m).astype(np.float32)
    inv = harness.default_invariant()
    opts = dict(storage_dtype=torch.int8, probes=16, power_steps=4,
                support=512, build_chunk=256)
    mesh = sharded.make_mesh()
    assert mesh.shape == (1, 1) and mesh.group is not None
    stats = {}
    sol = sharded.solve_sharded(inv, pcd0, D2s[0], As[0], u0, Params(), mesh,
                                device=dev, stats=stats, **opts)
    assert sol.u.is_cuda and stats["mesh"] == [1, 1]
    A = torch.as_tensor(As[0], device=dev)
    P1, P2 = gather_endpoints(torch.as_tensor(pcd0, device=dev),
                              torch.as_tensor(D2s[0], device=dev), A)
    MC = affinity_pallas.stored_build(
        inv, P1[None], P2[None], A[None],
        torch.full((1,), m, dtype=torch.int32, device=dev))[0]
    mv = msrc_flat.make_stacked_matvec(MC, torch.float32)
    u = msrc_flat.power_init(mv, torch.as_tensor(u0, device=dev), 4)
    s = msrc_flat.flat_init(mv, u, Params())
    s = msrc_flat.flat_solve_state(mv, s, Params(), probes=16)
    assert torch.equal(sol.u, s.u) and int(sol.ifinal) == int(s.i)
    chunked_mv = sharded.sharded_dual_matvec(MC, m, m, torch.float32, mesh,
                                             matvec_chunk=256)
    U = torch.rand(m, 16, generator=torch.Generator(device=dev)
                   .manual_seed(0), device=dev)
    for a, b in zip(chunked_mv(U), mv(U)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)
    chunked = sharded.solve_sharded(inv, pcd0, D2s[0], As[0], u0, Params(),
                                    mesh, device=dev, matvec_chunk=256,
                                    **opts)
    cpu = sharded.solve_sharded(inv, pcd0, D2s[0], As[0], u0, Params(),
                                sharded.make_mesh(), device="cpu", **opts)
    a = sol.mask.cpu().numpy()
    for other in (chunked.mask.cpu().numpy(), cpu.mask.numpy()):
        assert (a & other).sum() / max(1, (a | other).sum()) >= 0.95


# ---------------------------------------------------------------------------
# an invariant's own device score in kernels 2, 8, 4 and 6 (user_score.cuh)
# ---------------------------------------------------------------------------

# the sample scores at d = 2 (PlanarCauchy: screen, gate and tail), 3 and
# 5 (UserEuclidean: operator() alone), whose plain versions sum lengths in
# coordinate order as their C++ does
USER_SCORES = [("cauchy", 2), ("euclid", 3), ("euclid", 5)]


def _user_invariant(name, d):
    from clipper_tpu_torch.bench import user_scores
    if name == "cauchy":
        return user_scores.PlanarCauchy()
    return user_scores.UserEuclidean(harness.default_invariant().params, d)


def _user_endpoints(d, W, m, seed, cuda, dtype=torch.float32):
    """(P1, P2, A) on the card: W bunny problems at rho=0.9 in d values a
    point: the x, y projection (d = 2), the points (3), or the points and
    d - 3 more coordinates drawn a point and shared by its noisy copy."""
    pcd0, D2s, As, _ = _problems(W, m, seed)
    extra = np.random.default_rng(seed).random(
        (pcd0.shape[0], max(0, d - 3))).astype(np.float32) * 0.2
    D1 = np.concatenate([pcd0, extra], -1)[:, :d]
    D2s = np.concatenate([D2s, np.broadcast_to(extra, D2s.shape[:2]
                                               + extra.shape[1:])], -1)
    A = torch.from_numpy(As).to(cuda)
    P1, P2 = gather_endpoints(torch.from_numpy(D1).to(cuda, dtype),
                              torch.from_numpy(D2s[..., :d]).to(cuda, dtype),
                              A)
    return P1.contiguous(), P2.contiguous(), A


def _user_counts(before, kernel, n):
    """kernel's launches moved by n under its user key, and no other."""
    moved = {k: _kernels.LAUNCHES[k] - before[k] for k in before
             if _kernels.LAUNCHES[k] != before[k]}
    assert moved == {_kernels.route_key(kernel, "user"): n}, moved


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("name,d", USER_SCORES)
@pytest.mark.parametrize("t,nt", [(64, 4), (100, 3), (256, 2)])
def test_user_score_tri_builds_match_plain(cuda, name, d, storage, t, nt):
    """Kernels 2 and 8 over a device score: one launch each under their
    user keys, C exact and 0 M codes differing from the plain build,
    byte-equal to each other, m_true < m on two problems."""
    inv = _user_invariant(name, d)
    W, m = 3, t * nt
    P1, P2, A = _user_endpoints(d, W, m, t + d, cuda)
    mts = torch.tensor([m, m - 37, m - 100], device=cuda)
    before = dict(_kernels.LAUNCHES)
    tk = flattri.build_tri(inv, P1, P2, A, mts, t=t, storage_dtype=storage)
    _user_counts(before, "tri_build", 1)
    before = dict(_kernels.LAUNCHES)
    tf = flattri.build_tri_pallas_fused(inv, P1, P2, A, mts, t=t,
                                        storage_dtype=storage)
    _user_counts(before, "tri_build_fused", 1)
    tp = flattri.build_tri_plain(inv, P1, P2, A, mts, t=t,
                                 storage_dtype=storage)
    assert tk.dtype == storage and tk.shape == tp.shape
    assert bool(tp[:, t:].any()) and torch.equal(tk[:, t:], tp[:, t:])
    assert int((tk[:, :t] != tp[:, :t]).sum()) == 0
    assert torch.equal(tk, tf)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("name,d", USER_SCORES)
@pytest.mark.parametrize("m", [200, 256])
def test_user_score_stored_build_matches_plain(cuda, name, d, storage, m):
    """Kernel 4 over a device score, m_true < m on one problem: byte-equal
    to the plain stacked build, one launch under stored_build_user."""
    inv = _user_invariant(name, d)
    P1, P2, A = _user_endpoints(d, 2, m, m + d, cuda)
    mts = torch.tensor([m, m - 50], device=cuda)
    before = dict(_kernels.LAUNCHES)
    got = affinity_pallas.stored_build(inv, P1, P2, A, mts,
                                       storage_dtype=storage)
    _user_counts(before, "stored_build", 1)
    ref = affinity_pallas.stored_from_endpoints(
        inv, P1, P2, A, m_true=mts, storage_dtype=storage)
    assert bool(ref[:, m:].any()) and torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,d", USER_SCORES)
@pytest.mark.parametrize("m", [65, 203])
def test_user_score_dense_build_matches_plain(cuda, name, d, dtype, m):
    """Kernel 6 over a device score, f32 and f64 (the f64 PlanarCauchy
    takes its exact screen), affinityeps 1e-4, 0 and -1: M and C
    byte-equal to the plain dense build, one launch a call under
    affinity_build_user."""
    inv = _user_invariant(name, d)
    P1, P2, A = _user_endpoints(d, 1, m, m + d, cuda, dtype)
    for affeps in (1e-4, 0.0, -1.0):
        before = dict(_kernels.LAUNCHES)
        M, C = affinity_pallas.build_affinity_pallas(
            inv, P1[0], P2[0], A[0], affinityeps=affeps)
        _user_counts(before, "affinity_build", 1)
        Mp, Cp = affinity_pallas.pairwise_from_endpoints(
            inv, P1[0], P2[0], A[0], affinityeps=affeps)
        assert M.dtype == dtype and bool(Cp.any())
        assert torch.equal(_bits(M), _bits(Mp))
        assert torch.equal(_bits(C), _bits(Cp))


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.int8, torch.bfloat16])
def test_user_euclidean_equals_the_builtin_kernels(cuda, storage):
    """UserEuclidean's kernels 2, 8, 4 and 6 write the built-in
    Euclidean kernels' bytes (its plain arithmetic is the built-in's)."""
    from clipper_tpu_torch.bench import user_scores
    eu = harness.default_invariant()
    ue = user_scores.UserEuclidean(eu.params)
    P1, P2, A = _user_endpoints(3, 2, 512, 4, cuda)
    mts = torch.tensor([512, 450], device=cuda)
    for fn in (flattri.build_tri, flattri.build_tri_pallas_fused):
        assert torch.equal(fn(ue, P1, P2, A, mts, t=256,
                              storage_dtype=storage),
                           fn(eu, P1, P2, A, mts, t=256,
                              storage_dtype=storage))
    assert torch.equal(
        affinity_pallas.stored_build(ue, P1, P2, A, mts,
                                     storage_dtype=storage),
        affinity_pallas.stored_build(eu, P1, P2, A, mts,
                                     storage_dtype=storage))
    for dtype in (torch.float32, torch.float64):
        a, b = (affinity_pallas.build_affinity_pallas(
            inv, P1[0].to(dtype), P2[0].to(dtype), A[0]) for inv in (ue, eu))
        assert torch.equal(_bits(a[0]), _bits(b[0]))


@pytest.mark.cuda
def test_user_score_library_is_cached(cuda):
    """A device score's library is built once: a second lookup, in this
    process or from disk, runs no nvcc."""
    from clipper_tpu_torch.bench import user_scores
    score = user_scores.PlanarCauchy().cuda_score()
    lib = _kernels.user_lib(score)
    assert _kernels.user_target(score).is_file()
    assert _kernels.build_user(score) is None
    assert _kernels.user_lib(score) is lib
    _kernels._USER_LIBS.clear()
    assert _kernels.build_user(score) is None
    assert hasattr(_kernels.user_lib(score), "user_tri_build_int8")


@pytest.mark.cuda
def test_user_score_build_error_raises_with_its_log(cuda, monkeypatch,
                                                    tmp_path):
    """A device score whose source does not compile raises with nvcc's
    log on the card; no plain build runs in its place."""
    from clipper_tpu_torch.bench import user_scores
    from clipper_tpu_torch.invariants import DeviceScore

    class Broken(user_scores.PlanarCauchy):
        def cuda_score(self):
            return DeviceScore("template <typename T> struct Score "
                               "{ this is not C++ };", 2, (1.0, 1.0))

    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    P1, P2, A = _user_endpoints(2, 1, 128, 3, cuda)
    before = dict(_kernels.LAUNCHES)
    with pytest.raises(RuntimeError, match="(?s)nvcc exit .*error"):
        flattri.build_tri(Broken(), P1, P2, A, torch.tensor([128]), t=64)
    assert _kernels.LAUNCHES == before


@pytest.mark.cuda
def test_user_score_at_the_cap_and_the_tile_branch(cuda):
    """d = MAX_USER_D (80-byte records) in kernel 8's sub-tile branch in
    bf16, where its shared memory is fullest, byte-equal to kernel 2; and
    d = 5 at the first m past its whole-problem staging, against the
    plain build."""
    from clipper_tpu_torch.invariants import MAX_USER_D
    for d, storage in ((MAX_USER_D, torch.bfloat16), (5, torch.int8)):
        inv = _user_invariant("euclid", d)
        m = 256
        while flattri.tri_build_fused_whole(m, inv, storage):
            m += 256
        P1, P2, A = _user_endpoints(d, 2, m, d, cuda)
        mts = torch.tensor([m, m - 200], device=cuda)
        tk = flattri.build_tri(inv, P1, P2, A, mts, t=256,
                               storage_dtype=storage)
        tf = flattri.build_tri_pallas_fused(inv, P1, P2, A, mts, t=256,
                                            storage_dtype=storage)
        assert bool(tk[:, 256:].any()) and torch.equal(tk, tf)
        if d <= 8:   # the plain lengths sum in coordinate order to d = 8
            tp = flattri.build_tri_plain(inv, P1, P2, A, mts, t=256,
                                         storage_dtype=storage)
            assert torch.equal(tk, tp)
