"""Port parity: the 2D block-sharded engine over torch.distributed.

clipper_tpu_torch.parallel.sharded runs on gloo ranks on the CPU
(clipper_tpu_torch/bench/cpu_mesh_run.py: one group of 4 spawned ranks
for every job, under one timeout, so a hung collective fails the test)
and is held to clipper_tpu's solve_sharded on sharded.make_mesh(shape)
over the virtual CPU devices, on tests/test_parallel.py's scenes: meshes
1x1, 1x2, 2x1 and 2x2 with JAX's masks, u within 1e-8 and F within 1e-6
in f64; padding at m=91; the flat variants; int8 chunked end to end; the
support-overflow exact polish; the multihost mesh; and every rank's u
bit-identical. The block builds and the chunked matvec have no
collective, so they are held in this process, for every (ri, ci).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import clipper_tpu as ct
from clipper_tpu import utils as jutils
from clipper_tpu.parallel import sharded as jsharded
from clipper_tpu_torch.bench import cpu_mesh_run, data, harness
from clipper_tpu_torch.invariants.euclidean import (EuclideanDistance,
                                                    EuclideanDistanceParams)
from clipper_tpu_torch.invariants.pointnormal import (
    PointNormalDistance, PointNormalDistanceParams)
from clipper_tpu_torch.ops.affinity import score_pairwise_consistency
from clipper_tpu_torch.parallel import sharded
from clipper_tpu_torch.solvers import msrc_flat

from test_parallel import INV as JINV
from test_parallel import dense_solve, make_problem

INV = EuclideanDistance(EuclideanDistanceParams(sigma=0.015, epsilon=0.05))
PN_PARAMS = dict(sigp=0.03, epsp=0.06, sign=0.05, epsn=0.15)
PN_INV = PointNormalDistance(PointNormalDistanceParams(**PN_PARAMS))
SHAPES = [(1, 1), (1, 2), (2, 1), (2, 2)]
VARIANTS = {"nested": dict(solver="nested"), "probes8": dict(probes=8),
            "bf16": dict(storage_dtype=torch.bfloat16),
            "int8": dict(storage_dtype=torch.int8)}
JVARIANTS = {"nested": dict(solver="nested"), "probes8": dict(probes=8),
             "bf16": dict(storage_dtype=jnp.bfloat16),
             "int8": dict(storage_dtype=jnp.int8)}
CHUNKED = dict(storage_dtype=torch.int8, probes=4, power_steps=2,
               build_chunk=16)


def _scene(seed, **kw):
    rng = np.random.default_rng(seed)
    D1, D2, A = make_problem(rng, **kw)
    return D1, D2, A, rng.uniform(size=A.shape[0])


def _f32(D1, D2, A, u0):
    return (D1.astype(np.float32), D2.astype(np.float32), A,
            u0.astype(np.float32))


def _pn_scene():
    from clipper_tpu.bench import harness as jharness
    rng = np.random.default_rng(5)
    D1, D2, A, _ = jharness.make_pointnormal_problem(rng, n=60, m=96,
                                                     rho=0.5, noise=0.002)
    return np.asarray(D1), np.asarray(D2), np.asarray(A, np.int32), \
        rng.uniform(size=96)


def _bunny():
    rng = np.random.default_rng(11)
    pcd0 = harness.load_bunny().astype(np.float32)
    pcd1, A, Agt = harness.make_problem(pcd0, 512, 0.9, rng)
    u0 = np.asarray(jutils.randvec(jax.random.PRNGKey(0), 512,
                                   dtype=jnp.float32))
    return pcd0, pcd1.astype(np.float32), A.astype(np.int32), u0, Agt


def _job(scene, mesh, **kw):
    D1, D2, A, u0 = scene
    return dict(kind="sharded", D1=D1, D2=D2, A=A, u0=u0, mesh=mesh,
                invariant=kw.pop("invariant", INV), **kw)


def _jobs():
    """(name, job) of every 2D-engine job, run on one group of 4 ranks."""
    jobs = [(f"dense-{s}", _job(_scene(2, m=96), s)) for s in SHAPES]
    jobs.append(("pad", _job(_scene(3, m=91), (2, 2))))
    jobs.append(("pad-1x4", _job(_scene(3, m=91), (1, 4))))
    jobs.append(("pointnormal", _job(_pn_scene(), (2, 2),
                                     invariant=PN_INV)))
    jobs += [(f"variant-{k}", _job(_scene(6, m=96), (2, 2), **kw))
             for k, kw in VARIANTS.items()]
    jobs.append(("int8-chunked",
                 _job(_f32(*_scene(13, n_inliers=30)), (2, 2), support=64,
                      **CHUNKED)))
    jobs.append(("overflow", _job(_f32(*_scene(21, n_inliers=30)), (2, 2),
                                  support=8, **CHUNKED)))
    jobs.append(("overflow-1x1", _job(_f32(*_scene(21, n_inliers=30)),
                                      (1, 1), support=8, **CHUNKED)))
    pcd0, pcd1, A, u0, _ = _bunny()
    jobs.append(("multihost", _job((pcd0, pcd1, A, u0), "multihost",
                                   local_world_size=2)))
    return jobs


@pytest.fixture(scope="module")
def port():
    """{name: every rank's result} of every job, on one group of 4 gloo
    ranks under a 240 s timeout."""
    jobs = _jobs()
    got = cpu_mesh_run.run_all(4, [j for _, j in jobs], timeout=240.0)
    return {name: [got[r][i] for r in range(4)]
            for i, (name, _) in enumerate(jobs)}


def _rank0(results):
    """Rank 0's result, after checking every rank of the mesh returned a
    bit-identical u, the same mask and the same polish branch."""
    ref = results[0]
    members = [r for r in results if r is not None]
    for r in members:
        np.testing.assert_array_equal(r["u"], ref["u"])
        np.testing.assert_array_equal(r["mask"], ref["mask"])
        assert r["stats"]["polish_branch"] == ref["stats"]["polish_branch"]
        assert r["score"] == ref["score"] and r["ifinal"] == ref["ifinal"]
    return ref, len(members)


def _jax_solve(scene, shape, inv=JINV, **kw):
    D1, D2, A, u0 = scene
    return jsharded.solve_sharded(inv, D1, D2, A, u0, ct.Params(),
                                  jsharded.make_mesh(shape), **kw)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_matches_jax(port, shape):
    """f64: JAX's masks on the same mesh, u within 1e-8 and F within 1e-6
    of it and of the dense solve; every rank of the mesh agrees."""
    got, n = _rank0(port[f"dense-{shape}"])
    assert n == shape[0] * shape[1]
    assert got["stats"]["mesh"] == list(shape)
    scene = _scene(2, m=96)
    ref = _jax_solve(scene, shape)
    u_ref, F_ref, mask_ref = dense_solve(*scene)
    assert got["u"].dtype == np.float64
    np.testing.assert_array_equal(got["mask"], np.asarray(ref.mask))
    np.testing.assert_array_equal(got["mask"], mask_ref)
    np.testing.assert_allclose(got["u"], np.asarray(ref.u), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got["u"], u_ref, rtol=0, atol=1e-8)
    assert abs(got["score"] - float(ref.score)) < 1e-6
    assert abs(got["score"] - F_ref) < 1e-6


@pytest.mark.parametrize("name", ["pad", "pad-1x4"])
def test_sharded_padding_exactness(port, name):
    """m=91 padded to 92 (2x2) or 92 (1x4): exact against the dense solve
    and JAX's 2x4 mesh."""
    got, _ = _rank0(port[name])
    scene = _scene(3, m=91)
    u_ref, F_ref, mask_ref = dense_solve(*scene)
    ref = _jax_solve(scene, (2, 4))
    assert got["u"].shape == (91,)
    np.testing.assert_allclose(got["u"], u_ref, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(got["mask"], mask_ref)
    np.testing.assert_array_equal(got["mask"], np.asarray(ref.mask))


def test_sharded_pointnormal_matches_dense(port):
    """The point-normal invariant's score_block on a 2x2 mesh: u within
    1e-8 of JAX's dense nested solve."""
    got, _ = _rank0(port["pointnormal"])
    D1, D2, A, u0 = _pn_scene()
    jinv = ct.PointNormalDistance(ct.PointNormalDistanceParams(**PN_PARAMS))
    M, C = ct.score_pairwise_consistency(jinv, jnp.asarray(D1),
                                         jnp.asarray(D2), jnp.asarray(A))
    u_ref, _, _ = ct.find_dense_clique(M, C, jnp.asarray(u0), ct.Params())
    np.testing.assert_allclose(got["u"], np.asarray(u_ref), rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_sharded_flat_variants_match_dense(port, name):
    """As tests/test_parallel.py, on a 2x2 mesh: nested and probes=8 in
    f64 exact against the dense solve; every variant with JAX's masks on
    the same mesh and F within 1e-6 relative of it. Reduced storage
    (int8, bf16) perturbs the entries: JAX's own int8 mask on this 2x2
    mesh has IoU 25/31 with the dense one (its 0.85 bar held on its 2x4
    mesh), so the dense bar (IoU >= 0.85, F within 5%) is held where
    JAX's same-mesh solve meets it."""
    got, _ = _rank0(port[f"variant-{name}"])
    scene = _scene(6, m=96)
    u_ref, F_ref, mask_ref = dense_solve(*scene)
    ref = _jax_solve(scene, (2, 2), **JVARIANTS[name])
    np.testing.assert_array_equal(got["mask"], np.asarray(ref.mask))
    assert abs(got["score"] - float(ref.score)) <= 1e-6 * float(ref.score)
    if "storage_dtype" not in VARIANTS[name]:
        np.testing.assert_array_equal(got["mask"], mask_ref)
        np.testing.assert_allclose(got["u"], u_ref, rtol=0, atol=1e-8)
        assert abs(got["score"] - F_ref) < 1e-6
        return

    def iou(mask):
        a, b = set(np.flatnonzero(mask)), set(np.flatnonzero(mask_ref))
        return len(a & b) / len(a | b)

    if iou(np.asarray(ref.mask)) >= 0.85:
        assert iou(got["mask"]) >= 0.85
        assert abs(got["score"] - F_ref) / F_ref < 0.05


@pytest.mark.parametrize("name", ["int8-chunked", "overflow",
                                  "overflow-1x1"])
def test_sharded_int8_chunked_and_overflow(port, name):
    """The chunked int8 build, probes=4 and the polish: the planted clique
    of 30 recovered and F consistent with it; support=8 (below the
    clique) takes the exact branch, its f64 partials summed over the
    ranks, and support=64 the top-k one. JAX's masks on its 2x4 mesh
    within 2 vertices."""
    got, _ = _rank0(port[name])
    seed = 13 if name == "int8-chunked" else 21
    sel = set(np.flatnonzero(got["mask"]))
    assert len(sel & set(range(30))) >= 26, sel
    assert len(sel - set(range(30))) <= 3, sel
    assert 20 <= got["score"] <= 35
    assert got["stats"]["polish_branch"] == ("support" if seed == 13
                                             else "exact")
    ref = _jax_solve(_f32(*_scene(seed, n_inliers=30)), (2, 4),
                     storage_dtype=jnp.int8, probes=4, power_steps=2,
                     build_chunk=16, support=64 if seed == 13 else 8)
    assert int((got["mask"] != np.asarray(ref.mask)).sum()) <= 2


def test_sharded_overflow_polish_equals_exact_objective(port):
    """The exact branch's F on 4 ranks equals one rank's to f32 rounding,
    and the dense f64 rebuild's u'(M + I)u within 1e-3."""
    many, _ = _rank0(port["overflow"])
    one, _ = _rank0(port["overflow-1x1"])
    D1, D2, A, _ = _f32(*_scene(21, n_inliers=30))
    M, _ = score_pairwise_consistency(INV, torch.from_numpy(D1).double(),
                                      torch.from_numpy(D2).double(),
                                      torch.from_numpy(A))
    for got in (many, one):
        u = torch.from_numpy(got["u"]).double()
        F_ref = float(u @ (M @ u) + u @ u)
        assert abs(got["score"] - F_ref) < 1e-3, (got["score"], F_ref)


def test_sharded_engine_runs_on_multihost_mesh(port):
    """make_mesh_multihost with two ranks a node: a 2x2 mesh, and the
    bunny at m=512 at tests/test_parallel.py's bar (P > 0.97, R > 0.8)."""
    got, n = _rank0(port["multihost"])
    assert n == 4 and got["stats"]["mesh"] == [2, 2]
    _, _, A, _, Agt = _bunny()
    p, r = data.get_precision_recall(A[got["mask"]], Agt)
    assert p > 0.97 and r > 0.8


def test_make_mesh_shapes_without_a_group():
    """The squarest factorisation, the multihost split, and one rank with
    no collective when no process group is initialized."""
    assert sharded._squarest(8) == (2, 4)
    assert sharded._squarest(4) == (2, 2)
    assert sharded._squarest(7) == (1, 7)
    assert sharded.multihost_shape(8, 4) == (2, 4)
    assert sharded.multihost_shape(8, 1) == (8, 1)
    assert sharded.multihost_shape(8, 8) == (1, 8)
    with pytest.raises(ValueError, match="nodes"):
        sharded.multihost_shape(8, 3)
    mesh = sharded.make_mesh()
    assert mesh.shape == (1, 1) and mesh.member and (mesh.ri, mesh.ci) == (0, 0)
    assert mesh.group is None and mesh.col_group is None
    assert sharded.make_mesh_multihost().shape == (1, 1)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        sharded.make_mesh((1, 2))
    assert sharded._padded_size(91, 2, 4) == 92
    assert sharded._padded_size(91, 3, 2) == 96


def _endpoints(scene, dtype=torch.float64):
    D1, D2, A, _ = scene
    At = torch.from_numpy(np.asarray(A, np.int32))
    P1 = torch.as_tensor(D1, dtype=dtype)[At[:, 0].long()]
    P2 = torch.as_tensor(D2, dtype=dtype)[At[:, 1].long()]
    return P1, P2, At


def _assemble(blocks, R, C):
    return torch.cat([torch.cat(blocks[ri * C:(ri + 1) * C], dim=1)
                      for ri in range(R)])


@pytest.mark.parametrize("shape", [(2, 4), (3, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["euclidean", "pointnormal"])
def test_blocks_assemble_to_dense_build(kind, shape):
    """Each rank's (ri, ci) block (no collective in the build) tiles into
    the dense build: C exact, M within 1e-12 of JAX's dense build and
    bit-equal to the port's, and M symmetric bit for bit (the (i, j)
    score on one rank equals the (j, i) score on another)."""
    R, C = shape
    if kind == "euclidean":
        scene, inv, jinv = _scene(4, m=96), INV, JINV
    else:
        scene, inv = _pn_scene(), PN_INV
        jinv = ct.PointNormalDistance(
            ct.PointNormalDistanceParams(**PN_PARAMS))
    P1, P2, A = _endpoints(scene)
    m = A.shape[0]
    mr, mc = m // R, m // C
    blocks = [sharded._affinity_block(inv, P1, P2, A, m, mr, mc, 1e-4, ri,
                                      ci)
              for ri in range(R) for ci in range(C)]
    M = _assemble([b[0] for b in blocks], R, C)
    Cm = _assemble([b[1] for b in blocks], R, C)
    torch.testing.assert_close(M, M.T, rtol=0, atol=0)
    Mt, Ct = score_pairwise_consistency(inv, torch.from_numpy(scene[0]),
                                        torch.from_numpy(scene[1]), A)
    torch.testing.assert_close(M, Mt, rtol=0, atol=0)
    torch.testing.assert_close(Cm, Ct, rtol=0, atol=0)
    Mj, Cj = ct.score_pairwise_consistency(jinv, jnp.asarray(scene[0]),
                                           jnp.asarray(scene[1]),
                                           jnp.asarray(scene[2]))
    np.testing.assert_array_equal(Cm.numpy(), np.asarray(Cj))
    np.testing.assert_allclose(M.numpy(), np.asarray(Mj), rtol=0, atol=1e-12)


@pytest.mark.parametrize("storage", [torch.int8, torch.bfloat16],
                         ids=["int8", "bf16"])
def test_stored_build_bitmatches_plain_block(storage):
    """The chunked direct-to-storage build (build_chunk=16) is
    bit-identical to quantizing the full-precision block, on every block
    of a 2x4 mesh with m=96 padded from 96, f32 endpoints; the assembled
    int8 storage has JAX's C half exactly."""
    scene = _f32(*_scene(9))
    P1, P2, A = _endpoints(scene, torch.float32)
    m, R, C = 96, 2, 4
    mr, mc = m // R, m // C
    for ri in range(R):
        for ci in range(C):
            Mb, Cb = sharded._affinity_block(INV, P1, P2, A, m, mr, mc, 1e-4,
                                             ri, ci)
            MC = torch.cat([Mb, Cb])
            plain = (msrc_flat.quantize_stacked(MC) if storage == torch.int8
                     else MC.to(storage))
            chunked = sharded._affinity_block_stored(
                INV, P1, P2, A, m, mr, mc, 1e-4, storage, ri, ci,
                build_chunk=16)
            assert chunked.dtype == storage
            torch.testing.assert_close(chunked, plain, rtol=0, atol=0)
    if storage == torch.int8:
        mesh = jsharded.make_mesh((R, C))
        Pj = [jnp.asarray(x) for x in (P1.numpy(), P2.numpy(), A.numpy())]

        def body(P1, P2, A):
            return jsharded._affinity_block_stored(JINV, P1, P2, A, m, mr,
                                                   mc, 1e-4, jnp.int8, 16)

        ref = np.asarray(jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(P(), P(), P()), out_specs=P("r", "c"),
            check_vma=False))(*Pj))
        ours = np.concatenate([np.concatenate([
            sharded._affinity_block_stored(INV, P1, P2, A, m, mr, mc, 1e-4,
                                           storage, ri, ci, 16).numpy()
            for ci in range(C)], axis=1) for ri in range(R)])
        # each (2 mr, mc) block stacks its M rows over its C rows
        c_half = np.concatenate([ours[ri * 2 * mr + mr:(ri + 1) * 2 * mr]
                                 for ri in range(R)])
        c_ref = np.concatenate([ref[ri * 2 * mr + mr:(ri + 1) * 2 * mr]
                                for ri in range(R)])
        np.testing.assert_array_equal(c_half, c_ref)


@pytest.mark.parametrize("storage", [None, torch.float32, torch.bfloat16,
                                     torch.int8],
                         ids=["f64", "f32", "bf16", "int8"])
def test_chunked_matvec_matches_unchunked(storage):
    """matvec_chunk slices the rows before the cast (the whole f32 block
    is never made): (Mu, Cu) and the (m, K) form equal to the unchunked
    matvec bit for bit in f64 and f32 storage and within JAX's rtol=1e-6,
    atol=1e-8 in bf16 and int8; and the f64 1x1 matvec within 1e-12 of
    JAX's on a 2x4 mesh."""
    scene = _scene(11, m=96)
    P1, P2, A = _endpoints(scene)
    m = 96
    mesh = sharded.make_mesh()
    MC = sharded._affinity_block_stored(INV, P1, P2, A, m, m, m, 1e-4,
                                        storage or torch.float64, 0, 0, 32)
    U = torch.from_numpy(np.random.default_rng(11).uniform(size=(m, 3)))
    whole = sharded.sharded_dual_matvec(MC, m, m, torch.float64, mesh)
    chunked = sharded.sharded_dual_matvec(MC, m, m, torch.float64, mesh,
                                          matvec_chunk=16)
    exact = storage in (None, torch.float32)
    for u in (U[:, 0], U):
        for a, b in zip(chunked(u), whole(u)):
            assert a.shape == u.shape
            if exact:
                torch.testing.assert_close(a, b, rtol=0, atol=0)
            else:
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)
    # at 1 x 1 the engine's matvec is the dense flat engine's
    for a, b in zip(whole(U), msrc_flat.make_stacked_matvec(
            MC, torch.float64)(U)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    if storage is None:
        jmesh = jsharded.make_mesh((2, 4))
        Pj = [jnp.asarray(x) for x in (P1.numpy(), P2.numpy(), A.numpy(),
                                       U[:, 0].numpy())]

        def body(P1, P2, A, u):
            MCj = jsharded._affinity_block_stored(JINV, P1, P2, A, m, 48, 24,
                                                  1e-4, P1.dtype, 32)
            return jsharded.sharded_dual_matvec(MCj, 48, 24, P1.dtype)(u)

        ref = jax.jit(jax.shard_map(body, mesh=jmesh,
                                    in_specs=(P(), P(), P(), P()),
                                    out_specs=(P(), P()),
                                    check_vma=False))(*Pj)
        for a, b in zip(whole(U[:, 0]), ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-12)


def test_solve_sharded_options():
    """One rank, no group: bad solver raises; DSD rounds NONZERO; stats
    carry the stage times, the mesh and the storage bytes."""
    from clipper_tpu_torch.types import Params, Rounding
    scene = _scene(2, m=96)
    with pytest.raises(ValueError, match="solver"):
        sharded.solve_sharded(INV, *scene, solver="bfs", device="cpu")
    stats = {}
    sol = sharded.solve_sharded(INV, *scene, Params(rounding=Rounding.DSD),
                                device="cpu", stats=stats)
    np.testing.assert_array_equal(sol.mask.numpy(), sol.u.numpy() > 0)
    assert {"build", "init", "solve", "polish"} <= set(stats)
    assert stats["mesh"] == [1, 1] and stats["polish_branch"] is None
    assert stats["storage_bytes"] == 2 * 96 * 96 * 8
