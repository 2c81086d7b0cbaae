"""Port parity: the pools and the batched engine over a group of ranks.

make_pool_pipeline(mesh=group) and batched.shard_batch run on 2 gloo
ranks on the CPU (clipper_tpu_torch/bench/cpu_mesh_run.py, one group for
every job under one timeout): the stacked pool on tests/test_pool.py:257's
scene and the tri pool on tests/test_flattri.py:239's, each with the
masks of the port's mesh=None call and, within one problem, of JAX's mesh
pool on the virtual CPU devices; shard_batch with the batched engine on
tests/test_parallel.py:61's scene against JAX's sharded batch; and a
workload that does not split over the ranks raising.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import clipper_tpu as ct
from clipper_tpu import utils as jutils
from clipper_tpu.parallel import batched as jbatched
from clipper_tpu.parallel import pool as jpool
from clipper_tpu_torch.bench import cpu_mesh_run, data, harness
from clipper_tpu_torch.invariants.euclidean import (EuclideanDistance,
                                                    EuclideanDistanceParams)
from clipper_tpu_torch.parallel import batched, pool
from clipper_tpu_torch.types import Params

from test_parallel import INV as JINV
from test_parallel import dense_solve, make_problem

INV = EuclideanDistance(EuclideanDistanceParams(sigma=0.015, epsilon=0.05))
D = 2
# tests/test_pool.py:284-289 (the JAX defaults: stacked, bf16 storage)
STACKED = dict(lanes=4, window=4, power_steps=2, layout="stacked")
# tests/test_flattri.py:257-260
TRI = dict(lanes=2, window=2, power_steps=4, layout="tri", tri_probes=8,
           d_scale=0.15)


def _stacked_scene():
    rng = np.random.default_rng(51)
    W, n, ni, m = 16, 60, 20, 128
    D1 = rng.uniform(size=(n, 3))
    D2s, As = [], []
    for _ in range(W):
        th = rng.uniform(0, np.pi)
        R = np.array([[np.cos(th), -np.sin(th), 0],
                      [np.sin(th), np.cos(th), 0], [0, 0, 1]])
        D2s.append(D1 @ R.T + rng.normal(0, 0.003, size=(n, 3)))
        A = np.zeros((m, 2), dtype=np.int32)
        A[:ni, 0] = A[:ni, 1] = np.arange(ni)
        A[ni:, 0] = rng.integers(0, n, m - ni)
        A[ni:, 1] = rng.integers(0, n, m - ni)
        As.append(A)
    u0s = rng.uniform(size=(W, m)).astype(np.float32)
    return (D1.astype(np.float32), np.stack(D2s).astype(np.float32),
            np.stack(As), u0s)


def _tri_scene():
    rng = np.random.default_rng(7)
    pcd0 = harness.load_bunny()
    B, m = 16, 256
    problems = [harness.make_problem(pcd0, m, 0.9, rng) for _ in range(B)]
    u0s = np.asarray(jax.vmap(
        lambda k: jutils.randvec(k, m, dtype=jnp.float32))(
            jax.random.split(jax.random.PRNGKey(0), B)))
    return ((pcd0.astype(np.float32),
             np.stack([p[0] for p in problems]).astype(np.float32),
             np.stack([p[1] for p in problems]).astype(np.int32), u0s),
            [p[2] for p in problems])


def _batch_scene():
    rng = np.random.default_rng(1)
    B = 8
    problems = [make_problem(rng) for _ in range(B)]
    u0s = rng.uniform(size=(B, 96))
    return (np.stack([p[0] for p in problems]),
            np.stack([p[1] for p in problems]),
            np.stack([p[2] for p in problems]), u0s)


def _pool_job(scene, **opts):
    D1, D2s, As, u0s = scene
    return dict(kind="pool", D1=D1, D2s=D2s, As=As, u0s=u0s, invariant=INV,
                **opts)


@pytest.fixture(scope="module")
def port():
    """Every rank's results of the three jobs on one group of 2 gloo
    ranks, under a 180 s timeout."""
    D1s, D2s, As, u0s = _batch_scene()
    jobs = [_pool_job(_stacked_scene(), storage_dtype=torch.bfloat16,
                      **STACKED),
            _pool_job(_tri_scene()[0], storage_dtype=torch.int8, **TRI),
            dict(kind="batched", D1s=D1s, D2s=D2s, As=As, u0s=u0s,
                 invariant=INV)]
    return cpu_mesh_run.run_all(D, jobs, timeout=180.0)


def _single(scene, **opts):
    pipe = pool.make_pool_pipeline(INV, Params(), device="cpu", **opts)
    return pipe(*scene)


def _check_mesh_pool(results, single, W):
    """Every rank returns the whole W-problem Solution, equal to
    mesh=None's bit for bit (each rank's own loop, one exact gather)."""
    for res in results:
        assert res["u"].shape == single.u.shape and res["u"].shape[0] == W
        np.testing.assert_array_equal(res["mask"], single.mask.numpy())
        np.testing.assert_array_equal(res["u"], single.u.numpy())
        np.testing.assert_array_equal(res["score"], single.score.numpy())
        np.testing.assert_array_equal(res["ifinal"], single.ifinal.numpy())


def test_stacked_pool_mesh_matches_single_device(port):
    """tests/test_pool.py:257 on 2 ranks: the Solution of mesh=None bit
    for bit (JAX's own bar there: masks equal, F within 1e-5), and the
    masks of JAX's 8-device mesh pool on all but one problem (the f32
    pools' bar against JAX, tests/test_torch_pool.py)."""
    scene = _stacked_scene()
    single = _single(scene, storage_dtype=torch.bfloat16, **STACKED)
    _check_mesh_pool([port[r][0] for r in range(D)], single, 16)
    mesh = Mesh(np.array(jax.devices()[:8]), ("b",))
    ref = jpool.make_pool_pipeline(JINV, ct.Params(), lanes=4, window=4,
                                   power_steps=2, mesh=mesh)(
        *(jnp.asarray(x) for x in scene))
    assert (port[0][0]["mask"] == np.asarray(ref.mask)).all(1).sum() >= 15


def test_tri_pool_mesh_matches_quality(port):
    """tests/test_flattri.py:239 on 2 ranks: the masks of mesh=None, of
    JAX's mesh tri pool on all but one problem, and its bar (mean
    P > 0.97, R > 0.8)."""
    scene, Agts = _tri_scene()
    single = _single(scene, storage_dtype=torch.int8, **TRI)
    _check_mesh_pool([port[r][1] for r in range(D)], single, 16)
    mesh = Mesh(np.array(jax.devices()), ("b",))
    ref = jpool.make_pool_pipeline(harness_jax_invariant(), ct.Params(),
                                   storage_dtype=jnp.int8, mesh=mesh,
                                   **TRI)(*(jnp.asarray(x) for x in scene))
    masks = port[0][1]["mask"]
    assert (masks == np.asarray(ref.mask)).all(1).sum() >= 15
    pr = np.array([data.get_precision_recall(scene[2][b][masks[b]], Agts[b])
                   for b in range(16)])
    assert pr[:, 0].mean() > 0.97 and pr[:, 1].mean() > 0.8


def harness_jax_invariant():
    from clipper_tpu.bench import harness as jharness
    return jharness.default_invariant()


def test_shard_batch_with_batched_engine(port):
    """tests/test_parallel.py:61 on 2 ranks: each rank solves its 4 of the
    8 problems; together they are JAX's batch over its 8-device mesh
    (u within 1e-8, equal masks), problem 3 the dense solve's."""
    scene = _batch_scene()
    u = np.concatenate([port[r][2]["u"] for r in range(D)])
    masks = np.concatenate([port[r][2]["mask"] for r in range(D)])
    assert all(port[r][2]["u"].shape == (4, 96) for r in range(D))
    mesh = Mesh(np.array(jax.devices()), ("b",))
    args = jbatched.shard_batch(tuple(jnp.asarray(x) for x in scene), mesh)
    ref = jbatched.make_batched_pipeline(JINV, ct.Params())(*args)
    np.testing.assert_allclose(u, np.asarray(ref.u), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(masks, np.asarray(ref.mask))
    D1s, D2s, As, u0s = scene
    u_ref, _, mask_ref = dense_solve(D1s[3], D2s[3], As[3], u0s[3])
    np.testing.assert_allclose(u[3], u_ref, atol=1e-8)
    np.testing.assert_array_equal(masks[3], mask_ref)


def test_pool_mesh_workload_must_split():
    """W=3 problems on 2 ranks raises on every rank (the JAX assert), and
    fails the run instead of hanging it."""
    D1, D2s, As, u0s = _stacked_scene()
    job = _pool_job((D1, D2s[:3], As[:3], u0s[:3]), **STACKED)
    with pytest.raises(RuntimeError, match="divisible by the mesh size 2"):
        cpu_mesh_run.run(D, [job], timeout=60.0)


def test_rank_rows_and_shard_batch_without_a_group():
    """The split both paths use, and shard_batch on one rank: the whole
    tree, as tensors on the device."""
    assert pool.rank_rows(8, 2, 1) == slice(4, 8)
    assert pool.rank_rows(6, 3, 0) == slice(0, 2)
    with pytest.raises(ValueError, match="batch B=5 must be divisible"):
        pool.rank_rows(5, 2, 0, "batch B")
    tree = {"a": np.arange(6.0).reshape(3, 2), "b": (np.zeros(3),)}
    out = batched.shard_batch(tree, None, device="cpu")
    assert isinstance(out["b"], tuple)
    torch.testing.assert_close(out["a"], torch.arange(6.0,
                                                      dtype=torch.float64)
                               .reshape(3, 2))
