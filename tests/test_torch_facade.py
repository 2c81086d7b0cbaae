"""Port parity: the Clipper facade and its utilities.

Mirrors tests/test_facade.py and tests/test_facade_capacity.py where this
slice covers them: engine routing, the dense engine (f64), the triangle
capacity engine (f32, int8 storage) and the sharded engine on one rank
against clipper_tpu.Clipper from the
same explicit numpy u0, the accessors and their densify guard, seeding,
and the options that are not ported yet.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import clipper_tpu as ct
from clipper_tpu.bench import harness as jharness
from clipper_tpu_torch import CLIPPER, Clipper, EuclideanDistance, utils
from clipper_tpu_torch.bench import data, harness
from clipper_tpu_torch.types import Params, Rounding, Solution

from test_affinity import make_scene


def _scene(m, rho, seed):
    pcd0 = harness.load_bunny()
    pcd1, A, Agt = harness.make_problem(pcd0, m, rho,
                                        np.random.default_rng(seed))
    return pcd0, pcd1, A.astype(np.int32), Agt


def _both(engine, dtype, m, rho, seed, engine_opts=None, jax_opts=None):
    """The same problem and u0 through clipper_tpu.Clipper and the port's
    Clipper (device='cpu'); returns (jax clipper, port clipper, Agt).
    jax_opts are added to the JAX side's engine_opts."""
    pcd0, pcd1, A, Agt = _scene(m, rho, seed)
    u0 = np.random.default_rng(seed + 100).random(m).astype(dtype)
    jc = ct.Clipper(jharness.default_invariant(), ct.Params(),
                    dtype=jnp.dtype(dtype), engine=engine,
                    engine_opts=dict(engine_opts or {}, **(jax_opts or {})))
    jc.score_pairwise_consistency(pcd0.T.astype(dtype), pcd1.T.astype(dtype),
                                  A)
    jc.solve(u0=u0)
    tc = Clipper(harness.default_invariant(), Params(),
                 dtype=torch.from_numpy(u0).dtype, engine=engine,
                 device="cpu", engine_opts=engine_opts)
    tc.score_pairwise_consistency(pcd0.T, pcd1.T, A)
    tc.solve(u0=u0)
    return jc, tc, Agt


def test_resolve_engine_auto_threshold():
    c = Clipper(None, device="cpu")
    assert c._resolve_engine(1024) == "dense"
    assert c._resolve_engine(8191) == "dense"
    assert c._resolve_engine(8192) == "triangle"
    assert Clipper(None, engine="dense",
                   device="cpu")._resolve_engine(8192) == "dense"
    assert Clipper(None, engine="triangle",
                   device="cpu")._resolve_engine(64) == "triangle"
    with pytest.raises(ValueError):
        Clipper(None, engine="warp", device="cpu")
    assert CLIPPER is Clipper


def test_auto_routes_by_m_without_dense_build():
    """'auto' keeps the datasets (no (m, m)) from m = 8192 up."""
    pts = np.random.default_rng(0).random((3, 100))
    c = Clipper(harness.default_invariant(), dtype=torch.float32,
                device="cpu")
    c.score_pairwise_consistency(pts, pts, np.zeros((8192, 2), np.int32))
    assert c._cap is not None and c._M is None and c._A.shape == (8192, 2)
    c.score_pairwise_consistency(pts, pts, np.zeros((512, 2), np.int32))
    assert c._cap is None and c._M.shape == (512, 512)


def test_dense_engine_matches_jax_f64():
    jc, tc, Agt = _both("dense", np.float64, 100, 0.9, seed=1)
    sj, st = jc.get_solution(), tc.get_solution()
    assert int(st.ifinal) == int(sj.ifinal)
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    np.testing.assert_allclose(st.u.numpy(), np.asarray(sj.u), rtol=0,
                               atol=1e-10)
    np.testing.assert_array_equal(tc.get_selected_associations(),
                                  jc.get_selected_associations())
    np.testing.assert_array_equal(tc.get_initial_associations(),
                                  jc.get_initial_associations())
    p, r = data.get_precision_recall(tc.get_selected_associations(), Agt)
    assert p > 0.97 and r > 0.8
    np.testing.assert_allclose(tc.get_affinity_matrix().numpy(),
                               np.asarray(jc.get_affinity_matrix()),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tc.get_constraint_matrix().numpy(),
                                  np.asarray(jc.get_constraint_matrix()))


def test_triangle_engine_matches_jax_f32():
    """engine='triangle' at m=256 with tile=32: int8 storage, probes=16 and
    power_steps=4 (the facade's f32 defaults). The JAX side runs its
    row-chunked rows kernel in interpret mode (matvec='pallas'), the layout
    the port takes on every device: the same int8 products summed in
    another f32 order. (Its CPU default, the XLA tile-list matvec, sums in
    yet another order and here follows a trajectory 4.7e-3 away in u, to
    the same mask.)"""
    jc, tc, Agt = _both("triangle", np.float32, 256, 0.9, seed=2,
                        engine_opts=dict(tile=32),
                        jax_opts=dict(matvec="pallas"))
    sj, st = jc.get_solution(), tc.get_solution()
    assert tc._cap is not None and tc._M is None
    assert int(st.ifinal) == int(sj.ifinal)
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    np.testing.assert_array_equal(tc.get_selected_associations(),
                                  jc.get_selected_associations())
    np.testing.assert_allclose(st.u.numpy(), np.asarray(sj.u), rtol=0,
                               atol=1e-5)
    assert abs(float(st.score) - float(sj.score)) <= 1e-5 * float(sj.score)
    p, r = data.get_precision_recall(tc.get_selected_associations(), Agt)
    assert p > 0.97 and r > 0.8
    # the accessors densify on demand below the cap; XLA's vectorized f32
    # exp differs from PyTorch's by up to 1.4e-5 relative here
    np.testing.assert_allclose(tc.get_affinity_matrix().numpy(),
                               np.asarray(jc.get_affinity_matrix()),
                               rtol=3e-5, atol=0)
    np.testing.assert_array_equal(tc.get_constraint_matrix().numpy(),
                                  np.asarray(jc.get_constraint_matrix()))


@pytest.mark.parametrize("matvec", ["auto", "xla"])
def test_sharded_engine_matches_jax(matvec):
    """engine='sharded' on one rank (no process group) against the JAX
    facade's engine='sharded' on a 1-device mesh, m=256, tile=32, the
    facade's f32 defaults: equal masks and F within 1e-3 relative, in the
    port's row-chunked ('auto') and tile-list ('xla') modes. The JAX side
    takes its CPU default, the XLA tile list, whose f32 sums follow another
    trajectory to the same mask (F 1.4e-4 apart here; see
    test_triangle_engine_matches_jax_f32)."""
    from jax.sharding import Mesh
    import jax
    pcd0, pcd1, A, Agt = _scene(256, 0.9, seed=2)
    u0 = np.random.default_rng(102).random(256).astype(np.float32)
    jc = ct.Clipper(jharness.default_invariant(), ct.Params(),
                    dtype=jnp.float32, engine="sharded",
                    mesh=Mesh(np.array(jax.devices()[:1]), ("d",)),
                    engine_opts=dict(tile=32))
    jc.score_pairwise_consistency(pcd0.T.astype(np.float32),
                                  pcd1.T.astype(np.float32), A)
    sj = jc.solve(u0=u0)
    stats = {}
    tc = Clipper(harness.default_invariant(), Params(), dtype=torch.float32,
                 engine="sharded", device="cpu",
                 engine_opts=dict(tile=32, matvec=matvec, stats=stats))
    tc.score_pairwise_consistency(pcd0.T, pcd1.T, A)
    st = tc.solve(u0=u0)
    assert tc._cap is not None and tc._M is None
    assert stats["ranks"] == 1
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    assert abs(float(st.score) - float(sj.score)) <= 1e-3 * float(sj.score)
    p, r = data.get_precision_recall(tc.get_selected_associations(), Agt)
    assert p > 0.97 and r > 0.8


def test_engine_opts_reach_the_capacity_engine():
    pcd0, pcd1, A, _ = _scene(128, 0.9, seed=3)
    stats = {}
    c = Clipper(harness.default_invariant(), dtype=torch.float32,
                engine="triangle", device="cpu",
                engine_opts=dict(tile=32, probes=4, stats=stats))
    c.score_pairwise_consistency(pcd0.T, pcd1.T, A)
    soln = c.solve(u0=np.ones(128, np.float32))
    assert stats["ticks"] > 0 and set(stats) >= {"build", "solve", "polish"}
    assert soln.mask.shape == (128,) and soln.mask.dtype == torch.bool
    assert soln.u.dtype == torch.float32 and soln.t > 0


def test_capacity_densify_guard():
    c = Clipper(harness.default_invariant(), device="cpu")
    c._cap = {"D1": torch.zeros(4, 3), "D2": torch.zeros(4, 3)}
    c._A = torch.zeros(16385, 2, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="dense"):
        c.get_affinity_matrix()
    with pytest.raises(RuntimeError, match="dense"):
        c.get_constraint_matrix()


def test_unported_options_raise():
    # the sharded engine is ported: it constructs on the CPU
    sh = Clipper(None, engine="sharded", device="cpu")
    assert sh._resolve_engine(64) == "sharded" and sh.mesh is None
    model, scene = make_scene()
    c = Clipper(EuclideanDistance(), dtype=torch.float64, device="cpu")
    # the block-sparse path is ported: dense input takes the dense path
    c.set_sparse_matrix_data(np.triu(np.ones((3, 3)), 1), np.eye(3))
    assert c._M is not None and c._bs_info is None
    c.score_pairwise_consistency(model, scene)
    # multistart is ported on the dense engine; an explicit u0 with it is
    # contradictory, and the capacity engine refuses it, as in the JAX
    # package (clipper.py:171-175, 224-228)
    with pytest.raises(ValueError, match="contradictory"):
        c.solve(u0=np.ones(c.get_initial_associations().shape[0]),
                multistart=4)
    tri = Clipper(EuclideanDistance(), engine="triangle", device="cpu")
    tri.score_pairwise_consistency(model, scene)
    with pytest.raises(NotImplementedError, match="capacity engines"):
        tri.solve(multistart=4)
    sh = Clipper(EuclideanDistance(), engine="sharded", device="cpu")
    sh.score_pairwise_consistency(model, scene)
    with pytest.raises(NotImplementedError, match="capacity engines"):
        sh.solve(multistart=4)
    # the host solvers are ported: the maximum clique and exact DSD run
    assert float(c.solve_as_maximum_clique().score) == -1.0
    with pytest.raises(NotImplementedError, match="item 14"):
        c.solve_as_msrc_sdr()
    with pytest.raises(NotImplementedError, match="item 14"):
        Clipper.solve_as_msrc_sdr_batched(None, None)
    d = Clipper(EuclideanDistance(), Params(rounding=Rounding.DSD),
                dtype=torch.float64, device="cpu")
    d.score_pairwise_consistency(model, scene)
    assert d.solve().mask.sum() == 3
    with pytest.raises(RuntimeError, match="no affinity"):
        Clipper(None, device="cpu").solve()


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Clipper(EuclideanDistance())


def _scored(params=None, seed=0):
    model, scene = make_scene()
    c = Clipper(EuclideanDistance(), params or Params(),
                dtype=torch.float64, seed=seed, device="cpu")
    c.score_pairwise_consistency(model, scene)
    return c


def test_end_to_end_euclidean_most_seeds():
    """The reference integration test (test/clipper_test.cpp:15-68): the
    three identity pairs, for a strong majority of seeds (the solver is
    init-sensitive, as tests/test_solver.py notes)."""
    hits = 0
    for seed in range(8):
        c = _scored(seed=seed)
        c.solve()
        Ain = c.get_selected_associations()
        hits += Ain.shape[0] == 3 and bool((Ain[:, 0] == Ain[:, 1]).all())
    assert hits >= 6, f"only {hits}/8 seeds found the identity clique"


def test_get_set_matrix_roundtrip():
    c1 = _scored()
    M, C = c1.get_affinity_matrix(), c1.get_constraint_matrix()
    c2 = Clipper(EuclideanDistance(), dtype=torch.float64, device="cpu")
    c2.set_matrix_data(M, C, A=c1.get_initial_associations())
    torch.testing.assert_close(c2.get_affinity_matrix(), M, rtol=0, atol=0)
    torch.testing.assert_close(c2.get_constraint_matrix(), C, rtol=0, atol=0)
    c2.solve(u0=np.full(12, 0.5))
    Ain = c2.get_selected_associations()
    assert Ain.shape[0] == 3
    np.testing.assert_array_equal(Ain[:, 0], Ain[:, 1])
    c2.set_parallelize(False)          # API parity no-op


def test_solution_fields_and_warm_start():
    c = _scored()
    soln = c.solve(u0=np.full(12, 0.5))
    assert isinstance(soln, Solution) and soln is c.get_solution()
    assert soln.t > 0 and int(soln.ifinal) >= 1
    assert soln.u.shape == soln.u0.shape == (12,)
    assert sorted(soln.nodes) == list(soln.nodes)
    assert abs(float(torch.linalg.vector_norm(soln.u)) - 1.0) < 1e-12
    again = c.solve(u0=soln.u)
    np.testing.assert_array_equal(again.nodes, soln.nodes)


def test_solve_default_is_reproducible():
    """Call k draws u0 from (seed, k): a rerun of the program reproduces
    each call, and consecutive calls differ."""
    a, b = _scored(seed=5), _scored(seed=5)
    a1, a2 = a.solve(), a.solve()
    b1, b2 = b.solve(), b.solve()
    torch.testing.assert_close(a1.u0, b1.u0, rtol=0, atol=0)
    torch.testing.assert_close(a2.u, b2.u, rtol=0, atol=0)
    assert not torch.equal(a1.u0, a2.u0)
    gen = torch.Generator().manual_seed(3)
    assert not torch.equal(a.solve(generator=gen).u0, a1.u0)


def test_utils_match_jax():
    from clipper_tpu import utils as jutils
    n = 17
    k = np.arange(n * (n - 1) // 2)
    for got, ref in zip(utils.k2ij(k, n), jutils.k2ij(k, n)):
        np.testing.assert_array_equal(got, ref)
    x = np.array([0.1, 0.9, 0.4, 0.7, 0.2])
    for kk in (0, 3, 99):
        assert (utils.find_indices_of_k_largest(torch.from_numpy(x), kk)
                == jutils.find_indices_of_k_largest(x, kk))
    assert (utils.find_indices_where_above_threshold(x, 0.3)
            == jutils.find_indices_where_above_threshold(x, 0.3))
    np.testing.assert_array_equal(
        utils.select_from_indicator(torch.from_numpy(x), [1, 0, 1, 0, 0]),
        jutils.select_from_indicator(x, np.array([1, 0, 1, 0, 0])))
    v = utils.randvec(torch.Generator().manual_seed(0), 1000,
                      dtype=torch.float32, device="cpu")
    assert v.shape == (1000,) and v.dtype == torch.float32
    assert bool((v >= 0).all() & (v < 1).all())
    t = utils.Timer("x")
    t.start()
    assert t.stop() >= 0 and t.count == 1
    assert (t + utils.Timer()).count == 1 and "Timer('x'" in repr(t)
