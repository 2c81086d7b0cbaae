"""Port parity: the facade's remaining surface against clipper_tpu.Clipper.

Exact DSD rounding on the dense engine (f64), multistart, the triangle
engine, the sharded engine on two gloo ranks and the sparse path; the
maximum clique; set_sparse_matrix_data and its dense fall-back; and the
DSD of the block M[S, S] gathered on the device against the JAX facade's
full-matrix call. Inputs are numpy from a seed, u0 shared. Masks are
compared exactly: DSD is a combinatorial rounding of the support, so a
mask that differs is a fault, not a tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import clipper_tpu as ct
from clipper_tpu import utils as jutils
from clipper_tpu.bench import harness as jharness
from clipper_tpu.solvers import dsd as jdsd
from clipper_tpu.solvers import maxclique as jmc
from clipper_tpu_torch import Clipper, EuclideanDistance
from clipper_tpu_torch.bench import cpu_mesh_run, data, harness
from clipper_tpu_torch.clipper import utils as port_utils
from clipper_tpu_torch.solvers import maxclique
from clipper_tpu_torch.types import Params, Rounding

from test_affinity import make_scene
from test_facade import _planted_sparse

DSD = Rounding.DSD


def _scene(m, rho, seed):
    pcd0 = harness.load_bunny()
    pcd1, A, Agt = harness.make_problem(pcd0, m, rho,
                                        np.random.default_rng(seed))
    return pcd0, pcd1, A.astype(np.int32), Agt


def _clippers(engine, dtype, m, rho, seed, rounding=DSD, jax_opts=None,
              engine_opts=None, mesh=None):
    """(JAX clipper, port clipper, u0, Agt), both scored on one scene."""
    pcd0, pcd1, A, Agt = _scene(m, rho, seed)
    u0 = np.random.default_rng(seed + 100).random(m).astype(dtype)
    jc = ct.Clipper(jharness.default_invariant(),
                    ct.Params(rounding=ct.Rounding(int(rounding))),
                    dtype=jnp.dtype(dtype), engine=engine, mesh=mesh,
                    engine_opts=dict(engine_opts or {}, **(jax_opts or {})))
    jc.score_pairwise_consistency(pcd0.T.astype(dtype), pcd1.T.astype(dtype),
                                  A)
    tc = Clipper(harness.default_invariant(), Params(rounding=rounding),
                 dtype=torch.from_numpy(u0).dtype, engine=engine,
                 device="cpu", engine_opts=engine_opts)
    tc.score_pairwise_consistency(pcd0.T, pcd1.T, A)
    return jc, tc, u0, Agt


def _jax_draws(seed, nsolve, K, m, dtype):
    """The u0s the JAX facade's solve number ``nsolve`` draws for K
    restarts (clipper_tpu/clipper.py:162-170)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), nsolve)
    return np.asarray(jax.vmap(lambda k: jutils.randvec(k, m, dtype=dtype))(
        jax.random.split(key, K)))


def _replay(monkeypatch, rows):
    """Make the port facade's draws return ``rows`` in order."""
    it = iter(rows)
    monkeypatch.setattr(port_utils, "randvec",
                        lambda gen, m, dtype, device=None: torch.tensor(
                            next(it), dtype=dtype, device=device))


def _mask(c):
    return np.asarray(c.get_solution().mask)


@pytest.mark.parametrize("seed", [1, 4])
def test_dsd_dense_engine_matches_jax_f64(seed):
    """The dense engine in f64, m=256: DSD masks equal, and the DSD set
    lies in the support and is at least as dense as the DSD_HEU mask."""
    jc, tc, u0, Agt = _clippers("dense", np.float64, 256, 0.9, seed)
    jc.solve(u0=u0)
    st = tc.solve(u0=u0)
    np.testing.assert_array_equal(st.mask.numpy(), _mask(jc))
    u = st.u.numpy()
    assert st.mask.any() and (u[st.mask.numpy()] > 0).all()
    M = tc.get_affinity_matrix().numpy() - np.eye(256)

    def density(mask):
        return M[np.ix_(mask, mask)].sum() / 2 / mask.sum()

    heu = tc.get_solution().mask.numpy()
    tc.params = Params()
    tc.solve(u0=u0)
    assert density(heu) >= density(tc.get_solution().mask.numpy()) - 1e-12
    p, r = data.get_precision_recall(
        np.asarray(jc.get_selected_associations()), Agt)
    assert p > 0.97 and r > 0.8


def test_dsd_multistart_matches_jax_f64(monkeypatch):
    """solve(multistart=4) with DSD, the port replaying the JAX facade's
    four draws: masks, u and F equal."""
    jc, tc, _, _ = _clippers("dense", np.float64, 256, 0.9, seed=2)
    sj = jc.solve(multistart=4)
    _replay(monkeypatch, _jax_draws(0, 0, 4, 256, jnp.float64))
    st = tc.solve(multistart=4)
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    np.testing.assert_allclose(st.u.numpy(), np.asarray(sj.u), rtol=0,
                               atol=1e-10)


def test_dsd_triangle_engine_matches_jax_f32():
    """engine='triangle' at m=256, tile=32 (int8, the facade's f32
    defaults; the JAX side's rows kernel in interpret mode, as in
    test_torch_facade): the engine rounds NONZERO and DSD runs on the
    support block rebuilt from the invariant."""
    jc, tc, u0, _ = _clippers("triangle", np.float32, 256, 0.9, seed=2,
                              engine_opts=dict(tile=32),
                              jax_opts=dict(matvec="pallas"))
    jc.solve(u0=u0)
    st = tc.solve(u0=u0)
    assert tc._M is None and tc._cap is not None
    np.testing.assert_array_equal(st.mask.numpy(), _mask(jc))
    assert (st.u.numpy()[st.mask.numpy()] > 0).all()


def test_dsd_sharded_engine_two_ranks_matches_jax():
    """engine='sharded' on D=2 gloo ranks (the facade in each rank) against
    the JAX facade on a 2-device mesh, m=256, tile=32, f32: the ranks
    agree bit for bit and the DSD mask equals JAX's."""
    from jax.sharding import Mesh
    pcd0, pcd1, A, _ = _scene(256, 0.9, seed=2)
    u0 = np.random.default_rng(102).random(256).astype(np.float32)
    jc = ct.Clipper(jharness.default_invariant(),
                    ct.Params(rounding=ct.Rounding.DSD), dtype=jnp.float32,
                    engine="sharded",
                    mesh=Mesh(np.array(jax.devices()[:2]), ("d",)),
                    engine_opts=dict(tile=32))
    jc.score_pairwise_consistency(pcd0.T.astype(np.float32),
                                  pcd1.T.astype(np.float32), A)
    sj = jc.solve(u0=u0)
    job = dict(D1=pcd0.astype(np.float32), D2=pcd1.astype(np.float32), A=A,
               u0=u0, facade=True, params=Params(rounding=DSD), tile=32)
    res, = cpu_mesh_run.run(2, [job], timeout=120.0)
    assert res["ranks_agree"] and res["stats"]["ranks"] == 2
    np.testing.assert_array_equal(res["mask"], np.asarray(sj.mask))


@pytest.mark.parametrize("rounding", [DSD, Rounding.NONZERO])
def test_sparse_path_matches_jax(rounding):
    """tests/test_facade.py's planted sparse problem (m=1280) in f32 (int8
    tiles) from one u0: the occupied-tile storage equals JAX's, no dense
    (m, m) is made, the masks equal JAX's (DSD's: the planted clique; the
    f32 support also holds two noise vertices on both), and the
    polished F agrees to 1e-5 relative (f32 iterates summed in another
    order). (In f64, f64 tiles, both packages run out the 1000 outer
    iterations on this problem: the tile products are rounded to f32 and
    f64 has no stall guard.)"""
    M, C, planted = _planted_sparse(seed=1)
    u0 = np.random.default_rng(7).random(1280).astype(np.float32)
    jc = ct.Clipper(None, ct.Params(rounding=ct.Rounding(int(rounding))),
                    dtype=jnp.float32)
    jc.set_sparse_matrix_data(M, C)
    sj = jc.solve(u0=u0)
    tc = Clipper(None, Params(rounding=rounding), dtype=torch.float32,
                 device="cpu")
    tc.set_sparse_matrix_data(M, C)
    assert tc._M is None and tc._C is None and sp.issparse(tc._M_sparse)
    assert tc._bs_info["occupancy"] == jc._bs_info["occupancy"] < 0.5
    np.testing.assert_array_equal(tc._bs.tiles.numpy(),
                                  np.asarray(jc._bs.tiles))
    st = tc.solve(u0=u0)
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    found = set(np.flatnonzero(st.mask.numpy()))
    assert found == planted if rounding == DSD else found > planted
    assert abs(float(st.score) - float(sj.score)) <= 1e-5 * float(sj.score)
    Mi = tc.get_affinity_matrix().numpy()
    assert Mi.shape == (1280, 1280) and Mi[0, 1] == pytest.approx(0.9)
    np.testing.assert_array_equal(tc.get_constraint_matrix().numpy(),
                                  np.asarray(jc.get_constraint_matrix()))


def test_sparse_multistart_dsd_matches_jax(monkeypatch):
    """solve(multistart=3) with DSD on the sparse path in f32, the port
    replaying JAX's three draws: the chosen restart's mask is the planted
    clique on both, and the polished F agrees to 1e-5 relative."""
    M, C, planted = _planted_sparse(seed=1)
    jc = ct.Clipper(None, ct.Params(rounding=ct.Rounding.DSD),
                    dtype=jnp.float32)
    jc.set_sparse_matrix_data(M, C)
    sj = jc.solve(multistart=3)
    tc = Clipper(None, Params(rounding=DSD), dtype=torch.float32,
                 device="cpu")
    tc.set_sparse_matrix_data(M, C)
    _replay(monkeypatch, _jax_draws(0, 0, 3, 1280, jnp.float32))
    st = tc.solve(multistart=3)
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    assert set(np.flatnonzero(st.mask.numpy())) == planted
    assert abs(float(st.score) - float(sj.score)) <= 1e-5 * float(sj.score)


def test_sparse_high_occupancy_and_dense_input_fall_back():
    """At occupancy above max_occupancy, and for dense input, the matrices
    take the dense path with the JAX facade's M and C."""
    rng = np.random.default_rng(2)
    Md = np.triu(rng.uniform(0.1, 1.0, size=(256, 256)), 1)
    Cd = (Md > 0).astype(np.float64)
    for M, C in ((sp.csr_matrix(Md), sp.csr_matrix(Cd)), (Md, Cd)):
        tc = Clipper(None, Params(), dtype=torch.float64, device="cpu")
        tc.set_sparse_matrix_data(M, C)
        jc = ct.Clipper(None, ct.Params())
        jc.set_sparse_matrix_data(M, C)
        assert tc._bs_info is None and tc._M is not None
        np.testing.assert_array_equal(tc.get_affinity_matrix().numpy(),
                                      np.asarray(jc.get_affinity_matrix()))


@pytest.mark.parametrize("method", list(maxclique.Method))
def test_maximum_clique_matches_jax(method):
    """solve_as_maximum_clique on the bunny at m=256 (dense engine), its
    triangle-engine C densified on demand, and the sparse path: the set
    equals JAX's, score -1 and ifinal 0, and it is a clique of C."""
    prm = maxclique.Params(method=method, threads=2)
    jprm = jmc.Params(method=jmc.Method(int(method)), threads=2)
    jc, tc, _, _ = _clippers("dense", np.float64, 256, 0.9, seed=3,
                             rounding=Rounding.DSD_HEU)
    st = tc.solve_as_maximum_clique(prm)
    sj = jc.solve_as_maximum_clique(jprm)
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    assert float(st.score) == -1.0 and int(st.ifinal) == 0
    nodes = st.nodes
    C = tc.get_constraint_matrix().numpy()
    if method != maxclique.Method.KCORE:
        assert (C[np.ix_(nodes, nodes)] == 1).all()
    _, tri, _, _ = _clippers("triangle", np.float32, 256, 0.9, seed=3,
                             engine_opts=dict(tile=32))
    np.testing.assert_array_equal(
        tri.solve_as_maximum_clique(prm).mask.numpy(), st.mask.numpy())
    M, Cs, _ = _planted_sparse(seed=1)
    sps = Clipper(None, Params(), device="cpu")
    sps.set_sparse_matrix_data(M, Cs)
    jsp = ct.Clipper(None, ct.Params())
    jsp.set_sparse_matrix_data(M, Cs)
    np.testing.assert_array_equal(
        sps.solve_as_maximum_clique(prm).mask.numpy(),
        np.asarray(jsp.solve_as_maximum_clique(jprm).mask))


def test_maximum_clique_reference_scene():
    """tests/test_maxclique.py's facade case: the reference's 3-point
    scene (reference: src/clipper.cpp:82-97)."""
    model, scene = make_scene()
    c = Clipper(EuclideanDistance(), Params(), dtype=torch.float64,
                device="cpu")
    c.score_pairwise_consistency(model, scene)
    soln = c.solve_as_maximum_clique()
    assert float(soln.score) == -1.0
    Ain = c.get_selected_associations()
    assert Ain.shape[0] == 3
    np.testing.assert_array_equal(Ain[:, 0], Ain[:, 1])


@pytest.mark.parametrize("m, seed", [(512, 0), (1024, 5)])
def test_gathered_block_dsd_equals_full_matrix_dsd(m, seed):
    """The port's DSD of M[S, S] gathered on the device gives the node set
    of the JAX facade's call on the whole (m, m) M with S."""
    _, tc, u0, _ = _clippers("dense", np.float32, m, 0.9, seed)
    st = tc.solve(u0=u0)
    S = np.flatnonzero(st.u.numpy() > 0)
    full = jdsd.solve(tc._M.numpy(), list(S))
    np.testing.assert_array_equal(np.flatnonzero(st.mask.numpy()), full)
