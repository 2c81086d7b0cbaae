"""Port parity: the nested solver and the single-problem flat solver.

The same numpy (M, C, u0) through clipper_tpu.solvers and
clipper_tpu_torch.solvers in f64, and the nested solver against
tests/test_solver.py's NumPy transliteration of the reference loop.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import clipper_tpu as ct
from clipper_tpu.ops.affinity import (
    score_pairwise_consistency as jscore_pairwise_consistency)
from clipper_tpu.solvers import msrc as jmsrc
from clipper_tpu.solvers import msrc_flat as jmsrc_flat
from clipper_tpu_torch.solvers import msrc, msrc_flat
from clipper_tpu_torch.types import Params, Rounding

from test_affinity import make_scene
from test_solver import np_reference_solver


def _scene_matrices():
    model, data = make_scene()
    c = ct.Clipper(ct.EuclideanDistance(), ct.Params())
    c.score_pairwise_consistency(model, data)
    return np.array(c._M), np.array(c._C)


def _random_graph(rng, m=24, p=0.4):
    W = rng.uniform(size=(m, m))
    W = np.triu((W + W.T) / 2, 1)
    keep = np.triu(rng.uniform(size=(m, m)) < p, 1)
    Mu = np.where(keep, W, 0.0)
    M = Mu + Mu.T
    return M, (M > 0).astype(np.float64)


def _bunny_matrices(m, rho, seed):
    """Dense f64 (M, C) of one bunny problem, built by the JAX package."""
    from clipper_tpu.bench import harness as jharness
    pcd0 = jharness.load_bunny()
    pcd1, A, _ = jharness.make_problem(pcd0, m, rho,
                                       np.random.default_rng(seed))
    M, C = jscore_pairwise_consistency(
        jharness.default_invariant(), jnp.asarray(pcd0), jnp.asarray(pcd1),
        jnp.asarray(A))
    return np.array(M), np.array(C)


def _graphs():
    rng = np.random.default_rng(3)
    yield "scene", _scene_matrices()
    for k in range(2):
        yield f"random{k}", _random_graph(rng)
    yield "bunny", _bunny_matrices(96, 0.8, seed=4)


@pytest.mark.parametrize("fuse_md", [True, False])
def test_find_dense_clique_matches_jax_f64(fuse_md):
    """Same ifinal, u within 1e-10 and equal masks, from the same u0."""
    rng = np.random.default_rng(7)
    for name, (M, C) in _graphs():
        u0 = rng.uniform(size=M.shape[0])
        u_j, F_j, i_j = jmsrc.find_dense_clique(
            jnp.asarray(M), jnp.asarray(C), jnp.asarray(u0), ct.Params(),
            fuse_md=fuse_md)
        u, F, i = msrc.find_dense_clique(
            torch.from_numpy(M), torch.from_numpy(C), torch.from_numpy(u0),
            Params(), fuse_md=fuse_md)
        assert int(i) == int(i_j), name
        np.testing.assert_allclose(u.numpy(), np.asarray(u_j), rtol=0,
                                   atol=1e-10, err_msg=name)
        assert abs(float(F) - float(F_j)) <= 1e-10 * max(1.0, abs(float(F_j)))
        for rnd, jrnd in ((Rounding.DSD_HEU, ct.Rounding.DSD_HEU),
                          (Rounding.NONZERO, ct.Rounding.NONZERO)):
            np.testing.assert_array_equal(
                msrc.round_solution(u, F, rnd).numpy(),
                np.asarray(jmsrc.round_solution(u_j, F_j, jrnd)))


def test_find_dense_clique_matches_numpy_reference():
    """The reference loop's operation order (fuse_md=False) against
    tests/test_solver.py's np_reference_solver, as the JAX package's own
    parity test holds it."""
    rng = np.random.default_rng(11)
    for name, (M, C) in _graphs():
        u0 = rng.uniform(size=M.shape[0])
        u_np, F_np, i_np = np_reference_solver(M, C, u0)
        u, F, i = msrc.find_dense_clique(
            torch.from_numpy(M), torch.from_numpy(C), torch.from_numpy(u0),
            Params(), fuse_md=False)
        np.testing.assert_allclose(u.numpy(), u_np, atol=1e-10, err_msg=name)
        assert abs(float(F) - F_np) < 1e-8, name
        assert int(i) == i_np, name


@pytest.mark.parametrize("rounding", [Rounding.DSD_HEU, Rounding.NONZERO,
                                      Rounding.DSD])
def test_solve_msrc_matches_jax(rounding):
    M, C = _bunny_matrices(128, 0.9, seed=5)
    u0 = np.random.default_rng(6).uniform(size=M.shape[0])
    jparams = ct.Params(rounding=ct.Rounding(int(rounding)))
    sj = jmsrc.solve_msrc(jnp.asarray(M), jnp.asarray(C), jnp.asarray(u0),
                          jparams)
    st = msrc.solve_msrc(torch.from_numpy(M), torch.from_numpy(C),
                         torch.from_numpy(u0), Params(rounding=rounding))
    assert int(st.ifinal) == int(sj.ifinal) and st.ifinal.dtype == torch.int32
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    np.testing.assert_allclose(st.u.numpy(), np.asarray(sj.u), rtol=0,
                               atol=1e-10)
    assert st.mask.sum() > 0


def test_run_pga_stall_guard_f32():
    """f32 turns the stalled-homotopy guard on: the same f32 inputs give
    the JAX package's ifinal and mask."""
    M, C = _bunny_matrices(128, 0.9, seed=8)
    M, C = M.astype(np.float32), C.astype(np.float32)
    u0 = np.random.default_rng(9).uniform(size=M.shape[0]).astype(np.float32)
    u_j, F_j, i_j = jmsrc.find_dense_clique(
        jnp.asarray(M), jnp.asarray(C), jnp.asarray(u0), ct.Params())
    u, F, i = msrc.find_dense_clique(torch.from_numpy(M), torch.from_numpy(C),
                                     torch.from_numpy(u0), Params())
    assert u.dtype == torch.float32 and int(i) == int(i_j)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        msrc.round_solution(u, F).numpy(),
        np.asarray(jmsrc.round_solution(u_j, F_j)))


def _dense_mv(M, C):
    """(m,) or (m, K) -> (M u, C u): a plain dense dual matvec."""
    def mv(u):
        return M @ u, C @ u
    return mv


@pytest.mark.parametrize("probes", [1, 4, 16])
def test_flat_solve_single_matches_jax_f64(probes):
    """flat_solve_single (probes=1) and flat_solve_single_multiprobe over
    a dense stacked matvec: the same u, F, ifinal, ticks and rejected
    probes as the JAX package's while_loop solvers."""
    M, C = _bunny_matrices(128, 0.9, seed=10)
    u0 = np.random.default_rng(12).uniform(size=M.shape[0])
    jmv = jmsrc_flat.stacked_dual_matvec(jnp.asarray(M), jnp.asarray(C))
    mv = _dense_mv(torch.from_numpy(M), torch.from_numpy(C))
    ju0 = jmsrc_flat.power_init(jmv, jnp.asarray(u0), 2)
    tu0 = msrc_flat.power_init(mv, torch.from_numpy(u0), 2)
    np.testing.assert_allclose(tu0.numpy(), np.asarray(ju0), rtol=0,
                               atol=1e-12)
    if probes == 1:
        ref = jmsrc_flat.flat_solve_single(jmv, ju0, ct.Params(),
                                           d_scale=0.5, return_ticks=True)
        got = msrc_flat.flat_solve_single(mv, tu0, Params(), d_scale=0.5,
                                          return_ticks=True)
    else:
        ref = jmsrc_flat.flat_solve_single_multiprobe(
            jmv, ju0, ct.Params(), probes=probes, d_scale=0.5,
            return_ticks=True)
        got = msrc_flat.flat_solve_single_multiprobe(
            mv, tu0, Params(), probes=probes, d_scale=0.5, return_ticks=True)
    u, F, i, ticks, nback = got
    u_j, F_j, i_j, ticks_j, nback_j = ref
    assert (int(i), int(ticks), int(nback)) == (int(i_j), int(ticks_j),
                                                int(nback_j))
    assert int(i) >= 1 and u.shape == (M.shape[0],)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), rtol=0, atol=1e-12)
    assert abs(float(F) - float(F_j)) <= 1e-10
    # F at convergence is u'(M + I)u in the matvec's precision
    Fr = msrc_flat.recompute_objective(mv, u)
    Fr_j = jmsrc_flat.recompute_objective(jmv, u_j)
    assert abs(float(Fr) - float(Fr_j)) <= 1e-10


def test_flat_init_is_unbatched():
    M, C = _random_graph(np.random.default_rng(1))
    u0 = np.random.default_rng(2).uniform(size=M.shape[0])
    mv = _dense_mv(torch.from_numpy(M), torch.from_numpy(C))
    s = msrc_flat.flat_init(mv, torch.from_numpy(u0), Params())
    js = jmsrc_flat.flat_init(
        jmsrc_flat.stacked_dual_matvec(jnp.asarray(M), jnp.asarray(C)),
        jnp.asarray(u0), ct.Params())
    for name in s._fields:
        got, ref = getattr(s, name), np.asarray(getattr(js, name))
        assert tuple(got.shape) == ref.shape, name
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12,
                                   err_msg=name)
    with pytest.raises(ValueError, match="probes"):
        msrc_flat.flat_solve_state(mv, s, Params(), probes=0)
