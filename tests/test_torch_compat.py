"""Port parity: the clipperpy-compatible namespace (clipper_tpu_torch.compat)
against clipper_tpu.compat, mirroring tests/test_compat.py with
device="cpu": the reference bindings' usage patterns work verbatim."""

import numpy as np
import pytest
import torch

import clipper_tpu.compat as jclipperpy
import clipper_tpu_torch.compat as clipperpy
from clipper_tpu_torch.solvers import maxclique, sdp
from clipper_tpu_torch.types import Params as FrozenParams

from test_affinity import make_scene


def _toy(device="cpu", u0=None):
    iparams = clipperpy.invariants.EuclideanDistanceParams()
    iparams.sigma = 0.01
    iparams.epsilon = 0.06
    invariant = clipperpy.invariants.EuclideanDistance(iparams)
    clipper = clipperpy.CLIPPER(invariant, clipperpy.Params(), device=device)
    model, data = make_scene()
    clipper.score_pairwise_consistency(model, data, np.empty((0, 2)))
    clipper.solve(u0)
    return clipper


def test_clipperpy_style_end_to_end():
    # an explicit u0: the JAX namespace's unseeded solve draws from its
    # facade's seed 0, the port's from the clock (as the reference), and
    # some draws end on a 2-clique of this scene
    clipper = _toy(u0=np.random.default_rng(0).random(12))
    soln = clipper.get_solution()
    assert soln.score > 2.5
    assert len(soln.nodes) == 3
    Ain = clipper.get_selected_associations()
    np.testing.assert_array_equal(Ain[:, 0], Ain[:, 1])
    A = clipper.get_initial_associations()
    assert A.shape == (12, 2)
    M = clipper.get_affinity_matrix()
    C = clipper.get_constraint_matrix()
    assert isinstance(M, np.ndarray) and isinstance(C, np.ndarray)
    assert M.shape == (12, 12)
    np.testing.assert_array_equal(np.diag(C), np.ones(12))
    assert isinstance(soln.u, np.ndarray) and soln.u.shape == (12,)


def test_clipperpy_matches_jax_compat():
    """The same numpy u0 through both namespaces: the same selection and
    matrices (f32 working precision in both)."""
    u0 = np.random.default_rng(0).random(12)
    clipper = _toy(u0=u0)
    iparams = jclipperpy.invariants.EuclideanDistanceParams()
    iparams.sigma, iparams.epsilon = 0.01, 0.06
    j = jclipperpy.CLIPPER(jclipperpy.invariants.EuclideanDistance(iparams),
                           jclipperpy.Params())
    model, data = make_scene()
    j.score_pairwise_consistency(model, data, np.empty((0, 2)))
    j.solve(u0)
    np.testing.assert_array_equal(clipper.get_selected_associations(),
                                  j.get_selected_associations())
    assert clipper.get_solution().nodes == j.get_solution().nodes
    np.testing.assert_allclose(clipper.get_affinity_matrix(),
                               j.get_affinity_matrix(), atol=1e-6)
    assert clipper.get_solution().ifinal == j.get_solution().ifinal


def test_unseeded_solve_draws_from_the_clock():
    """solve() without u0 draws its init from a clock-seeded generator:
    two instances start from different vectors, each ends on a clique of
    C (this scene has more than one)."""
    a, b = _toy(), _toy()
    assert not np.array_equal(a.get_solution().u0, b.get_solution().u0)
    for c in (a, b):
        nodes = c.get_solution().nodes
        assert len(nodes) >= 2
        assert (c.get_constraint_matrix()[np.ix_(nodes, nodes)] == 1).all()


def test_mutable_params_snapshot():
    params = clipperpy.Params()
    params.rounding = clipperpy.DSD_HEU
    params.maxoliters = 500
    frozen = params.freeze()
    assert isinstance(frozen, FrozenParams)
    assert frozen.maxoliters == 500
    assert "tol_u" in repr(params)
    with pytest.raises(TypeError, match="unknown params"):
        clipperpy.Params(bogus=1)


def test_mc_and_sdp_params():
    mc = clipperpy.MCParams()
    mc.time_limit = 60
    assert mc.freeze().time_limit == 60
    assert isinstance(mc.freeze(), maxclique.Params)
    sp = clipperpy.SDPParams()
    sp.max_iters = 123
    assert sp.freeze().max_iters == 123
    assert isinstance(sp.freeze(), sdp.Params)
    # the same fields and defaults as the JAX holders
    jsp = jclipperpy.SDPParams()
    assert {k: v for k, v in vars(sp).items() if k != "max_iters"} == {
        k: v for k, v in vars(jsp).items()
        if not k.startswith("_") and k != "max_iters"}


def test_sdp_through_compat_matches_facade():
    """compat.SDPParams through solve_as_msrc_sdr selects the identity
    associations, as the JAX namespace does."""
    clipper = _toy(u0=np.ones(12))
    sp = clipperpy.SDPParams()
    sp.eps_abs = sp.eps_rel = 1e-4
    clipper.solve_as_msrc_sdr(sp)
    Ain = clipper.get_selected_associations()
    assert Ain.shape[0] == 3
    np.testing.assert_array_equal(Ain[:, 0], Ain[:, 1])
    assert clipper.get_solution().score == -1.0


def test_max_clique_through_compat():
    clipper = _toy(u0=np.ones(12))
    mc = clipperpy.MCParams()
    clipper.solve_as_maximum_clique(mc)
    assert len(clipper.get_solution().nodes) == 3


def test_utils_namespace():
    A = clipperpy.utils.create_all_to_all(3, 2)
    assert isinstance(A, np.ndarray) and A.shape == (6, 2)
    np.testing.assert_array_equal(A, jclipperpy.utils.create_all_to_all(3, 2))
    assert clipperpy.utils.k2ij(0, 4) == (0, 1)


def test_dsd_namespace():
    from test_dsd import golden_matrix, TRUE_NODES
    assert clipperpy.dsd.solve(golden_matrix()) == TRUE_NODES


def test_point_normal_invariant_namespace():
    ip = clipperpy.invariants.PointNormalDistanceParams()
    ip.sigp = 0.4
    inv = clipperpy.invariants.PointNormalDistance(ip)
    assert inv.params.sigp == 0.4
    assert "sigp=0.4" in repr(ip)


def test_compat_utils_surface():
    import clipper_tpu_torch.compat.utils as cu
    v = cu.randvec(16, seed=0)
    assert v.shape == (16,) and (0 <= v).all() and (v < 1).all()
    x = np.array([3.0, 1.0, 4.0, 1.5, 9.0])
    assert set(cu.find_indices_of_k_largest(x, 2)) == {4, 2}
    assert cu.find_indices_where_above_threshold(x, 2.0) == [0, 2, 4]
    sel = cu.select_from_indicator(x, np.array([1, 0, 1, 0, 0], bool))
    assert list(sel) == [3.0, 4.0]


def test_constants_and_version():
    assert clipperpy.NONZERO == jclipperpy.NONZERO == 0
    assert clipperpy.DSD == jclipperpy.DSD
    assert clipperpy.DSD_HEU == jclipperpy.DSD_HEU
    assert clipperpy.__version__ == jclipperpy.__version__


def test_clipper_raises_without_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    inv = clipperpy.invariants.EuclideanDistance()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        clipperpy.CLIPPER(inv, clipperpy.Params())
