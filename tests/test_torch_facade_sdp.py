"""Port parity: the facade's SDR (Clipper.solve_as_msrc_sdr and
solve_as_msrc_sdr_batched) against clipper_tpu.Clipper on the CPU.

The toy-scene get/set integration tests of tests/test_sdp.py:22-57 (dense
and sparse injection) through both facades, a bunny problem (m=128, f64)
whose SDR mask equals the JAX facade's, and the batched method. Masks and
node sets are compared exactly.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import clipper_tpu as ct
from clipper_tpu.bench import harness as jharness
from clipper_tpu.solvers import sdp as jsdp
from clipper_tpu_torch import Clipper, EuclideanDistance
from clipper_tpu_torch.bench import harness
from clipper_tpu_torch.solvers import sdp
from clipper_tpu_torch.types import Params

from test_affinity import make_scene


def _scored_pair():
    model, data = make_scene()
    jc = ct.Clipper(ct.EuclideanDistance(), ct.Params())
    jc.score_pairwise_consistency(model, data)
    c = Clipper(EuclideanDistance(), Params(), dtype=torch.float64,
                device="cpu")
    c.score_pairwise_consistency(model, data)
    return jc, c


def test_sdr_toy_scene_get_set():
    """reference: test/clipper_test.cpp:72-134 (dense get/set + SDP)."""
    jc, c = _scored_pair()
    M = c.get_affinity_matrix()
    C = c.get_constraint_matrix()
    np.testing.assert_array_equal(M.numpy(),
                                  np.asarray(jc.get_affinity_matrix()))
    c2 = Clipper(EuclideanDistance(), Params(), dtype=torch.float64,
                 device="cpu")
    c2.set_matrix_data(M, C, A=c.get_initial_associations())
    c2.solve_as_msrc_sdr()
    Ain = c2.get_selected_associations()
    assert Ain.shape[0] == 3
    np.testing.assert_array_equal(Ain[:, 0], Ain[:, 1])
    jc2 = ct.Clipper(ct.EuclideanDistance(), ct.Params())
    jc2.set_matrix_data(np.asarray(jc.get_affinity_matrix()),
                        np.asarray(jc.get_constraint_matrix()),
                        A=jc.get_initial_associations())
    jc2.solve_as_msrc_sdr()
    np.testing.assert_array_equal(Ain, jc2.get_selected_associations())
    sol = c2.get_solution()
    assert float(sol.score) == -1.0 and int(sol.ifinal) == 0


def test_sdr_sparse_get_set():
    """reference: test/clipper_test.cpp:138-207 (sparse get/set + SDP)."""
    jc, c = _scored_pair()
    M = c.get_affinity_matrix().numpy()
    C = c.get_constraint_matrix().numpy()
    Ms = sp.csr_matrix(np.triu(M, 1))
    Cs = sp.csr_matrix(np.triu(C, 1))
    c2 = Clipper(EuclideanDistance(), Params(), dtype=torch.float64,
                 device="cpu")
    c2.set_sparse_matrix_data(Ms, Cs, A=c.get_initial_associations())
    c2.solve_as_msrc_sdr()
    Ain = c2.get_selected_associations()
    assert Ain.shape[0] == 3
    np.testing.assert_array_equal(Ain[:, 0], Ain[:, 1])
    jc2 = ct.Clipper(ct.EuclideanDistance(), ct.Params())
    jc2.set_sparse_matrix_data(Ms, Cs, A=jc.get_initial_associations())
    jc2.solve_as_msrc_sdr()
    np.testing.assert_array_equal(Ain, jc2.get_selected_associations())


@pytest.mark.parametrize("blocksparse", [False, True])
def test_sdr_bunny_matches_jax_facade(blocksparse):
    """A bunny problem (m=128, rho=0.9, seed 0) in f64: the port's SDR mask
    equals the JAX facade's, on the dense path and from scipy input taken
    as occupied tiles (densified for the SDR)."""
    m = 128
    pcd0 = harness.load_bunny()
    pcd1, A, Agt = harness.make_problem(pcd0, m, 0.9,
                                        np.random.default_rng(0))
    jc = ct.Clipper(jharness.default_invariant(), ct.Params())
    jc.score_pairwise_consistency(pcd0.T, pcd1.T, A)
    c = Clipper(harness.default_invariant(), Params(), dtype=torch.float64,
                device="cpu")
    c.score_pairwise_consistency(pcd0.T, pcd1.T, A)
    if blocksparse:
        M = sp.csr_matrix(np.triu(c.get_affinity_matrix().numpy(), 1))
        C = sp.csr_matrix(np.triu(c.get_constraint_matrix().numpy(), 1))
        c.set_sparse_matrix_data(M, C, A, max_occupancy=1.0)
        assert c._bs_info is not None
    jsol = jc.solve_as_msrc_sdr()
    sol = c.solve_as_msrc_sdr()
    np.testing.assert_array_equal(sol.mask.numpy(), np.asarray(jsol.mask))
    assert int(sol.mask.sum()) > 0


def test_facade_sdr_batched():
    rng = np.random.default_rng(3)
    Ms, Cs = [], []
    for _ in range(2):
        n = 24
        W = np.triu(rng.uniform(0, 0.3, size=(n, n)) *
                    (rng.uniform(size=(n, n)) < 0.25), 1)
        clique = rng.choice(n, 5, replace=False)
        for a in range(5):
            for b in range(a + 1, 5):
                W[min(clique[a], clique[b]), max(clique[a], clique[b])] = 1.0
        M = W + W.T + np.eye(n)
        Ms.append(M)
        Cs.append((M > 0).astype(float))
    Ms, Cs = np.stack(Ms), np.stack(Cs)
    solns = Clipper.solve_as_msrc_sdr_batched(Ms, Cs, device="cpu")
    jsolns = ct.Clipper.solve_as_msrc_sdr_batched(Ms, Cs)
    for b in range(2):
        single = sdp.solve(Ms[b], Cs[b], device="cpu")
        assert solns[b].nodes == single.nodes == jsolns[b].nodes
        assert solns[b].iters == jsolns[b].iters
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Clipper.solve_as_msrc_sdr_batched(Ms, Cs)


def test_sdr_params_pass_through():
    """solve_as_msrc_sdr(params) reaches sdp.solve: a starved solve warns
    as the JAX facade's does."""
    _, c = _scored_pair()
    with pytest.warns(UserWarning, match="under-converged"):
        c.solve_as_msrc_sdr(sdp.Params(max_iters=1))
    jc, _ = _scored_pair()
    with pytest.warns(UserWarning, match="under-converged"):
        jc.solve_as_msrc_sdr(jsdp.Params(max_iters=1))
