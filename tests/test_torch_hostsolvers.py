"""Port parity: the host solvers (DSD, maximum clique), the k-core op and
the native PLY reader.

Mirrors tests/test_dsd.py, tests/test_maxclique.py and the JAX k-core op:
the reference's golden 20x20 DSD, the port's native DSD against its plain
version and against the JAX package's on random graphs, the exact clique
against brute force, the parallel clique equal to the serial one, core
numbers (native, plain, the torch op, JAX's) equal, and the native PLY
reader equal to the Python parser. Everything here is exact: sets and
integers compare equal.
"""

import numpy as np
import pytest
import torch

from clipper_tpu.ops import kcore as jkcore
from clipper_tpu.solvers import dsd as jdsd
from clipper_tpu.solvers import maxclique as jmc
from clipper_tpu_torch.bench import data
from clipper_tpu_torch.native import build as native_build
from clipper_tpu_torch.ops import kcore
from clipper_tpu_torch.solvers import dsd, maxclique

from test_dsd import TRUE_NODES, golden_matrix
from test_maxclique import brute_force_max_clique, planted_clique_graph


def _random_weighted(rng, n, p):
    W = np.triu(rng.uniform(size=(n, n)) * (rng.uniform(size=(n, n)) < p), 1)
    return W + W.T


def _random_adj(rng, n, p):
    adj = np.triu(rng.uniform(size=(n, n)) < p, 1)
    return adj | adj.T


@pytest.mark.parametrize("S", [None, [0, 1, 3, 5, 7, 12, 14, 15, 19]])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_dsd_golden(S, as_tensor):
    """reference: test/dsd_test.cpp, densest subgraph {3, 5, 12, 14, 15},
    whole and restricted to a support; numpy or tensor input."""
    M = golden_matrix()
    if as_tensor:
        M = torch.as_tensor(M)
    assert dsd.solve(M, S) == TRUE_NODES


def test_dsd_native_plain_and_jax_agree():
    """The golden matrix and random weighted graphs (n=12): the port's
    native DSD, its plain version and the JAX package's solve agree."""
    rng = np.random.default_rng(11)
    lib = native_build.load()
    cases = [np.triu(golden_matrix(), 1) + np.triu(golden_matrix(), 1).T]
    cases += [_random_weighted(rng, 12, 0.3) for _ in range(5)]
    for W in cases:
        n = W.shape[0]
        S = np.arange(n, dtype=np.int64)
        native = dsd._solve_native(lib, n, S, W)
        assert native == dsd._solve_python(n, S, W) == jdsd.solve(W)
        assert dsd.solve(W) == native


def test_dsd_planted_clique():
    rng = np.random.default_rng(5)
    n = 30
    W = np.triu(rng.uniform(0, 0.05, size=(n, n)), 1)
    clique = [2, 7, 13, 21, 28]
    for a in range(5):
        for b in range(a + 1, 5):
            W[clique[a], clique[b]] = 0.95 + rng.uniform(0, 0.05)
    assert set(clique) <= set(dsd.solve(W + W.T))


def test_max_clique_exact_against_brute_force():
    rng = np.random.default_rng(0)
    for _ in range(5):
        adj = _random_adj(rng, 14, 0.5)
        ours = maxclique.solve(adj, maxclique.Params(
            method=maxclique.Method.EXACT))
        assert len(ours) == len(brute_force_max_clique(adj))
        assert adj[np.ix_(ours, ours)][~np.eye(len(ours), dtype=bool)].all()
        assert ours == jmc.solve(adj, jmc.Params(method=jmc.Method.EXACT))
        plain = maxclique._solve_python(adj.astype(np.uint8),
                                        maxclique.Params())
        assert len(plain) == len(ours)


@pytest.mark.parametrize("method", list(maxclique.Method))
def test_max_clique_planted_matches_jax(method):
    rng = np.random.default_rng(1)
    adj, nodes = planted_clique_graph(rng, n=80, k=10, p=0.1)
    found = maxclique.solve(torch.as_tensor(adj), maxclique.Params(
        method=method))
    assert found == jmc.solve(adj, jmc.Params(method=jmc.Method(int(method))))
    if method == maxclique.Method.KCORE:
        assert set(nodes) <= set(found)
    else:
        assert len(found) >= len(nodes) - (method == maxclique.Method.HEU)
    if method != maxclique.Method.EXACT:
        assert found == maxclique._solve_python(adj.astype(np.uint8),
                                                maxclique.Params(method=method))


def test_max_clique_parallel_matches_serial():
    """threads > 1 finds a clique of the serial search's size on a dense
    random graph where the branch and bound branches (n=200, p=0.5)."""
    adj = _random_adj(np.random.default_rng(11), 200, 0.5)
    serial = maxclique.solve(adj, maxclique.Params(threads=1))
    parallel = maxclique.solve(adj, maxclique.Params(threads=4))
    assert len(parallel) == len(serial)
    sub = adj[np.ix_(parallel, parallel)]
    assert sub[~np.eye(len(parallel), dtype=bool)].all()


@pytest.mark.parametrize("n, p", [(40, 0.2), (97, 0.4)])
def test_core_numbers_native_plain_torch_jax(n, p):
    adj = _random_adj(np.random.default_rng(n), n, p)
    c_plain = maxclique._core_numbers_python(adj.astype(np.uint8))
    np.testing.assert_array_equal(maxclique.core_numbers(adj), c_plain)
    np.testing.assert_array_equal(kcore.core_numbers(adj, device="cpu")
                                  .numpy(), c_plain)
    np.testing.assert_array_equal(np.asarray(jkcore.core_numbers(adj)),
                                  c_plain)
    mask, maxcore = kcore.kcore_prune_mask(torch.as_tensor(adj))
    jmask, jmax = jkcore.kcore_prune_mask(adj)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert int(maxcore) == int(jmax) == c_plain.max()
    assert list(np.flatnonzero(mask.numpy())) == maxclique.solve(
        adj, maxclique.Params(method=maxclique.Method.KCORE))


def test_read_ply_native_equals_python_parser():
    native = data._read_ply_native(data.BUN10K)
    assert native is not None and native.shape == (9992, 3)
    np.testing.assert_array_equal(native, data._read_ply_py(data.BUN10K))
    np.testing.assert_array_equal(data.read_ply(data.BUN10K), native)


def test_read_ply_declined_layout_takes_the_python_parser(tmp_path):
    """A layout the native reader declines (a list property in the vertex
    element) goes to the Python parser, which raises for it, as the JAX
    package's does."""
    p = tmp_path / "list.ply"
    p.write_bytes(b"ply\nformat ascii 1.0\nelement vertex 1\n"
                  b"property list uchar int idx\nend_header\n1 0\n")
    assert data._read_ply_native(p) is None
    with pytest.raises(ValueError, match="list properties"):
        data.read_ply(p)
