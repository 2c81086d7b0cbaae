"""Port parity: the bench harness's trials, batched runs and grid.

The JAX functions draw u0 from a jax.random key; the port's take it as a
numpy argument, so each test hands the port np.asarray of the very vector
the JAX function draws (clipper_tpu.utils.randvec on the same key), and
both packages the same default_rng problems. P/R must match: equal masks
in f64; in f32 within one association of the mask (the f32 solves may
part at the ulp, ROADMAP Queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipper_tpu import utils as jutils
from clipper_tpu.bench import harness as jharness
from clipper_tpu_torch.bench import harness

M = 128
DTYPES = {"f64": (jnp.float64, torch.float64),
          "f32": (jnp.float32, torch.float32)}


@pytest.fixture(scope="module")
def pcd0():
    return harness.load_bunny()


def _close(got, ref, dtype_name, m):
    """P/R equal in f64; in f32 within one association of m."""
    tol = 0.0 if dtype_name == "f64" else 1.0 / (0.1 * m)
    assert got == pytest.approx(ref, abs=tol + 1e-12)


@pytest.mark.parametrize("dtype_name", ["f64", "f32"])
def test_run_trial_matches_jax(pcd0, dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    key = jax.random.PRNGKey(3)
    ref = jharness.run_trial(pcd0, M, 0.9, np.random.default_rng(3), key,
                             dtype=jdt)
    got = harness.run_trial(pcd0, M, 0.9, np.random.default_rng(3),
                            dtype=tdt, device="cpu",
                            u0=np.asarray(jutils.randvec(key, M, dtype=jdt)))
    _close((got.p, got.r), (ref.p, ref.r), dtype_name, M)
    assert got.t_affinity > 0 and got.t_solver > 0


@pytest.mark.parametrize("dtype_name", ["f64", "f32"])
def test_run_pointnormal_trial_matches_jax(dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    key = jax.random.PRNGKey(4)
    kw = dict(n=300, m=M, rho=0.8)
    ref = jharness.run_pointnormal_trial(np.random.default_rng(4), key,
                                         dtype=jdt, **kw)
    got = harness.run_pointnormal_trial(
        np.random.default_rng(4), dtype=tdt, device="cpu",
        u0=np.asarray(jutils.randvec(key, M, dtype=jdt)), **kw)
    _close((got.p, got.r), (ref.p, ref.r), dtype_name, M)


@pytest.mark.parametrize("dtype_name", ["f64", "f32"])
def test_run_batched_matches_jax(pcd0, dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    B = 3
    key = jax.random.PRNGKey(5)
    u0s = jax.vmap(lambda k: jutils.randvec(k, M, dtype=jdt))(
        jax.random.split(key, B))
    ref = jharness.run_batched(pcd0, M, 0.9, B, np.random.default_rng(5),
                               key, dtype=jdt, n_timing_reps=1)
    got = harness.run_batched(pcd0, M, 0.9, B, np.random.default_rng(5),
                              dtype=tdt, n_timing_reps=1, device="cpu",
                              u0=np.asarray(u0s))
    _close(got[1:3], ref[1:3], dtype_name, M)
    assert got[0] > 0 and got[3] > 0


def test_run_grid_rows(pcd0):
    """A 2 x 2 grid runs, one row a cell in the JAX order (rho outer, m
    inner), with the JAX rows' keys."""
    ref = jharness.run_grid(num_assocs=(64,), outrats=(0.9,), n_trials=1,
                            verbose=False)
    rows = harness.run_grid(num_assocs=(64, 96), outrats=(0.0, 0.9),
                            n_trials=1, verbose=False, device="cpu")
    assert [(r["rho"], r["m"]) for r in rows] == [
        (0.0, 64), (0.0, 96), (0.9, 64), (0.9, 96)]
    for row in rows:
        assert set(row) == set(ref[0])
        assert 0.0 <= row["precision"] <= 1.0 and 0.0 <= row["recall"] <= 1.0


def test_u0_and_generator_draws(pcd0):
    """Without u0 a trial draws from its generator: one seed, one result;
    a u0 of the wrong shape raises."""
    a, b = (harness.run_trial(pcd0, 64, 0.9, np.random.default_rng(1),
                              torch.Generator().manual_seed(7),
                              device="cpu") for _ in range(2))
    assert (a.p, a.r) == (b.p, b.r)
    with pytest.raises(ValueError, match="u0 must be"):
        harness.run_trial(pcd0, 64, 0.9, np.random.default_rng(1),
                          u0=np.ones(63), device="cpu")


def test_parse_argv_and_device():
    pos, opts = harness.parse_argv(["512", "--m=1024", "--mv-only", "7"])
    assert pos == ["512", "7"] and opts == {"m": "1024", "mv-only": True}
    assert harness.bench_device({"device": "cpu"}).type == "cpu"
    with pytest.raises(ValueError, match="--device"):
        harness.bench_device({"device": "tpu"})
