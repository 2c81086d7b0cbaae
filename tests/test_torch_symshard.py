"""Port parity: the triangle-sharded engine over torch.distributed.

clipper_tpu_torch.ops.symstore.solve_sharded_sym runs on D gloo ranks on
the CPU (clipper_tpu_torch/bench/cpu_mesh_run.py, spawned processes that
meet through a FileStore) and is held to clipper_tpu's solve_sharded_sym on
a D-device mesh of the virtual CPU devices, on tests/test_symshard.py's
scenes: equal masks in mode "xla" (int8 and f32 storage) and mode "pallas"
(G=2, int8), every rank's u bitwise equal, D = 2 and 3 giving the masks of
D = 1, and the overflow case's exact polish. Each group of ranks runs under
its own timeout, so a hung collective fails the test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import clipper_tpu as ct
from clipper_tpu.ops import symstore as jsym
from clipper_tpu_torch.bench import cpu_mesh_run
from clipper_tpu_torch.invariants.euclidean import EuclideanDistance

from test_symshard import make_problem

JINV = ct.EuclideanDistance()
RANKS = (1, 2, 3)
# mode, JAX storage, port storage (tests/test_symshard.py's cases)
CASES = {"xla-int8": ("xla", jnp.int8, torch.int8),
         "xla-f32": ("xla", jnp.float32, torch.float32),
         "pallas-int8": ("pallas", jnp.int8, torch.int8)}
OPTS = dict(tile=32, power_steps=4, support=64, build_chunk=3, G=2)


def _scene(seed, m, n_inliers):
    rng = np.random.default_rng(seed)
    D1, D2, A = make_problem(rng, n=120, n_inliers=n_inliers, m=m)
    u0 = rng.uniform(size=m).astype(np.float32)
    return (np.asarray(D1, np.float32), np.asarray(D2, np.float32),
            np.asarray(A, np.int32), u0)


def _jobs():
    D1, D2, A, u0 = _scene(3, 100, 40)
    jobs = [dict(D1=D1, D2=D2, A=A, u0=u0, invariant=EuclideanDistance(),
                 matvec=mode, storage_dtype=st, **OPTS)
            for mode, _, st in CASES.values()]
    D1, D2, A, u0 = _scene(5, 96, 60)
    jobs.append(dict(D1=D1, D2=D2, A=A, u0=u0, invariant=EuclideanDistance(),
                     matvec="xla",
                     storage_dtype=torch.int8, **dict(OPTS, support=8)))
    return jobs


@pytest.fixture(scope="module")
def port():
    """{D: rank 0's result of each job}: one group of D gloo ranks per D,
    each under a 120 s timeout."""
    jobs = _jobs()
    return {D: cpu_mesh_run.run(D, jobs, timeout=120.0) for D in RANKS}


def _jax_solve(D, job, mode, storage):
    mesh = Mesh(np.array(jax.devices()[:D]), ("d",))
    opts = dict(OPTS, support=job["support"])
    return jsym.solve_sharded_sym(
        JINV, jnp.asarray(job["D1"]), jnp.asarray(job["D2"]),
        jnp.asarray(job["A"]), jnp.asarray(job["u0"]), ct.Params(), mesh,
        storage_dtype=storage, matvec=mode, mv_chunk=2, **opts)


@pytest.mark.parametrize("D", RANKS)
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_matches_jax(port, D, case):
    """Equal masks with the JAX engine on a D-device mesh, F within 1e-4
    relative, and every rank's u bitwise equal to rank 0's."""
    idx = list(CASES).index(case)
    mode, jst, _ = CASES[case]
    got = port[D][idx]
    ref = _jax_solve(D, _jobs()[idx], mode, jst)
    assert got["ranks_agree"]
    assert got["u"].shape == (100,) and got["u"].dtype == np.float32
    np.testing.assert_array_equal(got["mask"], np.asarray(ref.mask))
    assert got["mask"].sum() > 0
    assert abs(got["score"] - float(ref.score)) <= 1e-4 * float(ref.score)
    assert got["stats"]["ranks"] == D
    assert got["stats"]["layout"] == ("tile-list" if mode == "xla"
                                      else "row-chunked")


@pytest.mark.parametrize("D", [2, 3])
def test_sharded_ranks_match_one_rank(port, D):
    """D ranks give one rank's masks and ifinal in every job; each rank
    holds about 1/D of the storage bytes."""
    for one, many in zip(port[1], port[D]):
        np.testing.assert_array_equal(many["mask"], one["mask"])
        assert many["ifinal"] == one["ifinal"]
        assert many["ranks_agree"]
        assert (many["stats"]["storage_bytes"]
                <= one["stats"]["storage_bytes"] // D + 2 * 64 * 32 * 4 * 2)


@pytest.mark.parametrize("D", RANKS)
def test_sharded_overflow_exact_polish(port, D):
    """A clique wider than support=8 takes the exact branch: the ranks'
    partial objectives, all-reduced, within 0.2 of the dense f64 rebuild
    (tests/test_symshard.py's bar)."""
    from clipper_tpu.ops.affinity import score_pairwise_consistency
    job = _jobs()[-1]
    got = port[D][-1]
    assert (got["u"] > 0).sum() > 8
    M, _ = score_pairwise_consistency(JINV, jnp.asarray(job["D1"]),
                                      jnp.asarray(job["D2"]),
                                      jnp.asarray(job["A"]), affinityeps=1e-4)
    u = got["u"].astype(np.float64)
    F_ref = float(u @ (np.asarray(M, np.float64) @ u) + u @ u)
    assert abs(got["score"] - F_ref) < 0.2, (got["score"], F_ref)
    assert got["mask"].sum() >= 0.8 * 60
    assert got["ranks_agree"]


def test_cpu_mesh_run_fails_fast():
    """A rank that raises fails the run with its error, not a hang."""
    D1, D2, A, u0 = _scene(3, 100, 40)
    job = dict(D1=D1, D2=D2, A=A, u0=u0, matvec="tiles")
    with pytest.raises(RuntimeError, match="unknown matvec"):
        cpu_mesh_run.run(2, [job], timeout=60.0)
