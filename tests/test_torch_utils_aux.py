"""Port parity: utils/transforms.py, utils/profiling.py and the solution
checkpoint of utils/checkpoint.py against clipper_tpu's (mirrors
tests/test_utils_aux.py). Kabsch agrees with JAX's within 1e-12 in f64."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipper_tpu.utils.transforms import kabsch_se3 as jkabsch
from clipper_tpu.utils.transforms import transform_rmse as jrmse
from clipper_tpu_torch import Clipper, EuclideanDistance
from clipper_tpu_torch.utils import Timer, checkpoint
from clipper_tpu_torch.utils.profiling import (StageTimer, annotate,
                                               device_trace)
from clipper_tpu_torch.utils.transforms import kabsch_se3, transform_rmse

from test_affinity import make_scene


def test_solution_checkpoint_roundtrip(tmp_path):
    model, data = make_scene()
    c = Clipper(EuclideanDistance(), dtype=torch.float64, device="cpu")
    c.score_pairwise_consistency(model, data)
    soln = c.solve(u0=np.random.default_rng(0).random(12))

    path = tmp_path / "soln.npz"
    checkpoint.save_solution(path, soln)
    back = checkpoint.load_solution(path, device="cpu")
    for name in ("ifinal", "mask", "u0", "u", "score"):
        a, b = getattr(soln, name), getattr(back, name)
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), name
    assert back.t == soln.t

    # warm-start from the checkpointed iterate reproduces the selection
    soln2 = c.solve(u0=back.u)
    assert torch.equal(soln2.mask, soln.mask)


def test_solution_checkpoint_reads_jax_file(tmp_path):
    """A Solution saved by the JAX package loads with the same values."""
    import clipper_tpu as ct
    from clipper_tpu.utils import checkpoint as jcheckpoint
    model, data = make_scene()
    jc = ct.Clipper(ct.EuclideanDistance(), ct.Params())
    jc.score_pairwise_consistency(model, data)
    jsoln = jc.solve(u0=np.random.default_rng(0).random(12))
    path = tmp_path / "jax_soln.npz"
    jcheckpoint.save_solution(path, jsoln)
    back = checkpoint.load_solution(path, device="cpu")
    np.testing.assert_array_equal(back.mask.numpy(), np.asarray(jsoln.mask))
    np.testing.assert_array_equal(back.u.numpy(), np.asarray(jsoln.u))
    assert back.u.dtype == torch.float64


def test_stage_timer():
    st = StageTimer()
    with st.stage("a"):
        pass
    with st.stage("b"):
        pass
    rep = st.report()
    assert set(rep) == {"total", "a", "b"}
    assert rep["total"] >= rep["a"]


def test_stage_timer_opens_a_span():
    """Each stage is a span of its name while a profiler runs."""
    from torch.profiler import ProfilerActivity, profile

    from clipper_tpu_torch.utils import profiling
    profiling.reset()
    st = StageTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with st.stage("a"):
            torch.ones(8) + 1
        with st.stage("a"):
            pass
    spans = profiling.totals()["spans"]
    profiling.reset()
    assert spans["a"]["count"] == 2
    assert spans["a"]["ms"] <= st.report()["a"] * 1e3
    assert sum(e.name == "a" for e in prof.events()) == 2


def test_named_timer():
    t = Timer("x")
    t.start()
    dt = t.stop()
    assert dt >= 0
    t2 = t + Timer("x")
    assert t2.count == 1


def test_device_trace_writes_named_regions(tmp_path):
    with device_trace(str(tmp_path)) as prof:
        with annotate("sdr-region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "sdr-region" in names
    assert any(e.key == "sdr-region" for e in prof.key_averages())


def _rot(th):
    return np.array([[np.cos(th), -np.sin(th), 0],
                     [np.sin(th), np.cos(th), 0],
                     [0, 0, 1]])


def test_kabsch_recovers_transform():
    rng = np.random.default_rng(0)
    P = rng.normal(size=(50, 3))
    R_true = _rot(0.7)
    t_true = np.array([1.0, -2.0, 0.5])
    Q = P @ R_true.T + t_true
    R, t = kabsch_se3(torch.tensor(P), torch.tensor(Q))
    np.testing.assert_allclose(R.numpy(), R_true, atol=1e-8)
    np.testing.assert_allclose(t.numpy(), t_true, atol=1e-8)
    assert float(transform_rmse(P, Q, R, t)) < 1e-8


def test_kabsch_weighted_ignores_outliers():
    rng = np.random.default_rng(1)
    P = rng.normal(size=(40, 3))
    t_true = np.array([0.5, 0.5, 0.5])
    Q = P + t_true
    Q[0] += 100.0  # gross outlier
    w = np.ones(40)
    w[0] = 0.0
    R, t = kabsch_se3(torch.tensor(P), torch.tensor(Q), torch.tensor(w))
    np.testing.assert_allclose(t.numpy(), t_true, atol=1e-8)


@pytest.mark.parametrize("seed,reflect", [(2, False), (3, False), (4, True)])
def test_kabsch_matches_jax(seed, reflect):
    """Noisy, weighted correspondences (and a reflected target, where the
    det correction acts): R, t and the RMSE within 1e-12 of JAX's."""
    rng = np.random.default_rng(seed)
    P = rng.normal(size=(30, 3))
    Q = P @ _rot(seed).T + rng.normal(size=3) + 0.05 * rng.normal(
        size=(30, 3))
    if reflect:
        Q[:, 2] *= -1
    w = rng.uniform(size=30)
    R, t = kabsch_se3(torch.tensor(P), torch.tensor(Q), torch.tensor(w))
    Rj, tj = jkabsch(jnp.asarray(P), jnp.asarray(Q), jnp.asarray(w))
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), rtol=0, atol=1e-12)
    assert float(torch.linalg.det(R)) == pytest.approx(1.0, abs=1e-12)
    assert float(transform_rmse(P, Q, R, t)) == pytest.approx(
        float(jrmse(jnp.asarray(P), jnp.asarray(Q), Rj, tj)), abs=1e-12)
