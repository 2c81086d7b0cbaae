"""The port's bench drivers on the CPU at their smallest settings.

Each driver's main([..., "--device=cpu"]) runs the plain versions of its
path (m <= 256, W <= 8) and returns or prints its table; with the default
--device=cuda it raises where there is no CUDA. The grid and mixed
drivers run a smaller grid by patching their module constants.
symshard_bench also runs through cpu_mesh_run on D=2 gloo ranks, and
tickstats' lane counts are held to the JAX tool's vmapped single solves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipper_tpu.bench import harness as jharness
from clipper_tpu.ops import affinity as jaffinity
from clipper_tpu.solvers import msrc_flat as jmsrc_flat
from clipper_tpu.types import Params as JParams
from clipper_tpu_torch import _kernels
from clipper_tpu_torch.bench import (build_probe, capacity_stages,
                                     cpu_mesh_run, grid_tpu,
                                     gridcell_probe, mixed_bench,
                                     multistart_bench, pool_ab,
                                     sdp_bench, symshard_bench,
                                     symstore_bench, harness, tickstats)
from clipper_tpu_torch.ops.affinity import score_pairwise_consistency

CPU = "--device=cpu"


def _finite_pr(rows):
    for row in rows:
        assert np.isfinite(row["precision"]) and np.isfinite(row["recall"])
        assert 0.0 <= row["precision"] <= 1.0


def test_build_probe_main():
    out = build_probe.main(["2", "100", CPU])
    assert set(out) == set(build_probe.VARIANTS)
    assert all(v > 0 for v in out.values())


@pytest.mark.parametrize("engine", ["pool", "batched"])
def test_grid_tpu_main(engine, capsys, monkeypatch):
    monkeypatch.setattr(grid_tpu, "NUM_ASSOCS", (64, 128))
    monkeypatch.setattr(grid_tpu, "OUTRATS", (0.0, 0.9))
    rows = grid_tpu.main(["2", f"--engine={engine}", CPU])
    assert [(r["m"], r["rho"]) for r in rows] == [
        (64, 0.0), (64, 0.9), (128, 0.0), (128, 0.9)]
    _finite_pr(rows)
    assert "| rho | m |" in capsys.readouterr().out


def test_pool_ab_main():
    rows = pool_ab.main(["4", "--m=128", CPU])
    assert [r["config"] for r in rows] == list(pool_ab.CONFIGS)
    _finite_pr(rows)
    # every configuration names its layout: the port's default differs
    assert all("layout" in kw for kw in pool_ab.CONFIGS.values())


def test_multistart_bench_main():
    out = multistart_bench.main(["4", "2", "1", "--m=128", CPU])
    _finite_pr([out["single"], out["multi"]])
    assert out["multi"]["K"] == 2


def test_mixed_bench_main(monkeypatch):
    monkeypatch.setattr(mixed_bench, "SIZES", (128, 256))
    out = mixed_bench.main(["2", "1", CPU])
    _finite_pr([out])
    assert set(out["homogeneous_ms"]) == {128, 256}


@pytest.mark.parametrize("storage", ["bf16", "int8", "f32"])
def test_tickstats_main(storage):
    out = tickstats.main(["3", "128", "0.9", "--power=2",
                          f"--storage={storage}", CPU])
    assert out["ticks"].shape == (3,) and (out["ticks"] > 0).all()
    assert (out["nback"] <= out["ticks"]).all()
    assert 0.0 < out["utilization"] <= 1.0


@pytest.mark.parametrize("power", [0, 2])
def test_tickstats_lanes_match_jax(power):
    """Each lane's (outer i, ticks, backtracks) equals the JAX tool's:
    its vmapped flat_solve_single over stacked_dual_matvec on the same
    default_rng problems and u0s, in f64 with f64 storage (exact counts,
    as in test_torch_msrc's flat solver parity)."""
    B, m = 3, 128
    pcd0 = harness.load_bunny()
    rng = np.random.default_rng(5)
    probs = [harness.make_problem(pcd0, m, 0.9, rng) for _ in range(B)]
    D2s = np.stack([p[0] for p in probs])
    As = np.stack([p[1] for p in probs]).astype(np.int32)
    u0s = np.random.default_rng(6).uniform(size=(B, m))
    jinv = jharness.default_invariant()
    jD1 = jnp.asarray(pcd0, jnp.float64)

    @jax.jit
    @jax.vmap
    def run(D2, A, u0):
        M, C = jaffinity.score_pairwise_consistency(jinv, jD1, D2, A,
                                                    affinityeps=1e-4)
        mv = jmsrc_flat.stacked_dual_matvec(M, C, None)
        if power:
            u0 = jmsrc_flat.power_init(mv, u0, power)
        _, _, i, ticks, nback = jmsrc_flat.flat_solve_single(
            mv, u0, JParams(), return_ticks=True)
        return i, ticks, nback

    ref = [np.asarray(x) for x in run(jnp.asarray(D2s), jnp.asarray(As),
                                      jnp.asarray(u0s))]
    M, C = score_pairwise_consistency(
        harness.default_invariant(), torch.from_numpy(pcd0),
        torch.from_numpy(D2s), torch.from_numpy(As), affinityeps=1e-4)
    got = tickstats.lane_ticks(M, C, torch.from_numpy(u0s), None, power)
    for name, g, r in zip(("outer i", "ticks", "backtracks"), got, ref):
        np.testing.assert_array_equal(g, r, err_msg=name)
    assert (got[1] > 0).all()


def test_gridcell_probe_main():
    rows = gridcell_probe.main(["3", "128", "--rhos=0,0.9", CPU])
    _finite_pr(rows)
    for row in rows:
        assert row["windows"] >= 1 and row["max_ticks"] > 0
        assert {"build_ms", "init_ms", "solve_ms", "polish_ms"} <= set(row)


def test_sdp_bench_main(capsys):
    rows = sdp_bench.main(["--sizes=64,128", "--batch=2", CPU])
    assert [(r["solver"], r["m"]) for r in rows] == [
        ("sdp", 64), ("pga", 64), ("sdp_batched", 64),
        ("sdp", 128), ("pga", 128), ("sdp_batched", 128)]
    _finite_pr(rows)
    sdp_rows = [r for r in rows if r["solver"] == "sdp"]
    assert all(r["iters"] > 0 and np.isfinite(r["gap"]) for r in sdp_rows)
    out = capsys.readouterr().out
    assert "SDP    m=  128" in out and "SDPxB" in out


def test_symstore_bench_main():
    before = dict(_kernels.LAUNCHES)
    out = symstore_bench.main(["200", "--probes=4", "--rho=0.9", CPU])
    assert _kernels.LAUNCHES == before
    assert {"sym tiles (plain) K=1", "sym rows (plain) K=4",
            "dense stacked int8 K=4"} <= set(out["mv_ms"])
    _finite_pr([out])
    mv = symstore_bench.main(["200", "--mv-only", "--skip-dense",
                              "--rows-only", CPU])
    assert set(mv) == {"mv_ms"} and list(mv["mv_ms"]) == [
        "sym rows (plain) K=1"]


@pytest.mark.parametrize("layout", ["rows", "tiles"])
def test_capacity_stages_main(layout):
    """One warm-up and two timed calls of the triangle engine in either
    layout, each with its four stage times and wall time."""
    rows = capacity_stages.main(["512", "--calls=2", f"--layout={layout}",
                                 CPU])
    assert len(rows) == 2
    for row in rows:
        assert set(row) == {"wall_s", *capacity_stages.STAGES}
        assert all(np.isfinite(v) and v >= 0 for v in row.values())


def test_symshard_bench_main():
    out = symshard_bench.main(["256", "--rho=0.9", "--matvec=xla", CPU])
    assert out["ranks"] == 1 and len(out["times"]) == 1
    _finite_pr([out])


def test_symshard_bench_on_gloo_ranks():
    """cpu_mesh_run's --bench=symshard hook: D=2 gloo ranks, each running
    the driver; the engine's result equals the one-rank run's."""
    argv = ["256", "--rho=0.9", "--support=64"]
    one = symshard_bench.main(argv + [CPU])
    two = cpu_mesh_run.main(["--bench=symshard", "--ranks", "2",
                             "--timeout", "120"] + argv)
    assert two["ranks"] == 2
    assert two["F"] == one["F"]
    assert (two["precision"], two["recall"]) == (one["precision"],
                                                 one["recall"])


DRIVERS = {
    "build_probe": (build_probe, ["2", "64"]),
    "grid_tpu": (grid_tpu, ["2"]),
    "pool_ab": (pool_ab, ["2", "--m=128"]),
    "multistart_bench": (multistart_bench, ["2", "2", "1", "--m=128"]),
    "mixed_bench": (mixed_bench, ["1", "1"]),
    "tickstats": (tickstats, ["2", "128"]),
    "gridcell_probe": (gridcell_probe, ["2", "128"]),
    "symstore_bench": (symstore_bench, ["128"]),
    "sdp_bench": (sdp_bench, ["--sizes=64", "--batch=2"]),
    "symshard_bench": (symshard_bench, ["128"]),
    "capacity_stages": (capacity_stages, ["128"]),
}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_driver_raises_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    module, argv = DRIVERS[name]
    for extra in ([], ["--device=cuda"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            module.main(argv + extra)
