"""The multi-GPU dry run and the 2D engine's bench on gloo ranks.

clipper_tpu_torch.dryrun.dryrun_multichip (the counterpart of
__graft_entry__.dryrun_multichip) through its command line on 1 and 2
spawned gloo ranks on the CPU, with the JAX dry run's shapes; and
bench/sharded_bench.py through ``cpu_mesh_run --bench=sharded`` on 2
ranks at m=256, and in this process on one rank.
"""

import json

import numpy as np
import pytest

from clipper_tpu_torch import dryrun
from clipper_tpu_torch.bench import cpu_mesh_run, sharded_bench


@pytest.mark.parametrize("ranks", [1, 2])
def test_dryrun_multichip(ranks, capsys):
    """Every multi-rank path once; the convergent check on the squarest
    mesh: f64 masks equal to the single-device flat solver's (and, on
    the CPU, u within tests/test_parallel.py's 1e-8 of it), f32 within
    IoU 0.95; one JSON line printed."""
    out = dryrun.main(["--ranks", str(ranks), "--device", "cpu",
                       "--timeout", "180"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == json.loads(json.dumps(out))
    assert out["ranks"] == ranks and out["mesh"] == [1, ranks]
    assert (out["m"], out["tile"], out["device"]) == (64, 16, "cpu")
    f64, f32 = out["parity_float64"], out["parity_float32"]
    assert f64["iou"] == 1.0 and f64["selected"] > 0
    assert f64["max_du"] <= 1e-8
    assert f32["iou"] >= 0.95 and f32["selected"] > 0


def test_dryrun_wrong_group_size_raises():
    with pytest.raises(RuntimeError, match="needs a group of 2 ranks"):
        dryrun.dryrun_multichip(2, device="cpu")


def test_sharded_bench_on_gloo_ranks(capfd):
    """--bench=sharded on 2 ranks at m=256: both meshes of the sweep (1x2,
    2x1) at the bench bar, and the strong-scaling table."""
    out = cpu_mesh_run.main(["--ranks", "2", "--bench=sharded", "256", "1",
                             "--rho=0.9", "--timeout=180"])
    text = capfd.readouterr().out
    assert out["ranks"] == 2
    assert [r["mesh"] for r in out["rows"]] == [[1, 2], [2, 1]]
    for row in out["rows"]:
        assert np.isfinite(row["ms"]) and row["m"] == 256
        assert row["precision"] >= 0.95 and row["recall"] >= 0.8
        assert row["stats"]["polish_branch"] == "support"
    assert "strong scaling" in text and "per-rank [M;C] block" in text


def test_sharded_bench_one_rank():
    """No process group: one rank, the given mesh, the options parsed."""
    out = sharded_bench.main(["256", "1", "--device=cpu", "--storage=bf16",
                              "--probes=4", "--mesh=1x1", "--mesh=1x2",
                              "--matvec-chunk=64", "--build-chunk=64"])
    assert out["ranks"] == 1 and len(out["rows"]) == 1
    row = out["rows"][0]
    assert row["mesh"] == [1, 1] and abs(row["block_gb"] - 2 * 256 * 256
                                         * 2 / 1e9) < 1e-12
    assert row["precision"] >= 0.95 and row["recall"] >= 0.8
