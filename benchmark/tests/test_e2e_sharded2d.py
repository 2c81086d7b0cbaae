"""The cell ``bunny.sharded_m262144`` driven on the CPU at a small size:
its entry kind ``kinds/sharded2d.py`` run by ``ranks.launch`` as 4 gloo
ranks (the path ``run.py`` takes for a cell on 4 cards, past its look for
the cards) on the test-only traffic ``traffic/sharded_small.json``
(m = 512), sound and with each fault of ``faults_sharded.py`` planted on
every rank (the test-only kind ``kinds/sharded2d_fault.py``); its
control (``control_sharded.py``) at the same size; its six per-layer
readers on synthetic records; and its least times at the cell's size.
Each launch has its own deadline."""

import contextlib
import io
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import pytest

from benchmark import faults_sharded, ranks, roofline_sharded, runner
from benchmark.trace import Summary

HERE = Path(__file__).resolve().parent
KINDS = (runner.KINDS_DIR, HERE / "kinds")
CELL = "bunny.sharded_m262144"
BENCH = runner.load_json(runner.ROOT / "BENCHMARK.json")
METRICS = ("sharded.build_ms", "sharded.solve_stage_ms", "sharded.matvecs",
           "sharded.collective_ms", "kernel.block_matvec_roofline",
           "kernel.block_build_roofline")
DEADLINE_S = 120


def small_traffic(**changes):
    return dict(json.loads((HERE / "traffic" / "sharded_small.json")
                           .read_text()), **changes)


def launched(traffic, trace=False):
    """(exit code, the result line or None, standard error) of one run of
    the cell on 4 gloo ranks."""
    cell = runner.find(BENCH["workloads"], CELL, "workload")
    config = runner.load_json(runner.BENCH_DIR / "configs"
                              / f"{cell['config']}.json")
    limits = runner.load_json(runner.BENCH_DIR / "workloads"
                              / f"{CELL}.json")["limits"]
    job = ranks.job(BENCH, cell, config, traffic, limits, 2 ** 31 + 99, 0.5,
                    trace, "cpu", time.perf_counter(), kinds=KINDS,
                    group_timeout_s=60)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = ranks.launch(job, 4, DEADLINE_S)
    lines = out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None, err.getvalue()


@pytest.fixture(scope="module")
def sound():
    return launched(small_traffic())


def test_sound_run_is_correct_on_four_ranks(sound):
    rc, line, err = sound
    assert rc == 0, err
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert line["device"]["count"] == 4
    assert set(line["metrics"]) == {"solve_ms", "setup_s"}
    assert line["checks"]["rank_disagreement"]["value"] == 0.0
    assert set(line["checks"]) == set(runner.load_json(
        runner.BENCH_DIR / "workloads" / f"{CELL}.json")["limits"])


def test_traced_run_reads_the_program():
    """A traced run carries every per-layer metric of the cell that a CPU
    trace has: all but the collectives' device time."""
    rc, line, err = launched(small_traffic(), trace=True)
    assert rc == 0, err
    assert line["correct"], line["checks"]
    want = set(METRICS) - {"sharded.collective_ms"}
    assert set(line["metrics"]) == want
    assert line["metrics"]["sharded.matvecs"]["value"] > 2
    for name in ("kernel.block_matvec_roofline",
                 "kernel.block_build_roofline"):
        assert 0 < line["metrics"][name]["value"] < 100


@pytest.mark.parametrize("fault", faults_sharded.FAULTS)
def test_fault_reads_not_correct(fault):
    rc, line, err = launched(small_traffic(entry="sharded2d_fault",
                                           fault=fault))
    assert rc == 0, err
    assert not line["correct"], line["checks"]
    # the fault is the program's, not a disagreement between ranks
    assert line["checks"]["rank_disagreement"]["value"] == 0.0


def test_control_and_faults_fail_and_the_program_passes():
    """control_sharded.py at the small size: the program passes every
    limit, the bfloat16 reference and each fault fail one."""
    t = small_traffic()
    res = subprocess.run(
        [sys.executable, str(runner.BENCH_DIR / "control_sharded.py"),
         "--workload", CELL, "--seeds", "5,6", "--device", "cpu",
         "--problems", "1", "--traffic",
         json.dumps({k: t[k] for k in ("m", "rho", "distinct_requests",
                                       "sharded")})],
        capture_output=True, text=True, timeout=DEADLINE_S,
        cwd=runner.ROOT)
    assert res.returncode == 0, res.stderr
    rows = [json.loads(x) for x in res.stdout.strip().splitlines()]
    summary = rows.pop()
    assert summary["seeds"] == 2 and summary["ranks"] == 4
    assert all(r["program_correct"] for r in rows)
    first = rows[0]
    for name in ("bf16",) + faults_sharded.FAULTS:
        assert first[f"{name}_correct"] is False, first[name]


# ----------------------------------------------------------------------
# the readers, on synthetic records
# ----------------------------------------------------------------------

def summary(nccl_s):
    kernels = {"ncclDevKernel_AllReduce_Sum_f64_RING_LL": (nccl_s, 10),
               "Memcpy DtoD": (0.5, 3)}
    return Summary(kernels, 1.0, [], 13)


def record(requests=2):
    return {"stage_ms": {"sharded.build": [1000.0, 1200.0],
                         "sharded.solve": [8000.0, 10000.0]},
            "launches": {"block_build": [0.0103] * 2,
                         "block_matvec": [0.0103] * 2},
            "summary": summary(0.2), "window_s": 20.0, "requests": requests,
            "ranks": [{"summary": summary(0.2)}, {"summary": summary(0.6)}]}


@pytest.fixture
def counters():
    from clipper_tpu_torch.utils import profiling
    profiling.reset()
    profiling.count({"sharded.matvecs": 200})
    yield
    profiling.reset()


def test_readers_on_a_synthetic_record(counters):
    r = record()
    got = {n: runner.read_layer(n, r) for n in METRICS}
    assert got["sharded.build_ms"] == pytest.approx(1100.0)
    assert got["sharded.solve_stage_ms"] == pytest.approx(9000.0)
    assert got["sharded.matvecs"] == pytest.approx(100.0)
    # the slowest card's 0.6 s over 2 requests
    assert got["sharded.collective_ms"] == pytest.approx(300.0)
    assert got["kernel.block_matvec_roofline"] == pytest.approx(
        100 * 100 * 0.0103 / 9.0)
    assert got["kernel.block_build_roofline"] == pytest.approx(
        100 * 0.0103 / 1.1)


def test_readers_find_nothing_where_the_inputs_are_missing():
    from clipper_tpu_torch.utils import profiling
    profiling.reset()
    bare = {"stage_ms": {}, "launches": {}, "summary": summary(0.0),
            "window_s": 20.0, "requests": 2}
    for n in METRICS:
        assert runner.read_layer(n, bare) is None, n
    # and where the program counts no matvec: the counter is missing
    r = record()
    assert runner.read_layer("sharded.matvecs", r) is None
    assert runner.read_layer("kernel.block_matvec_roofline", r) is None


def test_least_times_at_the_cells_size():
    """m = 262,144 on 2 x 2 in int8: a rank holds 2 (m/2)^2 bytes; one
    read of them, and the build's write or its 30 operations a pair."""
    m = 262144
    n_bytes = 2 * (m // 2) ** 2
    assert roofline_sharded.block_pairs(m, 2, 2) == (m // 2) ** 2
    assert roofline_sharded.block_matvec(m, 2, 2, "int8") == pytest.approx(
        n_bytes / 3.35e12)
    assert roofline_sharded.block_build(m, 2, 2, "int8") == pytest.approx(
        max(n_bytes / 3.35e12, (m // 2) ** 2 * 30 / 67e12))
    assert math.isclose(n_bytes, 34.36e9, rel_tol=1e-3)
