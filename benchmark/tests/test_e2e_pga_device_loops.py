"""The reader of ``pga.device_loops``, the program's count of dense PGA
solves that ran their whole loop on the device: it reads the counter a
request, and None where the program published none (a CPU run, whose
solves take the host loop, or a program without the counter)."""

import pytest

from benchmark import runner
from benchmark.tests.test_e2e_faults import BENCH, small_cell
from clipper_tpu_torch.utils import profiling

NAME = "pga.device_loops"
CELL = "bunny.dense_m2048"


@pytest.fixture(scope="module")
def traced():
    """A traced run's result on the CPU and the tracer's totals behind it."""
    profiling.reset()
    cell, config, traffic, limits = small_cell(CELL)
    out = runner.run_cell(BENCH, cell, config, traffic, limits,
                          2 ** 31 + 29, 0.3, True, "cpu", workers=2)
    totals = profiling.totals()
    profiling.reset()
    return out, totals


def test_reader_is_a_cells_per_layer_metric():
    names = {m["name"] for m in runner.cell_metrics(BENCH, CELL,
                                                    "per_layer")}
    assert NAME in names


def test_reader_reads_the_counter_a_request():
    """As the program publishes it on the kernel route: one a solve."""
    profiling.reset()
    profiling.count({NAME: 6, "pga.host_reads": 6})
    try:
        assert runner.read_layer(NAME, {"requests": 6}) == 1.0
        assert runner.read_layer(NAME, {"requests": 4}) == 1.5
    finally:
        profiling.reset()


def test_reader_is_none_on_the_host_loop(traced):
    """A CPU run's solves take the host loop: no counter, no reading, and
    the run's line leaves the metric out."""
    out, totals = traced
    assert out["correct"]
    assert NAME not in totals["counters"]
    assert NAME not in out["metrics"]


def test_reader_is_none_on_an_empty_tracer():
    profiling.reset()
    assert runner.read_layer(NAME, {"requests": 4}) is None


def test_reader_is_none_without_a_tracer(monkeypatch):
    """A program from before the tracer (the parent of a comparison)."""
    monkeypatch.delattr(profiling, "totals")
    assert runner.read_layer(NAME, {"requests": 4}) is None
