"""The readers of the program's own spans and counters: a traced run of
the cell on the CPU at a small size gives each a finite value that agrees
with the program's tracer, and each reads None where the tracer recorded
nothing or the program has none."""

import math

import pytest

from benchmark import runner
from benchmark.tests.test_e2e_faults import BENCH, small_cell
from clipper_tpu_torch.utils import profiling

READERS = ("pga.host_reads", "pga.linesearch_steps", "pga.read_wait_ms",
           "pga.host_ms", "facade.self_ms")
CELL = "bunny.dense_m2048"


@pytest.fixture(scope="module")
def traced():
    """A traced run's result and the tracer's totals behind it."""
    profiling.reset()
    cell, config, traffic, limits = small_cell(CELL)
    out = runner.run_cell(BENCH, cell, config, traffic, limits,
                          2 ** 31 + 23, 0.3, True, "cpu", workers=2)
    totals = profiling.totals()
    profiling.reset()
    return out, totals


def test_readers_are_the_cells_per_layer_metrics():
    names = {m["name"] for m in runner.cell_metrics(BENCH, CELL,
                                                    "per_layer")}
    assert set(READERS) <= names


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_a_traced_run(traced, name):
    out, _ = traced
    assert out["correct"]
    value = out["metrics"][name]["value"]
    assert math.isfinite(value) and value > 0


def test_readings_agree_with_the_tracer(traced):
    out, totals = traced
    n = out["attempted"] - out["failed"]
    c, s = totals["counters"], totals["spans"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert got["pga.host_reads"] == pytest.approx(c["pga.host_reads"] / n)
    assert got["pga.linesearch_steps"] == pytest.approx(
        c["pga.linesearch_steps"] / n)
    wait = c["pga.read_wait_ns"] * 1e-6
    assert got["pga.read_wait_ms"] == pytest.approx(wait / n)
    assert got["pga.host_ms"] == pytest.approx((s["pga"]["ms"] - wait) / n)
    assert got["facade.self_ms"] == pytest.approx(
        (s["facade.score"]["self_ms"] + s["facade.solve"]["self_ms"]) / n)
    # every request of the window, and none of the warm-up, was traced
    assert s["facade.score"]["count"] == s["facade.solve"]["count"] == n
    assert (c["pga.linesearch_steps"] + c["pga.inner_steps"]
            + c["pga.outer_steps"] <= c["pga.host_reads"]
            <= c["pga.linesearch_steps"] + c["pga.inner_steps"]
            + 2 * c["pga.outer_steps"])


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_on_an_empty_tracer(name):
    profiling.reset()
    assert runner.read_layer(name, {"requests": 4}) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_without_a_tracer(name, monkeypatch):
    """A program from before the tracer (the parent of a comparison)."""
    monkeypatch.delattr(profiling, "totals")
    assert runner.read_layer(name, {"requests": 4}) is None
