"""Each cell driven on the CPU at a small size (the look for a card
skipped): sound, its run reads correct under the committed limits; with
each fault the cell can have planted under the timed path, and with its
control in the program's place, it reads not correct."""

import json
from pathlib import Path

import pytest
import torch

from benchmark import control, faults, runner
from benchmark.traffic import generate

BENCH = runner.load_json(runner.ROOT / "BENCHMARK.json")
CELLS = BENCH["workloads"]
# small sizes of each cell's traffic, on the CPU
SMALL = {
    "bunny.dense_m2048": dict(m=256, distinct_requests=3, warm_requests=3,
                              judged=6),
}
# what each cell can have (faults.py): a facade request holds one problem
CELL_FAULTS = {"bunny.dense_m2048": ("state", "truncate", "alter")}
# each cell's control: one step below its configuration's precision
CONTROL = {"bunny.dense_m2048": "bf16"}


def small_cell(name):
    cell = runner.find(CELLS, name, "workload")
    config = runner.load_json(runner.BENCH_DIR / "configs"
                              / f"{cell['config']}.json")
    traffic = generate.load_traffic(cell["traffic"])
    for k, v in SMALL[name].items():
        traffic[k] = dict(traffic[k], **v) if isinstance(v, dict) else v
    limits = runner.load_json(runner.BENCH_DIR / "workloads"
                              / f"{name}.json")["limits"]
    return cell, config, traffic, limits


def run_small(name, seed=2 ** 31 + 11):
    cell, config, traffic, limits = small_cell(name)
    return runner.run_cell(BENCH, cell, config, traffic, limits, seed, 0.3,
                           False, "cpu", workers=2)


def test_every_cell_has_its_faults_and_control():
    assert set(CELL_FAULTS) == {w["name"] for w in CELLS}
    assert set(CONTROL) == set(CELL_FAULTS)
    assert all(set(f) <= set(faults.FAULTS) for f in CELL_FAULTS.values())


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sound_run_is_correct(name):
    out = run_small(name)
    assert out["correct"], json.dumps(out["checks"])
    assert out["failed"] == 0 and out["attempted"] >= 1


@pytest.mark.parametrize("name, fault", [
    (n, f) for n in sorted(CELL_FAULTS) for f in CELL_FAULTS[n]])
def test_fault_reads_not_correct(name, fault):
    with faults.plant(fault):
        out = run_small(name)
    assert not out["correct"], json.dumps(out["checks"])


@pytest.mark.parametrize("name", sorted(CONTROL))
def test_control_fails_a_number(name):
    _, config, traffic, limits = small_cell(name)
    traffic["judged"] = 2
    requests = generate.make_requests(config, traffic, 5)
    worst, n = control.control_numbers(CONTROL[name], config, traffic,
                                       requests, torch.device("cpu"))
    assert n == 2
    assert any(worst[k] > limit for k, limit in limits.items()), worst


@pytest.mark.parametrize("name", sorted(CONTROL))
def test_reference_in_float32_passes(name):
    """The reference itself in float32, the configuration's precision,
    reads within every limit: the control fails by its precision alone."""
    _, config, traffic, limits = small_cell(name)
    traffic["judged"] = 2
    requests = generate.make_requests(config, traffic, 5)
    worst, _ = control.control_numbers("f32", config, traffic, requests,
                                       torch.device("cpu"))
    assert all(worst[k] <= limit for k, limit in limits.items()), worst


def test_the_run_refuses_a_machine_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = runner.main(["--workload", "bunny.dense_m2048", "--seed", "1",
                      "--seconds", "1", "--trace", "0"], 0.0)
    assert rc != 0 and capsys.readouterr().out == ""


def test_the_run_needs_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark,
    the run exits non-zero and prints no result."""
    import shutil
    import subprocess
    import sys
    shutil.copy(runner.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(runner.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "bunny.dense_m2048", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
