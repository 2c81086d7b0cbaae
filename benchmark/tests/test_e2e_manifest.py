"""BENCHMARK.json against the benchmark's contract, and the files that
the harness finds by the names in it."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
BENCH_DIR = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert (ROOT / p).is_dir() and ".." not in p.split("/")
    assert 1 <= len(BENCH["command"]) <= 32
    assert (ROOT / BENCH["command"][1]).is_file()
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 cells runs of run_seconds + 60,
    # 2 x 90 s a cell to compile, 1200 s spare, in 43200 s
    cells = 24
    assert ((2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 180
            + 1200) <= 43200
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128


@pytest.mark.parametrize("item", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda it: it["name"])
def test_names_and_lines(item):
    assert NAME.match(item["name"])
    for key in ("why", "layer", "source"):
        if key in item:
            assert 1 <= len(item[key]) <= 200
            assert "\n" not in item[key] and "\t" not in item[key]
    if "unit" in item:
        assert UNIT.match(item["unit"])
        assert item["better"] in ("lower", "higher")


def test_unique_names():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [it["name"] for it in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    path = ROOT / cfg["file"]
    assert path.is_file() and cfg["file"].startswith("benchmark/")
    assert json.loads(path.read_text())["name"] == cfg["name"]
    assert len(cfg["reduced"]) <= 16
    assert all(NAME.match(k) for k in cfg["reduced"])
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cells(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4)
    assert NAME.match(cell["traffic"]) and NAME.match(cell["config"])
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    assert (BENCH_DIR / "traffic" / f"{cell['traffic']}.json").is_file()
    limits = json.loads((BENCH_DIR / "workloads"
                         / f"{cell['name']}.json").read_text())["limits"]
    assert limits and all(v >= 0 for v in limits.values())
    e2e = [m for m in BENCH["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert any(cell["name"] in m["workloads"] for m in BENCH["per_layer"])


def test_cells_once_and_chips():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("metric", BENCH["end_to_end"],
                         ids=lambda m: m["name"])
def test_end_to_end(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source",
                           "workloads"}
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer(metric):
    assert set(metric) == {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    assert (BENCH_DIR / "metrics" / f"{metric['name']}.py").is_file()
    moved = next(m for m in BENCH["end_to_end"]
                 if m["name"] == metric["moves"])
    cells = {w["name"] for w in BENCH["workloads"]}
    for cell in metric["workloads"]:
        assert cell in cells
        # each of its cells reports the end-to-end metric that it moves
        assert cell in moved.get("workloads", [cell])
    if "roofline" in metric["name"]:
        assert metric["name"].endswith("_roofline")
        assert metric["unit"] == "%"


def test_layers_spelled_alike():
    """Metrics of one layer name it letter for letter as PERF.md does."""
    perf = (ROOT / "PERF.md").read_text()
    for metric in BENCH["per_layer"]:
        assert f"`{metric['layer']}`" in perf, metric["layer"]
