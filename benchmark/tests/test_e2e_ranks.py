"""A cell on several cards, run as gloo ranks on the CPU by
``ranks.launch``: each request of the test-only entry kind
``kinds/lockstep.py`` is an all-reduce over the ranks. A cell on one card
starts neither a process group nor a child process. Each launch has its
own deadline, so a fault fails its test instead of hanging the suite.
The tests marked ``cuda`` run the same as NCCL ranks, one a card, where
the machine has two cards or more:
``python -m pytest benchmark/tests/test_e2e_ranks.py -q -s -m cuda``."""

import contextlib
import io
import json
import subprocess
import time
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from benchmark import entries, ranks, runner

TEST_KINDS = Path(__file__).resolve().parent / "kinds"
KINDS = (runner.KINDS_DIR, TEST_KINDS)
DEADLINE_S = 60
BENCH = {"end_to_end": [
    {"name": "solve_ms", "unit": "ms", "better": "lower", "bound": 0.25,
     "source": "host_clock"},
    {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
     "source": "host_clock"}], "per_layer": []}
LIMITS = {"ranks_apart": 0, "out_of_order": 0, "sums_wrong": 0,
          "requests_seen": 1e9}
TRAFFIC = {"entry": "lockstep", "warm_requests": 3, "trace_seconds": 0.5,
           "judged": 1}


def cell(n):
    return {"name": "test.lockstep", "config": "none", "traffic": "lockstep",
            "chips": n, "why": "a test"}


def launched(n, fault=None, trace=False, deadline_s=DEADLINE_S,
             group_timeout_s=30, device="cpu"):
    """(exit code, standard output, standard error, seconds taken) of a
    launch of n ranks, on the CPU or one card a rank."""
    traffic = dict(TRAFFIC, fault=fault) if fault else TRAFFIC
    job = ranks.job(BENCH, cell(n), {}, traffic, LIMITS, 2 ** 31 + 7, 0.5,
                    trace, device, time.perf_counter(), kinds=KINDS,
                    group_timeout_s=group_timeout_s)
    out, err = io.StringIO(), io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = ranks.launch(job, n, deadline_s)
    return rc, out.getvalue(), err.getvalue(), time.monotonic() - t0


def result(stdout):
    lines = stdout.strip().splitlines()
    assert len(lines) == 1, stdout
    return json.loads(lines[0])


@pytest.fixture(scope="module")
def four():
    return launched(4)


def test_four_ranks_give_one_line(four):
    rc, stdout, stderr, took = four
    assert rc == 0, stderr
    line = result(stdout)
    assert line["correct"] and line["failed"] == 0
    assert line["device"]["count"] == 4
    assert set(line["metrics"]) == {"solve_ms", "setup_s"}
    # the requests are counted once, not once a rank
    assert line["attempted"] == line["checks"]["requests_seen"]["value"]
    assert line["attempted"] > 10
    # the checks are the last lines of standard error
    assert stderr.strip().splitlines()[-1].startswith("check requests_seen")


def test_every_rank_ran_the_same_requests(four):
    checks = result(four[1])["checks"]
    assert checks["ranks_apart"]["value"] == 0
    assert checks["out_of_order"]["value"] == 0
    assert checks["sums_wrong"]["value"] == 0


def test_a_rank_that_raises_fails_the_run():
    rc, stdout, stderr, _ = launched(
        2, {"kind": "raise", "rank": 1, "request": 4})
    assert rc == 0, stderr
    line = result(stdout)
    assert line["failed"] == 1 and not line["correct"]
    assert "[rank 1] request failed" in stderr


@pytest.mark.parametrize("kind, rank, deadline_s, group_timeout_s", [
    ("exit", 1, DEADLINE_S, 30),      # the launcher sees it exit
    ("stall", 1, DEADLINE_S, 3),      # rank 0's all-reduce times out
    ("stall", -1, 5, 30),             # no collective waits: the deadline
])
def test_a_rank_at_fault_ends_the_command(kind, rank, deadline_s,
                                          group_timeout_s):
    rc, stdout, stderr, took = launched(
        2, {"kind": kind, "rank": rank, "request": 4},
        deadline_s=deadline_s, group_timeout_s=group_timeout_s)
    assert rc != 0 and stdout == "", stderr
    assert "were stopped" in stderr.strip().splitlines()[-1]
    assert took < deadline_s + 10


def test_traced_ranks_report_each_rank():
    rc, stdout, stderr, _ = launched(2, trace=True)
    assert rc == 0, stderr
    device = result(stdout)["device"]
    assert len(device["busy_s_ranks"]) == 2
    assert device["busy_s"] == sum(device["busy_s_ranks"]) / 2
    assert device["window_s"] > 0


def test_a_kind_comes_from_its_file():
    assert runner.entry_kind("facade") is entries.FacadeEntry
    kind = runner.entry_kind("lockstep", KINDS)
    assert kind.__name__ == "Entry"
    assert kind.__module__ == "benchmark_kind_lockstep"


def test_an_unknown_kind_fails_loudly():
    with pytest.raises(LookupError) as err:
        runner.entry_kind("nowhere", KINDS)
    assert str(runner.KINDS_DIR / "nowhere.py") in str(err.value)
    assert str(TEST_KINDS / "nowhere.py") in str(err.value)
    with pytest.raises(ValueError):
        runner.entry_kind("../lockstep", KINDS)


def _refuse(*args, **kwargs):
    raise AssertionError("a cell on one card started a process or group")


def test_one_card_starts_no_group_and_no_child(monkeypatch, capsys):
    real = runner.run_cell
    seen = {}

    def on_the_cpu(bench, cell_, config, traffic, limits, seed, seconds,
                   trace, device, t_start, workers):
        seen["cell"] = cell_["name"]
        out = real(BENCH, cell_, config, TRAFFIC, LIMITS, seed, 0.3, trace,
                   "cpu", t_start, workers=1, kinds=KINDS)
        seen["grouped"] = dist.is_initialized()
        return out

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(runner, "run_cell", on_the_cpu)
    monkeypatch.setattr(subprocess, "Popen", _refuse)
    monkeypatch.setattr(ranks, "launch", _refuse)
    monkeypatch.setattr(dist, "init_process_group", _refuse)
    rc = runner.main(["--workload", "bunny.dense_m2048", "--seed", "5",
                      "--seconds", "0.3", "--trace", "0"],
                     time.perf_counter())
    line = result(capsys.readouterr().out)
    assert rc == 0 and seen == {"cell": "bunny.dense_m2048",
                                "grouped": False}
    assert line["device"]["count"] == 1 and line["correct"]


def test_a_cell_on_four_cards_is_launched(monkeypatch):
    find = runner.find
    handed = {}

    def launch(job, n, deadline_s=None):
        handed.update(job=job, n=n)
        return 0

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(runner, "find", lambda items, name, what: dict(
        find(items, name, what), chips=4))
    monkeypatch.setattr(runner, "run_cell", _refuse)
    monkeypatch.setattr(ranks, "launch", launch)
    assert runner.main(["--workload", "bunny.dense_m2048", "--seed", "5",
                        "--seconds", "2", "--trace", "1"], 0.0) == 0
    job = handed["job"]
    assert handed["n"] == 4 and job["device"] == "cuda"
    assert (job["seed"], job["seconds"], job["trace"]) == (5, 2.0, True)
    assert json.loads(json.dumps(job)) == job


@pytest.fixture
def cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip(f"needs two CUDA cards or more; {n} found")
    return n


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_ranks_on_the_cards(cards, trace):
    rc, stdout, stderr, took = launched(cards, trace=trace, device="cuda",
                                        deadline_s=240)
    print(f"{cards} NCCL ranks in {took:.1f} s: {stdout.strip()}")
    assert rc == 0, stderr
    line = result(stdout)
    assert line["correct"] and line["failed"] == 0
    assert line["attempted"] == line["checks"]["requests_seen"]["value"]
    device = line["device"]
    assert device["platform"] == "gpu" and device["count"] == cards
    assert device["memory_peak_bytes"] > 0
    if trace:
        assert len(device["busy_s_ranks"]) == cards
        assert min(device["busy_s_ranks"]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind, rank, deadline_s, group_timeout_s", [
    ("raise", 1, 240, 30),
    ("exit", 1, 240, 30),
    ("stall", 1, 240, 20),
    ("stall", -1, 60, 30),
])
def test_a_rank_at_fault_on_the_cards(cards, kind, rank, deadline_s,
                                      group_timeout_s):
    rc, stdout, stderr, took = launched(
        cards, {"kind": kind, "rank": rank, "request": 4},
        deadline_s=deadline_s, group_timeout_s=group_timeout_s,
        device="cuda")
    print(f"{kind} on rank {rank}: code {rc} in {took:.1f} s; "
          + stderr.strip().splitlines()[-1])
    if kind == "raise":
        assert rc == 0, stderr
        line = result(stdout)
        assert line["failed"] == 1 and not line["correct"]
    else:
        assert rc != 0 and stdout == "", stderr
        assert took < deadline_s + 10
