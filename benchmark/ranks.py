"""A cell on N > 1 cards: N rank processes, one a card, in one
``torch.distributed`` group.

:func:`launch` is the command's own process for such a cell: a thin
launcher that is no rank. It starts N processes of ``run_rank.py`` on this
host with torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` 127.0.0.1 and a free
``MASTER_PORT``), hands each the run as JSON on its standard input, and
polls them. At the first rank that exits non-zero, or at its deadline, it
kills every rank and prints no result. Once every rank has exited 0 it
writes rank 0's standard error and then rank 0's standard output, whose
last line is the result. The other ranks' output goes to standard error
as it comes, each line marked with its rank.

:func:`rank_main` is one rank: it pins card ``LOCAL_RANK``, starts the
default group (NCCL on the card, gloo on the CPU) with a timeout, and runs
:func:`runner.run_cell` with a :class:`Ranks`. Its collectives are the
only ones the harness adds: one before the window, one a request, and
after the window the fullest card's memory peak and, traced, every rank's
trace summary.
"""

from __future__ import annotations

import ctypes
import datetime
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import List, Optional

from benchmark import runner

RUN_RANK = Path(__file__).resolve().parent / "run_rank.py"
# a collective that waits longer raises (gloo) or ends its process (NCCL,
# with TORCH_NCCL_ASYNC_ERROR_HANDLING=1): a stalled rank ends the run
GROUP_TIMEOUT_S = 300
# the launcher's deadline past --seconds: a checkout's first run compiles,
# and is allowed 1200 s in all
DEADLINE_S = 1140
PR_SET_PDEATHSIG = 1


class Ranks:
    """A rank's part in the harness's collectives over the default group;
    every rank makes each call, in the same order."""

    def __init__(self, dev):
        import torch.distributed as dist
        self.dist, self.dev = dist, dev
        self.rank = dist.get_rank()

    def _max(self, values: List[int]) -> List[int]:
        import torch
        t = torch.tensor(values, dtype=torch.int64, device=self.dev)
        self.dist.all_reduce(t, op=self.dist.ReduceOp.MAX)
        return t.tolist()

    def barrier(self) -> None:
        self._max([0])

    def step(self, close: bool, lost: bool):
        """(whether rank 0 closes the window, whether the request was lost
        on any rank): one all-reduce a request."""
        c, f = self._max([int(close and self.rank == 0), int(lost)])
        return bool(c), bool(f)

    def max_int(self, value: int) -> int:
        return self._max([int(value)])[0]

    def gather(self, obj) -> list:
        """Every rank's ``obj``, in rank order, on every rank."""
        out = [None] * self.dist.get_world_size()
        self.dist.all_gather_object(out, obj)
        return out


def job(bench, cell, config, traffic, limits, seed, seconds, trace, device,
        t_start, kinds=(runner.KINDS_DIR,),
        group_timeout_s=GROUP_TIMEOUT_S) -> dict:
    """What every rank runs, as JSON; ``t_start`` is the command's start
    on ``time.perf_counter``, the system's monotonic clock, which every
    process on the host shares."""
    workers = max(1, min(8, (os.cpu_count() or 1) // cell["chips"]))
    return {"bench": bench, "cell": cell, "config": config,
            "traffic": traffic, "limits": limits, "seed": seed,
            "seconds": seconds, "trace": trace, "device": device,
            "t_start": t_start, "workers": workers,
            "kinds": [str(k) for k in kinds],
            "group_timeout_s": group_timeout_s}


def rank_main(job: dict) -> int:
    """One rank of ``job`` under torchrun's environment; rank 0 prints."""
    import torch
    import torch.distributed as dist

    rank, local = int(os.environ["RANK"]), int(os.environ["LOCAL_RANK"])
    if job["device"] == "cuda":
        torch.cuda.set_device(local)
        device, backend = f"cuda:{local}", "nccl"
    else:
        device, backend = job["device"], "gloo"
    torch.set_num_threads(1)
    dist.init_process_group(backend, timeout=datetime.timedelta(
        seconds=job["group_timeout_s"]))
    out = runner.run_cell(job["bench"], job["cell"], job["config"],
                          job["traffic"], job["limits"], job["seed"],
                          job["seconds"], job["trace"], device,
                          job["t_start"], workers=job["workers"],
                          kinds=job["kinds"],
                          ranks=Ranks(torch.device(device)))
    dist.destroy_process_group()
    found = runner.forbidden_modules()
    if found:
        print(f"rank {rank} loaded: " + ", ".join(found), file=sys.stderr)
        return 3
    if rank == 0:
        runner.report(out)
    else:
        for err in out["errors"]:
            print(f"request failed: {err}", file=sys.stderr)
    return 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _die_with_launcher():
    """A hook run in each rank before it starts: the kernel kills the rank
    when the launcher dies (Linux's PR_SET_PDEATHSIG), so that none
    outlives a launcher that was killed; None where there is no prctl."""
    try:
        prctl = ctypes.CDLL(None, use_errno=True).prctl
    except (OSError, AttributeError):
        return None
    return lambda: prctl(PR_SET_PDEATHSIG, signal.SIGKILL)


def _keep(stream, into: list) -> None:
    for chunk in iter(lambda: stream.read1(1 << 16), b""):
        into.append(chunk)


def _forward(stream, rank: int) -> None:
    for line in iter(stream.readline, b""):
        sys.stderr.write(f"[rank {rank}] "
                         + line.decode(errors="replace"))
        sys.stderr.flush()


def _kill(p: subprocess.Popen) -> None:
    """SIGKILL to the rank's whole process group (the rank and whatever it
    started)."""
    try:
        os.killpg(p.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def launch(job: dict, n: int, deadline_s: Optional[float] = None) -> int:
    """Runs ``job`` as ``n`` ranks on this host: the command's exit code,
    0 where every rank exited 0, and then rank 0's line is printed."""
    if deadline_s is None:
        deadline_s = DEADLINE_S + job["seconds"]
    port = str(free_port())
    payload = json.dumps(job).encode()
    hook = _die_with_launcher()
    procs: List[subprocess.Popen] = []
    threads: List[threading.Thread] = []
    out0: list = []
    err0: list = []
    rc, why = 0, ""
    t0 = time.monotonic()
    try:
        for r in range(n):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n),
                       LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                       TORCH_NCCL_ASYNC_ERROR_HANDLING="1")
            procs.append(subprocess.Popen(
                [sys.executable, str(RUN_RANK)], stdin=subprocess.PIPE,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE if r == 0 else subprocess.STDOUT,
                env=env, start_new_session=True, preexec_fn=hook))
        threads = [threading.Thread(target=_keep, args=(procs[0].stdout,
                                                        out0)),
                   threading.Thread(target=_keep, args=(procs[0].stderr,
                                                        err0))]
        threads += [threading.Thread(target=_forward, args=(p.stdout, r))
                    for r, p in enumerate(procs) if r > 0]
        for t in threads:
            t.daemon = True
            t.start()
        for p in procs:
            try:
                p.stdin.write(payload)
                p.stdin.close()
            except OSError:             # it ended already: polled below
                pass
        while True:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                r, c = bad[0]
                rc = c if c > 0 else 1
                why = (f"rank {r} exited with code {c}; "
                       "the other ranks were stopped")
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() - t0 > deadline_s:
                rc = 124
                why = (f"the ranks had not ended {deadline_s:.0f} s after "
                       "the launch, and were stopped")
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            _kill(p)
        for p in procs:
            p.wait()
        for t in threads:
            t.join(timeout=10)
    sys.stderr.write(b"".join(err0).decode(errors="replace"))
    if rc == 0:
        found = runner.forbidden_modules()
        if found:
            print("loaded in the launcher: " + ", ".join(found),
                  file=sys.stderr)
            return 3
        sys.stdout.write(b"".join(out0).decode(errors="replace"))
        sys.stdout.flush()
    else:
        print(why, file=sys.stderr)
    sys.stderr.flush()
    return rc
