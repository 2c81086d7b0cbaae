"""Profiling / tracing helpers.

Counterpart of ``clipper_tpu/utils/profiling.py``. The reference's
observability is a manual named Timer and per-stage wall times in
Solution structs (reference: include/clipper/utils.h:107-163,
sdp.h:28-36). Here: ``torch.profiler`` for device traces (Chrome trace
format, viewable in Perfetto), named regions, and the same lightweight
stage timers.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[object]:
    """Profile the block (host activity, and CUDA activity where a card is
    present) and write its Chrome trace into ``logdir`` as
    ``trace.json``; yields the profiler (``key_averages()`` and friends)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region that shows up in device traces."""
    from torch.profiler import record_function

    with record_function(name):
        yield


class StageTimer:
    """Per-stage wall-time breakdown, reported as a dict.

    Mirrors the reference SDP Solution's timing breakdown style
    (reference: include/clipper/sdp.h:28-36). Host clock: synchronise the
    device inside a stage that should cover device work.
    """

    def __init__(self):
        self.stages = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + (
                time.perf_counter() - t0)

    def report(self) -> dict:
        total = sum(self.stages.values())
        return dict(total=total, **self.stages)
