"""Profiling / tracing helpers: the port's one tracer.

Counterpart of ``clipper_tpu/utils/profiling.py``. The reference's
observability is a manual named Timer and per-stage wall times in
Solution structs (reference: include/clipper/utils.h:107-163,
sdp.h:28-36). Here: ``torch.profiler`` for device traces (Chrome trace
format, viewable in Perfetto), named regions, and the same lightweight
stage timers.

The tracer records spans and counters while a ``torch.profiler`` /
``torch.autograd.profiler`` profile runs in the process, and at no other
time; it needs no switch of its own. With no profiler running, a span
costs one flag check and enters nothing, and the program publishes no
counter. A span is also a record-function region of its name, so the
profiler's trace holds it on the clock its device events share, and
the trace's idle gaps are named by the program's stage. It is entered
as a plain function scope (``_RecordFunctionFast``), not as a user
annotation: the profiler mirrors a user annotation onto the device's
timeline as an event of its own, which a reduction of the trace would
take for device work.

In memory each span keeps its name, its start and end
(``time.perf_counter_ns``), the span it was opened in, and the request
it belongs to (a span given no request takes its parent's).
:func:`totals` sums them by name, with each name's self time (its spans'
time less that of the spans opened inside them), beside the counters;
:func:`reset` clears both. The tracer is one per process, as the
profiler is.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

_RecordFunction = torch._C._profiler._RecordFunctionFast


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[object]:
    """Profile the block (host activity, and CUDA activity where a card is
    present) and write its Chrome trace into ``logdir`` as
    ``trace.json``; yields the profiler (``key_averages()`` and friends)."""
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


def tracing() -> bool:
    """True while a profiler runs in the process: the tracer records."""
    return _autograd_profiler._is_profiler_enabled


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: Optional[int]       # None while the span is open
    parent: int                 # index in spans() of its parent, -1: none
    request: Optional[int]


class Tracer:
    """The spans and counters recorded while a profiler runs."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._spans: List[list] = []    # [name, start, end, parent, request]
        self._open: List[int] = []      # indices of the open spans
        self._counters: Dict[str, int] = {}

    def open(self, name: str, request: Optional[int]):
        """Open a span; returns what :meth:`close` takes."""
        parent = self._open[-1] if self._open else -1
        if request is None and parent >= 0:
            request = self._spans[parent][4]
        rec = [name, time.perf_counter_ns(), None, parent, request]
        self._open.append(len(self._spans))
        self._spans.append(rec)
        return self._open, rec

    @staticmethod
    def close(handle) -> None:
        stack, rec = handle
        rec[2] = time.perf_counter_ns()
        stack.pop()

    def count(self, counts: Dict[str, int]) -> None:
        for name, n in counts.items():
            self._counters[name] = self._counters.get(name, 0) + n

    def spans(self) -> List[Span]:
        return [Span(*rec) for rec in self._spans]

    def totals(self) -> dict:
        """``{"spans": {name: {"count", "ms", "self_ms"}}, "counters":
        {name: n}}`` over the closed spans and the counters."""
        child_ns = [0] * len(self._spans)
        for _, start, end, parent, _ in self._spans:
            if end is not None and parent >= 0:
                child_ns[parent] += end - start
        spans: Dict[str, dict] = {}
        for (name, start, end, _, _), child in zip(self._spans, child_ns):
            if end is None:
                continue
            s = spans.setdefault(name, {"count": 0, "ms": 0.0,
                                        "self_ms": 0.0})
            s["count"] += 1
            s["ms"] += (end - start) * 1e-6
            s["self_ms"] += (end - start - child) * 1e-6
        return {"spans": spans, "counters": dict(self._counters)}


_TRACER = Tracer()
_REQUESTS = itertools.count(1)
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "request", "_rf", "_handle")

    def __init__(self, name: str, request: Optional[int]):
        self.name, self.request = name, request

    def __enter__(self):
        self._rf = _RecordFunction(self.name)
        self._rf.__enter__()
        self._handle = _TRACER.open(self.name, self.request)
        return self

    def __exit__(self, *exc):
        Tracer.close(self._handle)
        self._rf.__exit__(*exc)


def annotate(name: str, request: Optional[int] = None):
    """Named region that shows up in device traces, and a span of the
    tracer while a profiler runs (see the module docstring); otherwise a
    no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, request)


def new_request() -> int:
    """A fresh request id for :func:`annotate`."""
    return next(_REQUESTS)


def count(counts: Dict[str, int]) -> None:
    """Add to the tracer's counters; callers publish only while
    :func:`tracing`."""
    _TRACER.count(counts)


def spans() -> List[Span]:
    """Every span recorded since the last :func:`reset`."""
    return _TRACER.spans()


def totals() -> dict:
    """Each span name's count, ms and self ms, and the counters, since the
    last :func:`reset` (see :meth:`Tracer.totals`)."""
    return _TRACER.totals()


def reset() -> None:
    """Forget every span and counter."""
    _TRACER.reset()


class StageTimer:
    """Per-stage wall-time breakdown, reported as a dict.

    Mirrors the reference SDP Solution's timing breakdown style
    (reference: include/clipper/sdp.h:28-36). Each stage is also a span
    of its name (:func:`annotate`). Host clock: where the process has
    initialised CUDA, a stage synchronises the current device before it
    reads the clock at its end, so the stage covers the device work it
    queued.
    """

    def __init__(self):
        self.stages = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with annotate(name):
                yield
                if torch.cuda.is_initialized():
                    torch.cuda.synchronize()
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + (
                time.perf_counter() - t0)

    def report(self) -> dict:
        total = sum(self.stages.values())
        return dict(total=total, **self.stages)
