"""Milliseconds a request of the PGA loop's own host work, its Python and
its launches: the program's span ``pga`` (solvers.msrc.run_pga) less the
time blocked in its reads (``pga.read_wait_ns``), over the traced
window's requests."""

from benchmark import program_trace


def read(record):
    return program_trace.per_request(
        record, lambda spans, counters: (
            spans["pga"]["ms"] - counters["pga.read_wait_ns"] * 1e-6))
