"""Milliseconds a request the host is blocked in the PGA loop's
loop-condition reads, waiting on the device: the program's counter
``pga.read_wait_ns`` (``time.perf_counter_ns`` around each read) over the
traced window's requests."""

from benchmark import program_trace


def read(record):
    return program_trace.per_request(
        record, lambda spans, counters: counters["pga.read_wait_ns"] * 1e-6)
