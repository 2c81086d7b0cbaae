"""Line-search trials a request in the PGA loop (solvers.msrc.run_pga),
each one (M + d C) u product: the program's counter
``pga.linesearch_steps`` over the traced window's requests, the loop's
work."""

from benchmark import program_trace


def read(record):
    return program_trace.per_request(
        record, lambda spans, counters: counters["pga.linesearch_steps"])
