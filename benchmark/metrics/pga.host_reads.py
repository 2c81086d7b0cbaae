"""Loop-condition reads a request in the PGA loop (solvers.msrc.run_pga):
the program's counter ``pga.host_reads``, one host read for each
line-search trial, inner step and outer pass and for each frozen check,
over the traced window's requests."""

from benchmark import program_trace


def read(record):
    return program_trace.per_request(
        record, lambda spans, counters: counters["pga.host_reads"])
