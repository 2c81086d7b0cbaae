"""Dense PGA solves a request that ran their whole loop on the device
(solvers.msrc.pga_dense_cuda, one persistent kernel a solve): the
program's counter ``pga.device_loops`` over the traced window's requests;
None for a program without that counter."""

from benchmark import program_trace


def read(record):
    return program_trace.per_request(
        record, lambda spans, counters: counters["pga.device_loops"])
