"""Block matvecs a request in the 2D sharded engine (each one the local
product, its column sum and its row gather): the program's counter
``sharded.matvecs`` over the traced window's requests."""

from benchmark import program_trace


def read(record):
    return program_trace.per_request(
        record, lambda spans, counters: counters["sharded.matvecs"])
