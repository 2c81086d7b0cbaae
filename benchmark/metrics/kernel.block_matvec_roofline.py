"""The 2D sharded engine's block matvec against its roofline: the least
time of the window's block matvecs (each one read of the rank's stored
[M; C] block at 3.35 TB/s, ``roofline_sharded.block_matvec``; their
number the program's counter ``sharded.matvecs``) over the time of the
stage that runs them (init and solve, ``sharded.solve_stage_ms``). The
stage's vector work and collectives count against the share."""

from benchmark import program_trace


def read(record):
    bound = record["launches"].get("block_matvec")
    ms = record["stage_ms"].get("sharded.solve")
    calls = program_trace.per_request(
        record, lambda spans, counters: counters["sharded.matvecs"])
    if not bound or not ms or calls is None:
        return None
    return 100.0 * calls * bound[0] / (1e-3 * sum(ms) / len(ms))
