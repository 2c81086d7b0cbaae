"""Mean milliseconds of a rank's block build a request in the 2D sharded
engine: the program's own stage clock (``stats["build"]``, CUDA events
on the card), rank 0's."""


def read(record):
    ms = record["stage_ms"].get("sharded.build")
    return sum(ms) / len(ms) if ms else None
