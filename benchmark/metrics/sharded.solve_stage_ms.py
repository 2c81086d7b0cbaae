"""Mean milliseconds of the 2D sharded engine's init and solve a request
(the flat init and the flat solve: every block matvec and its
collectives): the program's own stage clock (``stats["init"] +
stats["solve"]``, CUDA events on the card), rank 0's."""


def read(record):
    ms = record["stage_ms"].get("sharded.solve")
    return sum(ms) / len(ms) if ms else None
