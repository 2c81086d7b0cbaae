"""Mean milliseconds of the facade's solver a request: the benchmark's
CUDA events around ``solve(u0)`` (the dense engine: the PGA loop and the
rounding, up to the mask on the host)."""


def read(record):
    ms = record["stage_ms"].get("facade.solve")
    return sum(ms) / len(ms) if ms else None
