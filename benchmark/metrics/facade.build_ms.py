"""Mean milliseconds of the facade's build a request: the benchmark's
CUDA events around ``score_pairwise_consistency`` (the dense engine,
kernel 6)."""


def read(record):
    ms = record["stage_ms"].get("facade.build")
    return sum(ms) / len(ms) if ms else None
