"""The 2D sharded engine's block build against its roofline: the least
time of one rank's block build (its stored [M; C] block written once at
3.35 TB/s, or its pairs' scores at the float32 peak, whichever is
longer; ``roofline_sharded.block_build``) over the build's time
(``sharded.build_ms``), a request's mean."""


def read(record):
    bound = record["launches"].get("block_build")
    ms = record["stage_ms"].get("sharded.build")
    if not bound or not ms:
        return None
    return 100.0 * (sum(bound) / len(bound)) / (1e-3 * sum(ms) / len(ms))
