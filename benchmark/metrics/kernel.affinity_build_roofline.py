"""Kernel 6's share of its roofline over the traced window: the least
time of each request's dense build (benchmark/roofline.py's
affinity_build) over the device time of affinity_build_kernel in the
trace."""


def read(record):
    bound = record["launches"].get("affinity_build")
    seconds, _ = record["summary"].seconds_of(
        "affinity_build_kernel")
    if not bound or seconds <= 0:
        return None
    return 100.0 * sum(bound) / seconds
