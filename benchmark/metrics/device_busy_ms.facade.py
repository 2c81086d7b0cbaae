"""Milliseconds a request in which a kernel or copy ran on the device:
the busy time of the traced window (the union of the device's intervals
in the profiler's trace) over the requests completed in it. A steadier
reading than the host-paced ``solve_ms`` of what the device does for a
request."""


def read(record):
    if record["requests"] <= 0 or record["summary"].n_device_items == 0:
        return None
    return 1e3 * record["summary"].busy_s / record["requests"]
