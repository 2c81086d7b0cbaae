"""The share of the traced window in which no kernel or copy ran on the
device: 100 (1 - busy / window), busy the union of the device's
intervals in the profiler's trace."""


def read(record):
    window = record["window_s"]
    if window <= 0 or record["summary"].n_device_items == 0:
        return None
    return 100.0 * (1.0 - record["summary"].busy_s / window)
