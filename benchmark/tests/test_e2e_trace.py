"""The reduction of a profiler trace: kernel time by name, busy time as
the union of device intervals, idle gaps named by the innermost host op."""

import types

from torch.autograd import DeviceType

from benchmark import trace


def ev(name, a, b, device):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=a, end=b),
        device_type=DeviceType.CUDA if device else DeviceType.CPU)


class Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_summary():
    prof = Prof([
        ev("request", 0, 1000, False), ev("aten::item", 300, 700, False),
        ev("k1", 0, 100, True), ev("k2", 50, 250, True),
        ev("k1", 800, 900, True), ev("copy", 950, 960, True)])
    s = trace.summarize(prof)
    assert {k: (round(v[0] * 1e6, 9), v[1]) for k, v in s.kernels.items()
            } == {"k1": (200, 2), "k2": (200, 1), "copy": (10, 1)}
    assert abs(s.busy_s - 360e-6) < 1e-12
    # gaps 250-800 (mid 525: inside aten::item) and 900-950 (request)
    assert s.idle_by_host[0][0] == "aten::item"
    assert abs(s.idle_by_host[0][1] - 550e-6) < 1e-12
    assert s.idle_by_host[1][0] == "request"
    sec, n = s.seconds_of("k1", "copy")
    assert n == 3 and abs(sec - 210e-6) < 1e-12
    b = s.breakdown(top=2)
    assert [n for n, _ in b["device_ops"]] == ["k1", "k2"]
    assert len(b["idle_gaps"]) == 2
