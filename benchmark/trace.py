"""Reduction of a ``torch.profiler`` trace of the measured window.

The device's kernels and copies (CUPTI activity, device-side events
only: a host op's own device-time column repeats its kernels' time) give
each kernel's seconds and count by name, the busy time (the union of
their intervals) and the idle gaps between them. Each of the longest
gaps is named by the innermost host op that was running at its middle,
which says what the host was doing while the device waited.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Tuple

GAPS_NAMED = 2000     # the longest gaps that get a host op's name


@dataclasses.dataclass
class Summary:
    kernels: Dict[str, Tuple[float, int]]      # name -> (seconds, count)
    busy_s: float
    idle_by_host: List[Tuple[str, float]]      # host op -> idle seconds
    n_device_items: int

    def seconds_of(self, *parts: str) -> Tuple[float, int]:
        """Seconds and count of the kernels whose name holds any of
        ``parts``."""
        s, n = 0.0, 0
        for name, (sec, cnt) in self.kernels.items():
            if any(p in name for p in parts):
                s, n = s + sec, n + cnt
        return s, n

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:top]
        return {"device_ops": [[name, sec] for name, (sec, _) in ops],
                "idle_gaps": [[name, sec] for name, sec
                              in self.idle_by_host[:top]]}


def summarize(prof) -> Summary:
    """The :class:`Summary` of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type == DeviceType.CUDA:
            device.append(span)
        elif e.device_type == DeviceType.CPU:
            host.append(span)
    kernels: Dict[str, Tuple[float, int]] = {}
    for a, b, name in device:
        s, n = kernels.get(name, (0.0, 0))
        kernels[name] = (s + (b - a) * 1e-6, n + 1)
    device.sort()
    busy, gaps, end = 0.0, [], None
    for a, b, _ in device:
        if end is None or a > end:
            if end is not None:
                gaps.append((a - end, end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return Summary(kernels, busy * 1e-6, _name_gaps(gaps, host),
                   len(device))


def _name_gaps(gaps, host) -> List[Tuple[str, float]]:
    """Idle seconds of the longest gaps summed by the innermost host op
    covering each gap's middle; "(between host ops)" where none does,
    which is the interpreter's own time between the program's calls."""
    host.sort()
    starts = [h[0] for h in host]
    idle: Dict[str, float] = {}
    for length, a, b in sorted(gaps, reverse=True)[:GAPS_NAMED]:
        mid = 0.5 * (a + b)
        name = "(between host ops)"
        i = bisect.bisect_right(starts, mid) - 1
        # the latest-starting op that still covers mid is the innermost
        for j in range(i, max(-1, i - 5000), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        idle[name] = idle.get(name, 0.0) + length * 1e-6
    return sorted(idle.items(), key=lambda kv: -kv[1])
