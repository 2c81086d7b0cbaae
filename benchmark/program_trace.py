"""The program's own tracer as the per-layer readers see it.

``clipper_tpu_torch.utils.profiling`` records spans and counters while a
profiler runs, so over a traced window it holds the window's requests
alone (the warm-up runs with no profiler).
"""

from __future__ import annotations

from typing import Callable, Optional


def per_request(record: dict, value: Callable[[dict, dict], float]
                ) -> Optional[float]:
    """``value(spans, counters)`` of the tracer's totals over the window's
    requests; None where the program has no tracer (``totals``) or
    ``value`` finds a name the tracer did not record."""
    from clipper_tpu_torch.utils import profiling
    totals = getattr(profiling, "totals", None)
    if totals is None or record["requests"] <= 0:
        return None
    t = totals()
    try:
        return value(t["spans"], t["counters"]) / record["requests"]
    except KeyError:
        return None
