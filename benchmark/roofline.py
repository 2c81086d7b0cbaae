"""Peaks of one NVIDIA H100 and the least time of a kernel's work.

The arithmetic is a frozen copy of ``chip_smoke.py``'s (``build_bound``
and its peaks), so that the yardstick does not move when the program
does. Peaks are the SXM data sheet's dense rates at its 700 W limit: HBM
3.35 TB/s; float32 outside the tensor cores 67 TFLOP/s (the builds). A
bound is the larger of the bytes needed, each read or written once, over
the memory rate and the operations over the peak of their type, in
seconds.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# f32 operations a pair of the Euclidean score (chip_smoke.py:
# BUILD_OPS_PER_PAIR)
OPS_PER_PAIR = 30


def bound_s(n_bytes: float, n_ops: float, peak: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / peak)


def affinity_build(m: int, d: int, item: int) -> float:
    """Kernel 6 over one problem: dense M and C (m x m, ``item`` bytes)
    written once, the endpoints and associations read once; the score's
    operations over the m (m - 1) / 2 distinct pairs at the f32 peak."""
    n_bytes = 2 * m * m * item + 2 * m * d * item + m * 2 * 4
    n_ops = (m * (m - 1) // 2) * OPS_PER_PAIR
    return bound_s(n_bytes, n_ops, F32_FLOPS)
