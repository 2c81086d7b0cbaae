"""The copied bound arithmetic reproduces the bounds PERF.md's kernel
table states at its shapes (H100 SXM peaks, ms)."""

import pytest

from benchmark import roofline


@pytest.mark.parametrize("m, expect_ms", [(1024, 0.0025), (2048, 0.0100)],
                         ids=["k6_m1024", "k6_m2048"])
def test_kernel6_bound_matches_the_kernel_table(m, expect_ms):
    """Kernel 6's bunny build, f32: bytes (PERF.md's kernel table, row 6,
    at m=1024; m=2048 writes four times the bytes)."""
    assert round(roofline.affinity_build(m, 3, 4) * 1e3, 4) == expect_ms


def test_bound_is_the_larger_side():
    assert roofline.bound_s(3.35e12, 0, 1.0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12, roofline.F32_FLOPS) == \
        pytest.approx(1.0)
