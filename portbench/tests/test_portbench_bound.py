"""The frozen bound of the field kernel equals the program's own."""

import pytest

from portbench.harness import fpbound


@pytest.mark.parametrize("lanes", [3072, 18432, 55296])
def test_frozen_bound_equals_bench_fp_mul(lanes):
    from coconut_tpu_torch import bench_fp_mul

    assert fpbound.bound(lanes) == bench_fp_mul.bound(lanes)


def test_bound_sums_over_launches():
    widths = {3072: 2, 55296: 1}
    want = (2 * fpbound.bound(3072)["bound_ms"] + fpbound.bound(55296)["bound_ms"]) / 1e3
    assert fpbound.bound_s(widths) == pytest.approx(want, rel=1e-12)
