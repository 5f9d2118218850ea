"""port_bench/counts.py, the frozen copy of chip_smoke.py's operation and
byte counts, equals the original at each cell's shapes."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

from port_bench import counts

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

# (B, h, ADMM iterations) of the cells that launch the fused-build kernel
SOLVE_SHAPES = ((2048, 10, 30), (256, 10, 30), (1, 10, 30), (1152, 10, 30))


@pytest.mark.parametrize("B,h,iters", SOLVE_SHAPES)
@pytest.mark.parametrize("rescued", (0, 7))
def test_solve_counts_equal_chip_smokes(B, h, iters, rescued):
    ns_it, ns_warm = 16, 6
    assert counts.solve_flops(B, h, iters, ns_it, ns_warm, rescued) == chip_smoke.solve_flops(
        B, h, iters, ns_it, ns_warm, rescued)
    assert counts.solve_bytes(B, h) == chip_smoke.solve_bytes(B, h)


@pytest.mark.parametrize("iters", (0, 1, 15))
def test_wbc_counts_equal_chip_smokes(iters):
    assert counts.wbc_flops(iters) == chip_smoke.wbc_flops(iters)
    assert counts.pdip_row_flops() == chip_smoke.pdip_row_flops()
    assert counts.TICK_FLOATS == chip_smoke.TICK_FLOATS
    for n in (1, 3, 6, 12, 18, 28):
        assert counts.spd_inv_flops(n) == chip_smoke.spd_inv_flops(n)
    for r, k, s in ((3, 18, 18), (12, 12, 1), (18, 3, 3)):
        assert counts.gemm_flops(r, k, s) == chip_smoke.gemm_flops(r, k, s)


@pytest.mark.parametrize("flops,nbytes", ((10**9, 10**6), (10**6, 10**9), (0, 1)))
def test_bound_equals_chip_smokes(flops, nbytes):
    assert counts.bound(flops, nbytes) == chip_smoke.bound(flops, nbytes)
    assert counts.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert counts.FP32_FLOPS_PER_S == chip_smoke.FP32_FLOPS_PER_S
