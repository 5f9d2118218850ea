"""The control comes out not correct: the plain reference put in the
program's place with its matrix products in TF32 (the nearest precision
below the configurations' float32 with TF32 off) fails at least one of
each cell's limits, on three seeds, on the CPU at a tiny batch; the same
on a card at a larger batch (``gpu``)."""

from __future__ import annotations

import time

import pytest
import torch

from port_bench import control
from port_bench.lib import harness
from port_bench.tests import _cpu

SEEDS = (_cpu.SEED, _cpu.SEED + 1, _cpu.SEED + 2)


def control_checks(cell: str, seed: int, device, instances, seconds: float) -> dict:
    w = harness.window_run(cell, seed, seconds, False, device, time.perf_counter(),
                           instances=instances, log=lambda s: None)
    gaps = control.control_gaps(w.cell, w.inp, w.start, w.kept, device)
    return {k: {"value": gaps[k], "limit": v} for k, v in w.cell.wl["limits"].items()}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", sorted(_cpu.TINY))
def test_control_is_not_correct(cell, seed):
    torch.set_num_threads(1)
    checks = control_checks(cell, seed, torch.device("cpu"), _cpu.TINY[cell], 0.2)
    assert not harness.correct(checks), checks


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -12, 1.0 + 2 ** -10, -3.14159, float("inf")])
    assert control.to_tf32(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -10, -3.140625, float("inf")]
    a, b = torch.randn(3, 13, 13), torch.randn(3, 13, 12)
    exact = a @ b
    with control.tf32_products():
        low = a @ b
    assert 0 < float((low - exact).abs().max()) < 1e-2
    assert torch.equal(a @ b, exact)          # the products are restored


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(_cpu.TINY))
def test_control_is_not_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    size = {"trot_fleet_b32768": 256, "single_robot_tick_b1": 1}[cell]
    for seed in SEEDS:
        checks = control_checks(cell, seed, torch.device("cuda", 0), size, 1.0)
        assert not harness.correct(checks), checks
