"""Helpers of the benchmark's CPU tests: a cell run on the CPU at a tiny
batch through the harness, with the look for a card skipped."""

from __future__ import annotations

import time

import torch

from port_bench.lib import harness

SEED = 2_300_000_017            # larger than 32 signed bits hold
TINY = {"trot_fleet_b32768": 3, "single_robot_tick_b1": 1}


def run(cell: str, seed: int = SEED, seconds: float = 0.2, traced: bool = False, hook=None,
        log=lambda s: None) -> dict:
    torch.set_num_threads(1)
    return harness.run_cell(cell, seed, seconds, traced, torch.device("cpu"),
                            time.perf_counter(), instances=TINY[cell], hook=hook, log=log)
