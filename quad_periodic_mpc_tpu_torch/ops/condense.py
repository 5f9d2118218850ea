"""Cost-weight helper of the condensed formulation
(counterpart of ``quad_periodic_mpc_tpu/ops/condense.py``).  Only
``full_weight`` is ported: the stagewise path needs nothing else."""

from __future__ import annotations

import torch


def full_weight(weights12: torch.Tensor) -> torch.Tensor:
    """13-entry stage weight: 12 tracked states + 0 on the gravity state
    (SolverMPC.cpp:624-630)."""
    zero = torch.zeros(weights12.shape[:-1] + (1,), dtype=weights12.dtype,
                       device=weights12.device)
    return torch.cat([weights12, zero], dim=-1)
