"""Friction-pyramid constraint assembly
(frozen copy of the port's ``quad_periodic_mpc_tpu_torch/ops/constraints.py``).

Per foot per horizon step the 5x3 pyramid block (SolverMPC.cpp:657-665)
F = [[1/mu, 0, 1], [-1/mu, 0, 1], [0, 1/mu, 1], [0, -1/mu, 1], [0, 0, 1]]
with bounds 0 <= F f <= [BIG, BIG, BIG, BIG, contact * f_max]
(SolverMPC.cpp:643-655).  Swing feet keep their variables and are pinned
to zero by the f_z <= 0 bound instead of being eliminated.
"""

from __future__ import annotations

import torch
from port_bench.reference.consts import const


def pyramid_block(mu, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """The 5x3 friction pyramid block F (SolverMPC.cpp:657-665)."""
    mu_inv = 1.0 / const(mu, dtype, device)
    z = torch.zeros_like(mu_inv)
    o = torch.ones_like(mu_inv)
    return torch.stack(
        [
            torch.stack([mu_inv, z, o], -1),
            torch.stack([-mu_inv, z, o], -1),
            torch.stack([z, mu_inv, o], -1),
            torch.stack([z, -mu_inv, o], -1),
            torch.stack([z, z, o], -1),
        ],
        dim=-2,
    )


def bounds(
    gait_table: torch.Tensor, f_max, big_number: float = 5e10,
    dtype=torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(l, u) of shape (..., h, 4, 5) from the (..., h, 4) contact table
    in {0, 1} (SolverMPC.cpp:643-655, lb = 0 at :846-849)."""
    g = gait_table.to(dtype)
    fm = const(f_max, dtype, g.device)
    if fm.ndim:
        fm = fm[..., None, None]
    fz_ub = g * fm
    big = torch.full_like(fz_ub, big_number)
    u = torch.stack([big, big, big, big, fz_ub], dim=-1)
    return torch.zeros_like(u), u


def apply(F: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """blockdiag(F) @ x via the block structure: F (c, a) (the 5x3 MPC
    pyramid or the 6x3 WBIC cone), x (..., k*a) -> (..., k*c)."""
    c, a = F.shape[-2], F.shape[-1]
    feet = x.reshape(x.shape[:-1] + (x.shape[-1] // a, a))
    return (feet @ F.transpose(-1, -2)).reshape(x.shape[:-1] + (-1,))


def apply_T(F: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """blockdiag(F)^T @ y: (..., k*c) -> (..., k*a)."""
    c, a = F.shape[-2], F.shape[-1]
    rows = y.reshape(y.shape[:-1] + (y.shape[-1] // c, c))
    return (rows @ F).reshape(y.shape[:-1] + (-1,))
