"""Single-rigid-body (SRB) 13-state convex-MPC dynamics linearization
(frozen copy of the port's ``quad_periodic_mpc_tpu_torch/models/srb.py``).

State (SolverMPC.cpp:592): x = [roll, pitch, yaw, p(3), omega(3), v(3), g]
with g a constant-gravity augmentation (x[12] = -9.8, A[11,12] = 1).
Continuous-time model (ct_ss_mats, SolverMPC.cpp:260-279):

    A[0:3, 6:9] = R^T,  A[3,9] = A[4,10] = A[5,11] = 1,
    A[11,9] = x_drag,  A[11,12] = 1,
    B[6:9, 3b:3b+3] = I_world^{-1} [r_b]x,  B[9:12, 3b:3b+3] = I/m,
    Qc[6:12, 0:6] = I_6  (external wrench in acceleration space).

A is nilpotent (A^3 = 0), which ops/discretize.py exploits.
"""

from __future__ import annotations

import torch

from port_bench.reference.rotations import skew
from port_bench.reference.consts import const

NX = 13
NU = 12
NW = 6


def world_inertia(R: torch.Tensor, I_body_diag: torch.Tensor) -> torch.Tensor:
    """I_world = R diag(I_body) R^T (SolverMPC.cpp:593)."""
    I_body = I_body_diag[..., :, None] * torch.eye(3, dtype=R.dtype, device=R.device)
    return R @ I_body @ R.transpose(-1, -2)


def ct_dynamics(
    R: torch.Tensor,
    r_feet: torch.Tensor,
    mass: float,
    I_body_diag,
    x_drag=0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Continuous-time (A (..., 13, 13), B (..., 13, 12), Qc (..., 13, 6)).

    R: (..., 3, 3) body->world; r_feet: (..., 4, 3) foot positions
    relative to the CoM, world frame; x_drag: scalar or (...,).
    """
    dtype, device = R.dtype, R.device
    x_drag = const(x_drag, dtype, device)
    batch = torch.broadcast_shapes(R.shape[:-2], r_feet.shape[:-2], x_drag.shape)
    x_drag = torch.broadcast_to(x_drag, batch)

    A = torch.zeros(batch + (NX, NX), dtype=dtype, device=device)
    A[..., 0:3, 6:9] = torch.broadcast_to(R.transpose(-1, -2), batch + (3, 3))
    # fill_, not `= 1.0`: on a card a Python number assigned into a 0-dim
    # slice (no batch axis) is a synchronous copy from the host
    A[..., 3, 9].fill_(1.0)
    A[..., 4, 10].fill_(1.0)
    A[..., 5, 11].fill_(1.0)
    A[..., 11, 9] = x_drag
    A[..., 11, 12].fill_(1.0)

    # I_world^{-1} = R diag(1/I_body) R^T (I_world = R diag(I) R^T,
    # SolverMPC.cpp:593)
    I_inv_diag = 1.0 / const(I_body_diag, dtype, device)
    I_inv = (R * I_inv_diag[..., None, :]) @ R.transpose(-1, -2)
    torque_blocks = I_inv[..., None, :, :] @ skew(r_feet)       # (..., 4, 3, 3)
    torque_blocks = torch.broadcast_to(torque_blocks, batch + (4, 3, 3))
    inv_m = 1.0 / const(mass, dtype, device)
    force_block = inv_m * torch.eye(3, dtype=dtype, device=device)

    B = torch.zeros(batch + (NX, NU), dtype=dtype, device=device)
    for b in range(4):
        B[..., 6:9, 3 * b: 3 * b + 3] = torque_blocks[..., b, :, :]
        B[..., 9:12, 3 * b: 3 * b + 3] = force_block

    Qc = torch.zeros(batch + (NX, NW), dtype=dtype, device=device)
    Qc[..., 6:12, 0:6] = torch.eye(6, dtype=dtype, device=device)
    return A, B, Qc


def pack_state(
    rpy: torch.Tensor,
    p: torch.Tensor,
    omega: torch.Tensor,
    v: torch.Tensor,
    gravity: float = 9.8,
) -> torch.Tensor:
    """x_0 = [rpy, p, omega_world, v_world, -g] (SolverMPC.cpp:592)."""
    g = torch.full(rpy.shape[:-1] + (1,), -gravity, dtype=rpy.dtype,
                   device=rpy.device)
    return torch.cat([rpy, p, omega, v, g], dim=-1)
