"""Pose-transition FSM state behaviors: StandUp / LayDown / RecoveryStand
(counterpart of ``quad_periodic_mpc_tpu/control/poses.py``).

The non-MPC FSM states as pure command generators:

- stand_up_impedance (FSM_State_StandUp.cpp:90-121): cartesian impedance
  ramp; foot z blends from the initial pose to -hMax (0.33 m) over 2 s
  (progress = 0.5 * t), with per-leg gravity feedforward -m g / 4;
- lay_down: the inverse ramp (FSM_State_LayDown semantics);
- recovery poses (FSM_State_RecoveryStand.cpp:31-45): fold
  (0, -1.4, 2.7), stand (0, -0.8, 1.6), rollover (1.5/1.3, -1.6/-3.1,
  2.77) joint targets with linear ramps.

All outputs are LegCommand-shaped tensors, batched.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

FOLD_JPOS = ((0.0, -1.4, 2.7),) * 4                       # RecoveryStand.cpp:31-34
STAND_JPOS = ((0.0, -0.8, 1.6),) * 4                      # :38-39
ROLL_JPOS = (
    (1.5, -1.6, 2.77), (1.3, -3.1, 2.77),
    (1.5, -1.6, 2.77), (1.3, -3.1, 2.77),
)                                                          # :42-44


class PoseCommand(NamedTuple):
    p_des: torch.Tensor        # (..., 4, 3) leg-frame foot targets (or NaN)
    q_des: torch.Tensor        # (..., 4, 3) joint targets (or NaN)
    force_ff: torch.Tensor     # (..., 4, 3)
    progress: torch.Tensor     # (...,)


def _with_z(p: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return torch.cat([p[..., 0:2], z[..., None]], dim=-1)


def stand_up_impedance(
    t: torch.Tensor,
    ini_foot_pos: torch.Tensor,    # (..., 4, 3) leg-frame feet at entry
    R_body: torch.Tensor,          # (..., 3, 3) world->body (rBody)
    mass: float = 6.0,
    h_max: float = 0.33,
) -> PoseCommand:
    """Impedance stand-up ramp (standUpImpedance,
    FSM_State_StandUp.cpp:90-121)."""
    dtype = ini_foot_pos.dtype
    t = torch.as_tensor(t, device=ini_foot_pos.device)
    progress = torch.clamp(0.5 * t, 0.0, 1.0).to(dtype)
    p_des = _with_z(ini_foot_pos, progress[..., None] * (-h_max)
                    + (1.0 - progress[..., None]) * ini_foot_pos[..., 2])
    g_world = torch.tensor([0.0, 0.0, -mass * 9.81 / 4.0], dtype=dtype,
                           device=ini_foot_pos.device)
    leg_force = (R_body @ g_world[:, None])[..., 0]
    force_ff = leg_force[..., None, :].expand(p_des.shape)
    return PoseCommand(p_des=p_des, q_des=torch.full_like(p_des, float("nan")),
                       force_ff=force_ff, progress=progress)


def lay_down(
    t: torch.Tensor,
    stand_foot_pos: torch.Tensor,
    ini_foot_z: torch.Tensor,
    duration: float = 2.0,
) -> PoseCommand:
    """Reverse ramp back toward the folded height (FSM_State_LayDown)."""
    dtype = stand_foot_pos.dtype
    t = torch.as_tensor(t, device=stand_foot_pos.device)
    progress = torch.clamp(t / duration, 0.0, 1.0).to(dtype)
    p_des = _with_z(stand_foot_pos, (1.0 - progress[..., None]) * stand_foot_pos[..., 2]
                    + progress[..., None] * ini_foot_z)
    return PoseCommand(p_des=p_des, q_des=torch.full_like(p_des, float("nan")),
                       force_ff=torch.zeros_like(p_des), progress=progress)


def joint_ramp(
    t: torch.Tensor,
    q_from: torch.Tensor,      # (..., 4, 3)
    target,                    # "fold" | "stand" | "rollover" | tensor (..., 4, 3)
    duration: float,
) -> PoseCommand:
    """Linear joint-space ramp toward a named recovery pose (the
    _StandUp/_FoldLegs/_RollOver interpolation,
    FSM_State_RecoveryStand.cpp:117-200)."""
    dtype = q_from.dtype
    if isinstance(target, str):
        table = {"fold": FOLD_JPOS, "stand": STAND_JPOS, "rollover": ROLL_JPOS}
        q_to = torch.tensor(table[target], dtype=dtype, device=q_from.device)
    else:
        q_to = target
    t = torch.as_tensor(t, device=q_from.device)
    s = torch.clamp(t / duration, 0.0, 1.0).to(dtype)
    q_des = (1.0 - s[..., None, None]) * q_from + s[..., None, None] * q_to
    return PoseCommand(p_des=torch.full_like(q_des, float("nan")), q_des=q_des,
                       force_ff=torch.zeros_like(q_des), progress=s)
