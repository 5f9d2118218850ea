"""Offline control-plan playback, the BackFlip/FrontJump tier (counterpart
of ``quad_periodic_mpc_tpu/control/playback.py``).

Rebuilds DataReader (src/controllers/BackFlip/DataReader.cpp:33-116) and
BackFlipCtrl (BackFlipCtrl.cpp:12-140): a control plan is a float32 binary
of rows with 22 columns —
  [0:7)  planar configuration (x, z, pitch, q_f_hip, q_f_knee,
         q_r_hip, q_r_knee)
  [7:14) velocities in the same order
  [14:18) feedforward torques (front hip, front knee, rear hip, rear
         knee), tau_offset = 14 (DataReader.hpp:11)
  [18:22) reserved / contact force data
Playback mirrors the planar plan to both legs of each pair, applies
tau_mult = 1.2, holds a preparation pose, and blends to the landing
configuration between tuck_iteration = 600 and ramp_end = 650
(BackFlipCtrl.cpp:30-140).  The file format is the reference package's:
a plan saved by either package loads in the other.  ``synthesize_jump_plan``
builds test plans on the host with numpy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

PLAN_COLS = 22      # DataReader.hpp:20
TAU_OFFSET = 14     # DataReader.hpp:11


def load_plan(path: str, device="cuda") -> torch.Tensor:
    """Binary float32 plan -> (T, 22) (load_control_plan,
    DataReader.cpp:33-77)."""
    raw = np.fromfile(path, dtype=np.float32)
    if raw.size % PLAN_COLS:
        raise ValueError(f"{path}: size not divisible by {PLAN_COLS}")
    return torch.from_numpy(raw.reshape(-1, PLAN_COLS)).to(device)


def save_plan(path: str, plan) -> None:
    if isinstance(plan, torch.Tensor):
        plan = plan.detach().cpu().numpy()
    np.asarray(plan, np.float32).reshape(-1, PLAN_COLS).tofile(path)


def synthesize_jump_plan(timesteps: int = 800, dt: float = 0.001) -> np.ndarray:
    """Generate a simple crouch-extend-tuck demo plan (test data; the
    reference ships a precomputed trajectory-optimization result)."""
    t = np.arange(timesteps) * dt
    plan = np.zeros((timesteps, PLAN_COLS), np.float32)
    crouch = t < 0.3
    thrust = (t >= 0.3) & (t < 0.45)
    q_hip = np.where(crouch, -1.0, np.where(thrust, -0.4, -1.3))
    q_knee = np.where(crouch, 2.2, np.where(thrust, 1.2, 2.4))
    plan[:, 3] = q_hip
    plan[:, 4] = q_knee
    plan[:, 5] = q_hip
    plan[:, 6] = q_knee
    plan[:, 10] = np.gradient(q_hip, dt)
    plan[:, 11] = np.gradient(q_knee, dt)
    plan[:, 12] = plan[:, 10]
    plan[:, 13] = plan[:, 11]
    plan[:, 14:18] = np.where(thrust[:, None], [[8.0, 16.0, 8.0, 16.0]], 0.0)
    return plan


class PlaybackOutput(NamedTuple):
    q_des: torch.Tensor     # (..., 4, 3)
    qd_des: torch.Tensor    # (..., 4, 3)
    tau_ff: torch.Tensor    # (..., 4, 3)
    kp_joint: torch.Tensor  # (..., 3)
    kd_joint: torch.Tensor  # (..., 3)


def _leg(row: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """(0, row[a], row[b]): a planar pair's abduction, hip, knee."""
    return torch.stack([torch.zeros_like(row[..., a]), row[..., a], row[..., b]], -1)


def playback_command(
    plan: torch.Tensor,
    iteration,
    preparation=False,
    tuck_iteration: int = 600,
    ramp_end_iteration: int = 650,
    tau_mult: float = 1.2,
    landing_front: tuple = (-0.8425, 1.70),
    landing_rear: tuple = (-1.0525, 1.65),
) -> PlaybackOutput:
    """One playback tick (BackFlipCtrl::_update_joint_command,
    BackFlipCtrl.cpp:30-140), batched over ``iteration``."""
    dtype, device = plan.dtype, plan.device
    T = plan.shape[0]
    it = torch.clamp(torch.as_tensor(iteration, device=device), 0, T - 1)
    prep = torch.as_tensor(preparation, device=device)
    c = lambda v: torch.tensor(v, dtype=dtype, device=device)

    row = plan[it]                                  # (..., 22)
    mult = torch.where(prep, c(0.0), c(tau_mult))

    q_f, q_r = _leg(row, 3, 4), _leg(row, 5, 6)
    qd_f, qd_r = _leg(row, 10, 11), _leg(row, 12, 13)
    tau = row[..., TAU_OFFSET:TAU_OFFSET + 4]
    tau_f = torch.stack([torch.zeros_like(tau[..., 0]), mult * tau[..., 0] / 2.0,
                         mult * tau[..., 1] / 2.0], -1)
    tau_r = torch.stack([torch.zeros_like(tau[..., 2]), mult * tau[..., 2] / 2.0,
                         mult * tau[..., 3] / 2.0], -1)

    # landing ramp (BackFlipCtrl.cpp:88-122)
    in_ramp = (it >= tuck_iteration)[..., None]
    s = torch.clamp((it - tuck_iteration) / float(ramp_end_iteration - tuck_iteration),
                    0.0, 1.0).to(dtype)
    row0 = plan[min(tuck_iteration, T - 1)]
    q_f0, q_r0 = _leg(row0, 3, 4), _leg(row0, 5, 6)
    q_ff, q_rf = c([0.0, *landing_front]), c([0.0, *landing_rear])
    q_f = torch.where(in_ramp, (1 - s[..., None]) * q_f0 + s[..., None] * q_ff, q_f)
    q_r = torch.where(in_ramp, (1 - s[..., None]) * q_r0 + s[..., None] * q_rf, q_r)
    zero = c(0.0)
    qd_f, qd_r = torch.where(in_ramp, zero, qd_f), torch.where(in_ramp, zero, qd_r)
    tau_f, tau_r = torch.where(in_ramp, zero, tau_f), torch.where(in_ramp, zero, tau_r)

    # legs: 0, 1 front; 2, 3 rear; abduction splays to +-0.2 during ramp
    # (BackFlipCtrl.cpp:126-133)
    s_ab = torch.where(in_ramp[..., 0], s, torch.zeros_like(s))
    ab = s_ab[..., None] * c([-0.2, 0.2, -0.2, 0.2])
    q = torch.stack([q_f, q_f, q_r, q_r], dim=-2)
    q = torch.cat([ab[..., None], q[..., 1:]], dim=-1)
    qd = torch.stack([qd_f, qd_f, qd_r, qd_r], dim=-2)
    tau_out = torch.stack([tau_f, tau_f, tau_r, tau_r], dim=-2)

    kp = torch.where(in_ramp, c([25.0, 25.0, 25.0]), c([10.0, 10.0, 10.0]))
    kd = torch.where(in_ramp, c([1.5, 1.5, 1.5]), c([1.0, 1.0, 1.0]))
    return PlaybackOutput(q_des=q, qd_des=qd, tau_ff=tau_out, kp_joint=kp, kd_joint=kd)
