"""Closed-loop rollout: controller + SRB plant
(counterpart of ``quad_periodic_mpc_tpu/control/loop.py``).

The 500 Hz process loop against the analytic plant: an outer loop over
MPC periods and an inner loop over the iterations_between_mpc control
ticks (FSM_State_Locomotion.cpp:13).  The reference's ``lax.scan`` is a
Python loop here.  Batched: a leading batch axis rolls out many scenarios
in lockstep.  Heightmaps, ground functions and tunable parameters are not
ported yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quad_periodic_mpc_tpu_torch.config import (
    ADMMConfig,
    EstimatorConfig,
    LoopConfig,
    MPCConfig,
    SwingConfig,
)
from quad_periodic_mpc_tpu_torch.control import mpc as mpc_ctrl
from quad_periodic_mpc_tpu_torch.models.a1 import A1, RobotModel
from quad_periodic_mpc_tpu_torch.ops import gait as gait_ops
from quad_periodic_mpc_tpu_torch.ops.rotations import quat_to_rpy
from quad_periodic_mpc_tpu_torch.sim import srb_sim


class RolloutCarry(NamedTuple):
    plant: srb_sim.PlantState
    ctrl: mpc_ctrl.ControllerState


class TickBalanceGains(NamedTuple):
    """Per-tick stance-force correction gains (the SRB-tier analog of the
    500 Hz WBC layer, WBC_Ctrl.cpp:60-205): a PD wrench on the tracking
    error mapped to stance-foot force deltas through the ridge-regularized
    grasp map."""

    kp_ori: tuple = (150.0, 120.0, 40.0)
    kd_ori: tuple = (20.0, 15.0, 8.0)
    kp_pos: tuple = (0.0, 60.0, 600.0)
    kd_pos: tuple = (20.0, 20.0, 60.0)
    ridge: float = 1e-2


def _tick_balance_correction(gains, obs, ctrl, cmd, stance, f_mpc, mpc_cfg):
    """Stance-force delta from the PD wrench via the masked grasp map."""
    dtype, device = f_mpc.dtype, f_mpc.device
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    rpy = quat_to_rpy(obs.quat)
    yaw = rpy[..., 2]
    yaw_err = ctrl.yaw_des - yaw
    yaw_err = torch.atan2(torch.sin(yaw_err), torch.cos(yaw_err))
    e_ori = torch.stack([-rpy[..., 0], -rpy[..., 1], yaw_err], dim=-1)
    zero = torch.zeros_like(yaw)
    w_des = torch.stack([zero, zero, cmd.yaw_rate], dim=-1)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    v_des = torch.stack(
        [ctrl.x_vel_des * cy - ctrl.y_vel_des * sy,
         ctrl.x_vel_des * sy + ctrl.y_vel_des * cy, zero], dim=-1)
    p_des = torch.cat(
        [ctrl.world_position_desired[..., :2], cmd.body_height[..., None]], dim=-1)
    d_force = t(gains.kp_pos) * (p_des - obs.p) + t(gains.kd_pos) * (v_des - obs.v)
    d_torque = t(gains.kp_ori) * e_ori + t(gains.kd_ori) * (w_des - obs.omega)
    dw = torch.cat([d_force, d_torque], dim=-1)

    r = (obs.p_feet - obs.p[..., None, :]) * stance[..., None]
    m = stance[..., None, None] * torch.eye(3, dtype=dtype, device=device)
    zr = torch.zeros_like(r[..., 0])
    rx = torch.stack(
        [torch.stack([zr, -r[..., 2], r[..., 1]], -1),
         torch.stack([r[..., 2], zr, -r[..., 0]], -1),
         torch.stack([-r[..., 1], r[..., 0], zr], -1)], dim=-2)
    batch = r.shape[:-2]
    Gf = m.transpose(-3, -2).reshape(batch + (3, 12))
    Gt = rx.transpose(-3, -2).reshape(batch + (3, 12))
    G = torch.cat([Gf, Gt], dim=-2)                          # (..., 6, 12)
    A = G @ G.transpose(-1, -2) + gains.ridge * torch.eye(6, dtype=dtype, device=device)
    lam = torch.linalg.solve(A, dw[..., None])[..., 0]
    df = (G.transpose(-1, -2) @ lam[..., None])[..., 0].reshape(f_mpc.shape)

    f = f_mpc + df
    fz = torch.clamp(f[..., 2], 0.0, mpc_cfg.f_max) * stance
    lim = mpc_cfg.mu * fz
    fx = torch.clamp(f[..., 0], -lim, lim)
    fy = torch.clamp(f[..., 1], -lim, lim)
    return torch.stack([fx, fy, fz], dim=-1)


class RolloutTrace(NamedTuple):
    """Per-MPC-step telemetry (LogData analog)."""

    x: torch.Tensor            # (..., steps, 13) plant state
    forces: torch.Tensor       # (..., steps, 4, 3) first-step MPC forces
    f_est: torch.Tensor        # (..., steps, 6)
    est_freq: torch.Tensor     # (..., steps)
    est_amp: torch.Tensor      # (..., steps)


def rollout(
    n_mpc_steps: int,
    plant: srb_sim.PlantState,
    ctrl: mpc_ctrl.ControllerState,
    cmd: mpc_ctrl.Command,
    gait: gait_ops.GaitParams,
    dist: srb_sim.DisturbanceParams,
    mpc_cfg: MPCConfig,
    loop_cfg: LoopConfig,
    est_cfg: EstimatorConfig,
    solver: ADMMConfig,
    model: RobotModel = A1,
    swing_cfg: SwingConfig = SwingConfig(),
    tick_balance: TickBalanceGains | None = None,
    heightmap=None,
    ground_fn=None,
    tunable=None,
) -> tuple[RolloutCarry, RolloutTrace]:
    """Run n_mpc_steps MPC periods (each = iterations_between_mpc ticks),
    on the device of the given states."""
    if heightmap is not None or ground_fn is not None or tunable is not None:
        raise NotImplementedError(
            "terrain and tunable parameters are not ported yet, see "
            "ROADMAP.md Queue 1")

    def control_tick(carry: RolloutCarry, do_mpc: bool) -> RolloutCarry:
        plant, ctrl = carry
        obs = srb_sim.observe(plant)
        ctrl = mpc_ctrl.setup_command(ctrl, cmd, loop_cfg)
        if do_mpc:
            ctrl, _ = mpc_ctrl.mpc_step(
                ctrl, obs, cmd, gait, plant.t, mpc_cfg, loop_cfg, est_cfg, solver)
        ctrl, out = mpc_ctrl.swing_update(
            ctrl, obs, cmd, gait, model, swing_cfg, mpc_cfg, loop_cfg,
            loop_cfg.swing_height)
        stance = (out.swing_state <= 0).to(plant.x.dtype)
        forces = out.fr_des
        if tick_balance is not None:
            forces = _tick_balance_correction(
                tick_balance, obs, ctrl, cmd, stance, forces, mpc_cfg)
        plant = srb_sim.step(
            plant, forces, out.p_foot_des, stance, dist, mpc_cfg, loop_cfg.dt)
        return RolloutCarry(plant, ctrl)

    carry = RolloutCarry(plant, ctrl)
    traces = []
    for _ in range(n_mpc_steps):
        carry = control_tick(carry, do_mpc=True)
        for _ in range(loop_cfg.iterations_between_mpc - 1):
            carry = control_tick(carry, do_mpc=False)
        traces.append(RolloutTrace(
            x=carry.plant.x, forces=carry.ctrl.fr_des, f_est=carry.ctrl.est.f_est,
            est_freq=carry.ctrl.est.est_freq, est_amp=carry.ctrl.est.est_amp,
        ))
    # steps after the batch axes, as the reference's moveaxis of the scan
    batch_ndim = plant.t.ndim
    trace = RolloutTrace(*(
        torch.stack([getattr(tr, f) for tr in traces], dim=batch_ndim)
        for f in RolloutTrace._fields))
    return carry, trace
