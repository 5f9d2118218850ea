"""The terrain-aware walking period (the CMPCLocomotion_Cv loop): the
period of ``loop.py`` with the map's body-height command in the MPC tick,
``terrain.foothold_update`` on the Raibert targets of every swing update,
and the plant's feet held on or above the staircase.

``period_step(...)(carry) -> TerrainOut``: the carry after the period and
``near``, (B, 4) bool, each leg of each instance that took a decision in
the period within rounding of where it would have gone the other way:

- a point within ``window_m`` of a cell boundary of the map (the MPC
  tick's body-height cells under the feet; a swinging leg's own target
  cell and its swing-start cell);
- a swinging leg's spiral search reading a traversability within
  ``window_trav`` of the threshold;
- a foot within ``window_m`` of a riser's x (the plant's ground).

The plain ticks' body-height commands are computed as the program
computes them but decide nothing: only the MPC tick reads the command's
height."""

from __future__ import annotations

from typing import NamedTuple

import torch

from port_bench.reference import gait as gait_ops
from port_bench.reference import mpc as mpc_ctrl
from port_bench.reference import srb_sim, swing
from port_bench.reference import terrain as T
from port_bench.reference.a1 import A1, RobotModel
from port_bench.reference.config import (
    ADMMConfig,
    EstimatorConfig,
    LoopConfig,
    MPCConfig,
    SwingConfig,
)
from port_bench.reference.consts import const
from port_bench.reference.loop import RolloutCarry
from port_bench.reference.rotations import quat_to_rotmat, quat_to_rpy


class TerrainOut(NamedTuple):
    carry: RolloutCarry
    near: torch.Tensor          # (B, 4) bool


def swing_update(state, obs, cmd, gait, model: RobotModel, swing_cfg: SwingConfig,
                 mpc: MPCConfig, loop: LoopConfig, swing_height, foothold):
    """``mpc.swing_update`` with the foothold hook (the call site of
    _updateFoothold in the swing-leg loop of CMPC_Locomotion_cv.cpp:1022):
    ``foothold(pf_target, state, obs) ->
    (pf, near)`` runs on the Raibert targets before they become swing
    goals.  Returns (state, output, near of the swinging legs)."""
    dtype, device = obs.p.dtype, obs.p.device
    R = quat_to_rotmat(obs.quat)
    v_des_robot, v_des_world = mpc_ctrl._v_des(state, R)

    ph = gait_ops.phase(gait, state.iteration, loop.iterations_between_mpc)
    contact = gait_ops.contact_state(gait, ph)
    swing_st = gait_ops.swing_state(gait, ph)
    swing_times = gait_ops.swing_time(gait, loop.dt_mpc)
    stance_times = gait_ops.stance_time(gait, loop.dt_mpc)
    str_new = torch.where(
        state.first_swing, swing_times, state.swing_time_remaining - loop.dt)

    as_t = lambda a: const(a, dtype, device)
    pf_target = swing.raibert_foothold(
        p_body=obs.p, v_world=obs.v, v_des_world=v_des_world, v_des_robot=v_des_robot,
        R_body=R.transpose(-1, -2),
        hip_location=as_t(model.hip_locations()).expand(obs.p_feet.shape),
        side_sign=as_t(model.side_signs()), abad_link_length=model.leg.abad_link_length,
        yaw_turn_rate=cmd.yaw_rate[..., None], stance_time=stance_times,
        swing_time_remaining=str_new, body_height_z=obs.p[..., 2],
        interleave_y=as_t(swing_cfg.interleave_y), interleave_gain=swing_cfg.interleave_gain,
        bonus_swing=swing_cfg.bonus_swing, p_rel_max=swing_cfg.p_rel_max,
        dt_mpc=loop.dt_mpc)
    pf_target, near = foothold(pf_target, state, obs)

    in_swing = swing_st > 0
    start_swing = in_swing & state.first_swing
    p0_new = torch.where(start_swing[..., None], obs.p_feet, state.swing_p0)
    pf_new = torch.where(in_swing[..., None], pf_target, state.swing_pf)
    ev = swing.evaluate(p0_new, pf_new, swing_height, swing_st, swing_times)
    p_des = torch.where(in_swing[..., None], ev.p, obs.p_feet)
    v_des = torch.where(in_swing[..., None], ev.v, torch.zeros_like(ev.v))
    a_des = torch.where(in_swing[..., None], ev.a, torch.zeros_like(ev.a))

    standing = (gait.durations >= gait.n_segments[..., None]).all(dim=-1)
    wpd = state.world_position_desired + torch.where(
        standing[..., None], torch.zeros_like(v_des_world), loop.dt * v_des_world)
    rpy = quat_to_rpy(obs.quat)
    vr = obs.v
    one = torch.ones_like(vr[..., 0])
    zero = torch.zeros_like(vr[..., 0])
    d_pitch = torch.where(
        torch.abs(vr[..., 0]) > 0.2,
        loop.dt * (0.0 - rpy[..., 1]) / torch.where(vr[..., 0] == 0, one, vr[..., 0]), zero)
    d_roll = torch.where(
        torch.abs(vr[..., 1]) > 0.1,
        loop.dt * (0.0 - rpy[..., 0]) / torch.where(vr[..., 1] == 0, one, vr[..., 1]), zero)
    rpy_int = torch.clamp(torch.stack(
        [state.rpy_int[..., 0] + d_roll, state.rpy_int[..., 1] + d_pitch], dim=-1), -0.25, 0.25)
    rpy_comp = torch.stack([vr[..., 1] * rpy_int[..., 0], vr[..., 0] * rpy_int[..., 1]], dim=-1)

    state = state._replace(
        iteration=state.iteration + 1, world_position_desired=wpd, rpy_int=rpy_int,
        rpy_comp=rpy_comp, first_swing=~in_swing, swing_time_remaining=str_new,
        swing_p0=p0_new, swing_pf=pf_new)
    out = mpc_ctrl.ControlOutput(
        f_ff=state.f_ff, fr_des=state.fr_des, p_foot_des=p_des, v_foot_des=v_des,
        a_foot_des=a_des, contact_state=contact, swing_state=swing_st)
    return state, out, near & in_swing


def period_step(cmd: mpc_ctrl.Command, gait, dist: srb_sim.DisturbanceParams,
                mpc_cfg: MPCConfig, loop_cfg: LoopConfig, est_cfg: EstimatorConfig,
                solver: ADMMConfig, hm: T.HeightMap, stairs: T.Stairs,
                terrain_cfg: T.TerrainConfig, window_m: float, window_trav: float,
                model: RobotModel = A1, swing_cfg: SwingConfig = SwingConfig()):
    """One terrain-aware MPC period with everything but the carry closed
    over: ``step(carry) -> TerrainOut``."""
    hm_feet = hm._replace(center=hm.center[..., None, :])

    def foothold(pf_target, state, obs):
        p0 = torch.where(state.first_swing[..., None], obs.p_feet, state.swing_p0)
        pf, trav_margin = T.foothold_update(hm, pf_target, p0, terrain_cfg)
        near = ((T.cell_margin(hm_feet, pf_target[..., 0:2]) < window_m)
                | (T.cell_margin(hm_feet, p0[..., 0:2]) < window_m)
                | (trav_margin < window_trav))
        return pf, near

    def control_tick(carry: RolloutCarry, do_mpc: bool, near: torch.Tensor):
        plant, ctrl = carry
        obs = srb_sim.observe(plant)
        cmd_t = cmd._replace(body_height=T.terrain_command(
            hm, cmd.body_height, obs.p_feet, terrain_cfg))
        ctrl = mpc_ctrl.setup_command(ctrl, cmd_t, loop_cfg)
        if do_mpc:
            if terrain_cfg.body_height_from_map:
                near = near | (T.cell_margin(hm_feet, obs.p_feet[..., 0:2]) < window_m)
            ctrl, _ = mpc_ctrl.mpc_step(
                ctrl, obs, cmd_t, gait, plant.t, mpc_cfg, loop_cfg, est_cfg, solver)
        ctrl, out, near_swing = swing_update(
            ctrl, obs, cmd_t, gait, model, swing_cfg, mpc_cfg, loop_cfg,
            loop_cfg.swing_height, foothold)
        stance = (out.swing_state <= 0).to(plant.x.dtype)
        plant = srb_sim.step(
            plant, out.fr_des, out.p_foot_des, stance, dist, mpc_cfg, loop_cfg.dt)
        feet = plant.p_feet
        gz = T.ground_z(stairs, feet[..., 0:2])
        feet = torch.cat([feet[..., 0:2], torch.maximum(feet[..., 2], gz)[..., None]], dim=-1)
        near = near | near_swing | (T.step_margin(stairs, feet[..., 0]) < window_m)
        return RolloutCarry(plant._replace(p_feet=feet), ctrl), near

    def step(carry: RolloutCarry) -> TerrainOut:
        near = torch.zeros(carry.plant.p_feet.shape[:-1], dtype=torch.bool,
                           device=carry.plant.p_feet.device)
        carry, near = control_tick(carry, True, near)
        for _ in range(loop_cfg.iterations_between_mpc - 1):
            carry, near = control_tick(carry, False, near)
        return TerrainOut(carry, near)

    return step
