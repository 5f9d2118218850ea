"""Convex-MPC locomotion controller (the ConvexMPCLocomotion rebuild), as the
configurations run it: ``ADMMConfig(formulation="stagewise",
backend="pallas")`` in float32 at h <= 64 with no tunables, where the
program takes the fused-build kernel; here its plain version
(``stagewise.solve_srb``).

    (ControllerState, Observation, Command) -> (ControllerState, Output)

- ``mpc_step`` runs once per MPC period (every 13 control ticks):
  reference trajectory, disturbance residual + periodic estimator, and the
  QP solve; then f_ff = -R^T f (ConvexMPCLocomotion.cpp:832-845).
- ``swing_update`` runs every control tick: swing bookkeeping and foot
  targets (ConvexMPCLocomotion.cpp:277-460).

A leading batch axis runs many MPC instances in one call.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from port_bench.reference import constraints, srb, stagewise, swing
from port_bench.reference import estimator as est_ops
from port_bench.reference import gait as gait_ops
from port_bench.reference.a1 import RobotModel
from port_bench.reference.config import (
    ADMMConfig,
    EstimatorConfig,
    LoopConfig,
    MPCConfig,
    SwingConfig,
)
from port_bench.reference.consts import const
from port_bench.reference.rotations import (
    quat_to_rotmat,
    quat_to_rpy,
    rpy_to_rotmat,
)


class Observation(NamedTuple):
    """Estimated robot state at the control tick (StateEstimate analog)."""

    p: torch.Tensor        # (..., 3) CoM position, world
    v: torch.Tensor        # (..., 3) CoM velocity, world
    quat: torch.Tensor     # (..., 4) orientation wxyz
    omega: torch.Tensor    # (..., 3) angular velocity, world
    p_feet: torch.Tensor   # (..., 4, 3) foot positions, world


class Command(NamedTuple):
    """Operator command (_SetupCommand inputs)."""

    vx: torch.Tensor
    vy: torch.Tensor
    yaw_rate: torch.Tensor
    body_height: torch.Tensor


class ControllerState(NamedTuple):
    """All mutable state of ConvexMPCLocomotion, as tensors."""

    iteration: torch.Tensor             # (...,) int32 control-tick counter
    x_vel_des: torch.Tensor
    y_vel_des: torch.Tensor
    yaw_des: torch.Tensor
    world_position_desired: torch.Tensor  # (..., 3)
    rpy_int: torch.Tensor               # (..., 2)
    rpy_comp: torch.Tensor              # (..., 2)
    first_swing: torch.Tensor           # (..., 4) bool
    swing_time_remaining: torch.Tensor  # (..., 4)
    swing_p0: torch.Tensor              # (..., 4, 3)
    swing_pf: torch.Tensor              # (..., 4, 3)
    f_ff: torch.Tensor                  # (..., 4, 3)
    fr_des: torch.Tensor                # (..., 4, 3)
    x_comp_integral: torch.Tensor       # (...,)
    est: est_ops.EstimatorState
    prev_x: torch.Tensor                # (..., 13)
    prev_R: torch.Tensor                # (..., 3, 3)
    prev_r_feet: torch.Tensor           # (..., 4, 3)
    prev_x_drag: torch.Tensor           # (...,)
    have_prev: torch.Tensor             # (...,) bool
    warm_x: torch.Tensor                # (..., 12h) warm-start carry
    warm_z: torch.Tensor                # (..., 20h)
    warm_y: torch.Tensor                # (..., 20h)
    warm_kinv: torch.Tensor             # (..., kn, kn) condensed only


class ControlOutput(NamedTuple):
    """Per-tick controller output (LegController command analog)."""

    f_ff: torch.Tensor
    fr_des: torch.Tensor
    p_foot_des: torch.Tensor
    v_foot_des: torch.Tensor
    a_foot_des: torch.Tensor
    contact_state: torch.Tensor
    swing_state: torch.Tensor


def init_state(
    batch: tuple,
    obs: Observation,
    window: int = 400,
    dtype=torch.float32,
    horizon: int = 10,
    formulation: str = "condensed",
) -> ControllerState:
    """firstRun initialization (ConvexMPCLocomotion.cpp:249-274), on the
    device of ``obs``."""
    device = obs.p.device
    z = lambda *s: torch.zeros(batch + s, dtype=dtype, device=device)
    kn = 12 * horizon if formulation == "condensed" else 1
    wpd = torch.cat(
        [obs.p[..., :2].to(dtype),
         torch.full(batch + (1,), 0.24, dtype=dtype, device=device)], dim=-1)
    return ControllerState(
        iteration=torch.zeros(batch, dtype=torch.int32, device=device),
        x_vel_des=z(), y_vel_des=z(), yaw_des=z(),
        world_position_desired=wpd,
        rpy_int=z(2), rpy_comp=z(2),
        first_swing=torch.ones(batch + (4,), dtype=torch.bool, device=device),
        swing_time_remaining=z(4),
        swing_p0=obs.p_feet.to(dtype).clone(),
        swing_pf=obs.p_feet.to(dtype).clone(),
        f_ff=z(4, 3), fr_des=z(4, 3),
        x_comp_integral=z(),
        est=est_ops.init(batch, window, dtype, device),
        prev_x=z(13),
        prev_R=torch.eye(3, dtype=dtype, device=device).expand(batch + (3, 3)).clone(),
        prev_r_feet=z(4, 3),
        prev_x_drag=z(),
        have_prev=torch.zeros(batch, dtype=torch.bool, device=device),
        warm_x=z(12 * horizon),
        warm_z=z(20 * horizon),
        warm_y=z(20 * horizon),
        warm_kinv=z(kn, kn),
    )


def setup_command(state: ControllerState, cmd: Command, loop: LoopConfig) -> ControllerState:
    """Velocity-command low-pass (filter 0.1, ConvexMPCLocomotion.cpp:101-123;
    _yaw_des pinned to 0 as at :120)."""
    f = 0.1
    return state._replace(
        x_vel_des=state.x_vel_des * (1 - f) + cmd.vx * f,
        y_vel_des=state.y_vel_des * (1 - f) + cmd.vy * f,
        yaw_des=torch.zeros_like(state.yaw_des),
    )


def build_reference_trajectory(
    state: ControllerState,
    obs: Observation,
    cmd: Command,
    v_des_world: torch.Tensor,
    rpy: torch.Tensor,
    mpc: MPCConfig,
    loop: LoopConfig,
) -> tuple[torch.Tensor, ControllerState]:
    """trajAll builder (ConvexMPCLocomotion.cpp:536-586).  Returns
    (x_ref (..., h, 13), state with the clamped world_position_desired)."""
    h = mpc.horizon
    dtype, device = obs.p.dtype, obs.p.device
    max_err = loop.max_pos_error
    start_xy = torch.clamp(
        state.world_position_desired[..., :2],
        obs.p[..., :2] - max_err,
        obs.p[..., :2] + max_err,
    )
    wpd = torch.cat([start_xy, state.world_position_desired[..., 2:]], dim=-1)

    i = torch.arange(h, dtype=dtype, device=device)
    dt_mpc = mpc.dt_mpc
    batch = obs.p.shape[:-1]
    tile = lambda v: v[..., None].expand(batch + (h,))

    x_ref = torch.zeros(batch + (h, 13), dtype=dtype, device=device)
    x_ref[..., 0] = tile(state.rpy_comp[..., 0])
    x_ref[..., 1] = tile(state.rpy_comp[..., 1])
    # yaw: step 0 = current yaw (:577), then + dtMPC * yaw_rate per step (:583)
    x_ref[..., 2] = rpy[..., 2:3] + i * dt_mpc * cmd.yaw_rate[..., None]
    x_ref[..., 3] = start_xy[..., 0:1] + i * dt_mpc * v_des_world[..., 0:1]
    x_ref[..., 4] = start_xy[..., 1:2] + i * dt_mpc * v_des_world[..., 1:2]
    x_ref[..., 5] = tile(cmd.body_height)
    x_ref[..., 8] = tile(cmd.yaw_rate)
    x_ref[..., 9] = tile(v_des_world[..., 0])
    x_ref[..., 10] = tile(v_des_world[..., 1])
    return x_ref, state._replace(world_position_desired=wpd)


def _v_des(state: ControllerState, R: torch.Tensor):
    v_des_robot = torch.stack(
        [state.x_vel_des, state.y_vel_des, torch.zeros_like(state.x_vel_des)],
        dim=-1)
    # v_des_world = rBody^T v_des_robot = R v_des_robot (:211,520)
    return v_des_robot, (R @ v_des_robot[..., None])[..., 0]


def full_weight(weights12: torch.Tensor) -> torch.Tensor:
    """13-entry stage weight: 12 tracked states + 0 on the gravity state
    (SolverMPC.cpp:624-630)."""
    zero = torch.zeros(weights12.shape[:-1] + (1,), dtype=weights12.dtype,
                       device=weights12.device)
    return torch.cat([weights12, zero], dim=-1)


def mpc_step(
    state: ControllerState,
    obs: Observation,
    cmd: Command,
    gait: gait_ops.GaitParams,
    sim_time: torch.Tensor,
    mpc: MPCConfig,
    loop: LoopConfig,
    est_cfg: EstimatorConfig,
    solver: ADMMConfig,
):
    """One MPC solve (solveDenseMPC, ConvexMPCLocomotion.cpp:612-870).
    Returns (state', forces (..., h, 4, 3))."""
    dtype = obs.p.dtype
    h = mpc.horizon
    if not (isinstance(solver, ADMMConfig) and solver.formulation == "stagewise"
            and h <= 64 and dtype == torch.float32 and not est_cfg.predictive):
        raise ValueError("the reference runs the fused-build stagewise solve only")

    R = quat_to_rotmat(obs.quat)
    rpy = quat_to_rpy(obs.quat)
    _, v_des_world = _v_des(state, R)
    x_ref, state = build_reference_trajectory(
        state, obs, cmd, v_des_world, rpy, mpc, loop)

    # r = pFoot - p (:628)
    p_used = obs.p
    r_feet = obs.p_feet - p_used[..., None, :]

    # x-drag integral (:813-818)
    pz_err = p_used[..., 2] - cmd.body_height
    vx = obs.v[..., 0]
    x_comp = state.x_comp_integral + torch.where(
        torch.abs(vx) > 0.3,
        mpc.x_drag_gain * pz_err * mpc.dt_mpc
        / torch.where(vx == 0, torch.ones_like(vx), vx),
        torch.zeros_like(vx),
    )

    # ---- disturbance residual + periodic estimator ----
    x_k = srb.pack_state(rpy, p_used, obs.omega, obs.v, mpc.gravity)
    if est_cfg.residual != "discrete":
        raise ValueError("the reference runs the discrete residual only")
    f_ext = est_ops.residual_discrete(
        x_k, state.prev_x, state.fr_des, state.prev_R, state.prev_r_feet,
        mpc.mass, mpc.inertia_body, state.prev_x_drag, mpc.dt_mpc)
    f_ext = torch.where(state.have_prev[..., None], f_ext, torch.zeros_like(f_ext))
    est_state, f_for_qp = est_ops.update(state.est, sim_time, f_ext, est_cfg)

    # ---- QP assembly + solve ----
    seg = gait_ops.segment_index(gait, state.iteration, loop.iterations_between_mpc)
    table = gait_ops.mpc_table(gait, seg, h)
    lead = obs.p.shape[:-1]
    U, z, y = _fused_build_solve(
        state, R, r_feet, x_comp, f_for_qp, x_k, x_ref, table, mpc, solver)
    state = state._replace(
        warm_x=U.reshape(lead + (h * 12,)),
        warm_z=z.reshape(lead + (h * 20,)),
        warm_y=y.reshape(lead + (h * 20,)),
    )

    forces = U.reshape(lead + (h, 4, 3))
    f_mpc0 = forces[..., 0, :, :]
    # f_ff = -rBody f = -R^T f per foot (:840)
    f_ff = -torch.einsum("...ji,...kj->...ki", R, f_mpc0)
    state = state._replace(
        f_ff=f_ff,
        fr_des=f_mpc0,
        x_comp_integral=x_comp,
        est=est_state,
        prev_x=x_k,
        prev_R=rpy_to_rotmat(rpy),
        prev_r_feet=r_feet,
        prev_x_drag=x_comp,
        have_prev=torch.ones_like(state.have_prev),
    )
    return state, forces


def _fused_build_solve(state, R, r_feet, x_comp, f_for_qp, x_k, x_ref, table, mpc, solver):
    """The fused-build branch of ``mpc_step``: bounds, weights and the flat
    warm start for the fused-build solve.  Returns (U, z, y), each
    (B, h, .) over the flattened batch."""
    h = mpc.horizon
    dtype, device = x_k.dtype, x_k.device
    lead = x_k.shape[:-1]
    l, u = constraints.bounds(table, mpc.f_max, mpc.big_number, dtype)
    batch = l.shape[:-3]
    l = l.reshape(batch + (h, 20))
    u = torch.clamp(u, max=1e4).reshape(batch + (h, 20))
    F = constraints.pyramid_block(mpc.mu, dtype, device)
    Qdiag = 2.0 * full_weight(const(mpc.weights, dtype, device))
    R_eff = (
        2.0 * mpc.alpha * torch.eye(12, dtype=dtype, device=device)
        + solver.rho * torch.kron(torch.eye(4, dtype=dtype, device=device),
                                  F.transpose(-1, -2) @ F)
    )
    flat = lambda t, *extra: torch.broadcast_to(
        t, lead + extra).reshape((-1,) + extra).contiguous()
    return stagewise.solve_srb(
        flat(R, 3, 3), flat(r_feet, 4, 3), flat(x_comp), flat(f_for_qp, 6),
        flat(x_k, 13), flat(x_ref, h, 13), Qdiag, R_eff, F,
        flat(l, h, 20), flat(u, h, 20),
        flat(state.warm_x, 12 * h).reshape(-1, h, 12),
        flat(state.warm_z, 20 * h).reshape(-1, h, 20),
        flat(state.warm_y, 20 * h).reshape(-1, h, 20),
        iters=solver.iterations, rho=float(solver.rho),
        over_relax=float(solver.over_relax),
        ns_it=stagewise.ns_combine_iters(h),
        dt=float(mpc.dt_mpc), mass=float(mpc.mass),
        i_inv_diag=tuple(1.0 / float(v) for v in mpc.inertia_body),
    )


def swing_update(
    state: ControllerState,
    obs: Observation,
    cmd: Command,
    gait: gait_ops.GaitParams,
    model: RobotModel,
    swing_cfg: SwingConfig,
    mpc: MPCConfig,
    loop: LoopConfig,
    swing_height,
) -> tuple[ControllerState, ControlOutput]:
    """Per-control-tick swing/stance bookkeeping + foot targets
    (ConvexMPCLocomotion.cpp:277-460).  Increments the iteration counter."""
    dtype, device = obs.p.dtype, obs.p.device
    R = quat_to_rotmat(obs.quat)
    v_des_robot, v_des_world = _v_des(state, R)

    ph = gait_ops.phase(gait, state.iteration, loop.iterations_between_mpc)
    contact = gait_ops.contact_state(gait, ph)
    swing_st = gait_ops.swing_state(gait, ph)
    swing_times = gait_ops.swing_time(gait, loop.dt_mpc)
    stance_times = gait_ops.stance_time(gait, loop.dt_mpc)

    # swing timers (:287-296)
    str_new = torch.where(
        state.first_swing, swing_times, state.swing_time_remaining - loop.dt)

    as_t = lambda a: const(a, dtype, device)
    pf_target = swing.raibert_foothold(
        p_body=obs.p,
        v_world=obs.v,
        v_des_world=v_des_world,
        v_des_robot=v_des_robot,
        R_body=R.transpose(-1, -2),          # rBody = world->body = R^T
        hip_location=as_t(model.hip_locations()).expand(obs.p_feet.shape),
        side_sign=as_t(model.side_signs()),
        abad_link_length=model.leg.abad_link_length,
        yaw_turn_rate=cmd.yaw_rate[..., None],
        stance_time=stance_times,
        swing_time_remaining=str_new,
        body_height_z=obs.p[..., 2],
        interleave_y=as_t(swing_cfg.interleave_y),
        interleave_gain=swing_cfg.interleave_gain,
        bonus_swing=swing_cfg.bonus_swing,
        p_rel_max=swing_cfg.p_rel_max,
        dt_mpc=loop.dt_mpc,
    )

    in_swing = swing_st > 0
    start_swing = in_swing & state.first_swing      # lock p0 (:376-381)
    p0_new = torch.where(start_swing[..., None], obs.p_feet, state.swing_p0)
    pf_new = torch.where(in_swing[..., None], pf_target, state.swing_pf)

    ev = swing.evaluate(p0_new, pf_new, swing_height, swing_st, swing_times)
    # stance: hold position, zero velocity (:413-421)
    p_des = torch.where(in_swing[..., None], ev.p, obs.p_feet)
    v_des = torch.where(in_swing[..., None], ev.v, torch.zeros_like(ev.v))
    a_des = torch.where(in_swing[..., None], ev.a, torch.zeros_like(ev.a))
    first_swing_new = ~in_swing

    # integrate desired world position (:237-240)
    standing = (gait.durations >= gait.n_segments[..., None]).all(dim=-1)
    wpd = state.world_position_desired + torch.where(
        standing[..., None], torch.zeros_like(v_des_world), loop.dt * v_des_world)

    # roll/pitch integral compensation (:217-230)
    rpy = quat_to_rpy(obs.quat)
    vr = obs.v
    one = torch.ones_like(vr[..., 0])
    zero = torch.zeros_like(vr[..., 0])
    d_pitch = torch.where(
        torch.abs(vr[..., 0]) > 0.2,
        loop.dt * (0.0 - rpy[..., 1]) / torch.where(vr[..., 0] == 0, one, vr[..., 0]),
        zero)
    d_roll = torch.where(
        torch.abs(vr[..., 1]) > 0.1,
        loop.dt * (0.0 - rpy[..., 0]) / torch.where(vr[..., 1] == 0, one, vr[..., 1]),
        zero)
    rpy_int = torch.stack(
        [state.rpy_int[..., 0] + d_roll, state.rpy_int[..., 1] + d_pitch], dim=-1)
    rpy_int = torch.clamp(rpy_int, -0.25, 0.25)
    rpy_comp = torch.stack(
        [vr[..., 1] * rpy_int[..., 0], vr[..., 0] * rpy_int[..., 1]], dim=-1)

    state = state._replace(
        iteration=state.iteration + 1,
        world_position_desired=wpd,
        rpy_int=rpy_int,
        rpy_comp=rpy_comp,
        first_swing=first_swing_new,
        swing_time_remaining=str_new,
        swing_p0=p0_new,
        swing_pf=pf_new,
    )
    out = ControlOutput(
        f_ff=state.f_ff, fr_des=state.fr_des, p_foot_des=p_des,
        v_foot_des=v_des, a_foot_des=a_des, contact_state=contact,
        swing_state=swing_st,
    )
    return state, out
