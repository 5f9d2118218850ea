"""Convex-MPC locomotion driver (counterpart of
``quad_periodic_mpc_tpu/control/mpc.py``, the ConvexMPCLocomotion rebuild).

    (ControllerState, Observation, Command) -> (ControllerState, Output)

- ``mpc_step`` runs once per MPC period (every 13 control ticks):
  reference trajectory, disturbance residual + periodic estimator (with its
  per-step prediction over the horizon when ``EstimatorConfig.predictive``),
  and the QP solve; then f_ff = -R^T f (ConvexMPCLocomotion.cpp:832-845).
  With ``ADMMConfig(formulation="stagewise")`` the solve takes the
  fused-build kernel (``fused_stagewise_solve_srb``, the dynamics assembled
  in the kernel) where the reference does: ``backend="pallas"``, float32,
  h <= 64, a time-invariant disturbance term and no tunable parameters.
  Otherwise
  ``problem.build_stagewise`` builds the problem and ``qp_stagewise.solve``
  solves it, in the caller-built kernels (``fused_stagewise_solve``, or
  ``fused_stagewise_solve_stream`` for 64 < h <= 128) or on its scan path
  (float64, ``backend="xla"``).  With the default
  ``formulation="condensed"``, ``problem.build_qp`` condenses the horizon
  and ``qp_admm.solve`` runs the ADMM iterations (``backend="pallas"``: in
  the fused kernel ``fused_admm_iterations``), the Newton-Schulz K^{-1}
  carried from period to period in ``warm_kinv``.  A ``PDIPConfig`` solves
  the same condensed QP by ``qp_pdip.solve``.
- ``swing_update`` runs every control tick: swing bookkeeping and foot
  targets (ConvexMPCLocomotion.cpp:277-460); on a card one launch of
  ``csrc/swing_update.cu`` (``swing_update_kernel``), on the CPU its plain
  version ``swing_update_plain``.

A leading batch axis runs many MPC instances in one call.  Both take
live-tunable parameters (``config.TunableParams``, tensors read only on the
device); ``swing_update`` takes the terrain tier's foothold hook.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quad_periodic_mpc_tpu_torch.config import (
    ADMMConfig,
    EstimatorConfig,
    LoopConfig,
    MPCConfig,
    PDIPConfig,
    SwingConfig,
    TunableParams,
)
from quad_periodic_mpc_tpu_torch.models import srb
from quad_periodic_mpc_tpu_torch.models.a1 import RobotModel
from quad_periodic_mpc_tpu_torch.ops import condense, constraints, problem, swing
from quad_periodic_mpc_tpu_torch.ops import estimator as est_ops
from quad_periodic_mpc_tpu_torch.ops import gait as gait_ops
from quad_periodic_mpc_tpu_torch.ops import qp_admm, qp_pdip, qp_stagewise
from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel
from quad_periodic_mpc_tpu_torch.ops.cuda import swing_update_kernel as swing_kernel
from quad_periodic_mpc_tpu_torch.ops.rotations import (
    quat_to_rotmat,
    quat_to_rpy,
    rpy_to_rotmat,
)
from quad_periodic_mpc_tpu_torch.utils.consts import const
from quad_periodic_mpc_tpu_torch.utils.telemetry import span, spanned


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


@spanned("mpc.mpc_step")
def mpc_step(
    state: ControllerState,
    obs: Observation,
    cmd: Command,
    gait: gait_ops.GaitParams,
    sim_time: torch.Tensor,
    mpc: MPCConfig,
    loop: LoopConfig,
    est_cfg: EstimatorConfig,
    solver: ADMMConfig | PDIPConfig,
    ground_truth_z: torch.Tensor | None = None,
    tunable: TunableParams | None = None,
    return_qp: bool = False,
):
    """One MPC solve (solveDenseMPC, ConvexMPCLocomotion.cpp:612-870).

    Returns (state', forces (..., h, 4, 3)), plus the problem the solve
    answered when ``return_qp``: the condensed ``QPData``, or with the
    stagewise formulation the StagewiseProblem ``qp_stagewise.solve`` was
    given or, on the fused-build branch, the same problem built
    independently of the kernel by ``problem.build_stagewise`` (for the KKT
    audit).  ``ground_truth_z`` (...,) replaces the observed CoM height
    (:628).  ``tunable`` overrides the weights, alpha, mu, f_max, x-drag
    gain and the estimator's EMAs; a tunable period takes
    ``problem.build_stagewise`` -> ``qp_stagewise.solve`` on the stagewise
    formulation, never the fused-build kernel.  The solve runs on the
    device of ``obs``: a CUDA kernel for CUDA tensors, its plain version
    for CPU tensors.
    """
    dtype = obs.p.dtype
    h = mpc.horizon

    R = quat_to_rotmat(obs.quat)
    rpy = quat_to_rpy(obs.quat)
    _, v_des_world = _v_des(state, R)
    with span("mpc.reference_trajectory"):
        x_ref, state = build_reference_trajectory(
            state, obs, cmd, v_des_world, rpy, mpc, loop)

    # r = pFoot - p, with z from ground truth when available (:628)
    p_used = obs.p
    if ground_truth_z is not None:
        p_used = torch.cat([p_used[..., :2], ground_truth_z[..., None].to(dtype)], dim=-1)
    r_feet = obs.p_feet - p_used[..., None, :]

    # x-drag integral (:813-818)
    pz_err = p_used[..., 2] - cmd.body_height
    vx = obs.v[..., 0]
    x_drag_gain = mpc.x_drag_gain if tunable is None else tunable.x_drag_gain
    x_comp = state.x_comp_integral + torch.where(
        torch.abs(vx) > 0.3,
        x_drag_gain * pz_err * mpc.dt_mpc
        / torch.where(vx == 0, torch.ones_like(vx), vx),
        torch.zeros_like(vx),
    )

    # ---- disturbance residual + periodic estimator ----
    with span("estimator.update"):
        x_k = srb.pack_state(rpy, p_used, obs.omega, obs.v, mpc.gravity)
        if est_cfg.residual == "discrete":
            f_ext = est_ops.residual_discrete(
                x_k, state.prev_x, state.fr_des, state.prev_R, state.prev_r_feet,
                mpc.mass, mpc.inertia_body, state.prev_x_drag, mpc.dt_mpc)
        else:
            f_ext = est_ops.residual_f_ext(
                x_k, state.prev_x, state.f_ff, state.prev_R, state.prev_r_feet,
                mpc.mass, mpc.inertia_body, state.prev_x_drag)
        f_ext = torch.where(state.have_prev[..., None], f_ext, torch.zeros_like(f_ext))
        est_state, f_for_qp = est_ops.update(
            state.est, sim_time, f_ext, est_cfg,
            ema_smooth=None if tunable is None else tunable.ema_smooth,
            ema_static=None if tunable is None else tunable.ema_static)
        f_steps = None
        if est_cfg.predictive:
            f_steps = est_ops.predict_horizon(est_state, sim_time, mpc.dt_mpc, h, est_cfg)

    # ---- QP assembly + solve ----
    with span("mpc.qp_solve"):
        seg = gait_ops.segment_index(gait, state.iteration, loop.iterations_between_mpc)
        table = gait_ops.mpc_table(gait, seg, h)
        lead = obs.p.shape[:-1]
        qp_obs = problem.RobotObs(
            p=p_used, v=obs.v, quat=obs.quat, omega=obs.omega, r_feet=r_feet)
        if isinstance(solver, ADMMConfig) and solver.formulation == "stagewise":
            # Fused-build gate (reference mpc.py:347-351): the dynamics are
            # assembled inside the kernel, which needs a time-invariant
            # disturbance term and the config's shared costs, is f32-internal
            # and serves h <= 64.
            use_fused_build = (
                solver.backend == "pallas" and h <= 64 and f_steps is None
                and tunable is None and dtype == torch.float32)
            if use_fused_build:
                U, z, y = _fused_build_solve(
                    state, R, r_feet, x_comp, f_for_qp, x_k, x_ref, table, mpc, solver)
                qp_out = None
                if return_qp:
                    # materialize the same problem, so the KKT audit checks the
                    # production dispatch
                    qp_out, _ = problem.build_stagewise(
                        qp_obs, x_ref, table, mpc, f_est=f_for_qp, x_drag=x_comp)
            else:
                qp_out, _ = problem.build_stagewise(
                    qp_obs, x_ref, table, mpc, f_est=f_for_qp, x_drag=x_comp,
                    f_est_steps=f_steps, tunable=tunable)
                warm = (state.warm_x.reshape(lead + (h, 12)),
                        state.warm_z.reshape(lead + (h, 20)),
                        state.warm_y.reshape(lead + (h, 20)))
                U, info = qp_stagewise.solve(qp_out, solver, warm=warm)
                z, y = info["z"], info["y"]
            state = state._replace(
                warm_x=U.reshape(lead + (h * 12,)),
                warm_z=z.reshape(lead + (h * 20,)),
                warm_y=y.reshape(lead + (h * 20,)),
            )
        else:
            qp_out, _, _ = problem.build_qp(
                qp_obs, x_ref, table, mpc, f_est=f_for_qp, x_drag=x_comp,
                f_est_steps=f_steps, tunable=tunable)
            if isinstance(solver, ADMMConfig):
                warm = qp_admm.ADMMState(
                    x=state.warm_x, z=state.warm_z, y=state.warm_y, kinv=state.warm_kinv)
                U, warm_out = qp_admm.solve(qp_out, solver, warm=warm)
                state = state._replace(
                    warm_x=warm_out.x, warm_z=warm_out.z, warm_y=warm_out.y,
                    warm_kinv=warm_out.kinv)
            else:
                U, _ = qp_pdip.solve(qp_out, solver)

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
    if return_qp:
        return state, forces, qp_out
    return state, forces


def _fused_build_solve(state, R, r_feet, x_comp, f_for_qp, x_k, x_ref, table, mpc, solver):
    """The fused-build branch of ``mpc_step``: bounds, weights and the flat
    warm start for ``fused_stagewise_solve_srb``.  Returns (U, z, y), each
    (B, h, .) over the flattened batch."""
    h = mpc.horizon
    dtype, device = x_k.dtype, x_k.device
    lead = x_k.shape[:-1]
    l, u = constraints.bounds(table, mpc.f_max, mpc.big_number, dtype)
    batch = l.shape[:-3]
    l = l.reshape(batch + (h, 20))
    u = torch.clamp(u, max=1e4).reshape(batch + (h, 20))
    F = constraints.pyramid_block(mpc.mu, dtype, device)
    Qdiag = 2.0 * condense.full_weight(
        const(mpc.weights, dtype, device))
    R_eff = (
        2.0 * mpc.alpha * torch.eye(12, dtype=dtype, device=device)
        + solver.rho * torch.kron(torch.eye(4, dtype=dtype, device=device),
                                  F.transpose(-1, -2) @ F)
    )
    flat = lambda t, *extra: torch.broadcast_to(
        t, lead + extra).reshape((-1,) + extra).contiguous()
    return stagewise_kernel.fused_stagewise_solve_srb(
        flat(R, 3, 3), flat(r_feet, 4, 3), flat(x_comp), flat(f_for_qp, 6),
        flat(x_k, 13), flat(x_ref, h, 13), Qdiag, R_eff, F,
        flat(l, h, 20), flat(u, h, 20),
        flat(state.warm_x, 12 * h).reshape(-1, h, 12),
        flat(state.warm_z, 20 * h).reshape(-1, h, 20),
        flat(state.warm_y, 20 * h).reshape(-1, h, 20),
        iters=solver.iterations, rho=float(solver.rho),
        over_relax=float(solver.over_relax),
        ns_it=qp_stagewise.ns_combine_iters(h),
        dt=float(mpc.dt_mpc), mass=float(mpc.mass),
        i_inv_diag=tuple(1.0 / float(v) for v in mpc.inertia_body),
    )


@spanned("mpc.swing_update")
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
    tunable: TunableParams | None = None,
    foothold_adjust=None,
) -> tuple[ControllerState, ControlOutput]:
    """Per-control-tick swing/stance bookkeeping + foot targets
    (ConvexMPCLocomotion.cpp:277-460).  Increments the iteration counter.
    ``tunable`` overrides swing_height, bonus_swing and p_rel_max.

    foothold_adjust: optional hook ``(pf_target, state, obs) -> pf`` run on
    the Raibert targets before they become swing goals; the terrain tier
    plugs the elevation-map foothold update in here (the call site of
    _updateFoothold in the _cv driver's swing-leg loop,
    CMPC_Locomotion_cv.cpp:1022).

    On a card ``swing_update_kernel``, on the CPU ``swing_update_plain``."""
    update = swing_update_kernel if obs.p.device.type == "cuda" else swing_update_plain
    return update(state, obs, cmd, gait, model, swing_cfg, mpc, loop, swing_height,
                  tunable, foothold_adjust)


def swing_update_kernel(state, obs, cmd, gait, model, swing_cfg, mpc, loop, swing_height,
                        tunable=None, foothold_adjust=None):
    """``swing_update_plain``'s update as one launch of a CUDA kernel
    (``ops/cuda/swing_update_kernel``); with a foothold hook, one launch
    for the Raibert targets, the hook, and one launch for the rest, which
    reads the state from before the update as the hook does.  ``mpc`` is
    not read: it keeps the plain version's signature, so either version
    takes the other's place."""
    params = (model, swing_cfg, loop, swing_height, tunable)
    pf_target = None
    if foothold_adjust is not None:
        pf_target = swing_kernel.launch(state, obs, cmd, gait, *params,
                                        targets_only=True)["pf_target"]
        pf_target = foothold_adjust(pf_target, state, obs)
    o = swing_kernel.launch(state, obs, cmd, gait, *params, pf_target=pf_target)
    state = state._replace(**{f: o[f] for f in (
        "iteration", "world_position_desired", "rpy_int", "rpy_comp", "first_swing",
        "swing_time_remaining", "swing_p0", "swing_pf")})
    out = ControlOutput(
        f_ff=state.f_ff, fr_des=state.fr_des, p_foot_des=o["p_foot_des"],
        v_foot_des=o["v_foot_des"], a_foot_des=o["a_foot_des"],
        contact_state=o["contact_state"], swing_state=o["swing_state"])
    return state, out


def swing_update_plain(state, obs, cmd, gait, model, swing_cfg, mpc, loop, swing_height,
                       tunable=None, foothold_adjust=None):
    """``swing_update`` in PyTorch operations, the plain version of
    ``swing_update_kernel``."""
    if tunable is not None:
        swing_height = tunable.swing_height
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
        bonus_swing=swing_cfg.bonus_swing if tunable is None else tunable.bonus_swing,
        p_rel_max=swing_cfg.p_rel_max if tunable is None else tunable.p_rel_max,
        dt_mpc=loop.dt_mpc,
    )
    if foothold_adjust is not None:
        pf_target = foothold_adjust(pf_target, state, obs)

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
