"""Closed-loop rollout: controller + SRB plant
(counterpart of ``quad_periodic_mpc_tpu/control/loop.py``).

The 500 Hz process loop against the analytic plant: an outer loop over
MPC periods and an inner loop over the iterations_between_mpc control
ticks (FSM_State_Locomotion.cpp:13).  The reference's ``lax.scan`` is a
Python loop here over ``period_step`` (its ``mpc_period``), which
``rollout_graphed`` replays from a CUDA graph instead.  Batched: a leading
batch axis rolls out many scenarios in lockstep.  Live-tunable parameters go to every MPC step and swing
update.  The terrain tier (the CMPCLocomotion_Cv / VisionMPC closed loop)
plugs in through ``heightmap`` (map-aware footholds and a map body-height
command) and ``ground_fn`` (the plant's true surface).
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
    TunableParams,
)
from quad_periodic_mpc_tpu_torch.control import cmpc_variant
from quad_periodic_mpc_tpu_torch.control import mpc as mpc_ctrl
from quad_periodic_mpc_tpu_torch.models.a1 import A1, RobotModel
from quad_periodic_mpc_tpu_torch.ops import gait as gait_ops
from quad_periodic_mpc_tpu_torch.ops.rotations import quat_to_rpy
from quad_periodic_mpc_tpu_torch.runtime import graphs
from quad_periodic_mpc_tpu_torch.sim import srb_sim
from quad_periodic_mpc_tpu_torch.terrain import heightmap as hmap
from quad_periodic_mpc_tpu_torch.utils.telemetry import span, spanned


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


class TerrainLoopConfig(NamedTuple):
    """Terrain-in-the-loop settings (the CMPCLocomotion_Cv / VisionMPC
    tier): map-aware foothold selection + map body-height command.

    max_step_height cites MAX_STEP_HEIGHT = 0.17 (CMPC_Locomotion_cv.h:24);
    search radius 0.10 m cites _idxMapChecking (CMPC_Locomotion_cv.cpp:921).
    body_height_from_map raises the commanded body height by the mean map
    elevation under the feet (the map branch of _body_height_heuristics,
    CMPC_Locomotion_cv.cpp:885-891)."""

    search_radius_m: float = 0.10
    traversability_min: float = 0.8
    max_step_height: float = 0.17
    body_height_from_map: bool = True


def terrain_command(heightmap, cmd, obs, terrain_cfg: TerrainLoopConfig = TerrainLoopConfig()):
    """The command with the map's body-height offset: the mean map elevation
    under the four feet added to cmd.body_height (unchanged without a map or
    with body_height_from_map off)."""
    if heightmap is None or not terrain_cfg.body_height_from_map:
        return cmd
    with span("terrain.command"):
        # per-foot lookup: the map center against the foot axis
        hm_feet = heightmap._replace(center=heightmap.center[..., None, :])
        idx = hmap.world_to_index(hm_feet, obs.p_feet[..., 0:2])
        z_ground = hmap.sample(heightmap.elevation, idx).mean(dim=-1)
        return cmd._replace(body_height=cmd.body_height + z_ground)


class RolloutTrace(NamedTuple):
    """Per-MPC-step telemetry (LogData analog)."""

    x: torch.Tensor            # (..., steps, 13) plant state
    forces: torch.Tensor       # (..., steps, 4, 3) first-step MPC forces
    f_est: torch.Tensor        # (..., steps, 6)
    est_freq: torch.Tensor     # (..., steps)
    est_amp: torch.Tensor      # (..., steps)


def period_step(
    cmd: mpc_ctrl.Command,
    gait: gait_ops.GaitParams,
    dist,
    mpc_cfg: MPCConfig,
    loop_cfg: LoopConfig,
    est_cfg: EstimatorConfig,
    solver: ADMMConfig,
    model: RobotModel = A1,
    swing_cfg: SwingConfig = SwingConfig(),
    tick_balance: TickBalanceGains | None = None,
    heightmap: hmap.HeightMap | None = None,
    ground_fn=None,
    terrain_cfg: TerrainLoopConfig = TerrainLoopConfig(),
    tunable: TunableParams | None = None,
):
    """One MPC period with everything but the carry closed over (the
    counterpart of the reference's ``mpc_period``): ``step(carry) ->
    (carry', trace)``, one MPC tick and iterations_between_mpc - 1 plain
    ticks, with trace the period's ``RolloutTrace`` (no step axis).  The
    arguments are ``rollout``'s; ``rollout`` iterates it and
    ``rollout_graphed`` replays it from a CUDA graph."""
    if heightmap is not None:
        @spanned("terrain.foothold")
        def foothold_adjust(pf_target, state, obs):
            p0 = torch.where(state.first_swing[..., None], obs.p_feet, state.swing_p0)
            return cmpc_variant.foothold_update(
                heightmap, pf_target, p0,
                search_radius_m=terrain_cfg.search_radius_m,
                traversability_min=terrain_cfg.traversability_min,
                max_step_height=terrain_cfg.max_step_height)
    else:
        foothold_adjust = None

    @spanned("loop.control_tick")
    def control_tick(carry: RolloutCarry, do_mpc: bool) -> RolloutCarry:
        plant, ctrl = carry
        obs = srb_sim.observe(plant)
        cmd_t = terrain_command(heightmap, cmd, obs, terrain_cfg)
        ctrl = mpc_ctrl.setup_command(ctrl, cmd_t, loop_cfg)
        if do_mpc:
            ctrl, _ = mpc_ctrl.mpc_step(
                ctrl, obs, cmd_t, gait, plant.t, mpc_cfg, loop_cfg, est_cfg, solver,
                tunable=tunable)
        ctrl, out = mpc_ctrl.swing_update(
            ctrl, obs, cmd_t, gait, model, swing_cfg, mpc_cfg, loop_cfg,
            loop_cfg.swing_height, tunable=tunable, foothold_adjust=foothold_adjust)
        stance = (out.swing_state <= 0).to(plant.x.dtype)
        forces = out.fr_des
        if tick_balance is not None:
            forces = _tick_balance_correction(
                tick_balance, obs, ctrl, cmd_t, stance, forces, mpc_cfg)
        plant = srb_sim.step(
            plant, forces, out.p_foot_des, stance, dist, mpc_cfg, loop_cfg.dt,
            ground_fn=ground_fn)
        return RolloutCarry(plant, ctrl)

    def step(carry: RolloutCarry) -> tuple[RolloutCarry, RolloutTrace]:
        carry = control_tick(carry, do_mpc=True)
        for _ in range(loop_cfg.iterations_between_mpc - 1):
            carry = control_tick(carry, do_mpc=False)
        return carry, RolloutTrace(
            x=carry.plant.x, forces=carry.ctrl.fr_des, f_est=carry.ctrl.est.f_est,
            est_freq=carry.ctrl.est.est_freq, est_amp=carry.ctrl.est.est_amp)

    return step


def _periods(step, carry: RolloutCarry, n: int, keep=lambda trace: trace):
    """``step`` iterated n times from carry: (carry, the periods' traces,
    each through ``keep``, with the steps after the batch axes, as the
    reference's moveaxis of the scan)."""
    traces = []
    for _ in range(n):
        carry, trace = step(carry)
        traces.append(keep(trace))
    return carry, RolloutTrace(*(
        torch.stack([getattr(tr, f) for tr in traces], dim=carry.plant.t.ndim)
        for f in RolloutTrace._fields))


def rollout(
    n_mpc_steps: int,
    plant: srb_sim.PlantState,
    ctrl: mpc_ctrl.ControllerState,
    cmd: mpc_ctrl.Command,
    gait: gait_ops.GaitParams,
    dist,
    mpc_cfg: MPCConfig,
    loop_cfg: LoopConfig,
    est_cfg: EstimatorConfig,
    solver: ADMMConfig,
    model: RobotModel = A1,
    swing_cfg: SwingConfig = SwingConfig(),
    tick_balance: TickBalanceGains | None = None,
    heightmap: hmap.HeightMap | None = None,
    ground_fn=None,
    terrain_cfg: TerrainLoopConfig = TerrainLoopConfig(),
    tunable: TunableParams | None = None,
) -> tuple[RolloutCarry, RolloutTrace]:
    """Run n_mpc_steps MPC periods (each = iterations_between_mpc ticks),
    on the device of the given states.  dist: a ``DisturbanceParams`` or a
    ``WrenchDisturbance``; tunable: ``TunableParams`` for every MPC step and
    swing update (retune by writing into its tensors between calls).

    Terrain tier: ``heightmap`` switches on map-aware foothold selection
    (``cmpc_variant.foothold_update`` in every swing update) and, per
    terrain_cfg, the map's body-height command; ``ground_fn`` (xy -> z)
    gives the plant the true surface, so terrain-blind swing targets strike
    risers early.  A (B, H, W) heightmap runs B terrain scenarios in
    lockstep."""
    step = period_step(cmd, gait, dist, mpc_cfg, loop_cfg, est_cfg, solver, model,
                       swing_cfg, tick_balance, heightmap, ground_fn, terrain_cfg, tunable)
    return _periods(step, RolloutCarry(plant, ctrl), n_mpc_steps)


def rollout_graphed(n_mpc_steps: int, plant: srb_sim.PlantState,
                    ctrl: mpc_ctrl.ControllerState, *args,
                    **kw) -> tuple[RolloutCarry, RolloutTrace]:
    """``rollout`` with the period replayed from a CUDA graph
    (``runtime/graphs.capture``): the first ``graphs.WARMUP`` periods run
    eagerly, the next captures the period, and it and the rest replay it.
    The same arguments (``rollout``'s after ctrl), the same kernels and
    launches, the same result.  Each period's trace is copied on the card;
    nothing is read back.  ``tunable``'s tensors and the ``heightmap``'s are
    read at every replay.  On CPU tensors every period runs eagerly."""
    carry = RolloutCarry(plant, ctrl)
    graphed = graphs.capture(period_step(*args, **kw), carry, name="loop.period")
    return _periods(graphed, carry, n_mpc_steps,
                    keep=lambda trace: RolloutTrace(*(t.clone() for t in trace)))
