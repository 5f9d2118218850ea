"""Full-stack torque-level closed loop: MPC + WBC on the articulated plant,
as the program runs it with ``wbc_backend="pallas"`` and
``kin_backend="pallas"``, every kernel replaced by its plain version.

  per control tick (500 Hz):
    model evaluation (mass matrix, its inverse, gravity, Coriolis, contacts)
    cheater state estimate from the plant
    [every 13th tick] mpc_step          (38.5 Hz convex MPC)
    swing_update                         (foot targets, gait phases)
    wbc.run                              (KinWBC + WBIC)
    joint PD + tau_ff
    articulated_sim.step_fast x substeps (plant at 10 kHz)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from port_bench.reference import articulated_sim as art
from port_bench.reference import floating_base as fb
from port_bench.reference import gait as gait_ops
from port_bench.reference import linalg
from port_bench.reference import mpc as mpc_mod
from port_bench.reference import wbc as wbc_mod
from port_bench.reference.a1 import A1, RobotModel
from port_bench.reference.config import EstimatorConfig, LoopConfig, MPCConfig, PDIPConfig, SwingConfig
from port_bench.reference.rotations import quat_to_rotmat


class FullStackCarry(NamedTuple):
    plant: art.ArtState
    ctrl: mpc_mod.ControllerState


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _observation(s: fb.FBState, R, info: fb.ContactInfo) -> mpc_mod.Observation:
    return mpc_mod.Observation(p=s.pos, v=_mv(R, s.v_body[..., 3:6]), quat=s.quat,
                               omega=_mv(R, s.v_body[..., 0:3]), p_feet=info.p_foot)


def observe_plant(plant: art.ArtState, mc: fb.ModelConstants):
    """Cheater estimate from the articulated plant: (Observation, R, info)."""
    s = plant.fb
    info = fb.contact_jacobians(s, mc)
    R = quat_to_rotmat(s.quat)
    return _observation(s, R, info), R, info


def model_eval(state: fb.FBState, mc: fb.ModelConstants):
    """The fused model evaluation's plain version: (A, Ainv, G, C, ContactInfo)."""
    A = fb.mass_matrix(state, mc)
    return (A, linalg.spd_inverse(A), fb.generalized_gravity(state, mc),
            fb.generalized_coriolis(state, mc), fb.contact_jacobians(state, mc))


def controller_tick(
    plant: art.ArtState,
    ctrl: mpc_mod.ControllerState,
    cmd: mpc_mod.Command,
    gait: gait_ops.GaitParams,
    mc: fb.ModelConstants,
    do_mpc: bool,
    mpc_cfg: MPCConfig = MPCConfig(horizon=10),
    loop_cfg: LoopConfig = LoopConfig(),
    est_cfg: EstimatorConfig = EstimatorConfig(),
    solver=None,
    wbc_gains: wbc_mod.WBCGains = wbc_mod.WBCGains(),
    wbc_pdip: PDIPConfig = PDIPConfig(iterations=15),
    model: RobotModel = A1,
    swing_cfg: SwingConfig = SwingConfig(),
):
    """The controller side of one 500 Hz tick: estimate -> (MPC every 13th
    tick) -> swing targets -> WBC -> joint torques.  Returns (ctrl', tau
    (..., 4, 3), model_terms) with model_terms = (A, Ainv, grav, cori, info)."""
    A_t, Ainv_t, G_t, C_t, info = model_eval(plant.fb, mc)
    R = quat_to_rotmat(plant.fb.quat)
    obs = _observation(plant.fb, R, info)

    ctrl = mpc_mod.setup_command(ctrl, cmd, loop_cfg)
    if do_mpc:
        ctrl, _ = mpc_mod.mpc_step(ctrl, obs, cmd, gait, plant.t, mpc_cfg,
                                   loop_cfg, est_cfg, solver)
    ctrl, out = mpc_mod.swing_update(ctrl, obs, cmd, gait, model, swing_cfg,
                                     mpc_cfg, loop_cfg, loop_cfg.swing_height)
    q = plant.fb.q.reshape(plant.fb.q.shape[:-1] + (4, 3))
    qd = plant.fb.qd.reshape(q.shape)
    # WBC input (LocomotionCtrl handoff, ConvexMPCLocomotion.cpp:465-501)
    zero = torch.zeros_like(cmd.yaw_rate)
    v_des_robot = torch.stack(
        [ctrl.x_vel_des, ctrl.y_vel_des, torch.zeros_like(ctrl.x_vel_des)], dim=-1)
    v_des_world = _mv(R, v_des_robot)
    wpd = ctrl.world_position_desired
    winp = wbc_mod.WBCInput(
        p_body_des=torch.cat([wpd[..., 0:2], cmd.body_height[..., None]], dim=-1),
        v_body_des=v_des_world,
        a_body_des=torch.zeros_like(v_des_world),
        rpy_des=torch.stack([zero, zero, ctrl.yaw_des], dim=-1),
        omega_des=torch.stack([zero, zero, cmd.yaw_rate], dim=-1),
        p_foot_des=out.p_foot_des, v_foot_des=out.v_foot_des,
        a_foot_des=out.a_foot_des, fr_des=out.fr_des,
        contact_state=out.contact_state,
    )
    wout = wbc_mod.run(plant.fb, winp, mc, gains=wbc_gains, pdip=wbc_pdip,
                       model=(A_t, Ainv_t, G_t, C_t, info))
    tau = (wout.tau_ff + wout.kp_joint * (wout.q_des - q)
           + wout.kd_joint * (wout.qd_des - qd))
    return ctrl, tau, (A_t, Ainv_t, G_t, C_t, info)


def substeps_plain(state: art.ArtState, tau_joints, dt: float, params: art.ContactParams,
                   cache, Jc, p_foot, substeps: int):
    """The fused plant kernel's plain version: returns (state', p_foot')."""
    s, pf = state, p_foot
    for _ in range(substeps):
        s, pf, _ = art.step_fast(s, tau_joints, dt, params, cache, Jc, pf)
    return s._replace(t=state.t + dt * substeps), pf


def tick_step(
    cmd: mpc_mod.Command,
    gait: gait_ops.GaitParams,
    mc: fb.ModelConstants,
    do_mpc: bool,
    loop_cfg: LoopConfig = LoopConfig(),
    contact: art.ContactParams = art.ContactParams(),
    substeps: int = 10,
    **kw,
):
    """One 500 Hz tick (``controller_tick``, then the plant's substeps on the
    tick's model terms): ``step(carry) -> (carry',)``.  The further keyword
    arguments are ``controller_tick``'s."""
    sub_dt = loop_cfg.dt / substeps

    def step(carry: FullStackCarry) -> tuple[FullStackCarry]:
        plant, ctrl = carry
        ctrl, tau, (_, Ainv_t, G_t, C_t, info) = controller_tick(
            plant, ctrl, cmd, gait, mc, do_mpc, loop_cfg=loop_cfg, **kw)
        plant, _ = substeps_plain(plant, tau, sub_dt, contact, (Ainv_t, G_t, C_t),
                                  info.Jc, info.p_foot, substeps)
        return (FullStackCarry(plant, ctrl),)

    return step
