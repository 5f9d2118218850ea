"""Full-stack torque-level closed loop: MPC + WBC + LegController on the
articulated plant (counterpart of ``quad_periodic_mpc_tpu/control/
full_stack.py``).

The reference control pipeline (Body_Manager::run -> ControlFSM ->
FSM_State_Locomotion -> ConvexMPCLocomotion + WBC_Ctrl -> LegController ->
plant) against the 18-DoF articulated simulator:

  per control tick (500 Hz):
    cheater state estimate from the plant
    [every 13th tick] mpc_step          (38.5 Hz convex MPC)
    swing_update                         (foot targets, gait phases)
    wbc.run                              (KinWBC + WBIC)
    joint PD + tau_ff
    articulated_sim.step_fast x substeps (plant at 10 kHz)

Batched; the reference's ``lax.scan`` loops are Python loops here over
``period_step`` and ``tick_step``, which ``rollout_articulated_graphed``
and ``capture_ticks`` replay from CUDA graphs instead.
``kin_backend`` / ``wbc_backend`` = "pallas" run the fused kernels
(``ops/cuda/kinematics_kernel``, ``wbc_kernel``, ``plant_kernel``: CUDA on
a CUDA device, their plain versions on the CPU); "xla" runs the plain
functions on any device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quad_periodic_mpc_tpu_torch.config import (
    EstimatorConfig, LoopConfig, MPCConfig, PDIPConfig, SwingConfig,
)
from quad_periodic_mpc_tpu_torch.control import leg_controller as lc
from quad_periodic_mpc_tpu_torch.control import mpc as mpc_mod
from quad_periodic_mpc_tpu_torch.control import wbc as wbc_mod
from quad_periodic_mpc_tpu_torch.models import floating_base as fb
from quad_periodic_mpc_tpu_torch.models.a1 import A1, RobotModel
from quad_periodic_mpc_tpu_torch.ops import gait as gait_ops
from quad_periodic_mpc_tpu_torch.ops import linalg
from quad_periodic_mpc_tpu_torch.ops.cuda import kinematics_kernel, plant_kernel
from quad_periodic_mpc_tpu_torch.ops.rotations import quat_to_rotmat
from quad_periodic_mpc_tpu_torch.runtime import graphs
from quad_periodic_mpc_tpu_torch.sim import articulated_sim as art
from quad_periodic_mpc_tpu_torch.utils.telemetry import span, spanned


class FullStackCarry(NamedTuple):
    plant: art.ArtState
    ctrl: mpc_mod.ControllerState


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _observation(s: fb.FBState, R, info: fb.ContactInfo) -> mpc_mod.Observation:
    return mpc_mod.Observation(p=s.pos, v=_mv(R, s.v_body[..., 3:6]), quat=s.quat,
                               omega=_mv(R, s.v_body[..., 0:3]), p_feet=info.p_foot)


def observe_plant(plant: art.ArtState, mc: fb.ModelConstants, kin_backend: str = "xla"):
    """Cheater estimate from the articulated plant: (Observation, R, info).
    kin_backend="pallas" computes the contact kinematics in the fused
    kernel."""
    s = plant.fb
    if kin_backend == "pallas":
        info = kinematics_kernel.fused_contact_kinematics(s, mc)
    else:
        info = fb.contact_jacobians(s, mc)
    R = quat_to_rotmat(s.quat)
    return _observation(s, R, info), R, info


@spanned("full_stack.controller_tick")
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
    solver=PDIPConfig(iterations=25),
    wbc_gains: wbc_mod.WBCGains = wbc_mod.WBCGains(),
    wbc_pdip: PDIPConfig = PDIPConfig(iterations=15),
    model: RobotModel = A1,
    swing_cfg: SwingConfig = SwingConfig(),
    use_wbc: bool = True,
    wbc_backend: str = "xla",
    kin_backend: str = "xla",
):
    """The controller side of one 500 Hz tick: estimate -> (MPC every 13th
    tick) -> swing targets -> WBC -> joint torques.  The MPC solve is the
    port's ``mpc_step`` with ``solver``: the default PDIP on the condensed
    QP, a condensed ``ADMMConfig``, or ``ADMMConfig(formulation="stagewise",
    backend="pallas")`` for the fused stagewise kernels.

    Returns (ctrl', tau (..., 4, 3), model_terms) with model_terms =
    (A, Ainv, grav, cori, info), the tick's one model evaluation, shared by
    the WBC, the plant's substep cache and the observation."""
    with span("kinematics.model_eval"):
        if kin_backend == "pallas":
            A_t, Ainv_t, G_t, C_t, info = kinematics_kernel.fused_model_eval(plant.fb, mc)
            R = quat_to_rotmat(plant.fb.quat)
            obs = _observation(plant.fb, R, info)
        else:
            obs, R, info = observe_plant(plant, mc)
            A_t = fb.mass_matrix(plant.fb, mc)
            Ainv_t = linalg.spd_inverse(A_t)
            G_t = fb.generalized_gravity(plant.fb, mc)
            C_t = fb.generalized_coriolis(plant.fb, mc)

    ctrl = mpc_mod.setup_command(ctrl, cmd, loop_cfg)
    if do_mpc:
        ctrl, _ = mpc_mod.mpc_step(ctrl, obs, cmd, gait, plant.t, mpc_cfg,
                                   loop_cfg, est_cfg, solver)
    ctrl, out = mpc_mod.swing_update(ctrl, obs, cmd, gait, model, swing_cfg,
                                     mpc_cfg, loop_cfg, loop_cfg.swing_height)
    q = plant.fb.q.reshape(plant.fb.q.shape[:-1] + (4, 3))
    qd = plant.fb.qd.reshape(q.shape)
    if use_wbc:
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
                           model=(A_t, Ainv_t, G_t, C_t, info), backend=wbc_backend)
        with span("full_stack.joint_pd"):
            tau = (wout.tau_ff + wout.kp_joint * (wout.q_des - q)
                   + wout.kd_joint * (wout.qd_des - qd))
    else:
        # MPC-only stance force path + swing cartesian PD
        data = lc.update_data(q, qd, model)
        hips = torch.as_tensor(model.hip_locations(), dtype=obs.p.dtype,
                               device=obs.p.device)
        RT = R.transpose(-1, -2)[..., None, :, :]
        p_des_leg = _mv(RT, out.p_foot_des - obs.p[..., None, :]) - hips
        v_des_leg = _mv(RT, out.v_foot_des - obs.v[..., None, :])
        f_body = _mv(RT, out.fr_des)
        stance = (out.swing_state <= 0)[..., None]
        leg_cmd = lc.LegCommand.zeros(obs.p.shape[:-1], obs.p.dtype, obs.p.device)._replace(
            force_ff=torch.where(stance, -f_body, torch.zeros_like(f_body)),
            p_des=p_des_leg, v_des=v_des_leg, q_des=data.q,
            qd_des=torch.zeros_like(data.qd),
            kp_cartesian=torch.where(stance, 120.0, 400.0) * torch.ones_like(p_des_leg),
            kd_cartesian=torch.full_like(p_des_leg, 10.0),
            kd_joint=torch.full_like(p_des_leg, 1.0),
        )
        tau = lc.torque_output(cmd=leg_cmd, data=data, model=model, flip_signs=False)
    return ctrl, tau, (A_t, Ainv_t, G_t, C_t, info)


def tick_step(
    cmd: mpc_mod.Command,
    gait: gait_ops.GaitParams,
    mc: fb.ModelConstants,
    do_mpc: bool,
    mpc_cfg: MPCConfig = MPCConfig(horizon=10),
    loop_cfg: LoopConfig = LoopConfig(),
    est_cfg: EstimatorConfig = EstimatorConfig(),
    solver=PDIPConfig(iterations=25),
    wbc_gains: wbc_mod.WBCGains = wbc_mod.WBCGains(),
    wbc_pdip: PDIPConfig = PDIPConfig(iterations=15),
    model: RobotModel = A1,
    swing_cfg: SwingConfig = SwingConfig(),
    contact: art.ContactParams = art.ContactParams(),
    substeps: int = 10,
    use_wbc: bool = True,
    wbc_backend: str = "xla",
    kin_backend: str = "xla",
):
    """One 500 Hz tick of the composed stack (``controller_tick``, then the
    plant's substeps on the tick's model terms) with everything but the
    carry closed over: ``step(carry) -> (carry',)``.  do_mpc: the MPC tick
    (every 13th) or a plain one."""
    sub_dt = loop_cfg.dt / substeps

    def step(carry: FullStackCarry) -> tuple[FullStackCarry]:
        plant, ctrl = carry
        ctrl, tau, (_, Ainv_t, G_t, C_t, info) = controller_tick(
            plant, ctrl, cmd, gait, mc, do_mpc, mpc_cfg=mpc_cfg,
            loop_cfg=loop_cfg, est_cfg=est_cfg, solver=solver,
            wbc_gains=wbc_gains, wbc_pdip=wbc_pdip, model=model,
            swing_cfg=swing_cfg, use_wbc=use_wbc, wbc_backend=wbc_backend,
            kin_backend=kin_backend)
        # the substeps reuse the tick's model terms and contact kinematics
        # (art.model_cache / step_fast contract)
        cache = (Ainv_t, G_t, C_t)
        with span("plant.substeps"):
            if kin_backend == "pallas":
                plant, _ = plant_kernel.fused_substeps(plant, tau, sub_dt, contact, cache,
                                                       info.Jc, info.p_foot, substeps)
            else:
                pf = info.p_foot
                for _ in range(substeps):
                    plant, pf, _ = art.step_fast(plant, tau, sub_dt, contact, cache,
                                                 info.Jc, pf)
        return (FullStackCarry(plant, ctrl),)

    return step


TRACE_FIELDS = ("pos", "quat", "v_body")


def period_step(cmd, gait, mc, loop_cfg: LoopConfig = LoopConfig(), **kw):
    """One MPC period of the composed stack (an MPC tick and
    iterations_between_mpc - 1 plain ticks): ``step(carry) -> (carry',
    trace)`` with trace {"pos", "quat", "v_body"} the plant at the period's
    end.  The keyword arguments are ``tick_step``'s."""
    mpc_tick = tick_step(cmd, gait, mc, True, loop_cfg=loop_cfg, **kw)
    plain_tick = tick_step(cmd, gait, mc, False, loop_cfg=loop_cfg, **kw)

    def step(carry: FullStackCarry) -> tuple[FullStackCarry, dict]:
        carry, = mpc_tick(carry)
        for _ in range(loop_cfg.iterations_between_mpc - 1):
            carry, = plain_tick(carry)
        return carry, {k: getattr(carry.plant.fb, k) for k in TRACE_FIELDS}

    return step


def _periods(step, carry: FullStackCarry, n: int, keep=lambda t: t):
    """``step`` iterated n times from carry: (carry, trace) with trace[k]
    the periods' ends, each through ``keep``, stacked on a leading axis."""
    trace = {k: [] for k in TRACE_FIELDS}
    for _ in range(n):
        carry, end = step(carry)
        for k in TRACE_FIELDS:
            trace[k].append(keep(end[k]))
    return carry, {k: torch.stack(v) for k, v in trace.items()}


def rollout_articulated(
    n_mpc_steps: int,
    plant: art.ArtState,
    ctrl: mpc_mod.ControllerState,
    cmd: mpc_mod.Command,
    gait: gait_ops.GaitParams,
    mc: fb.ModelConstants,
    **kw,
) -> tuple[FullStackCarry, dict]:
    """Run n_mpc_steps MPC periods of the full torque-level stack; the
    keyword arguments are ``tick_step``'s (mpc_cfg, loop_cfg, est_cfg,
    solver, wbc_gains, wbc_pdip, model, swing_cfg, contact, substeps = 10,
    use_wbc, wbc_backend, kin_backend).  Returns (carry, trace) with
    trace["pos"/"quat"/"v_body"] (n_mpc_steps, ..., k): the plant at the
    end of each period."""
    return _periods(period_step(cmd, gait, mc, **kw), FullStackCarry(plant, ctrl), n_mpc_steps)


def rollout_articulated_graphed(
    n_mpc_steps: int,
    plant: art.ArtState,
    ctrl: mpc_mod.ControllerState,
    cmd: mpc_mod.Command,
    gait: gait_ops.GaitParams,
    mc: fb.ModelConstants,
    **kw,
) -> tuple[FullStackCarry, dict]:
    """``rollout_articulated`` with the period replayed from a CUDA graph
    (``runtime/graphs.capture``; the first ``graphs.WARMUP`` periods run
    eagerly): the same arguments, kernels, launches and result, the trace
    copied on the card.  On CPU tensors every period runs eagerly."""
    carry = FullStackCarry(plant, ctrl)
    graphed = graphs.capture(period_step(cmd, gait, mc, **kw), carry, name="full_stack.period")
    return _periods(graphed, carry, n_mpc_steps, keep=torch.clone)


def capture_ticks(plant: art.ArtState, ctrl: mpc_mod.ControllerState, cmd, gait, mc, **kw):
    """The single robot's latency unit: the MPC tick and the plain tick
    (``tick_step``, keyword arguments as there) captured as two graphs over
    one set of state buffers in one memory pool, from (plant, ctrl).
    Returns (mpc_tick, plain_tick), each ``tick(carry) -> (carry',)``;
    a period is one MPC tick, then iterations_between_mpc - 1 plain ticks,
    each handing the next the carry it returned.  Each runs its first
    ``graphs.WARMUP`` calls eagerly and replays from then on.  On CPU
    tensors the two are the eager steps."""
    mpc_tick = graphs.capture(tick_step(cmd, gait, mc, True, **kw), FullStackCarry(plant, ctrl),
                              name="full_stack.mpc_tick")
    plain = tick_step(cmd, gait, mc, False, **kw)
    if isinstance(mpc_tick, graphs.Graphed):
        return mpc_tick, mpc_tick.also(plain, name="full_stack.plain_tick")
    return mpc_tick, plain
