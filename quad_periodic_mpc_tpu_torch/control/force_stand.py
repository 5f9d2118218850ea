"""The torque-level force stand: the FSM's balance stand driven through the
LegController onto the articulated plant, batched.

The reference package runs this loop as its capstone test
(``tests/test_articulated_sim.py:57-125``, ``test_torque_level_force_stand``):
each 500 Hz tick the stand-balance QP (``control/balance.solve``, PDIP-25,
all four feet in contact) gives the foot forces, the stance LegController
command (f_ff = -rBody f, ConvexMPCLocomotion.cpp:840, plus the cartesian
PD holding the world footholds, :420) gives the joint torques, and the
plant takes ten 1e-4 s substeps.  Here the command also goes through the
safety checks with their clamps applied (ControlFSM's post-check,
``control/safety.run_checks``), and the FSM (``control/fsm.step``) is fed
the orientation and locomotion masks each tick.

The plant follows the full stack's convention: one model evaluation a
tick (``kinematics_kernel.fused_model_eval``) gives (A^-1, G, C) and the
contact kinematics, frozen over the tick's substeps
(``plant_kernel.fused_substeps``).  On a CUDA device these are the two
hand-written kernels, two launches a tick; on the CPU their plain versions
(``art.model_cache`` + ``art.step_fast``).  ``command`` is the tick without
the plant: a caller with another plant step (the reference capstone's
``art.step`` every substep) drives it with that.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quad_periodic_mpc_tpu_torch.config import PDIPConfig
from quad_periodic_mpc_tpu_torch.control import balance, fsm, safety
from quad_periodic_mpc_tpu_torch.control import leg_controller as lc
from quad_periodic_mpc_tpu_torch.models import floating_base as fb
from quad_periodic_mpc_tpu_torch.models.a1 import A1, RobotModel
from quad_periodic_mpc_tpu_torch.ops.cuda import kinematics_kernel, plant_kernel
from quad_periodic_mpc_tpu_torch.ops.rotations import quat_to_rotmat, quat_to_rpy
from quad_periodic_mpc_tpu_torch.sim import articulated_sim as art

KP_CARTESIAN, KD_CARTESIAN, KD_JOINT = 300.0, 8.0, 1.0   # the capstone's stance gains


class StandTarget(NamedTuple):
    com: torch.Tensor          # (..., 3) target CoM position, world
    footholds: torch.Tensor    # (..., 4, 3) world stance footholds to hold


class TickRecord(NamedTuple):
    """The tick's safety masks, (...,) bool each, and the joint torques it
    applied (..., 4, 3)."""

    safe_orientation: torch.Tensor
    locomotion_safe: torch.Tensor
    safe_p_des: torch.Tensor
    safe_force: torch.Tensor
    tau: torch.Tensor


def total_mass() -> float:
    """The A1's total mass, rotors included (the capstone's m_tot)."""
    p = fb.A1ModelParams()
    return p.body_mass + 4 * (p.abad_mass + p.hip_mass + p.knee_mass + 3 * p.rotor_mass)


def settings() -> balance.BalanceSettings:
    """The capstone's balance settings."""
    return balance.BalanceSettings(mass=total_mass(), max_force=260.0)


def target(plant: art.ArtState, mc: fb.ModelConstants, dz=None) -> StandTarget:
    """Hold the start's footholds with the CoM over the origin at the start
    height plus ``dz`` ((...,) or None)."""
    s = plant.fb
    z = s.pos[..., 2] if dz is None else s.pos[..., 2] + dz
    com = torch.stack([torch.zeros_like(z), torch.zeros_like(z), z], dim=-1)
    return StandTarget(com=com, footholds=fb.contact_jacobians(s, mc).p_foot)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def command(
    plant: art.ArtState,
    fsm_state: fsm.FSMState,
    requested_state: torch.Tensor,
    stand: StandTarget,
    info: fb.ContactInfo,
    cfg: balance.BalanceSettings | None = None,
    pdip: PDIPConfig = PDIPConfig(iterations=25),
    model: RobotModel = A1,
) -> tuple[fsm.FSMState, TickRecord]:
    """The tick's controller on the plant's contact kinematics ``info``: the
    balance QP's forces, the stance LegController command through the
    safety post-check, the FSM step; returns (fsm', record), the joint
    torques in ``record.tau``."""
    cfg = settings() if cfg is None else cfg
    s = plant.fb
    R = quat_to_rotmat(s.quat)
    RT = R.transpose(-1, -2)
    rpy = quat_to_rpy(s.quat)
    v_world = _mv(R, s.v_body[..., 3:6])
    omega_world = _mv(R, s.v_body[..., 0:3])
    zero3 = torch.zeros_like(v_world)
    eye = torch.eye(3, dtype=s.pos.dtype, device=s.pos.device).expand(R.shape)
    cmd = balance.BalanceCommand(p_des=stand.com, v_des=zero3, a_des=zero3, R_des=eye,
                                 omega_des=zero3)
    f = balance.solve(s.pos, v_world, R, omega_world, rpy[..., 2],
                      info.p_foot - s.pos[..., None, :],
                      torch.ones_like(info.p_foot[..., 0]), cmd, cfg, pdip)

    # the stance LegController command (use_wbc == false path): f_ff =
    # -rBody f plus the cartesian PD on the world footholds, recomputed in
    # the leg frame every tick (pDesLeg = rBody (pDesFootWorld - p) - hip)
    q = s.q.reshape(s.q.shape[:-1] + (4, 3))
    data = lc.update_data(q, s.qd.reshape(q.shape), model)
    hips = torch.as_tensor(model.hip_locations(), dtype=s.pos.dtype, device=s.pos.device)
    RT4 = RT[..., None, :, :]
    f_body = _mv(RT4, f)
    p_des_leg = _mv(RT4, stand.footholds - s.pos[..., None, :]) - hips
    v_des_leg = _mv(RT, -v_world)[..., None, :].expand(q.shape)
    checks = safety.run_checks(rpy, p_des_leg, -f_body, model)
    loco = safety.check_locomotion_safe(rpy, data.p, data.v)
    fsm_next = fsm.step(fsm_state, requested_state, checks.safe_orientation, loco)
    full = lambda v: torch.full_like(q, v)
    leg_cmd = lc.LegCommand.zeros(s.pos.shape[:-1], s.pos.dtype, s.pos.device)._replace(
        force_ff=checks.force_ff, p_des=checks.p_des, v_des=v_des_leg, q_des=data.q,
        qd_des=torch.zeros_like(q), kp_cartesian=full(KP_CARTESIAN),
        kd_cartesian=full(KD_CARTESIAN), kd_joint=full(KD_JOINT))
    tau = lc.torque_output(cmd=leg_cmd, data=data, model=model, flip_signs=False)
    record = TickRecord(safe_orientation=checks.safe_orientation, locomotion_safe=loco,
                        safe_p_des=checks.safe_p_des, safe_force=checks.safe_force, tau=tau)
    return fsm_next, record


def tick(
    plant: art.ArtState,
    fsm_state: fsm.FSMState,
    requested_state: torch.Tensor,
    stand: StandTarget,
    mc: fb.ModelConstants,
    cfg: balance.BalanceSettings | None = None,
    pdip: PDIPConfig = PDIPConfig(iterations=25),
    model: RobotModel = A1,
    substeps: int = 10,
    dt: float = 1e-4,
    contact: art.ContactParams = art.ContactParams(),
) -> tuple[art.ArtState, fsm.FSMState, TickRecord]:
    """One 500 Hz tick of the force stand; returns (plant', fsm', record)."""
    _, Ainv, G, C, info = kinematics_kernel.fused_model_eval(plant.fb, mc)
    fsm_next, record = command(plant, fsm_state, requested_state, stand, info, cfg, pdip, model)
    plant, _ = plant_kernel.fused_substeps(plant, record.tau, dt, contact, (Ainv, G, C), info.Jc,
                                           info.p_foot, substeps)
    return plant, fsm_next, record
