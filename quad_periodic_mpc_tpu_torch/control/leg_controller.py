"""Leg-frame control abstraction: the LegController and torque calculator
(counterpart of ``quad_periodic_mpc_tpu/control/leg_controller.py``),
batched over 4 legs x instances.

Data path (updateData, LegController.cpp:95-116): (q, qd) -> p = FK(q),
v = J(q) qd per leg, in the leg frame.  Command path (updateCommand,
LegController.cpp:123-215): f = forceFeedForward + Kp (pDes - p)
+ Kd (vDes - v), tau_ff = tauFeedForward + J^T f.  Torque calculator
(be2r_cmpc_unitree.cpp:657-719): tau = Kp_joint (qDes - q)
+ Kd_joint (qdDes - qd) + tau_ff, clamped to 17/17/26 Nm (3 Nm in safe
mode), hip/knee signs flipped for the Unitree motors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quad_periodic_mpc_tpu_torch.models import leg_kinematics as lk
from quad_periodic_mpc_tpu_torch.models.a1 import RobotModel


class LegData(NamedTuple):
    """Per-leg measured state (LegControllerData)."""

    q: torch.Tensor    # (..., 4, 3)
    qd: torch.Tensor   # (..., 4, 3)
    p: torch.Tensor    # (..., 4, 3) foot position, leg frame
    v: torch.Tensor    # (..., 4, 3) foot velocity, leg frame
    J: torch.Tensor    # (..., 4, 3, 3)


class LegCommand(NamedTuple):
    """Per-leg command (LegControllerCommand); gains are diagonal (3,)."""

    tau_ff: torch.Tensor
    force_ff: torch.Tensor
    q_des: torch.Tensor
    qd_des: torch.Tensor
    p_des: torch.Tensor
    v_des: torch.Tensor
    kp_cartesian: torch.Tensor
    kd_cartesian: torch.Tensor
    kp_joint: torch.Tensor
    kd_joint: torch.Tensor

    @staticmethod
    def zeros(batch: tuple = (), dtype=torch.float32, device="cuda") -> "LegCommand":
        return LegCommand(*(torch.zeros(batch + (4, 3), dtype=dtype, device=device)
                            for _ in range(10)))


def _geom(model: RobotModel) -> lk.LegGeometry:
    return lk.LegGeometry(l1=model.leg.abad_link_length,
                          l2=model.leg.hip_link_length,
                          l3=model.leg.knee_link_length)


def update_data(q: torch.Tensor, qd: torch.Tensor, model: RobotModel) -> LegData:
    """(q, qd) (..., 4, 3) -> LegData with FK and Jacobian evaluated."""
    geom = _geom(model)
    side = torch.as_tensor(model.side_signs(), dtype=q.dtype, device=q.device)
    J = lk.leg_jacobian(q, geom, side)
    return LegData(q=q, qd=qd, p=lk.foot_position(q, geom, side),
                   v=(J @ qd[..., None])[..., 0], J=J)


def cartesian_impedance(cmd: LegCommand, data: LegData) -> torch.Tensor:
    """Cartesian PD + feedforward force -> feedforward joint torque
    (LegController.cpp:123-156; the integral term is zero in the
    reference configs)."""
    f = (cmd.force_ff + cmd.kp_cartesian * (cmd.p_des - data.p)
         + cmd.kd_cartesian * (cmd.v_des - data.v))
    return cmd.tau_ff + (data.J.transpose(-1, -2) @ f[..., None])[..., 0]


def torque_output(cmd: LegCommand, data: LegData, model: RobotModel,
                  safe_mode=False, low_level: bool = False,
                  flip_signs: bool = True) -> torch.Tensor:
    """Final motor torques (..., 4, 3) with clamping and the Unitree sign
    convention (_torqueCalculator, be2r_cmpc_unitree.cpp:657-719)."""
    tau_ff = cartesian_impedance(cmd, data)
    if low_level:
        tau = tau_ff
    else:
        tau = (cmd.kp_joint * (cmd.q_des - data.q)
               + cmd.kd_joint * (cmd.qd_des - data.qd) + tau_ff)
    limits = torch.as_tensor(model.tau_max, dtype=tau.dtype, device=tau.device)
    safe = torch.as_tensor(safe_mode, device=tau.device)
    lim = torch.where(safe[..., None, None], torch.full_like(limits, model.tau_safe),
                      limits)
    tau = torch.clamp(tau, -lim, lim)
    if flip_signs:
        # hip and knee axes are mirrored on the Unitree motors
        # (be2r_cmpc_unitree.cpp:717-718)
        tau = tau * torch.tensor([1.0, -1.0, -1.0], dtype=tau.dtype, device=tau.device)
    return tau



def stance_command_from_mpc(
    f_ff_world: torch.Tensor,
    R_body: torch.Tensor,
    kd_joint: torch.Tensor,
    batch: tuple = (),
) -> dict:
    """The stance-leg command fields the locomotion driver writes when the
    WBC is off (ConvexMPCLocomotion.cpp:428-437): feedforward force and
    joint damping.  ``R_body`` and ``batch`` are accepted as the reference's
    helper accepts them, and unused."""
    return dict(force_ff=f_ff_world, kd_joint=kd_joint)
