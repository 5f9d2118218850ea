"""Whole-body control tier: KinWBC + WBIC, batched and shape-static
(counterpart of ``quad_periodic_mpc_tpu/control/wbc.py``).

WBC_Ctrl / LocomotionCtrl (src/controllers/WBC_Ctrl/), KinWBC
(KinWBC.cpp) and WBIC (WBIC.cpp):

1. model: mass matrix, gravity, Coriolis, contact Jacobians
   (WBC_Ctrl::_UpdateModel, WBC_Ctrl.cpp:171-205);
2. tasks: body orientation, body position, one foot task per SWING leg;
   one point contact per STANCE leg (LocomotionCtrl.cpp:40-92);
3. KinWBC: contact-null-space task-priority IK -> des_jpos, des_jvel;
4. WBIC: dynamically consistent acceleration cascade and a relaxation QP
   in [delta qddot_float(6); delta F(12)]; tau = (A qddot + b - Jc^T F)[6:].

All 4 contacts and all 4 foot tasks always exist; stance/swing is carried
by masks (zeroed Jacobian rows, zeroed force bounds), which is exactly
equivalent.  The 6 equality rows of the QP are eliminated analytically and
the 12-variable cone QP goes to the batched PDIP.  ``run(backend="pallas")``
launches the fused CUDA kernel (``ops/cuda/wbc_kernel.py``) on a CUDA
device, its plain version on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from quad_periodic_mpc_tpu_torch.config import PDIPConfig
from quad_periodic_mpc_tpu_torch.estimation.orientation import quat_product
from quad_periodic_mpc_tpu_torch.models import floating_base as fb
from quad_periodic_mpc_tpu_torch.ops import constraints as con
from quad_periodic_mpc_tpu_torch.ops import linalg, qp_pdip
from quad_periodic_mpc_tpu_torch.ops.qp_admm import QPData
from quad_periodic_mpc_tpu_torch.ops.rotations import quat_to_rotmat, rpy_to_quat
from quad_periodic_mpc_tpu_torch.utils.consts import const
from quad_periodic_mpc_tpu_torch.utils.telemetry import spanned

N_DOF = 18


@dataclasses.dataclass(frozen=True)
class WBCGains:
    """Defaults from ros_dynamic_params.cfg:61-91 and the WBC_Ctrl ctor."""

    kp_ori: tuple = (100.0, 100.0, 100.0)
    kd_ori: tuple = (10.0, 10.0, 10.0)
    kp_body: tuple = (100.0, 100.0, 100.0)
    kd_body: tuple = (10.0, 10.0, 10.0)
    kp_foot: tuple = (500.0, 500.0, 500.0)
    kd_foot: tuple = (10.0, 10.0, 10.0)
    kp_joint: tuple = (3.0, 3.0, 3.0)
    kd_joint: tuple = (1.0, 0.2, 0.2)
    w_floating: float = 0.1        # WBC_Ctrl.cpp:20
    w_rf: float = 1.0              # WBC_Ctrl.cpp:22
    mu: float = 0.4                # SingleContact.cpp:15
    max_fz: float = 1500.0         # SingleContact.cpp:7
    pinv_damping: float = 1e-4     # ~ KinWBC threshold_ 0.001 (SVD cutoff)
    # the reference's knee barrier (WBC_Ctrl.cpp:153-163); see the
    # reference definition for why it is off by default
    knee_barrier: bool = False


class WBCInput(NamedTuple):
    """LocomotionCtrlData (LocomotionCtrl.hpp)."""

    p_body_des: torch.Tensor       # (..., 3)
    v_body_des: torch.Tensor       # (..., 3)
    a_body_des: torch.Tensor       # (..., 3)
    rpy_des: torch.Tensor          # (..., 3)
    omega_des: torch.Tensor        # (..., 3)
    p_foot_des: torch.Tensor       # (..., 4, 3)
    v_foot_des: torch.Tensor       # (..., 4, 3)
    a_foot_des: torch.Tensor       # (..., 4, 3)
    fr_des: torch.Tensor           # (..., 4, 3) MPC reaction forces
    contact_state: torch.Tensor    # (..., 4) > 0 = stance


class WBCOutput(NamedTuple):
    tau_ff: torch.Tensor           # (..., 4, 3)
    q_des: torch.Tensor            # (..., 4, 3)
    qd_des: torch.Tensor           # (..., 4, 3)
    kp_joint: torch.Tensor         # (3,)
    kd_joint: torch.Tensor         # (3,)
    fr: torch.Tensor               # (..., 4, 3) solved reaction forces


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _damped_pinv(J: torch.Tensor, damping: float) -> torch.Tensor:
    """J^+ = J^T (J J^T + lam I)^{-1}, the damped stand-in for the
    SVD-threshold pseudoInverse (KinWBC.cpp:97-101); zero rows drop out.

    The Gram matrices of both pseudo-inverses are inverted by
    ``linalg.spd_inverse_sym``, the form of the fused kernel (``wbc.cu``'s
    ``SpdInv``, the reference kernel's ``_spd_inv_rec``).  The reference's
    ``wbc.py`` calls its ``spd_inverse``, whose closed forms read both
    triangles: with a joint task after RyRz the damped Gram reaches cond
    ~1e6, and that form's float64 torques then move by up to 54 % under a
    1e-14 relative change of q (512 perturbed stances), its float32 ones lie
    up to 2.4x their size from float64 and go NaN on one stance.  The
    symmetric form moves by 8.5e-9 there and its float32 torques lie within
    0.13 of float64 (``tests/test_torch_wbc_tasks.py``); on well-posed task
    lists the two forms agree to rounding."""
    JT = J.transpose(-1, -2)
    return JT @ linalg.spd_inverse_sym(J @ JT + damping * _eye(J.shape[-2], J))


def _weighted_pinv(J: torch.Tensor, Ainv: torch.Tensor, damping: float) -> torch.Tensor:
    """Dynamically consistent inverse Jbar = Ainv J^T (J Ainv J^T)^{-1}
    (WBC::_WeightedInverse)."""
    AiJt = Ainv @ J.transpose(-1, -2)
    return AiJt @ linalg.spd_inverse_sym(J @ AiJt + damping * _eye(J.shape[-2], J))


def cone_block(mu: float, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """The 6x3 WBIC friction block Uf (SingleContact.cpp:17-29): rows
    [fz; fx+mu fz; -fx+mu fz; fy+mu fz; -fy+mu fz; -fz]."""
    return const(
        [[0.0, 0.0, 1.0], [1.0, 0.0, mu], [-1.0, 0.0, mu], [0.0, 1.0, mu],
         [0.0, -1.0, mu], [0.0, 0.0, -1.0]], dtype, device)


def _gen_vel(state: fb.FBState) -> torch.Tensor:
    return torch.cat([state.v_body, state.qd], dim=-1)


def _build_tasks(state: fb.FBState, contact: fb.ContactInfo, inp: WBCInput,
                 gains: WBCGains, dtype=torch.float32):
    """Task Jacobians (6 x (..., 3, 18)), kin errors, desired velocities,
    acceleration commands and Jdot qdot terms.  Order [body ori, body pos,
    foot0..3] (LocomotionCtrl.cpp:52-92); foot tasks are masked (zeroed)
    for stance legs."""
    batch = state.pos.shape[:-1]
    device = state.pos.device
    gain = lambda g: const(g, dtype, device)
    R = quat_to_rotmat(state.quat)               # body -> world

    # body orientation task (BodyOriTask.cpp)
    q_inv = state.quat * const([1.0, -1.0, -1.0, -1.0], dtype, device)
    ori_err_q = quat_product(rpy_to_quat(inp.rpy_des), q_inv)
    ori_err_q = torch.where(ori_err_q[..., 0:1] < 0, -ori_err_q, ori_err_q)
    vec = ori_err_q[..., 1:4]
    vn = torch.sqrt((vec * vec).sum(-1, keepdim=True))
    angle = 2.0 * torch.atan2(vn, ori_err_q[..., 0:1])
    so3 = torch.where(vn > 1e-9, vec / torch.clamp(vn, min=1e-12) * angle, 2.0 * vec)
    vel_err_ori = _mv(R, inp.omega_des - state.v_body[..., 0:3])
    cmd_ori = gain(gains.kp_ori) * so3 + gain(gains.kd_ori) * vel_err_ori
    J_ori = torch.zeros(batch + (3, N_DOF), dtype=dtype, device=device)
    J_ori[..., :, 0:3] = R

    # body position task (BodyPosTask.cpp)
    v_world = _mv(R, state.v_body[..., 3:6])
    pos_err = inp.p_body_des - state.pos
    cmd_pos = (gain(gains.kp_body) * pos_err
               + gain(gains.kd_body) * (inp.v_body_des - v_world) + inp.a_body_des)
    J_pos = torch.zeros(batch + (3, N_DOF), dtype=dtype, device=device)
    J_pos[..., :, 3:6] = R

    # foot tasks (LinkPosTask.cpp), masked for stance legs
    swing = (inp.contact_state <= 0.0).to(dtype)
    v_feet = (contact.Jc @ _gen_vel(state)[..., None, :, None])[..., 0]
    foot_err = (inp.p_foot_des - contact.p_foot) * swing[..., None]
    cmd_foot = (gain(gains.kp_foot) * (inp.p_foot_des - contact.p_foot)
                + gain(gains.kd_foot) * (inp.v_foot_des - v_feet)
                + inp.a_foot_des) * swing[..., None]
    J_feet = contact.Jc * swing[..., None, None]
    Jdqd_feet = contact.Jcdqd * swing[..., None]
    v_foot = inp.v_foot_des * swing[..., None]

    jacobians = [J_ori, J_pos] + [J_feet[..., k, :, :] for k in range(4)]
    errors = [so3, pos_err] + [foot_err[..., k, :] for k in range(4)]
    vels = [inp.omega_des, inp.v_body_des] + [v_foot[..., k, :] for k in range(4)]
    cmds = [cmd_ori, cmd_pos] + [cmd_foot[..., k, :] for k in range(4)]
    jdqd = [torch.zeros_like(so3), torch.zeros_like(pos_err)] + [
        Jdqd_feet[..., k, :] for k in range(4)]
    return jacobians, errors, vels, cmds, jdqd


def kin_wbc(state: fb.FBState, Jc_masked: torch.Tensor, jacobians, errors,
            vels, gains: WBCGains) -> tuple[torch.Tensor, torch.Tensor]:
    """KinWBC::FindConfiguration (KinWBC.cpp:16-90).  Returns (des_jpos
    (..., 12), des_jvel (..., 12)).  Only ``state.q`` is read."""
    batch = state.q.shape[:-1]
    eye = _eye(N_DOF, state.q)
    Jc_flat = Jc_masked.reshape(batch + (-1, N_DOF))
    Nc = eye - _damped_pinv(Jc_flat, gains.pinv_damping) @ Jc_flat

    JtPre = jacobians[0] @ Nc
    pinv = _damped_pinv(JtPre, gains.pinv_damping)
    delta_q = _mv(pinv, errors[0])
    qdot = _mv(pinv, vels[0])
    N_pre = Nc @ (eye - pinv @ JtPre)
    for i in range(1, len(jacobians)):
        Jt = jacobians[i]
        JtPre = Jt @ N_pre
        pinv = _damped_pinv(JtPre, gains.pinv_damping)
        delta_q = delta_q + _mv(pinv, errors[i] - _mv(Jt, delta_q))
        qdot = qdot + _mv(pinv, vels[i] - _mv(Jt, qdot))
        N_pre = N_pre @ (eye - pinv @ JtPre)
    return state.q + delta_q[..., 6:], qdot[..., 6:]


def wbic(state: fb.FBState, A, Ainv, cori, grav, Jc_masked, Jcdqd_masked,
         jacobians, cmds, jdqd, fr_des_masked, contact_mask, gains: WBCGains,
         pdip: PDIPConfig = PDIPConfig(iterations=20, kkt="spd")):
    """WBIC::MakeTorque (WBIC.cpp:17-135).  Returns (tau (..., 12),
    Fr (..., 12), qddot (..., 18)).  Only ``state.q`` is read."""
    dtype, device = state.q.dtype, state.q.device
    batch = state.q.shape[:-1]
    eye = _eye(N_DOF, state.q)
    Jc = Jc_masked.reshape(batch + (-1, N_DOF))
    Jcdqd = Jcdqd_masked.reshape(batch + (-1,))
    JcBar = _weighted_pinv(Jc, Ainv, gains.pinv_damping)
    qddot = _mv(JcBar, -Jcdqd)
    Npre = eye - JcBar @ Jc
    for i in range(len(jacobians)):
        Jt = jacobians[i]
        JtPre = Jt @ Npre
        JtBar = _weighted_pinv(JtPre, Ainv, gains.pinv_damping)
        qddot = qddot + _mv(JtBar, cmds[i] - jdqd[i] - _mv(Jt, qddot))
        Npre = Npre @ (eye - JtBar @ JtPre)

    # relaxation QP on dF (12 vars, 24 cone rows) after eliminating
    # z_f = A_ff^{-1} (resid + Jc_f^T dF) = z0 + M dF
    fr_des = fr_des_masked.reshape(batch + (12,))
    b_vec = cori + grav
    JcT = Jc.transpose(-1, -2)
    resid = -(_mv(A, qddot) + b_vec - _mv(JcT, fr_des))[..., 0:6]
    A_ff_inv = linalg.spd_inverse(A[..., 0:6, 0:6])
    z0 = _mv(A_ff_inv, resid)
    Mmat = A_ff_inv @ JcT[..., 0:6, :]                      # (..., 6, 12)
    MT = Mmat.transpose(-1, -2)
    P = 2.0 * (gains.w_floating * MT @ Mmat + gains.w_rf * _eye(12, A))
    q_lin = 2.0 * gains.w_floating * _mv(MT, z0)

    # cone inequality on F = fr_des + dF: Uf F >= ieq; swing feet get
    # fz_max = 0, which pins F = 0
    Uf = cone_block(gains.mu, dtype, device)
    ieq = torch.zeros(batch + (4, 6), dtype=dtype, device=device)
    ieq[..., 5] = -gains.max_fz * contact_mask
    l = ieq.reshape(batch + (24,)) - con.apply(Uf, fr_des)
    qp = QPData(P=P, q=q_lin, F=Uf, l=l, u=torch.full_like(l, 1e4))
    dF, _ = qp_pdip.solve(qp, pdip)

    fr = fr_des + dF
    z_f = z0 + _mv(Mmat, dF)
    qddot_final = torch.cat([qddot[..., 0:6] + z_f, qddot[..., 6:]], dim=-1)
    tau_full = _mv(A, qddot_final) + b_vec - _mv(JcT, fr)
    return tau_full[..., 6:], fr, qddot_final


@spanned("wbc.run")
def run(
    state: fb.FBState,
    inp: WBCInput,
    mc: fb.ModelConstants,
    gains: WBCGains = WBCGains(),
    pdip: PDIPConfig = PDIPConfig(iterations=20, kkt="spd"),
    model=None,
    backend: str = "xla",
) -> WBCOutput:
    """Full WBC step (WBC_Ctrl::run, WBC_Ctrl.cpp:71-116).

    model: optional precomputed (A, Ainv, grav, cori, contact) for the same
    state (the full-stack tick computes these once); None computes them.
    backend: "xla" runs the batched composition above; "pallas" the fused
    kernel (ops/cuda/wbc_kernel.py: the CUDA kernel on a CUDA device, which
    takes float32 only and raises otherwise; its plain version on the
    CPU)."""
    dtype = state.pos.dtype
    if model is None:
        A = fb.mass_matrix(state, mc)
        grav = fb.generalized_gravity(state, mc)
        cori = fb.generalized_coriolis(state, mc)
        Ainv = linalg.spd_inverse(A)
        contact = fb.contact_jacobians(state, mc)
    else:
        A, Ainv, grav, cori, contact = model

    contact_mask = (inp.contact_state > 0.0).to(dtype)
    fr_des_masked = inp.fr_des * contact_mask[..., None]
    jacobians, errors, vels, cmds, jdqd = _build_tasks(state, contact, inp, gains, dtype)

    if backend == "pallas":
        from quad_periodic_mpc_tpu_torch.ops.cuda import wbc_kernel

        lead = state.pos.shape[:-1]
        B = state.pos.reshape(-1, 3).shape[0]
        flat = lambda t, *s: t.reshape((B,) + s).contiguous()
        stack6 = lambda parts: torch.cat([p.reshape(B, 3) for p in parts], dim=-1)
        des_jpos, des_jvel, tau, fr = wbc_kernel.fused_wbc(
            flat(A, N_DOF, N_DOF), flat(Ainv, N_DOF, N_DOF),
            flat(cori + grav, N_DOF), flat(contact.Jc, 12, N_DOF),
            flat(contact.Jcdqd, 12), flat(contact_mask, 4),
            flat(quat_to_rotmat(state.quat), 3, 3),
            stack6(errors), stack6(vels), stack6(cmds), stack6(jdqd),
            flat(fr_des_masked, 12), flat(state.q, 12), gains=gains, pdip=pdip)
        des_jpos, des_jvel, tau, fr = (
            t.reshape(lead + (12,)) for t in (des_jpos, des_jvel, tau, fr))
    else:
        Jc_masked = contact.Jc * contact_mask[..., None, None]
        Jcdqd_masked = contact.Jcdqd * contact_mask[..., None]
        des_jpos, des_jvel = kin_wbc(state, Jc_masked, jacobians, errors, vels, gains)
        tau, fr, _ = wbic(state, A, Ainv, cori, grav, Jc_masked, Jcdqd_masked,
                          jacobians, cmds, jdqd, fr_des_masked, contact_mask,
                          gains, pdip)

    q_des = des_jpos.reshape(des_jpos.shape[:-1] + (4, 3))
    qd_des = des_jvel.reshape(des_jvel.shape[:-1] + (4, 3))
    tau_ff = tau.reshape(tau.shape[:-1] + (4, 3))
    if gains.knee_barrier:
        # knee barrier (WBC_Ctrl::_UpdateLegCMD, WBC_Ctrl.cpp:153-163)
        knee = state.q.reshape(state.q.shape[:-1] + (4, 3))[..., 2]
        q_des = torch.cat([q_des[..., :2], torch.clamp(q_des[..., 2:], min=0.3)], -1)
        tau_knee = torch.where(knee < 0.3, 1.0 / (knee * knee + 0.02), tau_ff[..., 2])
        tau_ff = torch.cat([tau_ff[..., :2], tau_knee[..., None]], -1)
    device = state.pos.device
    return WBCOutput(
        tau_ff=tau_ff, q_des=q_des, qd_des=qd_des,
        kp_joint=const(gains.kp_joint, dtype, device),
        kd_joint=const(gains.kd_joint, dtype, device),
        fr=fr.reshape(fr.shape[:-1] + (4, 3)),
    )
