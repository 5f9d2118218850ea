"""TaskSet / ContactSet variants beyond the locomotion path (counterpart of
``quad_periodic_mpc_tpu/control/wbc_tasks.py``).

The locomotion WBC (control/wbc.py) builds BodyOri + BodyPos + 4x LinkPos
tasks and 4 SingleContacts.  The reference additionally ships
(src/controllers/WBC_Ctrl/TaskSet/, ContactSet/):

- JPosTask         joint-space posture task (JPosTask.cpp:7-46):
                   Jt = [0 | I12], op_cmd = Kp e + Kd (qd_des - qd) + a;
- BodyRyRzTask     pitch/yaw-only orientation (BodyRyRzTask.cpp:12-59);
- LocalPosTask     link position relative to another frame
                   (LocalPosTask.cpp:26-77): Jt = Jc[link] - Jc[frame];
- FixedBodyContact 6-DoF body-pinned contact (FixedBodyContact.cpp:5-11):
                   Jc = [I6 | 0], no friction rows (Uf = 0, ieq = 0);
- BodyPostureTask  6-DoF pose task (BodyPostureTask.cpp:11-95);
- LocalRollTask    scalar roll complement of RyRz (LocalRollTask.cpp).

Each task constructor returns the (J, err, vel_des, cmd, jdqd) tuple that
``wbc.kin_wbc`` / ``wbc.wbic`` consume, so the variants compose with the
locomotion tasks as extra task lists.  All batched.
"""

from __future__ import annotations

import torch

from quad_periodic_mpc_tpu_torch.estimation.orientation import quat_product
from quad_periodic_mpc_tpu_torch.models import floating_base as fb
from quad_periodic_mpc_tpu_torch.ops.rotations import quat_to_rotmat, quat_to_rpy, rpy_to_quat

N_DOF = 18


def _zeros_like_batch(state: fb.FBState, *shape):
    return torch.zeros(state.pos.shape[:-1] + shape, dtype=state.pos.dtype,
                       device=state.pos.device)


def _selector(state: fb.FBState, rows, cols) -> torch.Tensor:
    """(..., len(rows), 18) zeros with ones at (rows[i], cols[i])."""
    J = _zeros_like_batch(state, len(rows), N_DOF)
    J[..., list(range(len(rows))), list(cols)] = 1.0
    return J


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def jpos_task(state: fb.FBState, q_des: torch.Tensor, qd_des: torch.Tensor | None = None,
              qdd_des: torch.Tensor | None = None, kp: float = 50.0, kd: float = 5.0):
    """Joint posture task (JPosTask.cpp:7-46; default gains :15-16)."""
    if qd_des is None:
        qd_des = torch.zeros_like(q_des)
    if qdd_des is None:
        qdd_des = torch.zeros_like(q_des)
    J = _selector(state, range(12), range(6, N_DOF))
    err = q_des - state.q
    cmd = kp * err + kd * (qd_des - state.qd) + qdd_des
    return J, err, qd_des, cmd, _zeros_like_batch(state, 12)


def _so3_of(ori_err_q: torch.Tensor) -> torch.Tensor:
    """so3 of an error quaternion, w-positive branch."""
    ori_err_q = torch.where(ori_err_q[..., 0:1] < 0, -ori_err_q, ori_err_q)
    vec = ori_err_q[..., 1:4]
    vn = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(vn, ori_err_q[..., 0:1])
    return torch.where(vn > 1e-9, vec / torch.clamp(vn, min=1e-12) * angle, 2.0 * vec)


def _quat_inv(state: fb.FBState) -> torch.Tensor:
    return state.quat * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=state.pos.dtype,
                                     device=state.pos.device)


def _ori_so3_error(state: fb.FBState, quat_des: torch.Tensor) -> torch.Tensor:
    """Implicit so3 orientation error (BodyRyRzTask.cpp:27-48 /
    BodyOriTask): so3(quat(q^-1 * q_des)), w-positive branch."""
    return _so3_of(quat_product(_quat_inv(state), quat_des))


def body_ryrz_task(state: fb.FBState, quat_des: torch.Tensor,
                   vel_des: torch.Tensor | None = None, acc_des: torch.Tensor | None = None,
                   kp: float = 50.0, kd: float = 3.0):
    """Pitch/yaw-only body orientation task (BodyRyRzTask.cpp:12-75): roll
    is left free.  Jt selects body-frame omega_y, omega_z directly
    (Jt_.block(0,1,2,2).setIdentity(), :14-15)."""
    if vel_des is None:
        vel_des = _zeros_like_batch(state, 2)
    if acc_des is None:
        acc_des = _zeros_like_batch(state, 2)
    so3 = _ori_so3_error(state, quat_des)
    omega_body = state.v_body[..., 0:3]
    err = so3[..., 1:3]                           # Kp_kin = 1 (:52)
    cmd = kp * err + kd * (vel_des - omega_body[..., 1:3]) + acc_des
    return _selector(state, range(2), (1, 2)), err, vel_des, cmd, _zeros_like_batch(state, 2)


def body_ryrz_task_rpy(state: fb.FBState, rpy_des: torch.Tensor, **kw):
    return body_ryrz_task(state, rpy_to_quat(rpy_des), **kw)


def local_pos_task(state: fb.FBState, contact: fb.ContactInfo, link_idx: int, frame_idx: int,
                   pos_des_rel: torch.Tensor, vel_des: torch.Tensor | None = None,
                   acc_des: torch.Tensor | None = None, kp: float = 120.0, kd: float = 5.0):
    """Relative link-position task (LocalPosTask.cpp:26-77): tracks
    p[link] - p[frame] with Jt = Jc[link] - Jc[frame], so the task is
    invariant to rigid translation of the pair (foot-relative targets)."""
    if vel_des is None:
        vel_des = torch.zeros_like(pos_des_rel)
    if acc_des is None:
        acc_des = torch.zeros_like(pos_des_rel)
    gen_vel = torch.cat([state.v_body, state.qd], dim=-1)
    J = contact.Jc[..., link_idx, :, :] - contact.Jc[..., frame_idx, :, :]
    p_rel = contact.p_foot[..., link_idx, :] - contact.p_foot[..., frame_idx, :]
    v_rel = _mv(J, gen_vel)
    err = pos_des_rel - p_rel
    cmd = kp * err + kd * (vel_des - v_rel) + acc_des
    jdqd = contact.Jcdqd[..., link_idx, :] - contact.Jcdqd[..., frame_idx, :]
    return J, err, vel_des, cmd, jdqd


def fixed_body_contact(batch: tuple = (), dtype=torch.float32, device="cuda"):
    """Body-pinned 6-DoF contact (FixedBodyContact.cpp:5-11): Jc = [I6|0]
    on the floating-base coordinates, zero JcDotQdot, and no friction
    inequality (Uf = 0 row, ieq = 0).

    Returns (Jc (..., 6, 18), Jcdqd (..., 6), Uf (1, 6), ieq (1,))."""
    batch = tuple(batch)
    Jc = torch.zeros(batch + (6, N_DOF), dtype=dtype, device=device)
    Jc[..., :, 0:6] = torch.eye(6, dtype=dtype, device=device)
    Jcdqd = torch.zeros(batch + (6,), dtype=dtype, device=device)
    Uf = torch.zeros((1, 6), dtype=dtype, device=device)
    ieq = torch.zeros((1,), dtype=dtype, device=device)
    return Jc, Jcdqd, Uf, ieq


def body_posture_task(state: fb.FBState, quat_des: torch.Tensor, pos_des: torch.Tensor,
                      vel_des: torch.Tensor | None = None, acc_des: torch.Tensor | None = None,
                      kp: float = 50.0, kd: float = 1.0):
    """6-DoF body posture task (BodyPostureTask.cpp:11-95): orientation so3
    error + world position error, linear velocity compared in the world
    frame, Jt = blkdiag(R, R) (body->world) on the floating-base columns
    (:91-92, Rot.transpose() of the reference's world->body matrix)."""
    if vel_des is None:
        vel_des = _zeros_like_batch(state, 6)
    if acc_des is None:
        acc_des = _zeros_like_batch(state, 6)
    R = quat_to_rotmat(state.quat)                # body -> world
    # the reference's error is quat_cmd * q^-1 (opposite order to RyRz)
    so3 = _so3_of(quat_product(quat_des, _quat_inv(state)))
    v_lin = _mv(R, state.v_body[..., 3:6])
    curr_vel = torch.cat([state.v_body[..., 0:3], v_lin], dim=-1)
    err = torch.cat([so3, pos_des - state.pos], dim=-1)
    cmd = kp * err + kd * (vel_des - curr_vel) + acc_des
    J = _zeros_like_batch(state, 6, N_DOF)
    J[..., 0:3, 0:3] = R
    J[..., 3:6, 3:6] = R
    return J, err, vel_des, cmd, _zeros_like_batch(state, 6)


def local_roll_task(state: fb.FBState, roll_des: torch.Tensor,
                    vel_des: torch.Tensor | None = None, acc_des: torch.Tensor | None = None,
                    kp: float = 350.0, kd: float = 13.0):
    """Roll-only task (LocalRollTask.cpp:14-45): scalar rpy[0] error on the
    body-frame omega_x row (Jt(0,0) = 1), the complement of BodyRyRzTask."""
    if vel_des is None:
        vel_des = _zeros_like_batch(state, 1)
    if acc_des is None:
        acc_des = _zeros_like_batch(state, 1)
    rpy = quat_to_rpy(state.quat)
    err = (roll_des - rpy[..., 0])[..., None]     # Kp_kin = 1 (:18)
    cmd = kp * err + kd * (vel_des - state.v_body[..., 0:1]) + acc_des
    return _selector(state, (0,), (0,)), err, vel_des, cmd, _zeros_like_batch(state, 1)
