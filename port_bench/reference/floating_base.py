"""Floating-base articulated dynamics of the A1 quadruped, batched
(frozen copy of the port's ``quad_periodic_mpc_tpu_torch/models/floating_base.py``).

FloatingBaseModel (src/common/Dynamics/FloatingBaseModel.cpp) with the tree
of Quadruped::buildModel (Quadruped.cpp:21-121) and the A1 parameters of
MiniCheetah.h:27-110, as plain functions over the fixed 13-body topology
(base + 4 x [abad, hip, knee]), unrolled in Python; every quantity carries
arbitrary leading batch dims.

Conventions (as the reference):
- generalized velocity qdot = [omega_body(3); v_body(3); qd(12)], 18 DoF;
- spatial motion vectors [omega; v] in link coordinates;
- joint rotations are coordinate rotations (orientation_tools.h:66-89);
- hip/knee joint frames carry the Rz(pi) flip (Quadruped.cpp:66-68);
- right legs (0, 2) use Y-mirrored inertias (Quadruped.cpp:50-55);
- rotors with gear ratio (= 1 on A1) as in forwardKinematics
  (FloatingBaseModel.cpp:509-538).

These functions, with ``ops/linalg.spd_inverse``, are the plain version of
the fused model evaluation and contact kinematics kernels
(``ops/cuda/kinematics_kernel.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from port_bench.reference import spatial as sp
from port_bench.reference.rotations import quat_to_rotmat

N_BODIES = 13     # index 0 = base, then 4 legs x (abad, hip, knee)
N_DOF = 18


@dataclasses.dataclass(frozen=True)
class A1ModelParams:
    """Host-side constant model description (MiniCheetah.h A1 branch)."""

    body_mass: float = 6.0
    body_com: tuple = (0.0, 0.0041, -0.0005)
    body_inertia: tuple = (15853e-6, 37799e-6, 45654e-6)  # diagonal
    abad_mass: float = 0.696
    abad_com: tuple = (-0.003311, 0.000635, 0.000031)     # LEFT side
    abad_inertia: tuple = (
        (469e-6, -9.4e-6, -0.34e-6),
        (-9.4e-6, 807e-6, -0.47e-6),
        (-0.34e-6, -0.47e-6, 553e-6),
    )
    hip_mass: float = 1.013
    hip_com: tuple = (-0.003237, -0.022327, -0.027326)
    hip_inertia: tuple = (
        (5529e-6, 4.825e-6, 343e-6),
        (4.825e-6, 5139e-6, 22e-6),
        (343e-6, 22e-6, 1367e-6),
    )
    knee_mass: float = 0.166
    knee_com: tuple = (0.006435, 0.0, -0.107388)
    # kneeRotationalInertiaRotated, rotated by RY(pi/2) (MiniCheetah.h:75-78)
    knee_inertia_rotated: tuple = (
        (2997e-6, 0.0, -141e-6),
        (0.0, 3014e-6, 0.0),
        (-141e-6, 0.0, 32e-6),
    )
    rotor_mass: float = 0.605
    rotor_inertia_z: tuple = (33e-6, 33e-6, 63e-6)
    abad_location: tuple = (0.1805, 0.047, 0.0)
    hip_location: tuple = (0.0, 0.0838, 0.0)
    knee_location: tuple = (0.0, 0.0, -0.2)
    knee_link_length: float = 0.2
    knee_link_y_offset: float = 0.0
    gear_abad: float = 1.0
    gear_hip: float = 1.0
    gear_knee: float = 1.0
    gravity: tuple = (0.0, 0.0, -9.81)


class ModelConstants(NamedTuple):
    """Device constants: per-joint (12) arrays, base inertia, feet.  The
    tuple fields are Python values (the tree's topology); the tensors live
    on one device."""

    parents: tuple                 # body index of each joint's parent
    axes: tuple                    # 'x' or 'y' per joint
    Xtree: torch.Tensor            # (12, 6, 6)
    Xrot: torch.Tensor             # (12, 6, 6)
    I_link: torch.Tensor           # (12, 6, 6)
    I_rotor: torch.Tensor          # (12, 6, 6)
    gear: torch.Tensor             # (12,)
    I_base: torch.Tensor           # (6, 6)
    gc_body: tuple                 # foot contact parent body per leg (4)
    gc_location: torch.Tensor      # (4, 3)
    gravity: torch.Tensor          # (3,)
    gear_static: tuple = ()        # Python-float mirrors (kernel parameters)
    gravity_static: tuple = ()


def _leg_sign_vec(v, leg):
    """withLegSigns (Quadruped.cpp:222-236)."""
    x, y, z = v
    sx = 1.0 if leg in (0, 1) else -1.0
    sy = -1.0 if leg in (0, 2) else 1.0
    return np.array([sx * x, sy * y, z])


def _sxform_np(R, r):
    X = np.zeros((6, 6))
    X[0:3, 0:3] = R
    X[3:6, 3:6] = R
    rx = np.array([[0, -r[2], r[1]], [r[2], 0, -r[0]], [-r[1], r[0], 0]])
    X[3:6, 0:3] = -R @ rx
    return X


def _spatial_inertia_np(m, com, I_rot):
    com = np.asarray(com)
    cx = np.array([[0, -com[2], com[1]], [com[2], 0, -com[0]],
                   [-com[1], com[0], 0]])
    out = np.zeros((6, 6))
    out[0:3, 0:3] = I_rot + m * cx @ cx.T
    out[0:3, 3:6] = m * cx
    out[3:6, 0:3] = m * cx.T
    out[3:6, 3:6] = m * np.eye(3)
    return out


@functools.lru_cache(maxsize=8)
def build_a1_constants(dtype_str: str = "float32", device="cuda") -> ModelConstants:
    """The A1 tree (Quadruped::buildModel), built in float64 numpy and
    stored as ``dtype_str`` tensors on ``device``.  Cached per (dtype,
    device); callers treat the tensors as read-only."""
    p = A1ModelParams()
    RY90 = sp.rot_y(np.pi / 2)
    RX90 = sp.rot_x(np.pi / 2)
    rotor_z = np.diag(p.rotor_inertia_z)
    rotor_x = RY90 @ rotor_z @ RY90.T
    rotor_y = RX90 @ rotor_z @ RX90.T
    knee_I = RY90 @ np.asarray(p.knee_inertia_rotated) @ RY90.T
    I3 = np.eye(3)
    RZPI = sp.rot_z(np.pi)

    parents, axes = [], []
    Xtree, Xrot, I_link, I_rotor, gear = [], [], [], [], []
    gc_body, gc_loc = [], []
    for leg in range(4):
        right = leg in (0, 2)     # sideSign -1 legs (Quadruped.cpp:34,113)
        joints = (
            # (parent, axis, tree rotation, location, mass, com, inertia,
            #  rotor inertia, gear)
            (0, "x", I3, _leg_sign_vec(p.abad_location, leg), p.abad_mass,
             p.abad_com, np.asarray(p.abad_inertia), rotor_x, p.gear_abad),
            (1 + 3 * leg, "y", RZPI, _leg_sign_vec(p.hip_location, leg),
             p.hip_mass, p.hip_com, np.asarray(p.hip_inertia), rotor_y,
             p.gear_hip),
            (2 + 3 * leg, "y", I3, np.asarray(p.knee_location), p.knee_mass,
             p.knee_com, knee_I, rotor_y, p.gear_knee),
        )
        for parent, axis, Rt, loc, m, com, I_rot, I_r, g in joints:
            parents.append(parent)
            axes.append(axis)
            Xtree.append(_sxform_np(Rt, loc))
            Xrot.append(_sxform_np(Rt, (0, 0, 0)))
            r_m, r_c = p.rotor_mass, (0, 0, 0)
            if right:
                m, com, I_rot = sp.flip_inertia_y(m, com, I_rot)
                r_m, r_c, I_r = sp.flip_inertia_y(r_m, r_c, I_r)
            I_link.append(_spatial_inertia_np(m, com, I_rot))
            I_rotor.append(_spatial_inertia_np(r_m, r_c, I_r))
            gear.append(g)
        # foot contact point on the knee body (Quadruped.cpp:92-108)
        gc_body.append(3 + 3 * leg)
        y_off = p.knee_link_y_offset if right else -p.knee_link_y_offset
        gc_loc.append([0.0, y_off, -p.knee_link_length])
    I_base = _spatial_inertia_np(p.body_mass, p.body_com, np.diag(p.body_inertia))

    t = lambda a: torch.as_tensor(np.asarray(a), dtype=getattr(torch, dtype_str),
                                  device=device)
    return ModelConstants(
        parents=tuple(parents), axes=tuple(axes),
        Xtree=t(np.stack(Xtree)), Xrot=t(np.stack(Xrot)),
        I_link=t(np.stack(I_link)), I_rotor=t(np.stack(I_rotor)),
        gear=t(gear), I_base=t(I_base), gc_body=tuple(gc_body),
        gc_location=t(gc_loc), gravity=t(p.gravity),
        gear_static=tuple(float(g) for g in gear),
        gravity_static=tuple(float(g) for g in p.gravity),
    )


class FBState(NamedTuple):
    """FloatingBaseModel state (FloatingBaseModel.h FBModelState)."""

    quat: torch.Tensor    # (..., 4) body orientation, wxyz
    pos: torch.Tensor     # (..., 3) body position, world
    v_body: torch.Tensor  # (..., 6) spatial velocity [omega; v], body frame
    q: torch.Tensor       # (..., 12) joint angles
    qd: torch.Tensor      # (..., 12)


class Kinematics(NamedTuple):
    Xup: list            # 13 x (..., 6, 6) parent-to-child motion transforms
    Xuprot: list
    Xa: list             # 13 x (..., 6, 6) world-to-link
    v: list              # 13 x (..., 6) link spatial velocities
    vrot: list
    c: list              # velocity-product terms
    crot: list
    S: list              # 13 x (6,) joint subspaces (None for base)
    Srot: list


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _mtv(M, v):
    """M^T v."""
    return (M.transpose(-1, -2) @ v[..., None])[..., 0]


def forward_kinematics(state: FBState, mc: ModelConstants) -> Kinematics:
    """forwardKinematics (FloatingBaseModel.cpp:509-553).  The reference's
    Xup[base] comes from quaternionToRotationMatrix, the world->body
    coordinate transform: quat_to_rotmat gives body->world, so the base
    rotation here is R^T."""
    dtype, device = state.pos.dtype, state.pos.device
    R_wb = quat_to_rotmat(state.quat).transpose(-1, -2)
    Xup, Xuprot = [sp.sxform(R_wb, state.pos)], [None]
    v, vrot = [state.v_body], [None]
    c, crot = [torch.zeros_like(state.v_body)], [None]
    S_list, Srot_list = [None], [None]
    zero3 = torch.zeros(state.q.shape[:-1] + (3,), dtype=dtype, device=device)
    for j in range(12):
        parent = mc.parents[j]
        qj, qdj, axis = state.q[..., j], state.qd[..., j], mc.axes[j]
        Xup_j = sp.sxform(sp.joint_rotation(axis, qj), zero3) @ mc.Xtree[j]
        S = sp.joint_motion_subspace(axis, dtype, device)
        vJ = S * qdj[..., None]
        v_j = _mv(Xup_j, v[parent]) + vJ
        gr = mc.gear[j]
        Xuprot_j = sp.sxform(sp.joint_rotation(axis, qj * gr), zero3) @ mc.Xrot[j]
        Srot = S * gr
        vJr = Srot * qdj[..., None]
        vrot_j = _mv(Xuprot_j, v[parent]) + vJr
        Xup.append(Xup_j)
        Xuprot.append(Xuprot_j)
        v.append(v_j)
        vrot.append(vrot_j)
        c.append(sp.motion_cross(v_j, vJ))
        crot.append(sp.motion_cross(vrot_j, vJr))
        S_list.append(S)
        Srot_list.append(Srot)
    Xa = [Xup[0]]
    for j in range(12):
        Xa.append(Xup[j + 1] @ Xa[mc.parents[j]])
    return Kinematics(Xup=Xup, Xuprot=Xuprot, Xa=Xa, v=v, vrot=vrot, c=c,
                      crot=crot, S=S_list, Srot=Srot_list)


def _composite_inertias(kin: Kinematics, mc: ModelConstants, batch) -> list:
    """compositeInertias (FloatingBaseModel.cpp:810-828), tips to base."""
    IC = [mc.I_base.expand(batch + (6, 6))]
    IC += [mc.I_link[j].expand(batch + (6, 6)) for j in range(12)]
    for j in range(11, -1, -1):
        body, parent = j + 1, mc.parents[j]
        XT = kin.Xup[body].transpose(-1, -2)
        XrT = kin.Xuprot[body].transpose(-1, -2)
        IC[parent] = IC[parent] + XT @ IC[body] @ kin.Xup[body] + (
            XrT @ mc.I_rotor[j] @ kin.Xuprot[body])
    return IC


def mass_matrix(state: FBState, mc: ModelConstants) -> torch.Tensor:
    """CRBA with rotors (massMatrix, FloatingBaseModel.cpp:834-869):
    (..., 18, 18)."""
    kin = forward_kinematics(state, mc)
    batch = state.pos.shape[:-1]
    IC = _composite_inertias(kin, mc, batch)
    H = torch.zeros(batch + (N_DOF, N_DOF), dtype=state.pos.dtype,
                    device=state.pos.device)
    H[..., 0:6, 0:6] = IC[0]
    for j in range(12):
        body = j + 1
        S, Srot = kin.S[body], kin.Srot[body]
        f = _mv(IC[body], S)
        frot = (mc.I_rotor[j] @ Srot).expand(batch + (6,))
        H[..., 6 + j, 6 + j] = (f * S).sum(-1) + (frot * Srot).sum(-1)
        f = _mtv(kin.Xup[body], f) + _mtv(kin.Xuprot[body], frot)
        i = mc.parents[j]
        while i > 0:
            ji = i - 1
            Hij = (f * kin.S[i]).sum(-1)
            H[..., 6 + ji, 6 + j] = Hij
            H[..., 6 + j, 6 + ji] = Hij
            f = _mtv(kin.Xup[i], f)
            i = mc.parents[ji]
        H[..., 0:6, 6 + j] = f
        H[..., 6 + j, 0:6] = f
    return H


def generalized_gravity(state: FBState, mc: ModelConstants) -> torch.Tensor:
    """generalizedGravityForce (FloatingBaseModel.cpp:655-675): (..., 18)."""
    kin = forward_kinematics(state, mc)
    batch = state.pos.shape[:-1]
    IC = _composite_inertias(kin, mc, batch)
    aG = torch.cat([torch.zeros_like(mc.gravity), mc.gravity])
    ag = [_mv(kin.Xup[0], aG)]
    G = torch.zeros(batch + (N_DOF,), dtype=state.pos.dtype, device=state.pos.device)
    G[..., 0:6] = -_mv(IC[0], ag[0])
    for j in range(12):
        body, parent = j + 1, mc.parents[j]
        ag_j = _mv(kin.Xup[body], ag[parent])
        agrot_j = _mv(kin.Xuprot[body], ag[parent])
        ag.append(ag_j)
        G[..., 6 + j] = -(kin.S[body] * _mv(IC[body], ag_j)).sum(-1) - (
            kin.Srot[body] * _mv(mc.I_rotor[j], agrot_j)).sum(-1)
    return G


def _bias_accelerations(kin: Kinematics, mc: ModelConstants, batch, rotors: bool):
    """biasAccelerations (FloatingBaseModel.cpp:632-648)."""
    avp = [torch.zeros(batch + (6,), dtype=kin.v[0].dtype, device=kin.v[0].device)]
    avprot = [None]
    for j in range(12):
        body, parent = j + 1, mc.parents[j]
        avp.append(_mv(kin.Xup[body], avp[parent]) + kin.c[body])
        if rotors:
            avprot.append(_mv(kin.Xuprot[body], avp[parent]) + kin.crot[body])
    return avp, avprot


def generalized_coriolis(state: FBState, mc: ModelConstants) -> torch.Tensor:
    """generalizedCoriolisForce (FloatingBaseModel.cpp:682-716): (..., 18)."""
    kin = forward_kinematics(state, mc)
    batch = state.pos.shape[:-1]
    avp, avprot = _bias_accelerations(kin, mc, batch, rotors=True)
    fvp, fvprot = [None] * N_BODIES, [None] * N_BODIES
    fvp[0] = _mv(mc.I_base, avp[0]) + sp.force_cross(kin.v[0], _mv(mc.I_base, kin.v[0]))
    for j in range(12):
        body = j + 1
        hi = _mv(mc.I_link[j], kin.v[body])
        fvp[body] = _mv(mc.I_link[j], avp[body]) + sp.force_cross(kin.v[body], hi)
        hr = _mv(mc.I_rotor[j], kin.vrot[body])
        fvprot[body] = _mv(mc.I_rotor[j], avprot[body]) + sp.force_cross(
            kin.vrot[body], hr)
    Cqd = torch.zeros(batch + (N_DOF,), dtype=state.pos.dtype, device=state.pos.device)
    for j in range(11, -1, -1):
        body, parent = j + 1, mc.parents[j]
        Cqd[..., 6 + j] = (kin.S[body] * fvp[body]).sum(-1) + (
            kin.Srot[body] * fvprot[body]).sum(-1)
        fvp[parent] = fvp[parent] + _mtv(kin.Xup[body], fvp[body]) + _mtv(
            kin.Xuprot[body], fvprot[body])
    Cqd[..., 0:6] = fvp[0]
    return Cqd


class ContactInfo(NamedTuple):
    Jc: torch.Tensor        # (..., 4, 3, 18) world-frame foot Jacobians
    Jcdqd: torch.Tensor     # (..., 4, 3)
    p_foot: torch.Tensor    # (..., 4, 3) world foot positions


def contact_jacobians(state: FBState, mc: ModelConstants) -> ContactInfo:
    """contactJacobians (FloatingBaseModel.cpp:586-625) for the 4 feet."""
    kin = forward_kinematics(state, mc)
    batch = state.pos.shape[:-1]
    avp, _ = _bias_accelerations(kin, mc, batch, rotors=False)
    Jc_all, Jcdqd_all, pf_all = [], [], []
    for leg in range(4):
        i = mc.gc_body[leg]
        Ra = kin.Xa[i][..., 0:3, 0:3]
        loc = mc.gc_location[leg].expand(batch + (3,))
        Xc = sp.sxform(Ra.transpose(-1, -2), loc)
        ac = _mv(Xc, avp[i])
        vc = _mv(Xc, kin.v[i])
        Jcdqd = ac[..., 3:6] + sp.cross(vc[..., 0:3], vc[..., 3:6])
        Xout = Xc[..., 3:6, :]
        Jc = torch.zeros(batch + (3, N_DOF), dtype=state.pos.dtype,
                         device=state.pos.device)
        while i > 0:
            j = i - 1
            Jc[..., :, 6 + j] = _mv(Xout, kin.S[i])
            Xout = Xout @ kin.Xup[i]
            i = mc.parents[j]
        Jc[..., :, 0:6] = Xout
        # world foot position: Xa maps world->link, bottom-left = -R [r]x
        BL = kin.Xa[mc.gc_body[leg]][..., 3:6, 0:3]
        rx = -Ra.transpose(-1, -2) @ BL
        r = torch.stack([rx[..., 2, 1], rx[..., 0, 2], rx[..., 1, 0]], dim=-1)
        Jc_all.append(Jc)
        Jcdqd_all.append(Jcdqd)
        pf_all.append(r + _mtv(Ra, loc))
    return ContactInfo(Jc=torch.stack(Jc_all, dim=-3),
                       Jcdqd=torch.stack(Jcdqd_all, dim=-2),
                       p_foot=torch.stack(pf_all, dim=-2))
