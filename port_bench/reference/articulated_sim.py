"""Articulated whole-body simulator for torque-level closed-loop testing
(frozen copy of the port's ``quad_periodic_mpc_tpu_torch/sim/articulated_sim.py``).

Full 18-DoF forward dynamics from the floating-base model
(models/floating_base.py) with penalty ground contact:

    qdd = A(q)^{-1} (tau_gen + sum_legs Jc^T f_contact - C qdot - G)

Contact: spring-damper normal force gated on penetration, Coulomb-capped
tangential stiction spring with sliding anchors.  Integration:
semi-implicit Euler in body coordinates, pose on the manifold (quaternion
form).  Batched over instances.  ``step_fast`` chained ``substeps`` times
is the plain version of the fused substep kernel
(``ops/cuda/plant_kernel.py``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from port_bench.reference.rotations import quat_product
from port_bench.reference import floating_base as fb
from port_bench.reference import leg_kinematics as lk
from port_bench.reference.a1 import A1
from port_bench.reference import linalg
from port_bench.reference.rotations import quat_to_rotmat


@dataclasses.dataclass(frozen=True)
class ContactParams:
    k_normal: float = 8000.0
    d_normal: float = 300.0
    mu: float = 0.6
    k_tangent: float = 3000.0     # stiction spring (anchor model)
    d_tangent: float = 60.0


class ArtState(NamedTuple):
    fb: fb.FBState
    t: torch.Tensor
    anchor: torch.Tensor      # (..., 4, 2) tangential stiction anchors
    in_contact: torch.Tensor  # (..., 4) previous-step contact flag


def mc_cache(dtype=torch.float32, device="cuda") -> fb.ModelConstants:
    """The A1 model constants for ``dtype`` on ``device`` (cached)."""
    return fb.build_a1_constants(str(dtype).removeprefix("torch."), str(device))


def init(
    batch: tuple = (),
    height: float = 0.32,
    q_stand: tuple = (0.0, 0.8, -1.6),
    dtype=torch.float32,
    device="cuda",
) -> ArtState:
    z = lambda *s: torch.zeros(batch + s, dtype=dtype, device=device)
    full = lambda v: torch.as_tensor(v, dtype=dtype, device=device).expand(
        batch + (len(v),)).clone()
    state = fb.FBState(quat=full([1.0, 0.0, 0.0, 0.0]),
                       pos=full([0.0, 0.0, height]), v_body=z(6),
                       q=full(tuple(q_stand) * 4), qd=z(12))
    info = fb.contact_jacobians(state, mc_cache(dtype, device))
    return ArtState(fb=state, t=z(), anchor=info.p_foot[..., 0:2].contiguous(),
                    in_contact=z(4))


def init_on_ground(
    batch: tuple = (),
    q_stand: tuple = (0.0, 0.8, -1.6),
    penetration: float = 2e-3,
    dtype=torch.float32,
    device="cuda",
) -> ArtState:
    """Feet on (slightly into) the ground: the body height comes from the
    stand-pose leg FK, so the plant starts in sustained contact."""
    geom = lk.LegGeometry(A1.leg.abad_link_length, A1.leg.hip_link_length,
                          A1.leg.knee_link_length)
    foot_z = float(lk.foot_position(
        torch.tensor(q_stand, dtype=torch.float64), geom, -1.0)[2])
    return init(batch, height=-foot_z - penetration, q_stand=q_stand,
                dtype=dtype, device=device)


def contact_forces(
    info: fb.ContactInfo,
    qdot: torch.Tensor,
    anchor: torch.Tensor,
    params: ContactParams,
    dtype=torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 4, 3) world-frame contact forces and updated anchors.

    Normal: spring-damper on penetration.  Tangential: a spring from the
    per-foot anchor set at touchdown plus damping, Coulomb-capped; when the
    cap binds the anchor slides to the point consistent with the capped
    force."""
    v_feet = (info.Jc @ qdot[..., None, :, None])[..., 0]
    z = info.p_foot[..., 2]
    vz = v_feet[..., 2]
    pen = torch.clamp(-z, min=0.0)
    active = (z < 0.0).to(dtype)
    fz = torch.clamp(params.k_normal * pen - params.d_normal * vz * active,
                     min=0.0) * active
    p_xy = info.p_foot[..., 0:2]
    ft = (-params.k_tangent * (p_xy - anchor)
          - params.d_tangent * v_feet[..., 0:2]) * active[..., None]
    ft_norm = torch.sqrt((ft * ft).sum(-1, keepdim=True))
    limit = params.mu * fz[..., None]
    slide = ft_norm > limit
    scale = torch.where(slide, limit / torch.clamp(ft_norm, min=1e-9),
                        torch.ones_like(ft_norm))
    ft = ft * scale
    anchor_new = torch.where(slide, p_xy + ft / params.k_tangent, anchor)
    # feet out of contact track their position (anchor reset at touchdown)
    anchor_new = torch.where(active[..., None] > 0, anchor_new, p_xy)
    return torch.cat([ft, fz[..., None]], dim=-1), anchor_new


def _flat_tau(tau_joints):
    if tau_joints.shape[-1] == 3:
        return tau_joints.reshape(tau_joints.shape[:-2] + (12,))
    return tau_joints


def _integrate(s: fb.FBState, qdd: torch.Tensor, dt: float):
    """Semi-implicit Euler + manifold quaternion update."""
    v_body = s.v_body + dt * qdd[..., 0:6]
    qd = s.qd + dt * qdd[..., 6:18]
    q = s.q + dt * qd
    R = quat_to_rotmat(s.quat)
    pos = s.pos + dt * (R @ v_body[..., 3:6, None])[..., 0]
    w = v_body[..., 0:3] * dt
    angle = torch.sqrt((w * w).sum(-1, keepdim=True))
    axis = w / torch.clamp(angle, min=1e-12)
    half = angle / 2.0
    dq = torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)
    quat = quat_product(s.quat, dq)
    quat = quat / torch.sqrt((quat * quat).sum(-1, keepdim=True))
    return fb.FBState(quat=quat, pos=pos, v_body=v_body, q=q, qd=qd)


def step_fast(
    state: ArtState,
    tau_joints: torch.Tensor,        # (..., 4, 3) or (..., 12)
    dt: float,
    params: ContactParams,
    cache,                           # (A_inv, G, C) from model_cache()
    Jc: torch.Tensor,                # (..., 4, 3, 18) tick-level frozen
    p_foot: torch.Tensor,            # (..., 4, 3) integrated foot pos
) -> tuple[ArtState, torch.Tensor, torch.Tensor]:
    """Substep with the tick-level kinematic cache: Jc frozen over the
    tick, world foot positions integrated (p' = p + Jc qdot dt, with qdot
    before the update).  Returns (state', p_foot', contact_forces)."""
    s = state.fb
    dtype = s.pos.dtype
    tau = _flat_tau(tau_joints)
    A_inv, G, C = cache
    qdot = torch.cat([s.v_body, s.qd], dim=-1)
    v_feet = (Jc @ qdot[..., None, :, None])[..., 0]
    info = fb.ContactInfo(Jc=Jc, Jcdqd=None, p_foot=p_foot)
    f_c, anchor_new = contact_forces(info, qdot, state.anchor, params, dtype)
    tau_gen = torch.cat([torch.zeros_like(s.v_body), tau], dim=-1)
    JTf = (Jc.transpose(-1, -2) @ f_c[..., None]).sum(-3)[..., 0]
    qdd = (A_inv @ (tau_gen + JTf - C - G)[..., None])[..., 0]
    new = ArtState(fb=_integrate(s, qdd, dt), t=state.t + dt,
                   anchor=anchor_new, in_contact=(f_c[..., 2] > 0).to(dtype))
    return new, p_foot + dt * v_feet, f_c
