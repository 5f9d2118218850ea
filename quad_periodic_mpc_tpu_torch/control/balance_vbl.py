"""Variation-based-linearization balance controller (VBL-LQR + QP)
(counterpart of ``quad_periodic_mpc_tpu/control/balance_vbl.py``).

Rebuilds BalanceControllerVBL + ReferenceGRF
(src/controllers/BalanceController/{BalanceControllerVBL,ReferenceGRF}.cpp),
the FSM_State_BalanceVBL stack:

1. ReferenceGRF: distribute m g across stance feet with moment balance,
   min |A z - b|^2 + alpha |z|^2 over the 4 normal forces, A rows
   [1 1 1 1; p_y; -p_x], b = [m g; 0; 0] (ReferenceGRF.cpp:176-203),
   swing feet pinned; solved in closed form on masked normal equations.
2. Variation dynamics about (x_d, R_d, f_ref): state
   s = [e_x, e_dx, e_R, e_omega] with e_R = vee(1/2 (R_d^T R - R^T R_d))
   (calc_linear_error, BalanceControllerVBL.cpp:279-293); A_LQR/B_LQR per
   update_A_LQR/update_B_LQR (:301-411).
3. P from the CARE: batched doubling (ops/linalg.care) instead of the
   reference's Hamiltonian eigendecomposition.
4. Force-delta QP: H = 2(R1+R2), g = 2(B_QP^T P^T s - R2 dF_prev),
   linearized cone |dF_xy| <= mu 0.7071 f_ref_z and normal bounds shifted
   by f_ref_z (calc_H/g/A/lbA, :461-536), solved with the batched PDIP on
   an 8-rows-per-foot block.  Output F = f_ref + dF.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from quad_periodic_mpc_tpu_torch.config import PDIPConfig
from quad_periodic_mpc_tpu_torch.ops import linalg, qp_pdip
from quad_periodic_mpc_tpu_torch.ops.qp_admm import QPData
from quad_periodic_mpc_tpu_torch.ops.rotations import skew


@dataclasses.dataclass(frozen=True)
class VBLSettings:
    mass: float = 12.0
    inertia_body: tuple = (0.35, 2.1, 2.1)
    mu: float = 0.5
    # LQR weights (set_LQR_weights defaults used by FSM_State_BalanceVBL)
    q_x: tuple = (100.0, 100.0, 150.0)
    q_dx: tuple = (10.0, 10.0, 30.0)
    q_R: tuple = (200.0, 200.0, 100.0)
    q_omega: tuple = (10.0, 10.0, 10.0)
    alpha: float = 0.1      # R1 diagonal
    beta: float = 0.1       # R2 diagonal (rate penalty)
    min_force: float = 10.0
    max_force: float = 160.0
    big: float = 1e3
    care_dt: float = 1e-3
    care_iters: int = 30


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def reference_grf(
    p_feet_des_rel: torch.Tensor,  # (..., 4, 3) desired feet rel CoM, world
    contact: torch.Tensor,         # (..., 4)
    cfg: VBLSettings = VBLSettings(),
    alpha: float = 1e-3,
) -> torch.Tensor:
    """Desired normal-force distribution f_ref (z components; x/y zero):
    closed-form masked ridge solve of the ReferenceGRF QP
    (ReferenceGRF.cpp:94-210)."""
    dtype = p_feet_des_rel.dtype
    ones = torch.ones_like(p_feet_des_rel[..., 0])
    A = torch.stack([ones, p_feet_des_rel[..., 1], -p_feet_des_rel[..., 0]], dim=-2)  # (..., 3, 4)
    zero = torch.zeros_like(ones[..., 0])
    b = torch.stack([torch.full_like(zero, cfg.mass * 9.81), zero, zero], dim=-1)
    c = contact.to(dtype)
    # swing pinning via a large diagonal penalty (exact as penalty -> inf)
    pen = alpha + (1.0 - c) * 1e9
    eye = torch.eye(4, dtype=dtype, device=ones.device)
    H = A.transpose(-1, -2) @ A + eye * pen[..., None, :]
    rhs = _mv(A.transpose(-1, -2), b)
    fz = torch.linalg.solve(H, rhs[..., None])[..., 0] * c
    zeros = torch.zeros_like(fz)
    return torch.stack([zeros, zeros, fz], dim=-1)           # (..., 4, 3)


class VariationLQR(NamedTuple):
    """Steps 1-3 of the controller, the force-delta QP's inputs."""

    f_ref: torch.Tensor   # (..., 4, 3) reference foot forces
    s: torch.Tensor       # (..., 12) variation state
    B: torch.Tensor       # (..., 12, 12) variation input matrix
    P: torch.Tensor       # (..., 12, 12) the CARE's solution


def variation_lqr(
    x_com: torch.Tensor,
    v_com: torch.Tensor,
    R_body: torch.Tensor,           # (..., 3, 3) body->world
    omega_world: torch.Tensor,
    p_feet_des_rel: torch.Tensor,   # (..., 4, 3) desired feet rel CoM
    x_des: torch.Tensor,
    v_des: torch.Tensor,
    R_des: torch.Tensor,
    omega_des_world: torch.Tensor,
    contact: torch.Tensor,
    cfg: VBLSettings = VBLSettings(),
) -> VariationLQR:
    """The reference forces, the variation state and dynamics about them,
    and P from the CARE (the reference's ``solve`` up to the QP)."""
    dtype, device = x_com.dtype, x_com.device
    batch = x_com.shape[:-1]
    c = contact.to(dtype)
    Ig = torch.diag(torch.tensor(cfg.inertia_body, dtype=dtype, device=device))
    Ig_inv = torch.linalg.inv(Ig)

    f_ref = reference_grf(p_feet_des_rel, contact, cfg)    # (..., 4, 3)

    # --- variation state s (calc_linear_error) ---
    RdT = R_des.transpose(-1, -2)
    RdT_R = RdT @ R_body
    e_R_mat = 0.5 * (RdT_R - RdT_R.transpose(-1, -2))
    e_R = torch.stack([e_R_mat[..., 2, 1], e_R_mat[..., 0, 2], e_R_mat[..., 1, 0]], dim=-1)
    omega_b = _mv(R_body.transpose(-1, -2), omega_world)
    omega_d_b = _mv(RdT, omega_des_world)
    e_omega = omega_b - _mv(RdT_R.transpose(-1, -2), omega_d_b)
    s = torch.cat([x_com - x_des, v_com - v_des, e_R, e_omega], dim=-1)

    # --- variation dynamics (update_A_LQR / update_B_LQR) ---
    A = torch.zeros(batch + (12, 12), dtype=dtype, device=device)
    eye3 = torch.eye(3, dtype=dtype, device=device)
    A[..., 0:3, 3:6] = eye3
    A[..., 6:9, 9:12] = eye3
    A[..., 6:9, 6:9] = skew(-omega_d_b)
    IRdT = (Ig_inv @ RdT)[..., None, :, :]
    A[..., 9:12, 0:3] = torch.sum(IRdT @ skew(f_ref), dim=-3)
    rxf = torch.cross(p_feet_des_rel, f_ref, dim=-1)
    A[..., 9:12, 6:9] = torch.sum(IRdT @ skew(rxf), dim=-3)

    B = torch.zeros(batch + (12, 12), dtype=dtype, device=device)
    mask = c[..., None, None]                                   # (..., 4, 1, 1)
    B_v = mask * eye3 / cfg.mass                                # (..., 4, 3, 3)
    B_w = mask * (IRdT @ skew(p_feet_des_rel))
    B[..., 3:6, :] = torch.cat(B_v.unbind(-3), dim=-1)
    B[..., 9:12, :] = torch.cat(B_w.unbind(-3), dim=-1)

    Q1 = torch.diag(torch.tensor(cfg.q_x + cfg.q_dx + cfg.q_R + cfg.q_omega, dtype=dtype,
                                 device=device))
    R1 = cfg.alpha * torch.eye(12, dtype=dtype, device=device)
    P = linalg.care(A, B, Q1.expand(A.shape), R1.expand(A.shape), dt=cfg.care_dt,
                    iters=cfg.care_iters)
    return VariationLQR(f_ref=f_ref, s=s, B=B, P=P)


def solve(
    x_com: torch.Tensor,
    v_com: torch.Tensor,
    R_body: torch.Tensor,           # (..., 3, 3) body->world
    omega_world: torch.Tensor,
    p_feet_des_rel: torch.Tensor,   # (..., 4, 3) desired feet rel CoM
    x_des: torch.Tensor,
    v_des: torch.Tensor,
    R_des: torch.Tensor,
    omega_des_world: torch.Tensor,
    contact: torch.Tensor,
    dF_prev: torch.Tensor | None = None,
    cfg: VBLSettings = VBLSettings(),
    pdip: PDIPConfig = PDIPConfig(iterations=25),
) -> torch.Tensor:
    """Returns world-frame foot forces (..., 4, 3) = f_ref + dF."""
    dtype, device = x_com.dtype, x_com.device
    batch = x_com.shape[:-1]
    c = contact.to(dtype)
    f_ref, s, B, P = variation_lqr(x_com, v_com, R_body, omega_world, p_feet_des_rel, x_des,
                                   v_des, R_des, omega_des_world, contact, cfg)

    # --- force-delta QP (calc_H/g/A/lbA) ---
    H = 2.0 * (cfg.alpha + cfg.beta) * torch.eye(12, dtype=dtype, device=device)
    if dF_prev is None:
        dF_prev = torch.zeros(batch + (12,), dtype=dtype, device=device)
    g = 2.0 * (_mv(B.transpose(-1, -2), _mv(P.transpose(-1, -2), s)) - cfg.beta * dF_prev)

    mu7 = cfg.mu * 0.7071
    F = torch.tensor(
        [
            [1.0, 0.0, -mu7],
            [0.0, 1.0, -mu7],
            [0.0, 1.0, mu7],
            [1.0, 0.0, mu7],
            [0.0, 0.0, 1.0],
            [1.0, 0.0, 0.0],     # variable-bound rows (contact gating)
            [0.0, 1.0, 0.0],
            [0.0, 0.0, 1.0],
        ],
        dtype=dtype, device=device)
    big = cfg.big
    fz_ref = f_ref[..., 2]
    l_foot = torch.stack([-big * c, -big * c, -mu7 * fz_ref, -mu7 * fz_ref,
                          cfg.min_force * c - fz_ref, -big * c, -big * c, -big * c], dim=-1)
    u_foot = torch.stack([mu7 * fz_ref, mu7 * fz_ref, big * c, big * c,
                          cfg.max_force * c - fz_ref, big * c, big * c, big * c], dim=-1)
    qp = QPData(P=H.expand(batch + (12, 12)), q=g, F=F,
                l=l_foot.reshape(batch + (32,)), u=u_foot.reshape(batch + (32,)))
    dF, _ = qp_pdip.solve(qp, pdip)
    return f_ref + dF.reshape(batch + (4, 3))
