"""Stand-balance QP controller, batched (counterpart of
``quad_periodic_mpc_tpu/control/balance.py``).

Rebuilds BalanceController (src/controllers/BalanceController/
BalanceController.cpp, the Focchi-et-al. wrench-distribution QP used by
FSM_State_BalanceStand / BalanceVBL):

1. PD wrench command in the yaw-rotated frame (calc_PDcontrol, :332-359):
     b = [ m (xddot_des + Kp e_x + Kd e_dx + g);
           II (Kp_th log(R_err) + Kd_th e_dth) ]
   with II = Ryaw^T R Ig R^T Ryaw (Ig = diag(.35, 2.1, 2.1), :350).
2. Grasp matrix A (update_A_control, :385-396):
     A = [ Ryaw^T ... ; Ryaw^T [c_i p_i]x ... ]   (per foot columns)
3. QP (calc_H/g, :398-448):  min |A f - b|^2_S + alpha |f|^2_W
   s.t. friction pyramid + normal-force bounds per foot
   (calc_A/lbA/ubA, :408-503) and per-variable contact gating
   (calc_lb_ub, :450-470: swing feet pinned to zero).

The reference's 12-var/20-con qpOASES solve becomes the batched PDIP
(``ops/qp_pdip``) on an 8-rows-per-foot block (5 pyramid/normal rows + 3
identity rows for the variable bounds), keeping the problem shape-static
across contact configurations.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from quad_periodic_mpc_tpu_torch.config import PDIPConfig
from quad_periodic_mpc_tpu_torch.ops import qp_pdip
from quad_periodic_mpc_tpu_torch.ops.qp_admm import QPData
from quad_periodic_mpc_tpu_torch.ops.rotations import skew, yaw_rotmat


@dataclasses.dataclass(frozen=True)
class BalanceSettings:
    """Defaults per FSM_State_BalanceVBL.cpp:61,120-126 call site."""

    mass: float = 12.0
    inertia_body: tuple = (0.35, 2.1, 2.1)   # Ig (BalanceController.cpp:350)
    mu: float = 0.5
    alpha: float = 0.01
    com_weights: tuple = (1.0, 1.0, 10.0)
    base_weights: tuple = (10.0, 10.0, 10.0)
    kp_com: tuple = (30.0, 30.0, 30.0)
    kd_com: tuple = (10.0, 10.0, 10.0)
    kp_base: tuple = (80.0, 80.0, 50.0)
    kd_base: tuple = (20.0, 20.0, 20.0)
    min_force: float = 10.0
    max_force: float = 160.0
    big: float = 1e3


class BalanceCommand(NamedTuple):
    p_des: torch.Tensor        # (..., 3) desired CoM position, world
    v_des: torch.Tensor        # (..., 3)
    a_des: torch.Tensor        # (..., 3) feedforward CoM acceleration
    R_des: torch.Tensor        # (..., 3, 3) desired body orientation
    omega_des: torch.Tensor    # (..., 3) desired world angular velocity


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def matrix_log_rot(R: torch.Tensor) -> torch.Tensor:
    """SO(3) log (matrixLogRot, BalanceController.cpp:705-730)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    s = torch.sin(theta)
    scale = torch.where(torch.abs(s) > 1e-8,
                        theta / (2.0 * torch.where(s == 0, torch.ones_like(s), s)),
                        torch.full_like(s, 0.5))
    return scale[..., None] * w


def friction_block(mu: float, dtype, device) -> torch.Tensor:
    """The per-foot constraint rows (directions n = z, t1 = x, t2 = y, flat
    ground): four pyramid rows, the normal row, three variable-bound rows."""
    return torch.tensor(
        [
            [1.0, 0.0, -mu],     # fx - mu fz in [-BIG c, 0]
            [0.0, 1.0, -mu],     # fy - mu fz in [-BIG c, 0]
            [0.0, 1.0, mu],      # fy + mu fz in [0, BIG c]
            [1.0, 0.0, mu],      # fx + mu fz in [0, BIG c]
            [0.0, 0.0, 1.0],     # fz in [min c, max c]
            [1.0, 0.0, 0.0],     # variable bounds (calc_lb_ub)
            [0.0, 1.0, 0.0],
            [0.0, 0.0, 1.0],
        ],
        dtype=dtype, device=device)


def solve(
    p_com: torch.Tensor,
    v_com: torch.Tensor,
    R_body: torch.Tensor,          # (..., 3, 3) body->world
    omega_world: torch.Tensor,
    yaw: torch.Tensor,
    p_feet_rel: torch.Tensor,      # (..., 4, 3) feet relative to CoM, world
    contact: torch.Tensor,         # (..., 4) in {0, 1}
    cmd: BalanceCommand,
    cfg: BalanceSettings = BalanceSettings(),
    pdip: PDIPConfig = PDIPConfig(iterations=25),
) -> torch.Tensor:
    """Returns world-frame foot forces (..., 4, 3)."""
    dtype, device = p_com.dtype, p_com.device
    batch = p_com.shape[:-1]
    vec = lambda v: torch.tensor(v, dtype=dtype, device=device)
    Ryaw = yaw_rotmat(yaw)
    RyawT = Ryaw.transpose(-1, -2)

    # PD wrench (calc_PDcontrol)
    e_x = _mv(RyawT, cmd.p_des - p_com)
    e_dx = _mv(RyawT, cmd.v_des - v_com)
    R_err = RyawT @ cmd.R_des @ R_body.transpose(-1, -2) @ Ryaw
    e_th = matrix_log_rot(R_err)
    e_dth = _mv(RyawT, cmd.omega_des - omega_world)

    a_des = cmd.a_des + vec(cfg.kp_com) * e_x + vec(cfg.kd_com) * e_dx
    alpha_des = vec(cfg.kp_base) * e_th + vec(cfg.kd_base) * e_dth

    Ig = torch.diag(vec(cfg.inertia_body))
    II = RyawT @ R_body @ Ig @ R_body.transpose(-1, -2) @ Ryaw
    b = torch.cat([cfg.mass * (a_des + vec([0.0, 0.0, 9.81])), _mv(II, alpha_des)], dim=-1)

    # grasp matrix (update_A_control)
    pc = contact[..., None] * p_feet_rel                       # (..., 4, 3)
    top = RyawT.unsqueeze(-3).expand(batch + (4, 3, 3))
    bottom = RyawT.unsqueeze(-3) @ skew(pc)
    A = torch.cat([torch.cat(top.unbind(-3), dim=-1),
                   torch.cat(bottom.unbind(-3), dim=-1)], dim=-2)  # (..., 6, 12)

    # cost 2(A' S A + (alpha + 1e-3) I), g = -2 A' S b (calc_H/g; the
    # xOptPrev warm-regularization term is omitted: cold-start form)
    S = vec(cfg.com_weights + cfg.base_weights)
    SA = S[:, None] * A
    P = 2.0 * (A.transpose(-1, -2) @ SA
               + (cfg.alpha + 1e-3) * torch.eye(12, dtype=dtype, device=device))
    q = -2.0 * _mv(SA.transpose(-1, -2), b)

    c = contact.to(dtype)
    big = cfg.big
    zero = torch.zeros_like(c)
    l_foot = torch.stack([-big * c, -big * c, zero, zero, cfg.min_force * c,
                          -big * c, -big * c, -big * c], dim=-1)
    u_foot = torch.stack([zero, zero, big * c, big * c, cfg.max_force * c,
                          big * c, big * c, big * c], dim=-1)
    qp = QPData(P=P, q=q, F=friction_block(cfg.mu, dtype, device),
                l=l_foot.reshape(batch + (32,)), u=u_foot.reshape(batch + (32,)))
    f, _ = qp_pdip.solve(qp, pdip)
    return f.reshape(batch + (4, 3))
