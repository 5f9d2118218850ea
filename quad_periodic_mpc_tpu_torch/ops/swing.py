"""Cubic-Bezier swing-foot trajectories and the Raibert foothold
(counterpart of ``quad_periodic_mpc_tpu/ops/swing.py``;
FootSwingTrajectory.cpp:17-41, Interpolation.h, ConvexMPCLocomotion.cpp:287-331).
The stairs variant is not ported yet."""

from __future__ import annotations

from typing import NamedTuple

import torch


def cubic_bezier(y0, yf, x):
    """y0 + (x^3 + 3 x^2 (1 - x)) (yf - y0)  (Interpolation.h:30-37)."""
    b = x * x * x + 3.0 * (x * x * (1.0 - x))
    return y0 + b * (yf - y0)


def cubic_bezier_d1(y0, yf, x):
    """First derivative wrt x (Interpolation.h:44-51)."""
    return 6.0 * x * (1.0 - x) * (yf - y0)


def cubic_bezier_d2(y0, yf, x):
    """Second derivative wrt x (Interpolation.h:58-65)."""
    return (6.0 - 12.0 * x) * (yf - y0)


class SwingEval(NamedTuple):
    p: torch.Tensor   # (..., 3) position
    v: torch.Tensor   # (..., 3) velocity
    a: torch.Tensor   # (..., 3) acceleration


def evaluate(p0, pf, height, phase, swing_time) -> SwingEval:
    """Swing curve at phase in [0, 1]: xy one Bezier, z a lift/land pair
    with chain-rule factors 2/swingTime and 4/swingTime^2."""
    ph = phase[..., None]
    st = swing_time[..., None]
    p = cubic_bezier(p0, pf, ph)
    v = cubic_bezier_d1(p0, pf, ph) / st
    a = cubic_bezier_d2(p0, pf, ph) / (st * st)

    z0 = p0[..., 2]
    zf = pf[..., 2]
    zmid = z0 + height
    first = phase < 0.5
    x1 = phase * 2.0
    x2 = phase * 2.0 - 1.0
    stz = swing_time
    zp = torch.where(first, cubic_bezier(z0, zmid, x1), cubic_bezier(zmid, zf, x2))
    zv = torch.where(
        first,
        cubic_bezier_d1(z0, zmid, x1) * 2.0 / stz,
        cubic_bezier_d1(zmid, zf, x2) * 2.0 / stz,
    )
    za = torch.where(
        first,
        cubic_bezier_d2(z0, zmid, x1) * 4.0 / (stz * stz),
        cubic_bezier_d2(zmid, zf, x2) * 4.0 / (stz * stz),
    )
    p = torch.cat([p[..., :2], zp[..., None]], dim=-1)
    v = torch.cat([v[..., :2], zv[..., None]], dim=-1)
    a = torch.cat([a[..., :2], za[..., None]], dim=-1)
    return SwingEval(p=p, v=v, a=a)


def raibert_foothold(
    p_body, v_world, v_des_world, v_des_robot, R_body, hip_location,
    side_sign, abad_link_length, yaw_turn_rate, stance_time,
    swing_time_remaining, body_height_z, interleave_y, interleave_gain,
    bonus_swing, p_rel_max, dt_mpc,
) -> torch.Tensor:
    """Raibert-heuristic swing target Pf (ConvexMPCLocomotion.cpp:287-331),
    (..., 4, 3) world frame with z = 0, including the reference's quirks
    (the y-speed term's extra dtMPC factor, the +yaw_rate*ts/2 rotation)."""
    v_abs = torch.abs(v_des_robot[..., 0:1])
    offset_y = side_sign * abad_link_length
    p_robot = hip_location.clone()
    p_robot[..., 1] = p_robot[..., 1] + (
        offset_y + interleave_y * v_abs * interleave_gain)

    ang = yaw_turn_rate * stance_time / 2.0
    c, s = torch.cos(ang), torch.sin(ang)
    px, py, pz = p_robot[..., 0], p_robot[..., 1], p_robot[..., 2]
    p_yaw = torch.stack([c * px - s * py, s * px + c * py, pz], dim=-1)

    des_vel = torch.cat(
        [v_des_robot[..., :2], torch.zeros_like(v_des_robot[..., :1])], dim=-1)
    local = p_yaw + des_vel[..., None, :] * swing_time_remaining[..., None]
    # (R_body^T) applied to each foot's vector
    pf = p_body[..., None, :] + torch.einsum("...ji,...kj->...ki", R_body, local)

    g = 9.81
    pfx_rel = (
        v_world[..., 0:1] * (0.5 + bonus_swing) * stance_time
        + 0.03 * (v_world[..., 0:1] - v_des_world[..., 0:1])
        + (0.5 * body_height_z[..., None] / g) * (v_world[..., 1:2] * yaw_turn_rate)
    )
    pfy_rel = (
        v_world[..., 1:2] * 0.5 * stance_time * dt_mpc
        + 0.03 * (v_world[..., 1:2] - v_des_world[..., 1:2])
        + (0.5 * body_height_z[..., None] / g) * (-v_world[..., 0:1] * yaw_turn_rate)
    )
    pfx_rel = torch.clamp(pfx_rel, -p_rel_max, p_rel_max)
    pfy_rel = torch.clamp(pfy_rel, -p_rel_max, p_rel_max)
    return torch.stack(
        [pf[..., 0] + pfx_rel, pf[..., 1] + pfy_rel, torch.zeros_like(pfx_rel)],
        dim=-1,
    )
