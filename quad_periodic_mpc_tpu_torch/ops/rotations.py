"""Quaternion / RPY / rotation-matrix conversions, batched over leading
dims (counterpart of ``quad_periodic_mpc_tpu/ops/rotations.py``).

- quat_to_rpy: SolverMPC.cpp:352-361, returned as (roll, pitch, yaw).
- rpy_to_rotmat: R = Rz(yaw) Ry(pitch) Rx(roll)
  (ConvexMPCLocomotion.cpp:1081-1097).
- yaw_rotmat: Rz(yaw) alone (the balance controllers' yaw frame).
"""

from __future__ import annotations

import torch


def quat_to_rpy(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) -> (roll, pitch, yaw), with the reference's
    asin clamp at 0.99999.  The argument is also clamped at -1 from below,
    where the reference clamps nothing: at a pitch of -90 degrees (a falling
    robot in a sweep) a unit quaternion's float32 argument can round below
    -1 here and not in the reference's rounding, and asin would return NaN.
    Every argument the reference takes without NaN gives the same pitch."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    as_ = torch.clamp(-2.0 * (x * z - w * y), min=-1.0, max=0.99999)
    yaw = torch.atan2(2.0 * (x * y + w * z), w * w + x * x - y * y - z * z)
    pitch = torch.asin(as_)
    roll = torch.atan2(2.0 * (y * z + w * x), w * w - x * x - y * y + z * z)
    return torch.stack([roll, pitch, yaw], dim=-1)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) -> rotation matrix R (body->world), Eigen's
    toRotationMatrix convention (RobotState.cpp:36)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = w * w + x * x + y * y + z * z
    s = torch.where(n > 0, 2.0 / n, torch.zeros_like(n))
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    r = torch.stack(
        [
            1.0 - (yy + zz), xy - wz, xz + wy,
            xy + wz, 1.0 - (xx + zz), yz - wx,
            xz - wy, yz + wx, 1.0 - (xx + yy),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def rpy_to_rotmat(rpy: torch.Tensor) -> torch.Tensor:
    """(roll, pitch, yaw) -> R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    roll, pitch, yaw = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    r = torch.stack(
        [
            cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
            sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
            -sp, cp * sr, cp * cr,
        ],
        dim=-1,
    )
    return r.reshape(rpy.shape[:-1] + (3, 3))


def rpy_to_quat(rpy: torch.Tensor) -> torch.Tensor:
    """(roll, pitch, yaw) -> quaternion (w, x, y, z) for Rz Ry Rx."""
    half = 0.5 * rpy
    cr, sr = torch.cos(half[..., 0]), torch.sin(half[..., 0])
    cp, sp = torch.cos(half[..., 1]), torch.sin(half[..., 1])
    cy, sy = torch.cos(half[..., 2]), torch.sin(half[..., 2])
    w = cr * cp * cy + sr * sp * sy
    x = sr * cp * cy - cr * sp * sy
    y = cr * sp * cy + sr * cp * sy
    z = cr * cp * sy - sr * sp * cy
    return torch.stack([w, x, y, z], dim=-1)


def yaw_rotmat(yaw: torch.Tensor) -> torch.Tensor:
    """Pure-yaw rotation Rz(yaw) (RobotState.cpp:40-42 before the R_yaw = R
    override; the balance controller's yaw frame)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    r = torch.stack([c, -s, zero, s, c, zero, zero, zero, one], dim=-1)
    return r.reshape(yaw.shape + (3, 3))


def skew(v: torch.Tensor) -> torch.Tensor:
    """[v]x cross-product matrix (cross_mat, SolverMPC.cpp:252-257)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    r = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return r.reshape(v.shape[:-1] + (3, 3))
