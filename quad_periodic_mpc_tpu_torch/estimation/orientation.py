"""Orientation estimator (counterpart of
``quad_periodic_mpc_tpu/estimation/orientation.py``, the
OrientationEstimator.cpp rebuild).

VectorNav path: take the IMU quaternion, zero its initial yaw (the first
visit captures q_ini_inv = quat(-[0, 0, yaw0]) and premultiplies it,
OrientationEstimator.cpp:48-58), derive rpy, body/world angular velocity
and acceleration.  The yaw-zeroing reference is explicit state.  The
reference's rBody is world->body; ``quat_to_rotmat`` returns body->world
R, so rBody = R^T.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quad_periodic_mpc_tpu_torch.ops.rotations import (
    quat_to_rotmat,
    quat_to_rpy,
    rpy_to_quat,
)


class OrientationResult(NamedTuple):
    quat: torch.Tensor         # (..., 4) yaw-zeroed orientation (wxyz)
    rpy: torch.Tensor          # (..., 3)
    R: torch.Tensor            # (..., 3, 3) body->world
    omega_body: torch.Tensor   # (..., 3)
    omega_world: torch.Tensor  # (..., 3)
    a_body: torch.Tensor       # (..., 3)
    a_world: torch.Tensor      # (..., 3)


def quat_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product (wxyz), matching ori::quatProduct."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def initial_yaw_correction(quat_imu: torch.Tensor) -> torch.Tensor:
    """q_ini_inv from the first IMU sample: the inverse pure-yaw rotation
    (OrientationEstimator.cpp:48-55)."""
    rpy = quat_to_rpy(quat_imu)
    zero = torch.zeros_like(rpy[..., 0])
    return rpy_to_quat(torch.stack([zero, zero, -rpy[..., 2]], dim=-1))


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def run(
    quat_imu: torch.Tensor,
    gyro_body: torch.Tensor,
    accel_body: torch.Tensor,
    yaw_correction: torch.Tensor,
) -> OrientationResult:
    """VectorNavOrientationEstimator::run (OrientationEstimator.cpp:38-80)."""
    quat = quat_product(yaw_correction, quat_imu)
    R = quat_to_rotmat(quat)
    return OrientationResult(
        quat=quat,
        rpy=quat_to_rpy(quat),
        R=R,
        omega_body=gyro_body,
        omega_world=_mv(R, gyro_body),
        a_body=accel_body,
        a_world=_mv(R, accel_body),
    )
