"""Point-cloud sensor processors: per-point height-variance models
(counterpart of ``quad_periodic_mpc_tpu/terrain/sensor.py``).

The elevation_mapping sensor-processor family
(elevation_mapping/src/sensor_processors/*.cpp) as batched functions:
given sensor-frame points, the sensor model's diagonal covariance Sigma_S,
the map-frame transforms and the robot's rotation covariance, apply the
error-propagation law

    sigma_h = J_q Sigma_q J_q^T + J_s Sigma_S J_s^T
    J_s = P C_MB C_BS,  J_q = P C_MB ([C_BS p]x + [r_BS]x)

(StructuredLightSensorProcessor.cpp:45-105, LaserSensorProcessor.cpp:43-90)
and transform the points to the map frame.  Models: structured light,
laser, stereo (disparity-quadratic, with a depth cutoff) and perfect.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from quad_periodic_mpc_tpu_torch.ops.rotations import skew
from quad_periodic_mpc_tpu_torch.terrain.heightmap import sqrt


def _norm(p: torch.Tensor) -> torch.Tensor:
    return sqrt((p * p).sum(-1))


@dataclasses.dataclass(frozen=True)
class StructuredLightModel:
    normal_a: float = 6.8e-3
    normal_b: float = 2.8e-3
    normal_c: float = 0.4
    normal_d: float = 0.0
    normal_e: float = 1.0
    lateral_factor: float = 0.01576

    def sensor_variance(self, points: torch.Tensor) -> torch.Tensor:
        d = points[..., 2]
        dev_n = (self.normal_a + self.normal_b * (d - self.normal_c) ** 2
                 + self.normal_d * torch.abs(d) ** self.normal_e)
        dev_l = self.lateral_factor * d
        return torch.stack([dev_l ** 2, dev_l ** 2, dev_n ** 2], dim=-1)


@dataclasses.dataclass(frozen=True)
class LaserModel:
    min_radius: float = 0.018
    beam_constant: float = 0.0015
    beam_angle: float = 0.0006

    def sensor_variance(self, points: torch.Tensor) -> torch.Tensor:
        d = _norm(points)
        var_l = (self.beam_constant + self.beam_angle * d) ** 2
        var_n = torch.full_like(var_l, self.min_radius ** 2)
        return torch.stack([var_l, var_l, var_n], dim=-1)


@dataclasses.dataclass(frozen=True)
class PerfectModel:
    def sensor_variance(self, points: torch.Tensor) -> torch.Tensor:
        return torch.zeros(points.shape[:-1] + (3,), dtype=points.dtype, device=points.device)


@dataclasses.dataclass(frozen=True)
class StereoModel:
    """Disparity-quadratic stereo depth noise (StereoSensorProcessor.cpp:
    40-97): with disparity d_p = f/z,

        var_n = (f/d_p^2)^2 ((p5 d_p + p2) sqrt((p3 d_p + p4 - j)^2
                + (v_c - i)^2) + p1),
        var_l = (lateral_factor |p|)^2.

    ``pixel_ij`` (..., n, 2) gives each point's organized-cloud pixel;
    without it each point sits at row v_center and the disparity-shifted
    principal column, zeroing both offset terms.  Points outside
    [cutoff_min_depth, cutoff_max_depth] are the reference's
    PassThrough-filtered points (:100-111): see ``depth_mask``.
    """

    p_1: float = 0.0
    p_2: float = 0.0
    p_3: float = 0.0
    p_4: float = 0.0
    p_5: float = 0.0
    lateral_factor: float = 0.0
    depth_to_disparity_factor: float = 1.0
    v_center: float = 240.0
    cutoff_min_depth: float = 0.0
    cutoff_max_depth: float = math.inf

    def sensor_variance(self, points: torch.Tensor,
                        pixel_ij: torch.Tensor | None = None) -> torch.Tensor:
        # f / x as one division (torch's float / tensor multiplies by 1 / x)
        f = torch.full((), self.depth_to_disparity_factor, dtype=points.dtype,
                       device=points.device)
        z = points[..., 2]
        disparity = f / z
        if pixel_ij is not None:
            di = self.v_center - pixel_ij[..., 0]
            dj = self.p_3 * disparity + self.p_4 - pixel_ij[..., 1]
        else:
            di = torch.zeros_like(z)
            dj = torch.zeros_like(z)
        var_n = (f / disparity ** 2) ** 2 * (
            (self.p_5 * disparity + self.p_2) * sqrt(dj ** 2 + di ** 2) + self.p_1)
        var_l = (self.lateral_factor * _norm(points)) ** 2
        return torch.stack([var_l, var_l, var_n], dim=-1)

    def depth_mask(self, points: torch.Tensor) -> torch.Tensor:
        z = points[..., 2]
        return (z >= self.cutoff_min_depth) & (z <= self.cutoff_max_depth)


def process_points(
    points_sensor: torch.Tensor,       # (..., n, 3)
    model,
    R_map_base: torch.Tensor,          # (..., 3, 3) base->map rotation
    R_base_sensor: torch.Tensor,       # (3, 3) sensor->base rotation
    t_base_sensor: torch.Tensor,       # (3,) sensor origin in base frame
    t_map_base: torch.Tensor,          # (..., 3) base origin in map frame
    rotation_covariance: torch.Tensor | None = None,   # (..., 3, 3)
    pixel_ij: torch.Tensor | None = None,              # (..., n, 2)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (points_map (..., n, 3), height_variances (..., n)).
    ``pixel_ij`` goes to models that read the organized-cloud pixel
    (StereoModel); the others ignore it."""
    p_base = torch.einsum("ij,...nj->...ni", R_base_sensor, points_sensor) + t_base_sensor
    p_map = torch.einsum("...ij,...nj->...ni", R_map_base, p_base) + t_map_base[..., None, :]

    # J_s = P C_MB C_BS (row vector); P = e_z
    J_s = (R_map_base @ R_base_sensor)[..., 2, :]              # (..., 3)
    if pixel_ij is not None:
        sv = model.sensor_variance(points_sensor, pixel_ij=pixel_ij)
    else:
        sv = model.sensor_variance(points_sensor)               # (..., n, 3)
    var_sensor = torch.einsum("...j,...nj,...j->...n", J_s, sv, J_s)

    if rotation_covariance is not None:
        # J_q = P C_MB ([C_BS p]x + [r_BS]x)
        Cp = torch.einsum("ij,...nj->...ni", R_base_sensor, points_sensor)
        Jq = torch.einsum("...i,...nij->...nj", R_map_base[..., 2, :],
                          skew(Cp) + skew(t_base_sensor))
        var_rot = torch.einsum("...ni,...ij,...nj->...n", Jq, rotation_covariance, Jq)
    else:
        var_rot = torch.zeros_like(var_sensor)
    return p_map, var_sensor + var_rot
