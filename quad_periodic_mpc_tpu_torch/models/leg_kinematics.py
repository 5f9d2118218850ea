"""3-DoF leg kinematics: FK, analytic Jacobian and IK, batched over legs x
instances (counterpart of ``quad_periodic_mpc_tpu/models/leg_kinematics.py``).

computeLegJacobianAndPosition (LegController.cpp:230-268): the A1 leg is
abad(roll, q0) -> hip(pitch, q1) -> knee(pitch, q2) with link lengths
(l1 = abad, l2 = hip, l3 = knee); positions in the hip-local frame
(x forward, y left, z up), sideSign = -1 for right legs:
  p_x = l3 s23 + l2 s2
  p_y = (l1+l4) side c1 + (l3 s1 c23 + l2 c2 s1)
  p_z = (l1+l4) side s1 - (l3 c1 c23 + l2 c1 c2)
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LegGeometry(NamedTuple):
    l1: float   # abad link length
    l2: float   # hip (thigh) link length
    l3: float   # knee (calf) link length
    l4: float = 0.0   # knee link y offset


def _trig(q):
    s1, s2, s3 = torch.sin(q[..., 0]), torch.sin(q[..., 1]), torch.sin(q[..., 2])
    c1, c2, c3 = torch.cos(q[..., 0]), torch.cos(q[..., 1]), torch.cos(q[..., 2])
    return s1, s2, s3, c1, c2, c3, c2 * c3 - s2 * s3, s2 * c3 + c2 * s3


def foot_position(q: torch.Tensor, geom: LegGeometry, side_sign) -> torch.Tensor:
    """FK: joint angles (..., 3) -> foot position (..., 3) in the leg frame
    (LegController.cpp:252-266 'if (p)')."""
    s1, s2, s3, c1, c2, c3, c23, s23 = _trig(q)
    l1 = geom.l1 + geom.l4
    px = geom.l3 * s23 + geom.l2 * s2
    py = l1 * side_sign * c1 + geom.l3 * s1 * c23 + geom.l2 * c2 * s1
    pz = l1 * side_sign * s1 - geom.l3 * c1 * c23 - geom.l2 * c1 * c2
    return torch.stack([px, py, pz], dim=-1)


def leg_jacobian(q: torch.Tensor, geom: LegGeometry, side_sign) -> torch.Tensor:
    """Analytic Jacobian (..., 3, 3) = d p / d q
    (LegController.cpp:252-266 'if (J)')."""
    s1, s2, s3, c1, c2, c3, c23, s23 = _trig(q)
    l1 = geom.l1 + geom.l4
    l2, l3 = geom.l2, geom.l3
    zero = torch.zeros_like(s1)
    rows = [
        zero, l3 * c23 + l2 * c2, l3 * c23,
        l3 * c1 * c23 + l2 * c1 * c2 - l1 * side_sign * s1,
        -l3 * s1 * s23 - l2 * s1 * s2,
        -l3 * s1 * s23,
        l3 * s1 * c23 + l2 * c2 * s1 + l1 * side_sign * c1,
        l3 * c1 * s23 + l2 * c1 * s2,
        l3 * c1 * s23,
    ]
    return torch.stack(rows, dim=-1).reshape(q.shape[:-1] + (3, 3))


def foot_velocity(q, qd, geom: LegGeometry, side_sign) -> torch.Tensor:
    """v = J qd (LegController.cpp:113)."""
    return (leg_jacobian(q, geom, side_sign) @ qd[..., None])[..., 0]


def inverse_kinematics(p: torch.Tensor, geom: LegGeometry, side_sign) -> torch.Tensor:
    """Analytic IK: leg-frame foot position (..., 3) -> (q0, q1, q2) on the
    A1's physical branch (knee q2 < 0).  With w = l3 c23 + l2 c2 >= 0 the FK
    reads [py; pz] = Rot(q0) [l1 side; -w] and (px, w) is a 2-link plane."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    l1 = geom.l1 + geom.l4
    l2, l3 = geom.l2, geom.l3
    side = torch.as_tensor(side_sign, dtype=p.dtype, device=p.device)
    r_leg = torch.sqrt(torch.clamp(y * y + z * z - l1 * l1, min=1e-12))
    q0 = torch.atan2(z, y) - torch.atan2(-r_leg, l1 * side)
    d2 = x * x + r_leg * r_leg
    cos_knee = torch.clamp((d2 - l2 * l2 - l3 * l3) / (2 * l2 * l3), -1.0, 1.0)
    q2 = -torch.arccos(cos_knee)
    phi = torch.atan2(x, r_leg)
    q1 = phi - torch.atan2(l3 * torch.sin(q2), l2 + l3 * torch.cos(q2))
    return torch.stack([q0, q1, q2], dim=-1)
