"""3-DoF leg kinematics: the foot position (FK), batched over legs x
instances (frozen copy of the port's ``quad_periodic_mpc_tpu_torch/models/leg_kinematics.py``).

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
