"""Unitree A1 robot constants (a frozen copy of the port's
``quad_periodic_mpc_tpu_torch/models/a1.py``, numpy only): SRB mass and
lumped inertia (RobotState.h:26, RobotState.cpp:45-49) and the leg
kinematic constants (MiniCheetah.h:27-110, the A1 branch).  Leg order:
0 = FR, 1 = FL, 2 = RR, 3 = RL; x forward, y left, z up.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SRBParams:
    """Single-rigid-body parameters for the convex MPC."""

    mass: float
    inertia_body: Tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class LegParams:
    """Per-leg kinematic constants (3-DoF abad/hip/knee legs)."""

    abad_link_length: float
    hip_link_length: float
    knee_link_length: float
    abad_location_x: float
    abad_location_y: float
    max_leg_length: float


@dataclasses.dataclass(frozen=True)
class RobotModel:
    name: str
    srb: SRBParams
    leg: LegParams
    tau_max: Tuple[float, float, float] = (17.0, 17.0, 26.0)
    tau_safe: float = 3.0

    def hip_locations(self) -> np.ndarray:
        """(4, 3) hip (abad) locations in the body frame
        (Quadruped::getHipLocation, Quadruped.h:95-102)."""
        x = self.leg.abad_location_x
        y = self.leg.abad_location_y
        return np.array(
            [[x, -y, 0.0], [x, y, 0.0], [-x, -y, 0.0], [-x, y, 0.0]],
            dtype=np.float64,
        )

    def side_signs(self) -> np.ndarray:
        """(4,) y-axis sign per leg: -1 right (0, 2), +1 left (1, 3)."""
        return np.array([-1.0, 1.0, -1.0, 1.0])


A1 = RobotModel(
    name="a1",
    srb=SRBParams(mass=12.0, inertia_body=(0.07, 0.26, 0.242)),
    leg=LegParams(
        abad_link_length=0.0838,
        hip_link_length=0.2,
        knee_link_length=0.2,
        abad_location_x=0.1805,
        abad_location_y=0.047,
        max_leg_length=0.4,
    ),
)

GO1 = RobotModel(
    name="go1",
    srb=SRBParams(mass=12.0, inertia_body=(0.07, 0.26, 0.242)),
    leg=LegParams(
        abad_link_length=0.08,
        hip_link_length=0.213,
        knee_link_length=0.213,
        abad_location_x=0.1881,
        abad_location_y=0.04675,
        max_leg_length=0.4,
    ),
)
