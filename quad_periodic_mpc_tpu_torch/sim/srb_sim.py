"""Analytic SRB plant with periodic disturbance injection
(counterpart of ``quad_periodic_mpc_tpu/sim/srb_sim.py``).

The plant is the same single-rigid-body model the MPC linearizes, stepped
with the exact nilpotent ZOH at the control dt and re-linearized about the
current orientation every step, plus the reference experiment's
disturbance F_x = d_s + d_n sin(2 pi f t + phi) (raisim_unitree_ros_driver
defaults d_s = -10 N, d_n = 15 N, f = 0.33 Hz) injected through the Q_d
channel as an acceleration F/m, or a per-component sinusoidal 6-wrench
(``WrenchDisturbance``, acceleration space).  A terrain ground function
keeps swing feet on or above the true surface.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from quad_periodic_mpc_tpu_torch.config import MPCConfig
from quad_periodic_mpc_tpu_torch.models import srb
from quad_periodic_mpc_tpu_torch.models.a1 import A1
from quad_periodic_mpc_tpu_torch.ops import discretize
from quad_periodic_mpc_tpu_torch.ops.cuda import srb_plant_kernel
from quad_periodic_mpc_tpu_torch.ops.rotations import rpy_to_quat, rpy_to_rotmat
from quad_periodic_mpc_tpu_torch.utils.consts import const
from quad_periodic_mpc_tpu_torch.utils.telemetry import spanned


class DisturbanceParams(NamedTuple):
    """F_x = static + amp * sin(2 pi freq t + phase), applied at the base."""

    static: torch.Tensor   # (...,) N
    amp: torch.Tensor      # (...,) N
    freq: torch.Tensor     # (...,) Hz
    phase: torch.Tensor    # (...,) rad

    @staticmethod
    def reference(batch: tuple = (), dtype=torch.float32, device="cuda"):
        """The paper's test signal (raisim_unitree_ros_driver.cpp:606)."""
        f = lambda v: torch.full(batch, v, dtype=dtype, device=device)
        return DisturbanceParams(f(-10.0), f(15.0), f(0.33), f(0.0))

    @staticmethod
    def zero(batch: tuple = (), dtype=torch.float32, device="cuda"):
        f = lambda v: torch.full(batch, v, dtype=dtype, device=device)
        return DisturbanceParams(f(0.0), f(0.0), f(0.33), f(0.0))


class WrenchDisturbance(NamedTuple):
    """Per-component sinusoidal 6-wrench disturbance in acceleration space,
    w_i(t) = static_i + amp_i sin(2 pi freq_i t + phase_i): the general case
    of the reference's x-force signal, for the ls6 estimator."""

    static: torch.Tensor   # (..., 6)
    amp: torch.Tensor      # (..., 6)
    freq: torch.Tensor     # (..., 6)
    phase: torch.Tensor    # (..., 6)

    @staticmethod
    def zero(batch: tuple = (), dtype=torch.float32, device="cuda"):
        f = lambda v: torch.full(batch + (6,), v, dtype=dtype, device=device)
        return WrenchDisturbance(f(0.0), f(0.0), f(0.33), f(0.0))


class PlantState(NamedTuple):
    x: torch.Tensor        # (..., 13) SRB state [rpy, p, omega, v, -g]
    p_feet: torch.Tensor   # (..., 4, 3) foot positions, world
    t: torch.Tensor        # (...,) sim time


def init_plant(
    batch: tuple = (),
    body_height: float = 0.29,
    model_hips=None,
    dtype=torch.float32,
    device="cuda",
) -> PlantState:
    """Robot standing at the origin with feet under the hips."""
    hips = np.asarray(model_hips if model_hips is not None else A1.hip_locations())
    feet = hips.copy()
    feet[:, 2] = 0.0
    feet[:, 1] += np.asarray(A1.side_signs()) * A1.leg.abad_link_length
    x = np.zeros(13)
    x[5] = body_height
    x[12] = -9.8
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return PlantState(
        x=t(x).expand(batch + (13,)).clone(),
        p_feet=t(feet).expand(batch + (4, 3)).clone(),
        t=torch.zeros(batch, dtype=dtype, device=device),
    )


def disturbance_wrench(dist, t: torch.Tensor, mass: float) -> torch.Tensor:
    """(..., 6) acceleration-space wrench [tau_acc(3); lin_acc(3)] of a
    ``DisturbanceParams`` or a ``WrenchDisturbance``."""
    two_pi = const(2.0 * math.pi, t.dtype, t.device)
    if isinstance(dist, WrenchDisturbance):
        return dist.static + dist.amp * torch.sin(
            two_pi * dist.freq * t[..., None] + dist.phase)
    fx = dist.static + dist.amp * torch.sin(two_pi * dist.freq * t + dist.phase)
    zeros = torch.zeros_like(fx)
    return torch.stack([zeros, zeros, zeros, fx / mass, zeros, zeros], dim=-1)


@spanned("srb_sim.step")
def step(
    plant: PlantState,
    forces: torch.Tensor,
    p_foot_des: torch.Tensor,
    stance_mask: torch.Tensor,
    dist,
    cfg: MPCConfig,
    dt: float,
    ground_fn=None,
) -> PlantState:
    """One plant step of length dt.  forces: (..., 4, 3) world-frame ground
    reactions (only stance feet push); swing feet follow p_foot_des.
    ground_fn: optional terrain surface ``xy (..., 2) -> z (...,)``; a foot
    commanded below it is clamped onto it (early touchdown against a riser
    face, the RaiSim stairs scene's case for a terrain-blind controller).
    On a card ``step_kernel``, on the CPU ``step_dense``."""
    advance = step_kernel if plant.x.device.type == "cuda" else step_dense
    new = advance(plant, forces, p_foot_des, stance_mask, dist, cfg, dt)
    feet_new = new.p_feet
    if ground_fn is not None:
        gz = ground_fn(feet_new[..., 0:2])
        feet_new = torch.cat(
            [feet_new[..., 0:2], torch.maximum(feet_new[..., 2], gz)[..., None]], dim=-1)
    return new._replace(p_feet=feet_new)


def step_kernel(plant: PlantState, forces, p_foot_des, stance_mask, dist, cfg: MPCConfig,
                dt: float) -> PlantState:
    """``step_dense``'s step as one launch of a CUDA kernel
    (``ops/cuda/srb_plant_kernel``): the exact ZOH applied matrix-free."""
    return PlantState(*srb_plant_kernel.srb_plant_step(
        plant.x, plant.p_feet, plant.t, forces, p_foot_des, stance_mask, tuple(dist),
        isinstance(dist, WrenchDisturbance), cfg.mass, cfg.inertia_body, dt))


def step_dense(plant: PlantState, forces, p_foot_des, stance_mask, dist, cfg: MPCConfig,
               dt: float) -> PlantState:
    """``step`` without the terrain clamp, in dense form: A, B, Qc of
    ``srb.ct_dynamics`` at the current orientation, discretized by
    ``discretize.nilpotent_zoh``.  The CPU's step, and the plain version the
    kernel is held to."""
    rpy = plant.x[..., 0:3]
    p = plant.x[..., 3:6]
    R = rpy_to_rotmat(rpy)
    r_feet = plant.p_feet - p[..., None, :]
    A, B, Qc = srb.ct_dynamics(R, r_feet, cfg.mass, cfg.inertia_body)
    Adt, Bdt, Qdt = discretize.nilpotent_zoh(A, B, Qc, dt)

    u = (forces * stance_mask[..., None]).reshape(forces.shape[:-2] + (12,))
    w = disturbance_wrench(dist, plant.t, cfg.mass)
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    x_new = mv(Adt, plant.x) + mv(Bdt, u) + mv(Qdt, w)
    feet_new = torch.where(stance_mask[..., None] > 0.5, plant.p_feet, p_foot_des)
    return PlantState(x=x_new, p_feet=feet_new, t=plant.t + dt)


@spanned("srb_sim.observe")
def observe(plant: PlantState):
    """PlantState -> controller Observation (cheater-mode ground truth)."""
    from quad_periodic_mpc_tpu_torch.control.mpc import Observation

    rpy = plant.x[..., 0:3]
    return Observation(
        p=plant.x[..., 3:6],
        v=plant.x[..., 9:12],
        quat=rpy_to_quat(rpy),
        omega=plant.x[..., 6:9],
        p_feet=plant.p_feet,
    )
