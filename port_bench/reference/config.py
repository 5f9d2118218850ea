"""Typed configuration for the PyTorch convex-MPC port.

A copy of the reference package's frozen dataclasses (``MPCConfig``,
``ADMMConfig``, ``PDIPConfig``, ``EstimatorConfig``, ``GaitConfig``,
``SwingConfig``, ``LoopConfig``) with identical fields and defaults, and of
its live-tunable parameters (``TunableParams``) as tensors.  The port keeps its
own copy instead of importing the JAX package, so it runs where JAX is
not installed; ``tests/test_torch_helpers.py`` holds every default equal
to the reference's, field by field.  The reasons behind each default are
documented at the reference definitions.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """Dense convex-MPC problem definition (SolverMPC problem_setup,
    ConvexMPCLocomotion.cpp:62,617,623; RobotState.h:26)."""

    horizon: int = 10
    dt_mpc: float = 0.026          # dt * iterationsBetweenMPC = 0.002 * 13
    mu: float = 0.4
    f_max: float = 120.0
    mass: float = 12.0
    inertia_body: Tuple[float, float, float] = (0.07, 0.26, 0.242)
    weights: Tuple[float, ...] = (
        0.25, 0.25, 10.0, 10.0, 2.0, 50.0, 0.0, 0.0, 0.3, 0.2, 0.2, 0.1,
    )
    alpha: float = 4e-5
    gravity: float = 9.8
    big_number: float = 5e10
    x_drag_gain: float = 3.0

    def __post_init__(self):
        if self.horizon < 1:
            raise ValueError("horizon must be >= 1")
        if len(self.weights) != 12:
            raise ValueError("weights must have 12 entries")


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    """OSQP-style ADMM settings with a fixed iteration count.
    ``formulation="stagewise"``: with ``backend="pallas"`` in the fused
    stagewise kernels (CUDA kernels here), with ``backend="xla"`` on the scan
    path of ``ops/qp_stagewise.solve``.  ``formulation="condensed"``
    (``ops/qp_admm.solve``): the KKT/NS fields choose how K^{-1} is built,
    ``backend="pallas"`` runs the iterations in the fused ADMM kernel,
    ``pallas_bf16_kinv`` stores K^{-1} there as bfloat16.  ``iter_precision``
    and ``ns_bucket_precision`` choose matmul passes on a TPU and are
    accepted and ignored here (every product is full float32)."""

    rho: float = 3e-4
    sigma: float = 1e-6
    over_relax: float = 1.6
    iterations: int = 200
    kkt: str = "ns"
    ns_iters: int = 30
    ns_warm_iters: int = 1
    ns_polish: int = 0
    refine: int = 0
    # "pallas" names the fused-kernel backend, kept for parity with the
    # reference's configs; in this package it selects the CUDA kernels.
    backend: str = "xla"
    eq_scale: float = 1e3
    eq_mode: str = "uniform"
    ns_escalate: str = "bucket"
    ns_cold_iters: int = 12
    ns_bucket_precision: str = "auto"
    formulation: str = "condensed"
    iter_precision: str = "highest"
    pallas_bf16_kinv: bool = False


@dataclasses.dataclass(frozen=True)
class PDIPConfig:
    """Primal-dual interior-point settings (``ops/qp_pdip.solve``: the WBIC
    relaxation QP and the condensed MPC QP)."""

    iterations: int = 25
    tau: float = 0.995
    reg: float = 1e-9
    kkt: str = "cholesky"
    mu_min: float = 1e-10
    slack_floor: float = 1e-14
    big_clamp: float = 1e4


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    """Periodic disturbance estimator settings (SolverMPC.cpp:704-798)."""

    window: int = 400
    freeze_after: int = 500
    sigma_fast: float = 7.0
    sigma_slow: float = 27.0
    ema_smooth: float = 0.95
    ema_static: float = 0.97
    mode: str = "ls"
    ls_release: int = 400
    residual: str = "discrete"
    predictive: bool = False


@dataclasses.dataclass(frozen=True)
class SwingConfig:
    """Swing trajectory + Raibert foot-placement parameters
    (ConvexMPCLocomotion.cpp:23,316,318)."""

    step_height: float = 0.06
    p_rel_max: float = 0.3
    bonus_swing: float = 0.0
    interleave_gain: float = -0.2
    interleave_y: Tuple[float, float, float, float] = (-0.08, 0.08, 0.02, -0.02)


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Control-loop timing (MAIN_LOOP_RATE 500, ITERATIONS_BETWEEN_MPC 13)."""

    dt: float = 0.002
    iterations_between_mpc: int = 13
    body_height: float = 0.29
    swing_height: float = 0.09
    max_pos_error: float = 0.1
    max_vel_x: float = 1.0
    max_vel_y: float = 0.6
    max_turn_rate: float = 2.0

    @property
    def dt_mpc(self) -> float:
        return self.dt * self.iterations_between_mpc
