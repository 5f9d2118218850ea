"""Batched 18-state / 28-measurement Kalman position-velocity estimator
(counterpart of ``quad_periodic_mpc_tpu/estimation/kf.py``, the
LinearKFPositionVelocityEstimator rebuild, PositionVelocityEstimator.cpp:
20-250).

State x = [p(3), v(3), p_foot0..3 (12)] (world frame).  Process:
p' = p + dt v, v' = v + dt a_world (IMU accel + gravity), feet static.
Measurements (28): 12 body-from-foot positions (-p_f per leg), 12 foot
velocities (trust-blended), 4 foot heights.  Contact-phase trust gating
inflates Q/R by (1 + (1 - trust) * 100) outside the mid-stance trust
window (PositionVelocityEstimator.cpp:180-200).

The estimator is a pure (KFState, inputs) -> KFState transition over any
leading batch dims.  ``backend="pallas"`` names the fused-kernel backend,
as in the reference's configs: here it selects the CUDA kernel
(``ops/cuda/kf_kernel.fused_kf_innovate``; its plain version for CPU
tensors).  ``backend="xla"`` is the dense chain in PyTorch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from quad_periodic_mpc_tpu_torch.ops import linalg


@dataclasses.dataclass(frozen=True)
class KFParams:
    """Noise parameters (ros_config.yaml analogs)."""

    dt: float = 0.002
    process_noise_pimu: float = 0.02
    process_noise_vimu: float = 0.02
    process_noise_pfoot: float = 0.002
    sensor_noise_pimu_rel_foot: float = 0.001
    sensor_noise_vimu_rel_foot: float = 0.1
    sensor_noise_zfoot: float = 0.001
    trust_window: float = 0.2
    high_suspect_number: float = 100.0


class KFState(NamedTuple):
    xhat: torch.Tensor   # (..., 18)
    P: torch.Tensor      # (..., 18, 18)


def _static_matrices(params: KFParams, dtype, device):
    """A (18x18), B (18x3), C (28x18), Q0 (18,), R0 (28,): the constant
    pieces from setup() (PositionVelocityEstimator.cpp:20-61)."""
    dt = params.dt
    A = np.eye(18)
    A[0:3, 3:6] = dt * np.eye(3)
    B = np.zeros((18, 3))
    B[3:6, :] = dt * np.eye(3)
    C = np.zeros((28, 18))
    for i in range(4):
        C[3 * i:3 * i + 3, 0:3] = np.eye(3)          # p - p_foot rows
        C[12 + 3 * i:15 + 3 * i, 3:6] = np.eye(3)    # v rows
    C[0:12, 6:18] = -np.eye(12)
    C[24, 8] = 1.0
    C[25, 11] = 1.0
    C[26, 14] = 1.0
    C[27, 17] = 1.0
    q0 = np.ones(18)
    q0[0:3] = (dt / 20.0) * params.process_noise_pimu
    q0[3:6] = (dt * 9.8 / 20.0) * params.process_noise_vimu
    q0[6:18] = dt * params.process_noise_pfoot
    r0 = np.ones(28)
    r0[0:12] = params.sensor_noise_pimu_rel_foot
    r0[12:24] = params.sensor_noise_vimu_rel_foot
    r0[24:28] = params.sensor_noise_zfoot
    return tuple(torch.as_tensor(m, dtype=dtype, device=device) for m in (A, B, C, q0, r0))


def init(batch: tuple = (), dtype=torch.float32, device="cuda") -> KFState:
    return KFState(
        xhat=torch.zeros(batch + (18,), dtype=dtype, device=device),
        P=(100.0 * torch.eye(18, dtype=dtype, device=device)).expand(
            batch + (18, 18)).clone(),
    )


def trust_from_phase(phase: torch.Tensor, params: KFParams) -> torch.Tensor:
    """Mid-stance trust ramp (PositionVelocityEstimator.cpp:180-195)."""
    ph = torch.clamp(phase, max=1.0)
    w = params.trust_window
    one = torch.ones_like(ph)
    return torch.where(ph < w, ph / w, torch.where(ph > 1.0 - w, (1.0 - ph) / w, one))


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def innovation_inputs(
    state: KFState,
    a_world: torch.Tensor,
    R_body: torch.Tensor,
    omega_body: torch.Tensor,
    p_rel: torch.Tensor,
    v_rel: torch.Tensor,
    contact_phase: torch.Tensor,
    params: KFParams,
):
    """The per-leg measurement prep both backends share (trust gating,
    measurement assembly, noise inflation).  Arguments as ``update``'s;
    returns (a (..., 3) world acceleration with gravity added, y (..., 28),
    q_diag (..., 18), r_diag (..., 28))."""
    dtype, device = state.xhat.dtype, state.xhat.device
    *_, q0, r0 = _static_matrices(params, dtype, device)
    lead = state.xhat.shape[:-1]

    g = torch.tensor([0.0, 0.0, -9.81], dtype=dtype, device=device)
    a = a_world + g

    Rbod = R_body.transpose(-1, -2)                        # body->world
    p_f = torch.einsum("...ij,...kj->...ki", Rbod, p_rel)  # feet rel body, world
    dp_f = torch.einsum(
        "...ij,...kj->...ki", Rbod,
        torch.cross(omega_body[..., None, :].expand(p_rel.shape), p_rel, dim=-1) + v_rel)

    trust = trust_from_phase(contact_phase, params)        # (..., 4)
    suspect = 1.0 + (1.0 - trust) * params.high_suspect_number

    # Q/R diagonals with per-leg inflation
    q_feet = q0[6:18].reshape(4, 3) * suspect[..., None]
    q_diag = torch.cat([q0[:6].expand(lead + (6,)), q_feet.reshape(lead + (12,))], dim=-1)
    r_v = r0[12:24].reshape(4, 3) * suspect[..., None]
    r_z = r0[24:28] * suspect
    r_diag = torch.cat(
        [r0[:12].expand(lead + (12,)), r_v.reshape(lead + (12,)), r_z], dim=-1)

    p0 = state.xhat[..., 0:3]
    v0 = state.xhat[..., 3:6]
    ps = (-p_f).reshape(lead + (12,))
    vs = ((1.0 - trust)[..., None] * v0[..., None, :]
          + trust[..., None] * (-dp_f)).reshape(lead + (12,))
    pzs = (1.0 - trust) * (p0[..., 2:3] + p_f[..., 2])
    y = torch.cat([ps, vs, pzs], dim=-1)
    return a, y, q_diag, r_diag


def update(
    state: KFState,
    a_world: torch.Tensor,        # (..., 3) IMU linear accel, world
    R_body: torch.Tensor,         # (..., 3, 3) world->body (rBody)
    omega_body: torch.Tensor,     # (..., 3)
    p_rel: torch.Tensor,          # (..., 4, 3) hip + leg FK, body frame
    v_rel: torch.Tensor,          # (..., 4, 3) leg velocity, body frame
    contact_phase: torch.Tensor,  # (..., 4)
    params: KFParams,
    backend: str = "xla",
) -> KFState:
    """One KF tick (run(), PositionVelocityEstimator.cpp:130-250).

    backend="pallas" with float32 runs predict + innovation in the fused
    kernel, the covariance chain kept on chip; float64 takes the dense
    chain (``dense_predict_innovate``) whatever the backend, as the
    reference does.  The per-leg measurement prep is shared."""
    dtype = state.xhat.dtype
    lead = state.xhat.shape[:-1]
    a, y, q_diag, r_diag = innovation_inputs(
        state, a_world, R_body, omega_body, p_rel, v_rel, contact_phase, params)

    if backend == "pallas" and dtype == torch.float32:
        from quad_periodic_mpc_tpu_torch.ops.cuda import kf_kernel

        Bn = math.prod(lead)
        flat = lambda t, *s: t.expand(lead + s).reshape((Bn,) + s).contiguous()
        x_new, P_new = kf_kernel.fused_kf_innovate(
            flat(state.xhat, 18), flat(state.P, 18, 18), flat(a, 3), flat(y, 28),
            flat(q_diag, 18), flat(r_diag, 28), dt=float(params.dt))
        return KFState(xhat=x_new.reshape(lead + (18,)), P=P_new.reshape(lead + (18, 18)))

    return KFState(*dense_predict_innovate(state.xhat, state.P, a, y, q_diag, r_diag, params))


def dense_predict_innovate(xhat, P, a, y, q_diag, r_diag, params: KFParams):
    """The dense chain of one tick (the "xla" backend): predict and innovate
    as products with A, B and C.  Arguments as the fused kernel's (``a``
    with gravity added); returns (xhat', P').

    S is symmetric positive definite and is inverted by
    ``linalg.spd_inverse_sym``.  The reference calls its ``spd_inverse``
    there, whose closed forms read both triangles: in float32, from a cold
    start (P0 = 100 I, cond(S) ~ 5e5) with a leg at trust 0, that form leaves
    |S^-1 S - I| ~ 0.5 in both packages, and whether the filter survives
    hangs on the summation order of the products around it (the reference's
    does, PyTorch's goes NaN at tick 3).  The symmetric form leaves 0.03 and
    follows the reference's float32 chain to 3e-4 from tick 3 on; in float64
    the two forms agree to rounding."""
    dtype, device = xhat.dtype, xhat.device
    A, B, C, _, _ = _static_matrices(params, dtype, device)

    # predict
    xhat = _mv(A, xhat) + _mv(B, a)
    eye18 = torch.eye(18, dtype=dtype, device=device)
    Pm = A @ P @ A.T + q_diag[..., :, None] * eye18

    # innovate: one explicit S^{-1} (28x28 SPD, the exact Schur recursion)
    # serves both the state and the covariance update
    ey = y - _mv(C, xhat)
    S = C @ Pm @ C.T + r_diag[..., :, None] * torch.eye(28, dtype=dtype, device=device)
    S_inv = linalg.spd_inverse_sym(S)
    PCt = Pm @ C.T
    xhat = xhat + _mv(PCt, _mv(S_inv, ey))
    P = (eye18 - PCt @ (S_inv @ C)) @ Pm
    P = (P + P.transpose(-1, -2)) / 2.0

    # xy-covariance reset heuristic (PositionVelocityEstimator.cpp:233-239)
    det2 = P[..., 0, 0] * P[..., 1, 1] - P[..., 0, 1] * P[..., 1, 0]
    blowup = (det2 > 1e-6)[..., None, None]
    is_xy = torch.zeros(18, dtype=torch.bool, device=device)
    is_xy[0:2] = True
    cross = is_xy[:, None] ^ is_xy[None, :]    # xy<->rest cross terms
    xyblk = is_xy[:, None] & is_xy[None, :]    # 2x2 xy block
    P = torch.where(blowup & cross, torch.zeros_like(P), P)
    P = torch.where(blowup & xyblk, P / 10.0, P)
    return xhat, P


def plane_body_height(p_local_stance: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Least-squares ground-plane body height + pitch (_getLocalBodyHeight,
    PositionVelocityEstimator.cpp:64-120): solve P k = 1 for the plane
    A x + B y + C z = 1 through the last stance footholds (body frame);
    height = 1/|k|, pitch = acos(A/|k|) - pi/2."""
    P = p_local_stance                                     # (..., 4, 3)
    G = torch.einsum("...ki,...kj->...ij", P, P)
    b = P.sum(dim=-2)
    k = _mv(linalg.spd_inverse(G), b)
    norm = torch.clamp(torch.linalg.vector_norm(k, dim=-1), min=1e-9)
    z = 1.0 / norm
    pitch = torch.arccos(torch.clamp(k[..., 0] / norm, -1, 1)) - math.pi / 2
    return z, pitch
