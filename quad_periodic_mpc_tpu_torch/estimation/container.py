"""State-estimator container: composes the orientation, position/velocity
and contact estimators into one per-tick update (counterpart of
``quad_periodic_mpc_tpu/estimation/container.py``).

Rebuilds StateEstimatorContainer (StateEstimatorContainer.h:22-216) and the
pass-through ContactEstimator (ContactEstimator.cpp:1-9): the shared
StateEstimate result struct is a NamedTuple, the estimator list one pure
function.  The cheater path mirrors cheater_mode.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quad_periodic_mpc_tpu_torch.control import leg_controller as lc
from quad_periodic_mpc_tpu_torch.estimation import kf as kf_mod
from quad_periodic_mpc_tpu_torch.estimation import orientation as ori_mod
from quad_periodic_mpc_tpu_torch.models.a1 import A1, RobotModel
from quad_periodic_mpc_tpu_torch.ops.rotations import quat_to_rotmat, quat_to_rpy


class StateEstimate(NamedTuple):
    """StateEstimatorContainer's result block (StateEstimatorContainer.h)."""

    position: torch.Tensor       # (..., 3)
    v_world: torch.Tensor        # (..., 3)
    v_body: torch.Tensor         # (..., 3)
    quat: torch.Tensor           # (..., 4)
    rpy: torch.Tensor            # (..., 3)
    R: torch.Tensor              # (..., 3, 3) body->world
    omega_body: torch.Tensor     # (..., 3)
    omega_world: torch.Tensor    # (..., 3)
    a_world: torch.Tensor        # (..., 3)
    contact_phase: torch.Tensor  # (..., 4)


class EstimatorState(NamedTuple):
    kf: kf_mod.KFState
    yaw_correction: torch.Tensor   # (..., 4) quaternion
    initialized: torch.Tensor      # (...,) bool


def init(batch: tuple = (), dtype=torch.float32, device="cuda") -> EstimatorState:
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)
    return EstimatorState(
        kf=kf_mod.init(batch, dtype, device),
        yaw_correction=ident.expand(batch + (4,)).clone(),
        initialized=torch.zeros(batch, dtype=torch.bool, device=device),
    )


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def update(
    state: EstimatorState,
    quat_imu: torch.Tensor,
    gyro_body: torch.Tensor,
    accel_body: torch.Tensor,
    q_joints: torch.Tensor,        # (..., 4, 3)
    qd_joints: torch.Tensor,       # (..., 4, 3)
    contact_phase: torch.Tensor,   # (..., 4) scheduled contact
    params: kf_mod.KFParams = kf_mod.KFParams(),
    model: RobotModel = A1,
    kf_backend: str = "xla",
) -> tuple[EstimatorState, StateEstimate]:
    """One estimation tick (StateEstimatorContainer::run,
    StateEstimatorContainer.h:112), on the device of its inputs."""
    # first-visit yaw zeroing (VectorNavOrientationEstimator)
    corr_new = ori_mod.initial_yaw_correction(quat_imu)
    corr = torch.where(state.initialized[..., None], state.yaw_correction, corr_new)
    ori = ori_mod.run(quat_imu, gyro_body, accel_body, corr)

    legs = lc.update_data(q_joints, qd_joints, model)
    hips = torch.as_tensor(model.hip_locations(), dtype=q_joints.dtype,
                           device=q_joints.device)
    kf_new = kf_mod.update(
        state.kf,
        a_world=ori.a_world,
        R_body=ori.R.transpose(-1, -2),
        omega_body=ori.omega_body,
        p_rel=hips + legs.p,
        v_rel=legs.v,
        contact_phase=contact_phase,
        params=params,
        backend=kf_backend,
    )

    v_world = kf_new.xhat[..., 3:6]
    est = StateEstimate(
        position=kf_new.xhat[..., 0:3],
        v_world=v_world,
        v_body=_mv(ori.R.transpose(-1, -2), v_world),
        quat=ori.quat,
        rpy=ori.rpy,
        R=ori.R,
        omega_body=ori.omega_body,
        omega_world=ori.omega_world,
        a_world=ori.a_world,
        contact_phase=contact_phase,
    )
    new_state = EstimatorState(
        kf=kf_new, yaw_correction=corr, initialized=torch.ones_like(state.initialized))
    return new_state, est


def cheater(position, v_world, quat, omega_body, a_body, contact_phase) -> StateEstimate:
    """Ground-truth pass-through (CheaterOrientationEstimator +
    CheaterPositionVelocityEstimator, cheater_mode)."""
    R = quat_to_rotmat(quat)
    return StateEstimate(
        position=position,
        v_world=v_world,
        v_body=_mv(R.transpose(-1, -2), v_world),
        quat=quat,
        rpy=quat_to_rpy(quat),
        R=R,
        omega_body=omega_body,
        omega_world=_mv(R, omega_body),
        a_world=_mv(R, a_body),
        contact_phase=contact_phase,
    )
