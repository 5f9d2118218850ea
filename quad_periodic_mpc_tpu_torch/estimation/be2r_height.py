"""be2r height estimator, the odometry-era KF variant (counterpart of
``quad_periodic_mpc_tpu/estimation/be2r_height.py``).

Re-implements be2rPositionVelocityEstimator.cpp (run(): offset calibration
over the first 500 ticks at :67-73, bias-corrected accel :79, simpleKalman
adaptive 1-D filters :82 (k = 1.0 on a_z) and :106 (k = 0.1 on v_z), double
integration z += v dt + a dt^2/2 at :107, heightBody output :110) as a pure
batched step function.

The reference's ``simpleKalman`` (:144-160) is a scalar adaptive filter
whose measurement-error estimate feeds back the innovation magnitude:

    g   = e / (e + r)
    est = est + g (x - est)
    e   = (1 - g) e + |est_new - est_old| * q,   q = dt

The C++ holds that filter's state in function-local statics, so the a_z
and v_z call sites share one (e, est) pair.  This keeps per-channel state
(the evident intent); ``shared_state=True`` in ``step`` reproduces the
shared storage for parity studies.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

CALIB_TICKS = 500  # be2rPositionVelocityEstimator.cpp:67


class SimpleKalman(NamedTuple):
    """State of the reference's adaptive scalar filter (est, err)."""

    est: torch.Tensor
    err: torch.Tensor


def simple_kalman(s: SimpleKalman, x: torch.Tensor, dt, k) -> tuple[SimpleKalman, torch.Tensor]:
    """One update of simpleKalman (be2rPositionVelocityEstimator.cpp:144)."""
    g = s.err / (s.err + k)
    est = s.est + g * (x - s.est)
    err = (1.0 - g) * s.err + torch.abs(est - s.est) * dt
    return SimpleKalman(est=est, err=err), est


class Be2rState(NamedTuple):
    count: torch.Tensor        # (...,) int32 calibration counter
    acc_offset: torch.Tensor   # (..., 3) summed world accel during calib
    vel_offset: torch.Tensor   # (...,) summed v_z during calib
    kf_acc: SimpleKalman       # a_z channel (k = 1.0)
    kf_vel: SimpleKalman       # v_z channel (k = 0.1)
    v_body_z: torch.Tensor     # integrated vertical velocity (diagnostic)
    z: torch.Tensor            # estimated body height


def init(batch: tuple = (), dtype=torch.float32, device="cuda") -> Be2rState:
    """setup() initial conditions: z = 0.056 (p_body init, :29/:42)."""
    zeros = lambda: torch.zeros(batch, dtype=dtype, device=device)

    def kf(k):
        # _err_estimate is initialized to _err_measure on first call (:151)
        return SimpleKalman(est=zeros(), err=torch.full(batch, k, dtype=dtype, device=device))

    return Be2rState(
        count=torch.zeros(batch, dtype=torch.int32, device=device),
        acc_offset=torch.zeros(batch + (3,), dtype=dtype, device=device),
        vel_offset=zeros(),
        kf_acc=kf(1.0),
        kf_vel=kf(0.1),
        v_body_z=zeros(),
        z=torch.full(batch, 0.056, dtype=dtype, device=device),
    )


def step(
    s: Be2rState,
    a_world: torch.Tensor,    # (..., 3) world-frame acceleration (with g removed)
    v_world_z: torch.Tensor,  # (...,) world-frame vertical velocity (e.g. leg odometry)
    dt: float = 0.002,
    shared_state: bool = False,
) -> Be2rState:
    """One 500 Hz tick.  Calibrating instances accumulate offsets; the rest
    run the filter + integrate pipeline.  Branch-free (where-masked), so
    mixed-phase batches are fine."""
    dtype, device = s.z.dtype, s.z.device
    a_world = a_world.to(dtype)
    v_world_z = torch.as_tensor(v_world_z, dtype=dtype, device=device)
    calibrating = s.count <= CALIB_TICKS
    cal = calibrating.to(dtype)

    acc_offset = s.acc_offset + cal[..., None] * a_world
    vel_offset = s.vel_offset + cal * v_world_z
    count = s.count + calibrating.to(torch.int32)

    a_z = a_world[..., 2] - acc_offset[..., 2] / CALIB_TICKS
    kf_acc, acc_z = simple_kalman(s.kf_acc, a_z, dt, 1.0)
    v_body_z = s.v_body_z + acc_z * dt

    vel_raw = v_world_z - vel_offset / CALIB_TICKS
    kf_vel_in = kf_acc if shared_state else s.kf_vel
    kf_vel, vel = simple_kalman(kf_vel_in, vel_raw, dt, 0.1)
    if shared_state:
        kf_acc = kf_vel
    z = s.z + vel * dt + 0.5 * acc_z * dt * dt

    sel = lambda new, old: torch.where(calibrating, old, new)
    return Be2rState(
        count=count,
        acc_offset=acc_offset,
        vel_offset=vel_offset,
        kf_acc=SimpleKalman(sel(kf_acc.est, s.kf_acc.est), sel(kf_acc.err, s.kf_acc.err)),
        kf_vel=SimpleKalman(sel(kf_vel.est, s.kf_vel.est), sel(kf_vel.err, s.kf_vel.err)),
        v_body_z=sel(v_body_z, s.v_body_z),
        z=sel(z, s.z),
    )
