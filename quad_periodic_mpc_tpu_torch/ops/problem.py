"""MPC problem assembly: robot state -> stagewise problem
(counterpart of ``quad_periodic_mpc_tpu/ops/problem.py``).

Only the stagewise build is ported.  ``control/mpc.mpc_step`` solves on it
wherever the fused-build kernel does not apply (a predictive disturbance
horizon, h > 64, float64, ``backend="xla"``), and audits the fused-build
solve against it (``return_qp``).  The condensed build is not ported yet
(ROADMAP.md Queue 1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quad_periodic_mpc_tpu_torch.config import MPCConfig
from quad_periodic_mpc_tpu_torch.models import srb
from quad_periodic_mpc_tpu_torch.ops import condense, constraints, discretize
from quad_periodic_mpc_tpu_torch.ops.qp_stagewise import StagewiseProblem
from quad_periodic_mpc_tpu_torch.ops.rotations import quat_to_rotmat, quat_to_rpy


class RobotObs(NamedTuple):
    """Observation fed to the MPC each solve (update_data_t analog)."""

    p: torch.Tensor          # (..., 3) CoM position, world
    v: torch.Tensor          # (..., 3) CoM velocity, world
    quat: torch.Tensor       # (..., 4) orientation (w, x, y, z)
    omega: torch.Tensor      # (..., 3) angular velocity, world
    r_feet: torch.Tensor     # (..., 4, 3) foot pos relative to CoM, world


def build_stagewise(
    obs: RobotObs,
    x_ref: torch.Tensor,
    gait_table: torch.Tensor,
    cfg: MPCConfig,
    f_est: torch.Tensor | None = None,
    x_drag=0.0,
    f_est_steps: torch.Tensor | None = None,
) -> tuple[StagewiseProblem, torch.Tensor]:
    """Assemble the stage-wise problem independently of the fused kernel's
    in-kernel build: ct_dynamics + nilpotent ZOH, c = Qd f_est, stage
    weights Qs = 2 diag(w13), Rs = 2 alpha I, pyramid bounds with the
    upper bound clamped at 1e4.  ``f_est_steps`` (..., h, 6), the per-step
    wrench prediction, gives a per-step affine term c_k = Qd f_k of shape
    (..., h, 13) instead.  Returns (problem, x0)."""
    h = cfg.horizon
    dtype, device = obs.p.dtype, obs.p.device
    R = quat_to_rotmat(obs.quat)
    rpy = quat_to_rpy(obs.quat)
    x0 = srb.pack_state(rpy, obs.p, obs.omega, obs.v, cfg.gravity)

    A_ct, B_ct, Q_ct = srb.ct_dynamics(
        R, obs.r_feet, cfg.mass, cfg.inertia_body, x_drag)
    Adt, Bdt, Qdt = discretize.nilpotent_zoh(A_ct, B_ct, Q_ct, cfg.dt_mpc)
    if f_est_steps is not None:
        c = torch.einsum("...nw,...hw->...hn", Qdt, f_est_steps)
    else:
        if f_est is None:
            f_est = torch.zeros(x0.shape[:-1] + (6,), dtype=dtype, device=device)
        c = (Qdt @ f_est[..., None])[..., 0]

    weights = torch.as_tensor(cfg.weights, dtype=dtype, device=device)
    l, u = constraints.bounds(gait_table, cfg.f_max, cfg.big_number, dtype)
    batch = l.shape[:-3]
    sw = StagewiseProblem(
        Ad=Adt, Bd=Bdt, c=c, x0=x0, x_ref=x_ref,
        Q=2.0 * condense.full_weight(weights),
        R=2.0 * cfg.alpha * torch.ones(12, dtype=dtype, device=device),
        F=constraints.pyramid_block(cfg.mu, dtype, device),
        l=l.reshape(batch + (h, 20)),
        u=torch.clamp(u, max=1e4).reshape(batch + (h, 20)),
    )
    return sw, x0
