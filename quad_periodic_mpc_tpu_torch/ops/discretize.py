"""Q_d-augmented zero-order-hold discretization, closed form
(counterpart of ``quad_periodic_mpc_tpu/ops/discretize.py``).

The SRB A matrix is nilpotent with A^3 = 0 (models/srb.py), so the
reference's 31x31 augmented matrix exponential (c2qp, SolverMPC.cpp:96-146)
reduces exactly to

    Adt = I + dt A + dt^2/2 A^2,   Phi = dt I + dt^2/2 A + dt^3/6 A^2,
    Bdt = Phi B,   Qdt = Phi Qc.

The generic expm variant is not ported; ``torch.linalg.matrix_exp`` serves
as the oracle in the tests.
"""

from __future__ import annotations

import torch


def nilpotent_zoh(
    A: torch.Tensor,
    B: torch.Tensor,
    Qc: torch.Tensor,
    dt,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact ZOH discretization for A with A^3 = 0; dt scalar or (...,)."""
    dt = torch.as_tensor(dt, dtype=A.dtype, device=A.device)
    dt1 = dt[..., None, None] if dt.ndim else dt
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    A2 = A @ A
    Adt = eye + dt1 * A + (dt1 * dt1 / 2.0) * A2
    Phi = dt1 * eye + (dt1 * dt1 / 2.0) * A + (dt1 * dt1 * dt1 / 6.0) * A2
    return Adt, Phi @ B, Phi @ Qc
