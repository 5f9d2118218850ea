"""Q_d-augmented zero-order-hold discretization, closed form
(counterpart of ``quad_periodic_mpc_tpu/ops/discretize.py``).

The SRB A matrix is nilpotent with A^3 = 0 (models/srb.py), so the
reference's 31x31 augmented matrix exponential (c2qp, SolverMPC.cpp:96-146)
reduces exactly to

    Adt = I + dt A + dt^2/2 A^2,   Phi = dt I + dt^2/2 A + dt^3/6 A^2,
    Bdt = Phi B,   Qdt = Phi Qc.

``zoh_via_expm`` is the generic augmented-matrix form through
``torch.linalg.matrix_exp``, the verification path.
"""

from __future__ import annotations

import torch
from quad_periodic_mpc_tpu_torch.utils.consts import const


def nilpotent_zoh(
    A: torch.Tensor,
    B: torch.Tensor,
    Qc: torch.Tensor,
    dt,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact ZOH discretization for A with A^3 = 0; dt scalar or (...,)."""
    dt = const(dt, A.dtype, A.device)
    dt1 = dt[..., None, None] if dt.ndim else dt
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    A2 = A @ A
    Adt = eye + dt1 * A + (dt1 * dt1 / 2.0) * A2
    Phi = dt1 * eye + (dt1 * dt1 / 2.0) * A + (dt1 * dt1 * dt1 / 6.0) * A2
    return Adt, Phi @ B, Phi @ Qc


def zoh_via_expm(
    A: torch.Tensor,
    B: torch.Tensor,
    Qc: torch.Tensor,
    dt: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Generic augmented-matrix ZOH through the matrix exponential
    (verification path): the reference's 31x31 exp([A B Q; 0]) construction
    (SolverMPC.cpp:96-107) for any A.  Not for the hot path."""
    n, m, w = A.shape[-1], B.shape[-1], Qc.shape[-1]
    batch = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2], Qc.shape[:-2])
    aug = torch.zeros(batch + (n + m + w, n + m + w), dtype=A.dtype, device=A.device)
    aug[..., :n, :n] = A
    aug[..., :n, n:n + m] = B
    aug[..., :n, n + m:] = Qc
    e = torch.linalg.matrix_exp(dt * aug)
    return e[..., :n, :n], e[..., :n, n:n + m], e[..., :n, n + m:]
