"""Horizon condensation and QP cost assembly, closed form (counterpart of
``quad_periodic_mpc_tpu/ops/condense.py``).

The reference condenses the discrete dynamics into dense prediction
matrices by a sequential power iteration (c2qp, SolverMPC.cpp:118-139):

    A_qp[13r:13r+13, :]        = Adt^(r+1)
    B_qp[13r:.., 12c:..]       = Adt^(r-c) @ Bdt      (r >= c)
    Q_qp[13r:.., :]            = sum_{a<=r} Adt^a @ Qdt

and assembles the QP cost (SolverMPC.cpp:806-814):

    qH = 2 (B_qp^T S B_qp + alpha I)
    qg = 2  B_qp^T S (A_qp x0 + Q_qp f_est - X_d)

Adt = I + N with N = dt A + dt^2/2 A^2 nilpotent (N^3 = 0, models/srb.py),
so matrix powers collapse to

    Adt^k            = I + k N + C(k,2) N^2
    sum_{a<=r} Adt^a = (r+1) I + C(r+1,2) N + C(r+1,3) N^2

and every prediction block is a combination of {X0, X1, X2} = {Bdt, N Bdt,
N^2 Bdt} with integer coefficient tables that depend only on the horizon:

    B_qp = L0 (x) X0 + L1 (x) X1 + L2 (x) X2        ((x) = Kronecker)

Because S = I_h (x) diag(w13), the Gram matrix factors exactly:

    B_qp^T S B_qp = sum_{i,j} (Li^T Lj) (x) (Xi^T W Xj)

nine 12x13 @ 13x12 products plus an h^2-coefficient broadcast.  The
materialized path is kept for verification.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

NX = 13
NU = 12
NW = 6


class CoeffTables(NamedTuple):
    """Horizon-dependent integer coefficient tables (host-precomputed)."""

    a_pow: np.ndarray    # (3, h) coefficients of Adt^(r+1) = c0 I + c1 N + c2 N^2
    L: np.ndarray        # (3, h, h) L_i[r, c] = coeff of N^i in Adt^(r-c), r >= c
    q_sum: np.ndarray    # (3, h) coefficients of sum_{a<=r} Adt^a
    gram: np.ndarray     # (3, 3, h, h) G[i, j] = L_i^T @ L_j


@functools.lru_cache(maxsize=32)
def coeff_tables(horizon: int) -> CoeffTables:
    k = np.arange(horizon + 1, dtype=np.float64)
    c0 = np.ones_like(k)
    c1 = k
    c2 = k * (k - 1) / 2.0
    a_pow = np.stack([c0[1:], c1[1:], c2[1:]])            # powers 1..h

    L = np.zeros((3, horizon, horizon))
    d = np.arange(horizon)[:, None] - np.arange(horizon)[None, :]
    mask = d >= 0
    dd = np.where(mask, d, 0).astype(np.float64)
    L[0] = mask.astype(np.float64)
    L[1] = np.where(mask, dd, 0.0)
    L[2] = np.where(mask, dd * (dd - 1) / 2.0, 0.0)

    rr = np.arange(1, horizon + 1, dtype=np.float64)      # r+1 for r=0..h-1
    q_sum = np.stack([rr, rr * (rr - 1) / 2.0, rr * (rr - 1) * (rr - 2) / 6.0])
    gram = np.einsum("irc,jrk->ijck", L, L)
    return CoeffTables(a_pow=a_pow, L=L, q_sum=q_sum, gram=gram)


def _table(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _n_matrices(A: torch.Tensor, dt) -> tuple[torch.Tensor, torch.Tensor]:
    """N = dt A + dt^2/2 A^2 and N^2 = dt^2 A^2 (using A^3 = 0)."""
    dt = torch.as_tensor(dt, dtype=A.dtype, device=A.device)
    d1 = dt[..., None, None] if dt.ndim else dt
    A2 = A @ A
    return d1 * A + (d1 * d1 / 2.0) * A2, d1 * d1 * A2


class Prediction(NamedTuple):
    """Structured prediction operator.

    Xu[i] = N^i @ Bdt  (..., 3, 13, 12): input response basis
    Xw[i] = N^i @ Qdt  (..., 3, 13, 6):  disturbance response basis
    N, N2: nilpotent parts of Adt (for the state response)
    Adt, Bdt, Qdt: one-step discrete matrices
    """

    Xu: torch.Tensor
    Xw: torch.Tensor
    N: torch.Tensor
    N2: torch.Tensor
    Adt: torch.Tensor
    Bdt: torch.Tensor
    Qdt: torch.Tensor


def build_prediction(A: torch.Tensor, B: torch.Tensor, Qc: torch.Tensor, dt) -> Prediction:
    """Discretize (closed form) and precompute the response bases."""
    dtype, device = A.dtype, A.device
    dt = torch.as_tensor(dt, dtype=dtype, device=device)
    d1 = dt[..., None, None] if dt.ndim else dt
    N, N2 = _n_matrices(A, dt)
    eye = torch.eye(NX, dtype=dtype, device=device)
    Adt = eye + N
    # Phi = dt I + dt^2/2 A + dt^3/6 A^2 (exact integral of exp(As))
    Phi = d1 * eye + (d1 * d1 / 2.0) * A + (d1 * d1 * d1 / 6.0) * (A @ A)
    Bdt = Phi @ B
    Qdt = Phi @ Qc
    Xu = torch.stack([Bdt, N @ Bdt, N2 @ Bdt], dim=-3)
    Xw = torch.stack([Qdt, N @ Qdt, N2 @ Qdt], dim=-3)
    return Prediction(Xu=Xu, Xw=Xw, N=N, N2=N2, Adt=Adt, Bdt=Bdt, Qdt=Qdt)


def state_response(pred: Prediction, x0: torch.Tensor, horizon: int) -> torch.Tensor:
    """A_qp @ x0 without materializing A_qp: (..., h, 13).  Row r is
    Adt^(r+1) x0 = x0 + (r+1) N x0 + C(r+1,2) N^2 x0."""
    coef = _table(coeff_tables(horizon).a_pow, x0)         # (3, h)
    nx0 = (pred.N @ x0[..., None])[..., 0]
    n2x0 = (pred.N2 @ x0[..., None])[..., 0]
    basis = torch.stack([x0, nx0, n2x0], dim=-2)           # (..., 3, 13)
    return torch.einsum("kh,...kn->...hn", coef, basis)


def disturbance_response(pred: Prediction, f_est: torch.Tensor, horizon: int) -> torch.Tensor:
    """Q_qp @ f_est without materializing Q_qp: (..., h, 13)."""
    coef = _table(coeff_tables(horizon).q_sum, f_est)      # (3, h)
    bw = torch.einsum("...knw,...w->...kn", pred.Xw, f_est)
    return torch.einsum("kh,...kn->...hn", coef, bw)


def disturbance_response_timevarying(
    pred: Prediction, w_steps: torch.Tensor, horizon: int
) -> torch.Tensor:
    """Response to a per-step disturbance sequence w_steps (..., h, 6):

        row r = sum_{c<=r} Adt^{r-c} Qdt w_c = sum_i sum_c L_i[r, c] (N^i Qdt) w_c

    (the Toeplitz tables of B_qp).  Returns (..., h, 13)."""
    L = _table(coeff_tables(horizon).L, w_steps)           # (3, h, h)
    xww = torch.einsum("...inw,...cw->...icn", pred.Xw, w_steps)
    return torch.einsum("irc,...icn->...rn", L, xww)


def materialize_B_qp(pred: Prediction, horizon: int) -> torch.Tensor:
    """Dense B_qp (..., 13h, 12h): verification path."""
    L = _table(coeff_tables(horizon).L, pred.Xu)
    blocks = torch.einsum("krc,...knm->...rncm", L, pred.Xu)
    return blocks.reshape(blocks.shape[:-4] + (horizon * NX, horizon * NU))


def materialize_A_qp(pred: Prediction, horizon: int) -> torch.Tensor:
    """Dense A_qp (..., 13h, 13): verification path."""
    coef = _table(coeff_tables(horizon).a_pow, pred.N)
    eye = torch.eye(NX, dtype=pred.N.dtype, device=pred.N.device)
    basis = torch.stack([eye.expand(pred.N.shape), pred.N, pred.N2], dim=-3)
    rows = torch.einsum("kh,...knm->...hnm", coef, basis)
    return rows.reshape(rows.shape[:-3] + (horizon * NX, NX))


def materialize_Q_qp(pred: Prediction, horizon: int) -> torch.Tensor:
    """Dense Q_qp (..., 13h, 6): verification path."""
    coef = _table(coeff_tables(horizon).q_sum, pred.Xw)
    rows = torch.einsum("kh,...knw->...hnw", coef, pred.Xw)
    return rows.reshape(rows.shape[:-3] + (horizon * NX, NW))


def full_weight(weights12: torch.Tensor) -> torch.Tensor:
    """13-entry stage weight: 12 tracked states + 0 on the gravity state
    (SolverMPC.cpp:624-630)."""
    zero = torch.zeros(weights12.shape[:-1] + (1,), dtype=weights12.dtype,
                       device=weights12.device)
    return torch.cat([weights12, zero], dim=-1)


def cost_hessian(pred: Prediction, weights12: torch.Tensor, alpha, horizon: int) -> torch.Tensor:
    """qH = 2 (B_qp^T S B_qp + alpha I), (..., 12h, 12h), by the Kronecker
    factorization B_qp^T S B_qp = sum_ij gram[i,j] (x) (Xu_i^T W Xu_j)."""
    w13 = full_weight(weights12)
    gram = _table(coeff_tables(horizon).gram, pred.Xu)     # (3, 3, h, h)
    WX = w13[..., None, :, None] * pred.Xu                 # (..., 3, 13, 12)
    M = torch.einsum("...ina,...jnb->...ijab", pred.Xu, WX)
    # block (r, c) = sum_ij gram[i,j,r,c] * M[i,j]; rows (r, a), cols (c, b)
    H = torch.einsum("ijrc,...ijab->...racb", gram, M)
    H = H.reshape(H.shape[:-4] + (horizon * NU, horizon * NU))
    eye = torch.eye(horizon * NU, dtype=H.dtype, device=H.device)
    alpha = torch.as_tensor(alpha, dtype=H.dtype, device=H.device)
    a1 = alpha[..., None, None] if alpha.ndim else alpha
    return 2.0 * (H + a1 * eye)


def cost_gradient(
    pred: Prediction,
    weights12: torch.Tensor,
    x0: torch.Tensor,
    x_ref: torch.Tensor,
    f_est: torch.Tensor,
    horizon: int,
    f_est_steps: torch.Tensor | None = None,
) -> torch.Tensor:
    """qg = 2 B_qp^T S (A_qp x0 + Q_qp f_est - X_d), (..., 12h).  x_ref is
    (..., h, 13) with the last column zero; f_est_steps (..., h, 6), when
    given, replaces the constant f_est by the time-varying response."""
    if f_est_steps is not None:
        dist = disturbance_response_timevarying(pred, f_est_steps, horizon)
    else:
        dist = disturbance_response(pred, f_est, horizon)
    y = state_response(pred, x0, horizon) + dist - x_ref    # (..., h, 13)
    wy = full_weight(weights12)[..., None, :] * y
    L = _table(coeff_tables(horizon).L, y)                  # (3, h, h)
    # g_c = sum_i Xu_i^T sum_r L_i[r, c] wy_r
    z = torch.einsum("irc,...rn->...icn", L, wy)            # (..., 3, h, 13)
    g = torch.einsum("...ina,...ihn->...ha", pred.Xu, z)    # (..., h, 12)
    return 2.0 * g.reshape(g.shape[:-2] + (horizon * NU,))


def cost_naive(
    pred: Prediction,
    weights12: torch.Tensor,
    alpha,
    x0: torch.Tensor,
    x_ref: torch.Tensor,
    f_est: torch.Tensor,
    horizon: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Materialized-B_qp cost assembly (verification path, mirrors
    SolverMPC.cpp:806-814 literally)."""
    B_qp = materialize_B_qp(pred, horizon)
    A_qp = materialize_A_qp(pred, horizon)
    Q_qp = materialize_Q_qp(pred, horizon)
    s_diag = full_weight(weights12).repeat(horizon)
    SB = s_diag[..., :, None] * B_qp
    eye = torch.eye(horizon * NU, dtype=B_qp.dtype, device=B_qp.device)
    H = 2.0 * (B_qp.transpose(-1, -2) @ SB + alpha * eye)
    batch = B_qp.shape[:-2]
    y = ((A_qp @ x0[..., None])[..., 0] + (Q_qp @ f_est[..., None])[..., 0]
         - x_ref.reshape(batch + (horizon * NX,)))
    g = 2.0 * torch.einsum("...nm,...n->...m", SB, y)
    return H, g
