"""Stage-wise (sparse) MPC problem and its KKT audit
(counterpart of ``quad_periodic_mpc_tpu/ops/qp_stagewise.py``).

    min  sum_k 1/2 (x_k - xref_k)^T Qs (x_k - xref_k) + 1/2 u_k^T Rs u_k
    s.t. x_{k+1} = Ad x_k + Bd u_k + c,   l <= F u_k <= u.

The solve itself runs in the fused kernel (ops/cuda/stagewise_kernel.py).
The reference's non-fused solve (associative-scan Riccati) is not ported
yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

NX = 13
NU = 12

# NS rounds for the factorization's Quu^{-1}: the spectral budget grows
# with log2(h / 16) (reference module note at NS_COMBINE_ITERS)
NS_COMBINE_ITERS = 16


def ns_combine_iters(h: int) -> int:
    """Horizon-scaled NS round budget for the factorization inverses."""
    return NS_COMBINE_ITERS + 2 * max(0, math.ceil(math.log2(max(h, 16) / 16)))


class StagewiseProblem(NamedTuple):
    Ad: torch.Tensor      # (..., 13, 13) discrete dynamics (time-invariant)
    Bd: torch.Tensor      # (..., 13, 12)
    c: torch.Tensor       # (..., 13) affine term (Qd @ f_est)
    x0: torch.Tensor      # (..., 13)
    x_ref: torch.Tensor   # (..., h, 13)
    Q: torch.Tensor       # (13,) stage state cost diagonal
    R: torch.Tensor       # (12,) input cost diagonal
    F: torch.Tensor       # (5, 3) pyramid block
    l: torch.Tensor       # (..., h, 20)
    u: torch.Tensor       # (..., h, 20)


def kkt_residuals(
    prob: StagewiseProblem,
    U: torch.Tensor,        # (..., h, 12)
    z: torch.Tensor,        # (..., h, 20)
    y: torch.Tensor,        # (..., h, 20)
) -> dict[str, torch.Tensor]:
    """Per-instance primal / dual / feasibility residual norms.

    grad_k = R u_k + Bd' mu_{k+1}, with the costate recursion
    mu_k = Q (x_k - xref_{k-1}) + Ad' mu_{k+1} over the rolled-out states;
    primal = max |F u - z|, dual = max |grad + F' y|.
    """
    if prob.c.ndim != prob.x0.ndim:
        raise NotImplementedError(
            "per-step affine terms (predictive estimator) are not ported "
            "yet, see ROADMAP.md Queue 1")
    h = U.shape[-2]
    batch = prob.x0.shape[:-1]
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    Ad = torch.broadcast_to(prob.Ad, batch + (NX, NX))
    Bd = torch.broadcast_to(prob.Bd, batch + (NX, NU))
    c = torch.broadcast_to(prob.c, batch + (NX,))
    U = torch.broadcast_to(U, batch + (h, NU))

    xs = []
    x = prob.x0
    for k in range(h):
        x = mv(Ad, x) + mv(Bd, U[..., k, :]) + c
        xs.append(x)                                        # x_1 .. x_h
    xref = torch.broadcast_to(prob.x_ref, batch + (h, NX))
    AdT = Ad.transpose(-1, -2)
    BdT = Bd.transpose(-1, -2)
    mu = torch.zeros(batch + (NX,), dtype=U.dtype, device=U.device)
    grad_u = [None] * h
    for k in reversed(range(h)):
        mu = prob.Q * (xs[k] - xref[..., k, :]) + mv(AdT, mu)   # mu_{k+1}
        grad_u[k] = prob.R * U[..., k, :] + mv(BdT, mu)
    grad_u = torch.stack(grad_u, dim=-2)                    # (..., h, 12)

    F = prob.F
    ax = (U.reshape(batch + (h, 4, 1, 3)) * F).sum(-1).reshape(batch + (h, 20))
    fty = (y.reshape(batch + (h, 4, 5, 1)) * F).sum(-2).reshape(batch + (h, 12))
    r_prim = torch.abs(ax - z).amax(dim=(-1, -2))
    r_dual = torch.abs(grad_u + fty).amax(dim=(-1, -2))
    viol = torch.maximum(ax - prob.u, prob.l - ax)
    r_feas = torch.clamp(viol, min=0.0).amax(dim=(-1, -2))
    return {"primal": r_prim, "dual": r_dual, "feas": r_feas}
