"""Structure-preserving Ruiz equilibration for the condensed MPC QP
(counterpart of ``quad_periodic_mpc_tpu/ops/equilibrate.py``).

General diagonal scaling would destroy the property the solver lives on: the
constraint matrix is I_{4h} (x) F with one shared 5x3 block.  The scaling is
therefore restricted to block scalars: D = diag(d_k I_3),
E = diag(d_k^{-1} I_5) per foot-step block k.  Then

    E (I (x) F) D = I (x) F        (exactly invariant)

and only P, q, l, u change: P~ = D P D, q~ = D q, l~ = E l, u~ = E u,
x = D x~, y = E^{-1} y~.  Ruiz iteration on the block inf-norms of P
equalizes the cost curvature across foot-steps.  The scaled problem is
solved by the unmodified ``qp_admm.solve``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quad_periodic_mpc_tpu_torch.config import ADMMConfig
from quad_periodic_mpc_tpu_torch.ops import qp_admm


class Scaling(NamedTuple):
    d: torch.Tensor       # (..., k) per-block scalar
    d_x: torch.Tensor     # (..., n) expanded to variables
    d_z: torch.Tensor     # (..., m) expanded to constraint rows (= 1/d)


def compute(qp: qp_admm.QPData, iters: int = 3) -> Scaling:
    """Block-scalar modified Ruiz on P: d_k <- d_k / sqrt(s_k) with s_k the
    inf-norm over rows of block k of the scaled P."""
    n = qp.P.shape[-1]
    c, a = qp.F.shape[-2], qp.F.shape[-1]
    k = n // a
    batch = qp.P.shape[:-2]

    d = torch.ones(batch + (k,), dtype=qp.P.dtype, device=qp.P.device)
    for _ in range(iters):
        dx = d.repeat_interleave(a, dim=-1)
        Ps = dx[..., :, None] * qp.P * dx[..., None, :]
        rownorm = Ps.abs().sum(-1)                               # (..., n)
        s = rownorm.reshape(batch + (k, a)).amax(-1)             # (..., k)
        d = d / torch.sqrt(torch.clamp(s, min=1e-12))
    return Scaling(d=d, d_x=d.repeat_interleave(a, dim=-1),
                   d_z=(1.0 / d).repeat_interleave(c, dim=-1))


def scale(qp: qp_admm.QPData, s: Scaling) -> qp_admm.QPData:
    return qp_admm.QPData(
        P=s.d_x[..., :, None] * qp.P * s.d_x[..., None, :],
        q=s.d_x * qp.q,
        F=qp.F,
        l=s.d_z * qp.l,
        u=s.d_z * qp.u,
    )


def solve(
    qp: qp_admm.QPData,
    cfg: ADMMConfig,
    warm: qp_admm.ADMMState | None = None,
    ruiz_iters: int = 3,
) -> tuple[torch.Tensor, qp_admm.ADMMState]:
    """Equilibrated ADMM solve; drop-in for ``qp_admm.solve``.  The returned
    warm state lives in the original coordinates and is re-scaled on entry;
    the carried K^{-1} is in the scaled coordinates of the current scaling,
    which drifts as slowly as P does between consecutive periods."""
    s = compute(qp, ruiz_iters)
    if warm is not None:
        warm = qp_admm.ADMMState(
            x=warm.x / s.d_x, z=s.d_z * warm.z, y=warm.y / s.d_z, kinv=warm.kinv)
    x_s, st = qp_admm.solve(scale(qp, s), cfg, warm)
    x = s.d_x * x_s
    return x, qp_admm.ADMMState(x=x, z=st.z / s.d_z, y=s.d_z * st.y, kinv=st.kinv)
