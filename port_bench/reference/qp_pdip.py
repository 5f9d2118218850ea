"""Batched primal-dual interior-point QP solver (a frozen copy of the port's
``quad_periodic_mpc_tpu_torch/ops/qp_pdip.py``).

    min 1/2 x^T P x + q^T x   s.t.  l <= A x <= u,   A = blockdiag(F),

with two slack/dual pairs A x - l = sl, u - A x = su (all > 0) and a fixed
number of infeasible-start Newton steps.  Newton condensation gives
(P + A^T D A) dx = rhs with D = diag(zl/sl + zu/su): a block-diagonal bump
on P, solved per iteration by the Schur-recursion inverse plus one
refinement step (``kkt="spd"``, the form the WBC kernel takes).  It runs
for the WBIC relaxation QP (12 variables, 24 cone rows).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from port_bench.reference.config import PDIPConfig
from port_bench.reference import constraints as con
from port_bench.reference import linalg


class QPData(NamedTuple):
    """One batched QP instance set (leading batch dims shared)."""

    P: torch.Tensor        # (..., n, n)
    q: torch.Tensor        # (..., n)
    F: torch.Tensor        # (c, a) constraint block (shared)
    l: torch.Tensor        # (..., m) lower bounds
    u: torch.Tensor        # (..., m) upper bounds


class PDIPState(NamedTuple):
    x: torch.Tensor
    sl: torch.Tensor
    su: torch.Tensor
    zl: torch.Tensor
    zu: torch.Tensor


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _kkt_solve(qp: QPData, d: torch.Tensor, rhs: torch.Tensor, reg,
               kkt: str = "spd") -> torch.Tensor:
    """(P + A^T diag(d) A + reg I) \\ rhs using the block structure."""
    n = qp.P.shape[-1]
    batch = qp.P.shape[:-2]
    c, a = qp.F.shape[-2], qp.F.shape[-1]
    d_blocks = d.reshape(batch + (n // a, c))
    G = torch.einsum("ca,...kc,cb->...kab", qp.F, d_blocks, qp.F)
    K = qp.P + reg * torch.eye(n, dtype=qp.P.dtype, device=qp.P.device)
    K = linalg.add_block_diag(K, G)
    if kkt != "spd":
        raise ValueError(f"kkt={kkt!r}: the reference solves the WBC's spd form only")
    # explicit Schur inverse plus one refinement step: near the barrier
    # endgame cond(K) reaches ~1e8-1e10, and the residual correction
    # recovers the digits the f32 inverse loses
    Mi = linalg.spd_inverse(K)
    dx = _mv(Mi, rhs)
    return dx + _mv(Mi, rhs - _mv(K, dx))


def _max_step(v: torch.Tensor, dv: torch.Tensor, tau) -> torch.Tensor:
    """Largest alpha in (0, 1] with v + alpha dv >= (1 - tau) v."""
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                        torch.full_like(v, float("inf")))
    return torch.clamp(tau * ratio.amin(-1), max=1.0)


def solve(qp: QPData, cfg: PDIPConfig) -> tuple[torch.Tensor, PDIPState]:
    """Fixed-iteration infeasible primal-dual IPM; returns (x, state)."""
    dtype, device = qp.P.dtype, qp.P.device
    batch = qp.q.shape[:-1]
    n, m = qp.q.shape[-1], qp.l.shape[-1]
    # keep never-active "infinite" bounds finite, and open degenerate l == u
    # rows (swing-foot fz in [0, 0]) by a hair so an interior path exists
    u_eff = torch.clamp(qp.u, max=cfg.big_clamp)
    u_eff = torch.where(u_eff - qp.l < 1e-6, qp.l + 1e-6, u_eff)
    qp = qp._replace(u=u_eff)
    one = torch.ones(batch + (m,), dtype=dtype, device=device)
    x = torch.zeros(batch + (n,), dtype=dtype, device=device)
    sl, su, zl, zu = one, one, one, one
    floor = cfg.slack_floor
    for _ in range(cfg.iterations):
        sl, su = torch.clamp(sl, min=floor), torch.clamp(su, min=floor)
        zl, zu = torch.clamp(zl, min=floor), torch.clamp(zu, min=floor)
        ax = con.apply(qp.F, x)
        r_dual = _mv(qp.P, x) + qp.q - con.apply_T(qp.F, zl - zu)
        r_pl = sl - (ax - qp.l)
        r_pu = su - (qp.u - ax)
        mu = ((sl * zl).sum(-1) + (su * zu).sum(-1)) / (2 * m)
        mu_target = torch.clamp(0.1 * mu, min=cfg.mu_min)
        r_cl = sl * zl - mu_target[..., None]
        r_cu = su * zu - mu_target[..., None]
        d = zl / sl + zu / su
        rhs = (-r_dual - con.apply_T(qp.F, (r_cl - zl * r_pl) / sl)
               + con.apply_T(qp.F, (r_cu - zu * r_pu) / su))
        dx = _kkt_solve(qp, d, rhs, cfg.reg, cfg.kkt)
        adx = con.apply(qp.F, dx)
        dsl = adx - r_pl
        dsu = -adx - r_pu
        dzl = -(r_cl + zl * dsl) / sl
        dzu = -(r_cu + zu * dsu) / su
        a = torch.minimum(
            torch.minimum(_max_step(sl, dsl, cfg.tau), _max_step(su, dsu, cfg.tau)),
            torch.minimum(_max_step(zl, dzl, cfg.tau), _max_step(zu, dzu, cfg.tau)),
        )[..., None]
        # late-path NaN freeze: an instance whose Newton step is not finite
        # (f32 KKT near exact complementarity) keeps its current iterate
        finite = (torch.isfinite(dx).all(-1) & torch.isfinite(dsl).all(-1)
                  & torch.isfinite(dsu).all(-1) & torch.isfinite(dzl).all(-1)
                  & torch.isfinite(dzu).all(-1))[..., None]
        zero = torch.zeros((), dtype=dtype, device=device)
        a = torch.where(finite, a, zero)
        x = x + a * torch.where(finite, dx, zero)
        sl = sl + a * torch.where(finite, dsl, zero)
        su = su + a * torch.where(finite, dsu, zero)
        zl = zl + a * torch.where(finite, dzl, zero)
        zu = zu + a * torch.where(finite, dzu, zero)
    final = PDIPState(x=x, sl=sl, su=su, zl=zl, zu=zu)
    return final.x, final
