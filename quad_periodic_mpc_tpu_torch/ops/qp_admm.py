"""Batched OSQP-style ADMM for the condensed MPC QP (counterpart of
``quad_periodic_mpc_tpu/ops/qp_admm.py``).

Problem:   min 1/2 x^T P x + q^T x   s.t.  l <= A x <= u
with A = I_{4h} (x) F (block friction pyramid, ops/constraints.py).

Iteration (OSQP, with over-relaxation alpha), a fixed count of them:

    x~ = K^{-1} (sigma x - q + A^T (rho z - y))     K = P + sigma I + A^T rho A
    x+ = alpha x~ + (1 - alpha) x
    z~ = A x~
    zr = alpha z~ + (1 - alpha) z
    z+ = clip(zr + y / rho, l, u)
    y+ = y + rho (zr - z+)

- A^T rho A is block-diagonal with 3x3 blocks F^T diag(rho_5) F, so K is P
  plus a block-diagonal bump.
- K^{-1} is computed once per problem (Cholesky, or Newton-Schulz warm
  started from the previous period's inverse); every iteration is then one
  matrix-vector product plus elementwise work.  ``backend="pallas"`` runs
  all iterations in one fused kernel with K^{-1} held on chip
  (``ops/cuda/admm_kernel.fused_admm_iterations``; its plain version for CPU
  tensors), ``backend="xla"`` as a loop of PyTorch operations.
- rho per constraint type mirrors OSQP: with ``eq_mode="woodbury"`` rows
  with l == u (swing-foot fz in [0, 0]) get rho * eq_scale.

``ADMMConfig.iter_precision`` and ``ns_bucket_precision`` choose bf16 passes
on a TPU's matrix unit; every product here is a full float32 (or float64)
product and both are accepted and ignored (see ``ops/linalg.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quad_periodic_mpc_tpu_torch.config import ADMMConfig
from quad_periodic_mpc_tpu_torch.ops import constraints as con
from quad_periodic_mpc_tpu_torch.ops import linalg


class QPData(NamedTuple):
    """One batched QP instance set (leading batch dims shared)."""

    P: torch.Tensor        # (..., n, n)
    q: torch.Tensor        # (..., n)
    F: torch.Tensor        # (c, a) constraint block (shared)
    l: torch.Tensor        # (..., m) lower bounds
    u: torch.Tensor        # (..., m) upper bounds


class ADMMState(NamedTuple):
    x: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor
    # Carried inverse for Newton-Schulz warm starts: with kkt="ns" the
    # uniform-rho base inverse K0^{-1}, with "cholesky" the full K^{-1}
    # (unused for warm starts there).
    kinv: torch.Tensor | None = None


def rho_vector(l: torch.Tensor, u: torch.Tensor, cfg: ADMMConfig) -> torch.Tensor:
    """Per-constraint rho: rho * eq_scale where l == u (OSQP convention)."""
    eq = torch.abs(u - l) < 1e-9
    return torch.where(eq, torch.full_like(l, cfg.rho * cfg.eq_scale),
                       torch.full_like(l, cfg.rho))


def build_kkt_uniform(qp: QPData, cfg: ADMMConfig) -> torch.Tensor:
    """K = P + sigma I + rho blockdiag(F^T F) for uniform rho: the bump is
    one constant (n, n) matrix shared by every instance."""
    n = qp.P.shape[-1]
    a = qp.F.shape[-1]
    G = cfg.rho * (qp.F.T @ qp.F)
    C = cfg.sigma * torch.eye(n, dtype=qp.P.dtype, device=qp.P.device)
    C = linalg.add_block_diag(C, G.expand((n // a,) + G.shape))
    return qp.P + C


def build_kkt(qp: QPData, rho: torch.Tensor, cfg: ADMMConfig) -> torch.Tensor:
    """K = P + sigma I + A^T diag(rho) A, with A^T diag(rho) A =
    blockdiag_k(F^T diag(rho_k) F), one 3x3 block per foot-step k."""
    n = qp.P.shape[-1]
    batch = qp.P.shape[:-2]
    k = n // qp.F.shape[-1]
    rho_blocks = rho.reshape(batch + (k, qp.F.shape[-2]))
    G = torch.einsum("ca,...kc,cb->...kab", qp.F, rho_blocks, qp.F)
    K = qp.P + cfg.sigma * torch.eye(n, dtype=qp.P.dtype, device=qp.P.device)
    return linalg.add_block_diag(K, G)


def build_kkt_inverse(qp: QPData, rho: torch.Tensor, cfg: ADMMConfig) -> torch.Tensor:
    """K^{-1} via the configured backend (see ADMMConfig.kkt)."""
    K = build_kkt(qp, rho, cfg)
    if cfg.kkt == "ns":
        return linalg.ns_inverse(K, cfg.ns_iters, polish=cfg.ns_polish)
    return linalg.cho_inverse(linalg.cholesky_factor(K))


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def solve(qp: QPData, cfg: ADMMConfig,
          warm: ADMMState | None = None) -> tuple[torch.Tensor, ADMMState]:
    """Run cfg.iterations fixed ADMM steps; returns (x, final state), on
    the device of ``qp``.

    eq_mode "uniform" is plain rho everywhere (tuned for the warm-started
    loop, whose carried y already holds the swing-pin duals); "woodbury" is
    the bounds-based eq-scaled rho, restored exactly by a low-rank
    correction (faster pinning on cold one-shot solves).  With kkt="ns",
    warm.kinv carries the previous MPC step's uniform-rho base inverse
    K0^{-1}: K0 drifts only with P, never with the gait table, so the seed
    stays contractive across stance<->swing flips.
    """
    if cfg.eq_mode == "uniform":
        rho = torch.full_like(qp.l, cfg.rho)
    else:
        rho = rho_vector(qp.l, qp.u, cfg)
    need_K = cfg.kkt != "ns" or cfg.refine
    K = build_kkt(qp, rho, cfg) if need_K else None
    if cfg.kkt != "ns":
        K_inv = linalg.cho_inverse(linalg.cholesky_factor(K))
        kinv_carry = K_inv
    elif cfg.eq_mode == "woodbury":
        K_inv, kinv_carry = _kkt_inverse_woodbury(qp, rho, cfg, warm)
    else:
        K0 = K if need_K else build_kkt_uniform(qp, cfg)
        # the bucket's top-k gather needs a flat batch
        if cfg.ns_escalate == "bucket" and warm is not None and K0.ndim >= 3:
            n = K0.shape[-1]
            K_inv = linalg.ns_inverse_bucket(
                K0.reshape(-1, n, n), warm.kinv.reshape(-1, n, n),
                warm_iters=cfg.ns_warm_iters, cold_iters=cfg.ns_cold_iters,
                polish=cfg.ns_polish).reshape(K0.shape)
        else:
            K_inv = linalg.ns_inverse(
                K0, cfg.ns_iters, X0=warm.kinv if warm is not None else None,
                warm_iters=cfg.ns_warm_iters, polish=cfg.ns_polish)
        kinv_carry = K_inv

    n = qp.P.shape[-1]
    m = qp.l.shape[-1]
    lead = qp.q.shape[:-1]
    dtype, device = qp.P.dtype, qp.P.device
    if warm is None:
        warm = ADMMState(
            x=torch.zeros(lead + (n,), dtype=dtype, device=device),
            z=torch.zeros(lead + (m,), dtype=dtype, device=device),
            y=torch.zeros(lead + (m,), dtype=dtype, device=device),
        )

    if cfg.backend == "pallas":
        from quad_periodic_mpc_tpu_torch.ops.cuda import admm_kernel

        # the kernel is float32 inside, whatever the problem's dtype
        flat = lambda t, width: t.expand(lead + (width,)).reshape(-1, width).to(
            torch.float32).contiguous()
        x_f, z_f, y_f = admm_kernel.fused_admm_iterations(
            K_inv.reshape(-1, n, n).to(torch.float32).contiguous(),
            flat(qp.q, n), flat(qp.l, m), flat(qp.u, m), flat(rho, m),
            qp.F.to(torch.float32).contiguous(),
            flat(warm.x, n), flat(warm.z, m), flat(warm.y, m),
            iters=cfg.iterations, sigma=cfg.sigma, over_relax=cfg.over_relax,
            kinv_bf16=cfg.pallas_bf16_kinv)
        final = ADMMState(
            x=x_f.reshape(lead + (n,)).to(dtype), z=z_f.reshape(lead + (m,)).to(dtype),
            y=y_f.reshape(lead + (m,)).to(dtype), kinv=kinv_carry)
        return final.x, final

    a = cfg.over_relax
    rho_inv = 1.0 / rho
    x, z, y = warm.x, warm.z, warm.y
    for _ in range(cfg.iterations):
        rhs = cfg.sigma * x - qp.q + con.apply_T(qp.F, rho * z - y)
        x_t = _mv(K_inv, rhs)
        # iterative refinement: one K-residual correction per round makes up
        # for the inexact (Newton-Schulz / f32) inverse, so the ADMM fixed
        # point matches the exact-solve fixed point
        for _ in range(cfg.refine):
            x_t = x_t + _mv(K_inv, rhs - _mv(K, x_t))
        x = a * x_t + (1.0 - a) * x
        z_r = a * con.apply(qp.F, x_t) + (1.0 - a) * z
        z_new = torch.clamp(z_r + rho_inv * y, qp.l, qp.u)
        y = y + rho * (z_r - z_new)
        z = z_new
    return x, ADMMState(x=x, z=z, y=y, kinv=kinv_carry)


def _kkt_inverse_woodbury(
    qp: QPData, rho: torch.Tensor, cfg: ADMMConfig, warm: ADMMState | None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K^{-1} as a gait-independent base inverse + exact low-rank update.

    The eq_scale rho bump lands only on fz rows (l == u swing pins), and
    the fz pyramid row is (0, 0, 1), so relative to the uniform-rho K0,

        K = K0 + E diag(delta) E^T,   E = z-variable selector (n x k),
        delta_k = (eq_scale - 1) rho  on swing blocks, else 0.

    K0 never depends on the gait table, so the previous period's K0^{-1} is
    always a contractive Newton-Schulz seed.  The bump is restored by
    Woodbury, written symmetrically so that the capacitance matrix is SPD:

        K^{-1} = K0^{-1} - (B D^{1/2}) W^{-1} (B D^{1/2})^T,  B = K0^{-1} E,
        W = I + D^{1/2} S D^{1/2},  S = E^T K0^{-1} E,  D = diag(delta),

    with W Jacobi-preconditioned (cond drops from ~1e2-1e3 to O(10)) and
    inverted by 8 Newton-Schulz rounds.  Every product is exact f32 (or
    f64): the correction cancels K0^{-1}'s large z-block down to the
    ~1/(rho eq_scale) bumped value.  Returns (K^{-1}, K0^{-1} to carry).
    """
    n = qp.P.shape[-1]
    c, a = qp.F.shape[-2], qp.F.shape[-1]
    k = n // a

    rho_u = torch.full_like(rho, cfg.rho)
    K0 = build_kkt(qp, rho_u, cfg)
    K0_inv = linalg.ns_inverse(
        K0, cfg.ns_iters, X0=warm.kinv if warm is not None else None,
        warm_iters=cfg.ns_warm_iters, polish=cfg.ns_polish)
    if cfg.eq_scale == 1.0:
        return K0_inv, K0_inv

    # per-block bump: (rho - rho_u) weighted by the squares of F's z-column;
    # for the pyramid only the fz row (0, 0, 1) hits z
    fz2 = qp.F[:, a - 1] ** 2                              # (c,)
    delta = torch.einsum(
        "...kc,c->...k", (rho - rho_u).reshape(rho.shape[:-1] + (k, c)), fz2)

    lead = K0_inv.shape[:-2]
    Bm = K0_inv.reshape(lead + (n, k, a))[..., a - 1]      # (..., n, k) z columns
    S = Bm.reshape(lead + (k, a, k))[..., a - 1, :]        # (..., k, k)
    dh = torch.sqrt(delta)
    W = torch.eye(k, dtype=S.dtype, device=S.device) + dh[..., :, None] * S * dh[..., None, :]
    dw = torch.sqrt(1.0 / (1.0 + delta * S.diagonal(dim1=-2, dim2=-1)))
    X = linalg.ns_posspec_inverse(dw[..., :, None] * W * dw[..., None, :], 8)
    X = dw[..., :, None] * X * dw[..., None, :]            # undo the scaling
    Bd = Bm * dh[..., None, :]                             # B D^{1/2}
    K_inv = K0_inv - Bd @ (X @ Bd.transpose(-1, -2))
    return K_inv, K0_inv


def kkt_residuals(qp: QPData, x: torch.Tensor, z: torch.Tensor,
                  y: torch.Tensor) -> dict[str, torch.Tensor]:
    """Primal / dual residual and bound-violation norms (per instance):
    max|A x - z|, max|P x + q + A^T y|, max violation of l <= A x <= u."""
    ax = con.apply(qp.F, x)
    r_prim = (ax - z).abs().amax(-1)
    r_dual = (_mv(qp.P, x) + qp.q + con.apply_T(qp.F, y)).abs().amax(-1)
    viol = torch.maximum(ax - qp.u, qp.l - ax)
    r_feas = torch.clamp(viol, min=0.0).amax(-1)
    return {"primal": r_prim, "dual": r_dual, "feas": r_feas}
