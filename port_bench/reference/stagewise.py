"""The stagewise Riccati-ADMM solve with the SRB dynamics assembled from
the observation: the plain version of the fused-build kernel
(``fused_stagewise_solve_srb``), the same sequential algorithm in batched
torch ops in the same elimination order.

NS rescue semantics: a stage whose warm Newton-Schulz inverse fails the
2e-3 residual gate restarts cold on its own instance.
"""

from __future__ import annotations

import math

import torch

from port_bench.reference.rotations import skew

NX = 13
NU = 12
NC = 20
# structured Ad = I + N: live rows / columns of N
N_ROWS = (0, 1, 2, 3, 4, 5, 11)
N_COLS = (6, 7, 8, 9, 10, 11, 12)
# NS rounds for the factorization's inverses: the spectral budget grows
# with log2(h / 16)
NS_COMBINE_ITERS = 16


def ns_combine_iters(h: int) -> int:
    """Horizon-scaled NS round budget for the factorization inverses."""
    return NS_COMBINE_ITERS + 2 * max(0, math.ceil(math.log2(max(h, 16) / 16)))


def _constants(dt: float, mass: float) -> dict[str, float]:
    """Scalar coefficients of the SRB build, formed in double precision
    as the reference forms them from Python floats."""
    inv_m = 1.0 / mass
    dt2 = dt * dt / 2.0
    dt3 = dt * dt * dt / 6.0
    return {"dt": dt, "dt2": dt2, "dt3": dt3, "dt_inv_m": dt * inv_m,
            "dt2_inv_m": dt2 * inv_m, "dt3_inv_m": dt3 * inv_m}


def ns_warm_rounds(ns_it: int) -> int:
    """Warm NS rounds per stage (reference _solve_body)."""
    return max(ns_it * 3 // 8, 6)


def srb_assemble(R, r_feet, x_drag, f_est, dt=0.026, mass=12.0,
                 i_inv_diag=(1 / 0.07, 1 / 0.26, 1 / 0.242)):
    """Discrete SRB (Ad (B,13,13), Bd (B,13,12), c (B,13)) assembled entry
    by entry from the nilpotent closed forms, as the kernel builds them."""
    k = _constants(float(dt), float(mass))
    Bn = R.shape[0]
    dtype, device = R.dtype, R.device
    RT = R.transpose(1, 2)
    d = torch.tensor([float(v) for v in i_inv_diag], dtype=dtype, device=device)
    Iinv = (R * d) @ RT
    Tb = Iinv[:, None] @ skew(r_feet.reshape(Bn, 4, 3))      # (B, 4, 3, 3)
    RTTb = RT[:, None] @ Tb
    xd = x_drag

    N = torch.zeros(Bn, NX, NX, dtype=dtype, device=device)
    N[:, 0:3, 6:9] = k["dt"] * RT
    N[:, 3, 9] = k["dt"]
    N[:, 4, 10] = k["dt"]
    N[:, 5, 11] = k["dt"]
    N[:, 11, 9] = k["dt"] * xd
    N[:, 11, 12] = k["dt"]
    N[:, 5, 9] = k["dt2"] * xd
    N[:, 5, 12] = k["dt2"]
    Ad = torch.eye(NX, dtype=dtype, device=device) + N

    Bd = torch.zeros(Bn, NX, NU, dtype=dtype, device=device)
    for f in range(4):
        c0 = 3 * f
        Bd[:, 0:3, c0:c0 + 3] = k["dt2"] * RTTb[:, f]
        Bd[:, 6:9, c0:c0 + 3] = k["dt"] * Tb[:, f]
        Bd[:, 3, c0] = k["dt2_inv_m"]
        Bd[:, 4, c0 + 1] = k["dt2_inv_m"]
        Bd[:, 5, c0 + 2] = k["dt2_inv_m"]
        Bd[:, 5, c0] = k["dt3_inv_m"] * xd
        Bd[:, 9, c0] = k["dt_inv_m"]
        Bd[:, 10, c0 + 1] = k["dt_inv_m"]
        Bd[:, 11, c0 + 2] = k["dt_inv_m"]
        Bd[:, 11, c0] = k["dt2_inv_m"] * xd

    tau, ff = f_est[:, 0:3], f_est[:, 3:6]
    c = torch.zeros(Bn, NX, dtype=dtype, device=device)
    c[:, 0:3] = k["dt2"] * (RT @ tau[..., None])[..., 0]
    c[:, 6:9] = k["dt"] * tau
    c[:, 3:6] = k["dt2"] * ff
    c[:, 9:12] = k["dt"] * ff
    c[:, 5] = c[:, 5] + k["dt3"] * xd * ff[:, 0]
    c[:, 11] = c[:, 11] + k["dt2"] * xd * ff[:, 0]
    return Ad, Bd, c


def _inf_norm(M: torch.Tensor) -> torch.Tensor:
    """max_i sum_j |M_ij| per instance (NaN-propagating)."""
    return M.abs().sum(-1).amax(-1)


def _ns_round(Quu, X):
    eye = torch.eye(NU, dtype=X.dtype, device=X.device)
    return X @ (2.0 * eye - Quu @ X)


def _cold_seed(Quu):
    eye = torch.eye(NU, dtype=Quu.dtype, device=Quu.device)
    return eye / _inf_norm(Quu)[:, None, None]


def stage_quu_inverse(Quu, X_prev, first: bool, ns_it: int, ns_warm: int):
    """Per-stage Quu^{-1} (B, 12, 12) by Newton-Schulz, the schedule of the
    reference's _stage_quu_inverse.  Returns (X, number of instances
    rescued).

    first: cold scalar seed I/||Quu||_inf and ns_it rounds.  Otherwise warm
    from X_prev with the alpha = 1.8/(1+r) rescale when r >= 0.9, ns_warm
    rounds in all, then the 2e-3 residual gate (NaN counts as bad); bad
    instances restart from the cold seed (non-finite entries zeroed) for
    ns_it rounds, each on its own."""
    if first:
        X = _cold_seed(Quu)
        for _ in range(ns_it):
            X = _ns_round(Quu, X)
        return X, 0
    eye = torch.eye(NU, dtype=Quu.dtype, device=Quu.device)
    M = X_prev @ Quu
    r = _inf_norm(eye - M)
    alpha = torch.where(r < 0.9, torch.ones_like(r), 1.8 / (1.0 + r))
    al = alpha[:, None, None]
    # round 1 reuses the seed product: X1 = a Xp (2I - a M)
    X = (al * X_prev) @ (2.0 * eye - al * M)
    for _ in range(ns_warm - 1):
        X = _ns_round(Quu, X)
    bad = ~(_inf_norm(eye - Quu @ X) < 2e-3)            # catches NaN too
    n_bad = int(bad.sum())
    if n_bad:
        Xb = _cold_seed(Quu)
        Xb = torch.where(torch.isfinite(Xb), Xb, torch.zeros_like(Xb))
        for _ in range(ns_it):
            Xb = _ns_round(Quu, Xb)
        X = torch.where(bad[:, None, None], Xb, X)
    return X, n_bad


def solve(
    Ad, Bd, c, x0, x_ref, Q, R_eff, F, l, u, U0, z0, y0,
    iters: int, rho: float, over_relax: float, ns_it: int,
    stats: dict | None = None,
):
    """The kernels' solve_body on the SRB structure: Ad products as the
    identity plus the 7 live rows / columns of N = Ad - I, and Bd's zero
    row 12 skipped.  c: (B, 13).  Returns (U, z, y)."""
    Bn, h = x_ref.shape[0], x_ref.shape[1]
    dtype, device = x0.dtype, x0.device
    c_at = lambda k: c
    ns_warm = ns_warm_rounds(ns_it)
    rescued = 0
    nbd = NU                            # Bd row 12 is structurally zero
    Bdn = Bd[:, :nbd, :]
    BdnT = Bdn.transpose(1, 2)
    N = Ad - torch.eye(NX, dtype=dtype, device=device)

    def row_A(X):                                        # X Ad, X (B, r, 13)
        out = X
        for m in N_ROWS:
            out = out + X[:, :, m:m + 1] * N[:, None, m, :]
        return out

    def At_P(P):                                         # Ad^T P
        out = P
        for m in N_ROWS:
            out = out + N[:, m, :, None] * P[:, None, m, :]
        return out

    def At_v(v):                                         # Ad^T v
        out = v
        for m in N_ROWS:
            out = out + N[:, m, :] * v[:, m:m + 1]
        return out

    def A_x(x):                                          # Ad x
        out = x
        for m in N_COLS:
            out = out + N[:, :, m] * x[:, m:m + 1]
        return out

    # ---- backward Riccati ----
    Qm = torch.diag(Q).expand(Bn, NX, NX)
    P = Qm.clone()
    K_s, M_s, Pc_s = [None] * h, [None] * h, [None] * h
    X = torch.zeros(Bn, NU, NU, dtype=dtype, device=device)
    for kk in range(h):
        k = h - 1 - kk
        BtP = BdnT @ P[:, :nbd, :]                       # (B, 12, 13)
        Quu = R_eff + BtP[:, :, :nbd] @ Bdn
        X, n_bad = stage_quu_inverse(Quu, X, kk == 0, ns_it, ns_warm)
        rescued += n_bad
        Qux = row_A(BtP)
        K = X @ Qux
        K_s[k] = K
        M_s[k] = X
        Pc_s[k] = (P @ c_at(k)[..., None])[..., 0]
        Pn = (Qm + row_A(At_P(P))) - Qux.transpose(1, 2) @ K
        P = (Pn + Pn.transpose(1, 2)) / 2.0

    # ---- ADMM iterations ----
    a = float(over_relax)
    rho = float(rho)
    rho_inv = 1.0 / rho
    q_s = [torch.zeros(Bn, NX, dtype=dtype, device=device)] + [
        -(Q * x_ref[:, k - 1]) for k in range(1, h)]
    qT = -(Q * x_ref[:, h - 1])
    U, z, y = U0.clone(), z0.clone(), y0.clone()
    r_s, v_s = [None] * h, [None] * h
    for _ in range(iters):
        p = qT
        for kk in range(h):
            k = h - 1 - kk
            w = rho * z[:, k] - y[:, k]
            rk = (w.reshape(Bn, 4, 5, 1) * F).sum(-2).reshape(Bn, NU)
            v = Pc_s[k] + p
            r_s[k], v_s[k] = rk, v
            s = (BdnT @ v[:, :nbd, None])[..., 0] - rk
            p = (q_s[k] + At_v(v)) - (K_s[k].transpose(1, 2) @ s[..., None])[..., 0]
        x = x0
        for k in range(h):
            s = (BdnT @ v_s[k][:, :nbd, None])[..., 0] - r_s[k]
            kff = (M_s[k] @ s[..., None])[..., 0]
            ut = -(K_s[k] @ x[..., None])[..., 0] - kff
            x = (A_x(x) + (Bd @ ut[..., None])[..., 0]) + c_at(k)
            U[:, k] = a * ut + (1.0 - a) * U[:, k]
            Fu = (F * ut.reshape(Bn, 4, 1, 3)).sum(-1).reshape(Bn, NC)
            fur = a * Fu + (1.0 - a) * z[:, k]
            zn = torch.clamp(fur + rho_inv * y[:, k], l[:, k], u[:, k])
            y[:, k] = y[:, k] + rho * (fur - zn)
            z[:, k] = zn
    if stats is not None:
        stats["rescued"] = rescued
    return U, z, y


def solve_srb(
    R, r_feet, x_drag, f_est, x0, x_ref, Q, R_eff, F, l, u, U0, z0, y0,
    iters: int, rho: float, over_relax: float = 1.6, ns_it: int = 16,
    dt: float = 0.026, mass: float = 12.0,
    i_inv_diag: tuple = (1 / 0.07, 1 / 0.26, 1 / 0.242),
    stats: dict | None = None,
):
    """The fused-build kernel's solve.  Returns (U, z, y).

    stats: optional dict; receives "rescued", the number of
    (instance, stage) pairs whose warm NS inverse failed the gate and
    restarted cold (the data-dependent part of the kernel's work)."""
    Ad, Bd, c = srb_assemble(R, r_feet, x_drag, f_est, dt, mass, i_inv_diag)
    return solve(Ad, Bd, c, x0, x_ref, Q, R_eff, F, l, u, U0, z0, y0,
                            iters, rho, over_relax, ns_it, stats=stats)
