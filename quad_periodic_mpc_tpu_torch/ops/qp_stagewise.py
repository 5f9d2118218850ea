"""Stage-wise (sparse) MPC solver: Riccati-ADMM for long horizons
(counterpart of ``quad_periodic_mpc_tpu/ops/qp_stagewise.py``).

    min  sum_k 1/2 (x_k - xref_k)^T Qs (x_k - xref_k) + 1/2 u_k^T Rs u_k
    s.t. x_{k+1} = Ad x_k + Bd u_k + c_k,   l <= F u_k <= u.

The ADMM x-update is an equality-constrained tracking LQR whose quadratics
do not change between iterations.  ``solve`` dispatches as the reference
does: with ``backend="pallas"`` and float32 the whole solve runs in one
kernel (``ops/cuda/stagewise_kernel.py``: ``fused_stagewise_solve`` for
h <= 64, ``fused_stagewise_solve_stream`` for 64 < h <= 128 with
h % 8 == 0); everything else (float64, ``backend="xla"``, other horizons)
takes the scan path: ``lqr_factorize_packed`` computes the value
quadratics and gains once per solve with a parallel-in-time Riccati
(O(log h) depth), and each ADMM iteration costs two affine doubling scans
(``lqr_apply_packed``).  The scan path is written in batch-leading layout,
``torch.matmul`` on (..., 13, 13) blocks; the reference's lane-major
packing is a TPU layout and is not carried over (its names are).
``lqr_solve`` is the sequential oracle the tests use; ``solve_blocked``
(with ``lqr_factorize`` / ``lqr_apply``) is the reference's cross-check
copy of the scan path, the same ADMM with the scans' transition products
formed anew in every iteration.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from quad_periodic_mpc_tpu_torch.config import ADMMConfig
from quad_periodic_mpc_tpu_torch.ops import linalg

NX = 13
NU = 12

# NS rounds for the factorization's inverses (the combine's
# (I + C J)^{-1} and Quu^{-1}): the spectral budget grows with
# log2(h / 16) (reference module note at NS_COMBINE_ITERS)
NS_COMBINE_ITERS = 16


def ns_combine_iters(h: int) -> int:
    """Horizon-scaled NS round budget for the factorization inverses."""
    return NS_COMBINE_ITERS + 2 * max(0, math.ceil(math.log2(max(h, 16) / 16)))


class StagewiseProblem(NamedTuple):
    Ad: torch.Tensor      # (..., 13, 13) discrete dynamics (time-invariant)
    Bd: torch.Tensor      # (..., 13, 12)
    c: torch.Tensor       # (..., 13) affine term (Qd @ f_est), or per step (..., h, 13)
    x0: torch.Tensor      # (..., 13)
    x_ref: torch.Tensor   # (..., h, 13)
    Q: torch.Tensor       # (13,) stage state cost diagonal
    R: torch.Tensor       # (12,) input cost diagonal
    F: torch.Tensor       # (5, 3) pyramid block
    l: torch.Tensor       # (..., h, 20)
    u: torch.Tensor       # (..., h, 20)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def _tr(M: torch.Tensor) -> torch.Tensor:
    return M.transpose(-1, -2)


def _r_eff(R: torch.Tensor, extra: torch.Tensor) -> torch.Tensor:
    """diag(R) + kron(I4, extra): the input cost with the ADMM penalty."""
    eye4 = torch.eye(4, dtype=R.dtype, device=R.device)
    return torch.diag(R) + torch.kron(eye4, extra.to(R.dtype))


def lqr_solve(
    prob: StagewiseProblem,
    R_eff_diag_extra: torch.Tensor,     # (3, 3) G = rho F^T F block add-on
    r_lin: torch.Tensor,                # (..., h, 12) linear u-term
) -> torch.Tensor:
    """Tracking LQR with affine dynamics (time-invariant c): U (..., h, 12).

    Minimizes sum_k 1/2 dx_k^T Q dx_k + 1/2 u_k^T R_eff u_k - r_k^T u_k with
    dx = x - xref, x_{k+1} = Ad x_k + Bd u_k + c: sequential backward
    Riccati and forward rollout.  The states x_1..x_h are penalised against
    xref_0..xref_{h-1}: terminal cost (Q, -Q xref_{h-1}) on x_h, stage
    k >= 1 carries (Q, -Q xref_{k-1}), stage 0 none."""
    h = prob.x_ref.shape[-2]
    dtype = prob.x0.dtype
    Qm = torch.diag(prob.Q).to(dtype)
    R_eff = _r_eff(prob.R.to(dtype), R_eff_diag_extra)
    Ad, Bd = prob.Ad, prob.Bd
    AdT, BdT = _tr(Ad), _tr(Bd)
    batch = prob.x0.shape[:-1]
    q_lin = -(prob.Q.to(dtype) * prob.x_ref)

    P = Qm.expand(batch + (NX, NX))
    p = q_lin[..., h - 1, :].expand(batch + (NX,))
    K_t, k_t = [None] * h, [None] * h
    for k in reversed(range(h)):
        Pcp = _mv(P, prob.c) + p
        Quu = R_eff + BdT @ P @ Bd
        Qux = BdT @ P @ Ad
        qu = _mv(BdT, Pcp) - r_lin[..., k, :]
        K = torch.linalg.solve(Quu, Qux)
        kff = torch.linalg.solve(Quu, qu[..., None])[..., 0]
        K_t[k], k_t[k] = K, kff
        P_new = AdT @ P @ Ad - _tr(Qux) @ K
        p_new = _mv(AdT, Pcp) - _mv(_tr(Qux), kff)
        if k >= 1:
            P_new = Qm + P_new
            p_new = q_lin[..., k - 1, :] + p_new
        P = (P_new + _tr(P_new)) / 2.0
        p = p_new

    x = prob.x0
    U = []
    for k in range(h):
        u = -_mv(K_t[k], x) - k_t[k]
        x = _mv(Ad, x) + _mv(Bd, u) + prob.c
        U.append(u)
    return torch.stack(U, dim=-2)


class LQRGains(NamedTuple):
    """Iteration-invariant LQR factorization (see ``lqr_factorize``):
    blocks (..., h, r, c), vectors (..., h, r)."""

    K: torch.Tensor       # (..., h, 12, 13) feedback gains
    Minv: torch.Tensor    # (..., h, 12, 12) (R_eff + B'P_{k+1}B)^{-1}
    G: torch.Tensor       # (..., h, 13, 12) Qux' M^{-1}
    Ft: torch.Tensor      # (..., h, 13, 13) backward linear map A' - G B'
    Acl: torch.Tensor     # (..., h, 13, 13) closed-loop A - B K
    Pc: torch.Tensor      # (..., h, 13) P_{k+1} c_k
    q_stage: torch.Tensor  # (..., h, 13) stage linear cost (masked -Q xref)
    p_T: torch.Tensor     # (..., 13) terminal linear cost


class LQRGainsPacked(NamedTuple):
    """Iteration-invariant LQR factorization: blocks (B, h, r, c), vectors
    (B, h, r).  PF_back / PF_fwd / T_F cache the recursive-doubling
    transition products of the backward (Ft) and forward (Acl) affine
    scans, whose matrix parts do not change between ADMM iterations: each
    level of ``lqr_apply_packed`` is then one matvec."""

    K: torch.Tensor       # (B, h, 12, 13) feedback gains
    Minv: torch.Tensor    # (B, h, 12, 12) (R_eff + B'P_{k+1}B)^{-1}
    G: torch.Tensor       # (B, h, 13, 12) Qux' M^{-1}
    Ft: torch.Tensor      # (B, h, 13, 13) backward linear map A' - G B'
    Acl: torch.Tensor     # (B, h, 13, 13) closed-loop A - B K
    Pc: torch.Tensor      # (B, h, 13) P_{k+1} c_k
    q_stage: torch.Tensor  # (B, h, 13) stage linear cost
    p_T: torch.Tensor     # (B, 13) terminal linear cost
    PF_back: tuple        # level-d products of [Ft..., 0]: (B, h + 1, 13, 13)
    PF_fwd: tuple         # level-d products of Acl: (B, h, 13, 13)
    T_F: torch.Tensor     # (B, h, 13, 13) full prefix Acl_k ... Acl_0


def _doubling_products(F: torch.Tensor, reverse: bool) -> tuple[tuple, torch.Tensor]:
    """Per-level transition products of a recursive-doubling affine scan
    along axis 1 of F (B, L, n, n).

    For the suffix (reverse) recursion p_k = s_k + F_k p_{k+1} the level-d
    update is v_k += M_k v_{k+d}, M_k <- M_k M_{k+d} (zero past the end);
    for the prefix recursion x_{k+1} = A_k x_k + g_k it is
    v_k += M_k v_{k-d}, M_k <- M_k M_{k-d} (identity before the start).
    Returns (the levels' M, the final full product)."""
    L = F.shape[1]
    levels = []
    M = F
    d = 1
    while d < L:
        levels.append(M)
        if reverse:
            Ms = torch.cat([M[:, d:], torch.zeros_like(M[:, :d])], dim=1)
        else:
            eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device).expand(
                M[:, :d].shape)
            Ms = torch.cat([eye, M[:, :-d]], dim=1)
        M = M @ Ms
        d *= 2
    return tuple(levels), M


def _doubling_apply(levels: tuple, v: torch.Tensor, reverse: bool) -> torch.Tensor:
    """The vector half of the doubling scan with cached products; v (B, L, n)."""
    d = 1
    for M in levels:
        if reverse:
            vs = torch.cat([v[:, d:], torch.zeros_like(v[:, :d])], dim=1)
        else:
            vs = torch.cat([torch.zeros_like(v[:, :d]), v[:, :-d]], dim=1)
        v = v + _mv(M, vs)
        d *= 2
    return v


def _riccati_suffix_scan(A, C, J, ns_it: int):
    """Suffix products e_k (x) e_{k+1} (x) ... (x) e_L of the conditional
    value elements (A, C, J), each (B, L + 1, 13, 13), under

        D    = (I + C_i J_j)^{-1}
        A_ij = A_j D A_i
        C_ij = A_j D C_i A_j' + C_j
        J_ij = A_i' D' J_j A_i + J_i

    (i the earlier element, j the later).  The parallel prefix is written
    by hand as recursive doubling: at level d every element k with
    k + d <= L absorbs the partial product that starts at k + d.  The
    operator is associative, so this gives what the reference's
    ``associative_scan`` gives, to roundoff."""
    n = A.shape[1]
    eye = torch.eye(NX, dtype=A.dtype, device=A.device)
    d = 1
    while d < n:
        Ai, Ci, Ji = A[:, :n - d], C[:, :n - d], J[:, :n - d]
        Aj, Cj, Jj = A[:, d:], C[:, d:], J[:, d:]
        D = linalg.ns_posspec_inverse(eye + Ci @ Jj, ns_it)
        AjD = Aj @ D
        An = AjD @ Ai
        Cn = (AjD @ Ci) @ _tr(Aj) + Cj
        Jn = (_tr(Ai) @ (_tr(D) @ Jj)) @ Ai + Ji
        A = torch.cat([An, A[:, n - d:]], dim=1)
        C = torch.cat([(Cn + _tr(Cn)) / 2.0, C[:, n - d:]], dim=1)
        J = torch.cat([(Jn + _tr(Jn)) / 2.0, J[:, n - d:]], dim=1)
        d *= 2
    return A, C, J


def _factorize(Ad, Bd, c, x_ref, Q, R, R_eff_diag_extra) -> LQRGains:
    """The gains of ``LQRGains`` over a flat batch: Ad (B, 13, 13), Bd
    (B, 13, 12), c (B, 1 or h, 13), x_ref (B, h, 13)."""
    Bn, h = x_ref.shape[0], x_ref.shape[1]
    dtype, device = x_ref.dtype, x_ref.device
    ns_it = ns_combine_iters(h)
    Qm = torch.diag(Q).to(dtype)
    R_eff = _r_eff(R.to(dtype), R_eff_diag_extra)
    R_inv = linalg.ns_inverse(R_eff, iters=30)
    C_step = (Bd @ R_inv) @ _tr(Bd)                            # (B, 13, 13)

    q_lin = -(Q.to(dtype) * x_ref)                             # (B, h, 13)
    # elements k = 0..h-1 (transition + source-state cost; none at x_0)
    # and k = h (terminal cost only: A = C = 0)
    zblk = torch.zeros(Bn, 1, NX, NX, dtype=dtype, device=device)
    A_el = torch.cat([Ad[:, None].expand(Bn, h, NX, NX), zblk], dim=1)
    C_el = torch.cat([C_step[:, None].expand(Bn, h, NX, NX), zblk], dim=1)
    J_el = Qm.expand(Bn, h + 1, NX, NX).clone()
    J_el[:, 0] = 0.0
    _, _, J_suf = _riccati_suffix_scan(A_el, C_el, J_el, ns_it)
    P = J_suf[:, 1:]                                           # P_{k+1}, k = 0..h-1

    Bh, Ah = Bd[:, None], Ad[:, None]
    BtP = _tr(Bh) @ P                                          # (B, h, 12, 13)
    Minv = linalg.ns_posspec_inverse(R_eff + BtP @ Bh, ns_it)
    Qux = BtP @ Ah
    K = Minv @ Qux
    G = _tr(Qux) @ Minv                                        # (B, h, 13, 12)
    q_stage = torch.cat(
        [torch.zeros(Bn, 1, NX, dtype=dtype, device=device), q_lin[:, :h - 1]], dim=1)
    return LQRGains(
        K=K, Minv=Minv, G=G, Ft=_tr(Ah) - G @ _tr(Bh), Acl=Ah - Bh @ K, Pc=_mv(P, c),
        q_stage=q_stage, p_T=q_lin[:, h - 1])


def _with_products(gains: LQRGains) -> LQRGainsPacked:
    """The gains with the doubling scans' transition products."""
    zblk = torch.zeros_like(gains.Ft[:, :1])
    PF_back, _ = _doubling_products(torch.cat([gains.Ft, zblk], dim=1), reverse=True)
    PF_fwd, T_F = _doubling_products(gains.Acl, reverse=False)
    return LQRGainsPacked(*gains, PF_back=PF_back, PF_fwd=PF_fwd, T_F=T_F)


def lqr_factorize_packed(
    Ad: torch.Tensor,      # (B, 13, 13)
    Bd: torch.Tensor,      # (B, 13, 12)
    c: torch.Tensor,       # (B, 1 or h, 13) per-step affine term
    x_ref: torch.Tensor,   # (B, h, 13)
    Q: torch.Tensor,       # (13,)
    R: torch.Tensor,       # (12,)
    R_eff_diag_extra: torch.Tensor,   # (3, 3)
) -> LQRGainsPacked:
    """Parallel-in-time Riccati: the value quadratics P_k and all gain
    matrices, once per solve, by a scan over Sarkka-style conditional value
    elements (Temporal Parallelization of LQR)."""
    return _with_products(_factorize(Ad, Bd, c, x_ref, Q, R, R_eff_diag_extra))


def lqr_apply_packed(
    gains: LQRGainsPacked,
    Bd: torch.Tensor,      # (B, 13, 12)
    c: torch.Tensor,       # (B, 1 or h, 13)
    x0: torch.Tensor,      # (B, 13)
    r_lin: torch.Tensor,   # (B, h, 12)
) -> torch.Tensor:
    """Per-iteration LQR solve with precomputed gains: two affine doubling
    scans (backward costate, forward closed-loop rollout).  U (B, h, 12)."""
    h = r_lin.shape[1]
    s = gains.q_stage + _mv(gains.Ft, gains.Pc) + _mv(gains.G, r_lin)
    s_elems = torch.cat([s, gains.p_T[:, None]], dim=1)
    p_next = _doubling_apply(gains.PF_back, s_elems, reverse=True)[:, 1:]

    BtPp = _mv(_tr(Bd)[:, None], gains.Pc + p_next)
    kff = _mv(gains.Minv, BtPp - r_lin)
    g = c - _mv(Bd[:, None], kff)

    T_s = _doubling_apply(gains.PF_fwd, g, reverse=False)
    x_later = _mv(gains.T_F, x0[:, None]) + T_s                # x_{k+1}
    x = torch.cat([x0[:, None], x_later[:, :h - 1]], dim=1)
    return -_mv(gains.K, x) - kff


def _flat_problem(prob: StagewiseProblem):
    """(batch, B, flat) of a problem: ``flat(t, *extra)`` broadcasts t to
    the batch and flattens it to (B, *extra)."""
    batch = prob.x0.shape[:-1]
    B = math.prod(batch)
    flat = lambda t, *extra: torch.broadcast_to(
        t, batch + extra).reshape((B,) + extra).contiguous()
    return batch, B, flat


def lqr_factorize(prob: StagewiseProblem, R_eff_diag_extra: torch.Tensor) -> LQRGains:
    """The value quadratics and gains of the ADMM x-update's LQR (whose
    quadratics do not change between iterations) for a problem with a
    time-invariant c, in the problem's batch layout: the parallel-in-time
    Riccati of ``lqr_factorize_packed`` without the cached scan products.
    The reference's analog is OSQP's one-time KKT factorization reused
    across iterations (SparseCMPC.cpp:27-137)."""
    h = prob.x_ref.shape[-2]
    batch, _, flat = _flat_problem(prob)
    gains = _factorize(
        flat(prob.Ad, NX, NX), flat(prob.Bd, NX, NU), flat(prob.c, NX)[:, None],
        flat(prob.x_ref, h, NX), prob.Q, prob.R, R_eff_diag_extra)
    return LQRGains(*(t.reshape(batch + t.shape[1:]) for t in gains))


def lqr_apply(gains: LQRGains, prob: StagewiseProblem, r_lin: torch.Tensor) -> torch.Tensor:
    """Per-iteration LQR solve with precomputed gains, r_lin (..., h, 12) ->
    U (..., h, 12): the two affine scans (backward costate, forward
    closed-loop rollout), their transition products formed in the call."""
    h = r_lin.shape[-2]
    batch, B, flat = _flat_problem(prob)
    packed = _with_products(LQRGains(*(t.reshape((B,) + t.shape[len(batch):]) for t in gains)))
    U = lqr_apply_packed(packed, flat(prob.Bd, NX, NU), flat(prob.c, NX)[:, None],
                         flat(prob.x0, NX), flat(r_lin, h, NU))
    return U.reshape(batch + (h, NU))


def _pcone_apply(F: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """(B, h, 12) -> (B, h, 20): per-leg F u (5 rows per leg, leg-major)."""
    Bn, h = U.shape[:2]
    return (U.reshape(Bn, h, 4, 1, 3) * F).sum(-1).reshape(Bn, h, 20)


def _pcone_apply_T(F: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """(B, h, 20) -> (B, h, 12): per-leg F^T v."""
    Bn, h = V.shape[:2]
    return (V.reshape(Bn, h, 4, 5, 1) * F).sum(-2).reshape(Bn, h, 12)


def solve(
    prob: StagewiseProblem,
    cfg: ADMMConfig,
    warm: tuple | None = None,
) -> tuple[torch.Tensor, dict]:
    """ADMM with Riccati x-update.  Returns (U (..., h, 12), {"z", "y"}).

    warm: optional (U, z, y) of the previous MPC step, shaped like the
    outputs.  prob.c may be per-step (..., h, 13) (predictive disturbance
    horizon) or time-invariant (..., 13).

    ``backend="pallas"`` with float32 runs the whole solve in one kernel
    (the kernels are f32-internal, so float64 problems take the scan path
    rather than being demoted): the resident one to h = 64, the streamed
    one for 64 < h <= 128 with h % 8 == 0.  Everything else takes the
    scan path below."""
    dtype, device = prob.x0.dtype, prob.x0.device
    h = prob.x_ref.shape[-2]
    batch, B, flat = _flat_problem(prob)
    unflat = lambda t: t.reshape(batch + t.shape[1:])
    per_step_c = prob.c.ndim == prob.x0.ndim + 1
    if warm is None:
        U0, z0, y0 = (torch.zeros(B, h, r, dtype=dtype, device=device)
                      for r in (NU, 20, 20))
    else:
        U0, z0, y0 = (flat(t, h, r) for t, r in zip(warm, (NU, 20, 20)))
    F = prob.F.to(dtype)
    G = cfg.rho * (_tr(F) @ F)

    use_stream = 64 < h <= 128 and h % 8 == 0
    if cfg.backend == "pallas" and dtype == torch.float32 and (h <= 64 or use_stream):
        from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel

        solve_fn = (stagewise_kernel.fused_stagewise_solve_stream if use_stream
                    else stagewise_kernel.fused_stagewise_solve)
        U, z, y = solve_fn(
            flat(prob.Ad, NX, NX), flat(prob.Bd, NX, NU),
            flat(prob.c, h, NX) if per_step_c else flat(prob.c, NX),
            flat(prob.x0, NX), flat(prob.x_ref, h, NX), prob.Q.to(dtype).contiguous(),
            _r_eff(prob.R.to(dtype), G), F.contiguous(), flat(prob.l, h, 20),
            flat(prob.u, h, 20), U0, z0, y0, iters=cfg.iterations, rho=float(cfg.rho),
            over_relax=float(cfg.over_relax), ns_it=ns_combine_iters(h))
        return unflat(U), {"z": unflat(z), "y": unflat(y)}

    Ad, Bd = flat(prob.Ad, NX, NX), flat(prob.Bd, NX, NU)
    c = flat(prob.c, h, NX) if per_step_c else flat(prob.c, NX)[:, None]
    x0 = flat(prob.x0, NX)
    l_p, u_p = flat(prob.l, h, 20), flat(prob.u, h, 20)
    gains = lqr_factorize_packed(
        Ad, Bd, c, flat(prob.x_ref, h, NX), prob.Q.to(dtype), prob.R.to(dtype), G)
    rho, a = cfg.rho, cfg.over_relax
    U, z, y = U0, z0, y0
    for _ in range(cfg.iterations):
        r_lin = _pcone_apply_T(F, rho * z - y)
        U_t = lqr_apply_packed(gains, Bd, c, x0, r_lin)
        # over-relaxation: relax both the iterate carry and the constraint
        # image before the projection
        U = a * U_t + (1.0 - a) * U
        Fu_r = a * _pcone_apply(F, U_t) + (1.0 - a) * z
        z_new = torch.clamp(Fu_r + y / rho, l_p, u_p)
        y = y + rho * (Fu_r - z_new)
        z = z_new
    return unflat(U), {"z": unflat(z), "y": unflat(y)}


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
    h = U.shape[-2]
    batch = prob.x0.shape[:-1]
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    Ad = torch.broadcast_to(prob.Ad, batch + (NX, NX))
    Bd = torch.broadcast_to(prob.Bd, batch + (NX, NU))
    per_step_c = prob.c.ndim == prob.x0.ndim + 1
    c = torch.broadcast_to(prob.c, batch + ((h, NX) if per_step_c else (NX,)))
    U = torch.broadcast_to(U, batch + (h, NU))

    xs = []
    x = prob.x0
    for k in range(h):
        x = mv(Ad, x) + mv(Bd, U[..., k, :]) + (c[..., k, :] if per_step_c else c)
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


def solve_blocked(prob: StagewiseProblem, cfg: ADMMConfig) -> tuple[torch.Tensor, dict]:
    """ADMM with the Riccati x-update through ``lqr_factorize`` /
    ``lqr_apply``, from a cold start (the reference's cross-check of
    ``solve``: the same iteration, uniform rho, eq_scale not applied).
    Returns (U (..., h, 12), {"z", "y"})."""
    dtype, device = prob.x0.dtype, prob.x0.device
    h = prob.x_ref.shape[-2]
    batch = prob.x0.shape[:-1]
    F = prob.F.to(dtype)
    rho, a = cfg.rho, cfg.over_relax
    gains = lqr_factorize(prob, rho * (_tr(F) @ F))
    z = torch.zeros(batch + (h, 20), dtype=dtype, device=device)
    y = torch.zeros_like(z)
    U = torch.zeros(batch + (h, NU), dtype=dtype, device=device)
    for _ in range(cfg.iterations):
        r_lin = (((rho * z - y).reshape(batch + (h, 4, 5, 1)) * F).sum(-2)
                 .reshape(batch + (h, NU)))
        U_t = lqr_apply(gains, prob, r_lin)
        U_new = a * U_t + (1.0 - a) * U
        Fu_t = (U_t.reshape(batch + (h, 4, 1, 3)) * F).sum(-1).reshape(batch + (h, 20))
        Fu_r = a * Fu_t + (1.0 - a) * z
        z_new = torch.clamp(Fu_r + y / rho, prob.l, prob.u)
        y = y + rho * (Fu_r - z_new)
        U, z = U_new, z_new
    return U, {"z": z, "y": y}
