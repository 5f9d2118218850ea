"""Stagewise Riccati-ADMM solves: the CUDA kernels, their wrappers and
their plain PyTorch versions.

Four entry points, one for each function of
``quad_periodic_mpc_tpu/ops/pallas/stagewise_kernel.py`` that reaches a
TPU kernel.  The sources are under ``quad_periodic_mpc_tpu_torch/csrc``;
each one's header note says what it computes, what bounds it on an H100
and how the design is laid out (one thread per instance, gains in
instance-minor device scratch, the solve itself shared through
``stagewise_body.cuh``).

- ``fused_stagewise_solve_srb`` (``stagewise_srb.cu``): the dynamics are
  assembled in the kernel from (R, r_feet, x_drag, f_est).
- ``fused_stagewise_solve`` (``stagewise_solve.cu``, and
  ``stagewise_solve_dense.cu`` for ``srb_ad=False``): caller-built Ad, Bd
  and c; c is one vector per instance ``(B, 13)`` or one per stage
  ``(B, h, 13)``; ``srb_ad`` picks structured or dense Ad products.
- ``fused_stagewise_solve_stream`` (``stagewise_stream.cu``): the same
  solve with Quu^{-1} kept as its 78 upper-triangle entries, for the
  horizons ``ops/qp_stagewise.solve`` sends it (64 < h <= 128, h % 8 == 0).
- ``srb_build_dump`` (``stagewise_srb.cu``): the Ad, Bd, c that the first
  kernel assembles in itself, written out for audit.

Each wrapper launches its kernel for CUDA tensors (or raises) and takes
the plain version for CPU tensors; the CUDA branch is the wrapper's
``_*_cuda`` function.  The plain versions (``*_reference``, and
``srb_assemble`` for the dump) run the same sequential algorithm in batched
torch ops in the same elimination order; the tests use them, and the
port's entry points use them on the CPU.  ``LAUNCHES`` counts kernel
launches by entry point since it was last reset.

NS rescue semantics: a stage whose warm Newton-Schulz inverse fails the
2e-3 residual gate restarts cold on its own instance.  The TPU kernels
decided per 128-lane chunk and then ran the extra rounds on every lane of
the chunk, good lanes included; so the port differs from the JAX kernels,
within the gate, in lanes that shared a chunk with a bad lane.
"""

from __future__ import annotations

import ctypes

import torch

from quad_periodic_mpc_tpu_torch.ops.cuda import build
from quad_periodic_mpc_tpu_torch.ops.rotations import skew

NX = 13
NU = 12
NC = 20
NPACK = NU * (NU + 1) // 2          # upper triangle of Quu^{-1}
STREAM_BLOCK = 8                    # the reference's stage-block granularity
SOURCE = "stagewise_srb.cu"
SOURCE_SOLVE = "stagewise_solve.cu"
SOURCE_SOLVE_DENSE = "stagewise_solve_dense.cu"     # the srb_ad=False instantiation
SOURCE_STREAM = "stagewise_stream.cu"
# structured Ad = I + N: live rows / columns of N (reference _N_ROWS/_N_COLS)
N_ROWS = (0, 1, 2, 3, 4, 5, 11)
N_COLS = (6, 7, 8, 9, 10, 11, 12)

LAUNCHES = {"fused_stagewise_solve_srb": 0, "fused_stagewise_solve": 0,
            "fused_stagewise_solve_stream": 0, "srb_build_dump": 0}


class _Params(ctypes.Structure):
    _fields_ = (
        [(n, ctypes.c_int) for n in ("B", "h", "iters", "ns_it", "ns_warm",
                                     "srb_ad", "c_per_step")]
        + [(n, ctypes.c_float) for n in (
            "rho", "rho_inv", "a", "one_minus_a", "dt", "dt2", "dt3",
            "dt_inv_m", "dt2_inv_m", "dt3_inv_m", "d0", "d1", "d2")]
    )


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


def _solve_reference(
    Ad, Bd, c, x0, x_ref, Q, R_eff, F, l, u, U0, z0, y0,
    iters: int, rho: float, over_relax: float, ns_it: int,
    srb_ad: bool = True, pack_minv: bool = False, stats: dict | None = None,
):
    """The solve shared by the plain versions (the kernels' solve_body).

    c: (B, 13), or (B, h, 13) for a per-stage affine term.  srb_ad: Ad
    products as the identity plus the 7 live rows / columns of N = Ad - I,
    and Bd's zero row 12 skipped; else dense.  pack_minv: apply Quu^{-1}
    as the symmetric matrix its upper triangle gives (the streamed
    variant's packed storage).  Returns (U, z, y)."""
    Bn, h = x_ref.shape[0], x_ref.shape[1]
    dtype, device = x0.dtype, x0.device
    per_step_c = c.ndim == 3
    c_at = (lambda k: c[:, k]) if per_step_c else (lambda k: c)
    ns_warm = ns_warm_rounds(ns_it)
    rescued = 0
    nbd = NU if srb_ad else NX          # Bd row 12 is structurally zero
    Bdn = Bd[:, :nbd, :]
    BdnT = Bdn.transpose(1, 2)
    if srb_ad:
        N = Ad - torch.eye(NX, dtype=dtype, device=device)

        def row_A(X):                                    # X Ad, X (B, r, 13)
            out = X
            for m in N_ROWS:
                out = out + X[:, :, m:m + 1] * N[:, None, m, :]
            return out

        def At_P(P):                                     # Ad^T P
            out = P
            for m in N_ROWS:
                out = out + N[:, m, :, None] * P[:, None, m, :]
            return out

        def At_v(v):                                     # Ad^T v
            out = v
            for m in N_ROWS:
                out = out + N[:, m, :] * v[:, m:m + 1]
            return out

        def A_x(x):                                      # Ad x
            out = x
            for m in N_COLS:
                out = out + N[:, :, m] * x[:, m:m + 1]
            return out
    else:
        AdT = Ad.transpose(1, 2)
        row_A = lambda X: X @ Ad
        At_P = lambda P: AdT @ P
        At_v = lambda v: (AdT @ v[..., None])[..., 0]
        A_x = lambda x: (Ad @ x[..., None])[..., 0]

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
        M_s[k] = (torch.triu(X) + torch.triu(X, 1).transpose(1, 2)) if pack_minv else X
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


def fused_stagewise_solve_srb_reference(
    R, r_feet, x_drag, f_est, x0, x_ref, Q, R_eff, F, l, u, U0, z0, y0,
    iters: int, rho: float, over_relax: float = 1.6, ns_it: int = 16,
    dt: float = 0.026, mass: float = 12.0,
    i_inv_diag: tuple = (1 / 0.07, 1 / 0.26, 1 / 0.242),
    stats: dict | None = None,
):
    """Plain PyTorch version of the fused-build kernel.  Returns (U, z, y).

    stats: optional dict; receives "rescued", the number of
    (instance, stage) pairs whose warm NS inverse failed the gate and
    restarted cold (the data-dependent part of the kernel's work)."""
    Ad, Bd, c = srb_assemble(R, r_feet, x_drag, f_est, dt, mass, i_inv_diag)
    return _solve_reference(Ad, Bd, c, x0, x_ref, Q, R_eff, F, l, u, U0, z0, y0,
                            iters, rho, over_relax, ns_it, stats=stats)


def fused_stagewise_solve_reference(
    Ad, Bd, c, x0, x_ref, Q, R_eff, F, l, u, U0, z0, y0,
    iters: int, rho: float, over_relax: float = 1.6, ns_it: int = 16,
    srb_ad: bool = True, stats: dict | None = None,
):
    """Plain PyTorch version of ``fused_stagewise_solve``."""
    return _solve_reference(Ad, Bd, c, x0, x_ref, Q, R_eff, F, l, u, U0, z0, y0,
                            iters, rho, over_relax, ns_it, srb_ad=srb_ad, stats=stats)


def fused_stagewise_solve_stream_reference(
    Ad, Bd, c, x0, x_ref, Q, R_eff, F, l, u, U0, z0, y0,
    iters: int, rho: float, over_relax: float = 1.6, ns_it: int = 16,
    stats: dict | None = None,
):
    """Plain PyTorch version of ``fused_stagewise_solve_stream``: the
    resident solve with Quu^{-1} applied as its upper triangle gives it.
    (What the kernel recomputes instead of storing, r_k and q_k, are the
    same numbers either way.)"""
    return _solve_reference(Ad, Bd, c, x0, x_ref, Q, R_eff, F, l, u, U0, z0, y0,
                            iters, rho, over_relax, ns_it, pack_minv=True, stats=stats)


def _check_common(x0, x_ref, Q, R_eff, F, l, u, U0, z0, y0) -> tuple[int, int]:
    """Raise on what no stagewise kernel takes (on every device)."""
    Bn, h = x_ref.shape[0], x_ref.shape[1]
    device = x0.device
    named = {
        "x0": (x0, (Bn, NX)), "x_ref": (x_ref, (Bn, h, NX)),
        "Q": (Q, (NX,)), "R_eff": (R_eff, (NU, NU)), "F": (F, (5, 3)),
        "l": (l, (Bn, h, NC)), "u": (u, (Bn, h, NC)),
        "U0": (U0, (Bn, h, NU)), "z0": (z0, (Bn, h, NC)),
        "y0": (y0, (Bn, h, NC)),
    }
    for name, (t, shape) in named.items():
        build.check(name, t, shape, device)
    if h < 1 or Bn < 1:
        raise ValueError("need B >= 1 and h >= 1")
    return Bn, h


def _check_observation(R, r_feet, x_drag, f_est, Bn: int, device) -> None:
    build.check("R", R, (Bn, 3, 3), device)
    build.check("r_feet", r_feet, (Bn, 4, 3), device)
    build.check("x_drag", x_drag, (Bn,), device)
    build.check("f_est", f_est, (Bn, 6), device)


def _check_dynamics(Ad, Bd, c, x0, x_ref, Q, R_eff, F, l, u, U0, z0, y0) -> None:
    Bn, h = _check_common(x0, x_ref, Q, R_eff, F, l, u, U0, z0, y0)
    device = x0.device
    build.check("Ad", Ad, (Bn, NX, NX), device)
    build.check("Bd", Bd, (Bn, NX, NU), device)
    if c.ndim not in (2, 3):
        raise ValueError(f"c: expected (B, 13) or (B, h, 13), got {tuple(c.shape)}")
    build.check("c", c, (Bn, h, NX) if c.ndim == 3 else (Bn, NX), device)


def _params(Bn, h, iters, rho, over_relax, ns_it, **extra) -> _Params:
    return _Params(
        B=Bn, h=h, iters=int(iters), ns_it=int(ns_it),
        ns_warm=ns_warm_rounds(int(ns_it)), rho=float(rho),
        rho_inv=1.0 / float(rho), a=float(over_relax),
        one_minus_a=1.0 - float(over_relax), **extra)


def _dispatch(device, cuda_fn, reference_fn, args, kw):
    """CPU tensors take the plain version, CUDA tensors the kernel."""
    if device.type == "cpu":
        return reference_fn(*args, **kw)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return cuda_fn(*args, **kw)


def fused_stagewise_solve_srb(
    R, r_feet, x_drag, f_est, x0, x_ref, Q, R_eff, F, l, u, U0, z0, y0,
    iters: int, rho: float, over_relax: float = 1.6, ns_it: int = 16,
    dt: float = 0.026, mass: float = 12.0,
    i_inv_diag: tuple = (1 / 0.07, 1 / 0.26, 1 / 0.242),
):
    """Fused-build stagewise solve; arguments and shapes as the reference's:
    R (B,3,3), r_feet (B,4,3), x_drag (B,), f_est (B,6), x0 (B,13),
    x_ref (B,h,13), Q (13,), R_eff (12,12), F (5,3), l/u/z0/y0 (B,h,20),
    U0 (B,h,12), all float32 and contiguous.  Returns (U, z, y).

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream and raise if the launch fails."""
    kw = dict(iters=iters, rho=rho, over_relax=over_relax, ns_it=ns_it, dt=dt,
              mass=mass, i_inv_diag=i_inv_diag)
    args = (R, r_feet, x_drag, f_est, x0, x_ref, Q, R_eff, F, l, u, U0, z0, y0)
    Bn, _ = _check_common(*args[4:])
    _check_observation(R, r_feet, x_drag, f_est, Bn, x0.device)
    return _dispatch(x0.device, _fused_stagewise_solve_srb_cuda,
                     fused_stagewise_solve_srb_reference, args, kw)


def fused_stagewise_solve(
    Ad, Bd, c, x0, x_ref, Q, R_eff, F, l, u, U0, z0, y0,
    iters: int, rho: float, over_relax: float = 1.6, ns_it: int = 16,
    srb_ad: bool = True,
):
    """Stagewise solve on caller-built dynamics: Ad (B,13,13), Bd (B,13,12),
    c (B,13) or per stage (B,h,13); the rest as ``fused_stagewise_solve_srb``.
    Returns (U, z, y).

    srb_ad (default True): Ad and Bd carry the sparsity of the nilpotent
    SRB discretisation (true of every problem ``problem.build_stagewise``
    builds) and only the live rows are contracted; pass False for a
    general dense Ad."""
    kw = dict(iters=iters, rho=rho, over_relax=over_relax, ns_it=ns_it, srb_ad=srb_ad)
    args = (Ad, Bd, c, x0, x_ref, Q, R_eff, F, l, u, U0, z0, y0)
    _check_dynamics(*args)
    return _dispatch(x0.device, _fused_stagewise_solve_cuda,
                     fused_stagewise_solve_reference, args, kw)


def fused_stagewise_solve_stream(
    Ad, Bd, c, x0, x_ref, Q, R_eff, F, l, u, U0, z0, y0,
    iters: int, rho: float, over_relax: float = 1.6, ns_it: int = 16,
):
    """The long-horizon solve (``ops/qp_stagewise.solve`` sends it
    64 < h <= 128); arguments as ``fused_stagewise_solve``, structured Ad.
    Requires h % 8 == 0, the reference's stage-block granularity.
    Returns (U, z, y)."""
    h = x_ref.shape[1]
    if h % STREAM_BLOCK != 0:
        raise ValueError(f"the streamed solve needs h % {STREAM_BLOCK} == 0, got h = {h}")
    kw = dict(iters=iters, rho=rho, over_relax=over_relax, ns_it=ns_it)
    args = (Ad, Bd, c, x0, x_ref, Q, R_eff, F, l, u, U0, z0, y0)
    _check_dynamics(*args)
    return _dispatch(x0.device, _fused_stagewise_solve_stream_cuda,
                     fused_stagewise_solve_stream_reference, args, kw)


def srb_build_dump(R, r_feet, x_drag, f_est, dt: float = 0.026, mass: float = 12.0,
                   i_inv_diag: tuple = (1 / 0.07, 1 / 0.26, 1 / 0.242)):
    """The SRB build of ``fused_stagewise_solve_srb`` written out (audit
    hook): (Ad (B,13,13), Bd (B,13,12), c (B,13)).  On the card it is the
    kernel's own assembly function; on the CPU ``srb_assemble``."""
    _check_observation(R, r_feet, x_drag, f_est, x_drag.shape[0], x_drag.device)
    return _dispatch(x_drag.device, _srb_build_dump_cuda, srb_assemble,
                     (R, r_feet, x_drag, f_est), dict(dt=dt, mass=mass, i_inv_diag=i_inv_diag))


def _gain_scratch(Bn: int, h: int, minv: int, f32: dict) -> list:
    """Per-stage gains, instance-minor ([stage][row][col][B]): K, Quu^{-1}
    (``minv`` entries per stage), P c, v = Pc + p; and the Riccati carry."""
    return [
        torch.empty(h * NU * NX * Bn, **f32),   # K
        torch.empty(h * minv * Bn, **f32),      # Quu^{-1}
        torch.empty(h * NX * Bn, **f32),        # P c
        torch.empty(h * NX * Bn, **f32),        # v = Pc + p
        torch.empty(NX * NX * Bn, **f32),       # Riccati carry P
    ]


def _resident_buffers(Bn: int, h: int, f32: dict) -> tuple[list, list]:
    """The resident kernels' outputs (U, z, y) and their scratch in launch
    order: the gains, with the stored r_lin and q_stage before the carry."""
    out = [torch.empty(Bn, h, r, **f32) for r in (NU, NC, NC)]
    K, Minv, Pc, v, P = _gain_scratch(Bn, h, NU * NU, f32)
    r_lin, q_stage = torch.empty(h * NU * Bn, **f32), torch.empty(h * NX * Bn, **f32)
    return out, [K, Minv, Pc, v, r_lin, q_stage, P]


def _fused_stagewise_solve_srb_cuda(
    R, r_feet, x_drag, f_est, x0, x_ref, Q, R_eff, F, l, u, U0, z0, y0,
    iters, rho, over_relax, ns_it, dt, mass, i_inv_diag,
):
    """Allocate outputs and scratch, launch the kernel (inputs checked)."""
    Bn, h = x_ref.shape[0], x_ref.shape[1]
    device = x0.device
    with torch.cuda.device(device):
        out, scratch = _resident_buffers(Bn, h, dict(dtype=torch.float32, device=device))
        d = [float(v) for v in i_inv_diag]
        params = _params(Bn, h, iters, rho, over_relax, ns_it, srb_ad=1, c_per_step=0,
                         d0=d[0], d1=d[1], d2=d[2], **_constants(float(dt), float(mass)))
        build.launch(SOURCE, "stagewise_srb_launch",
                     [R, r_feet, x_drag, f_est, x0, x_ref, l, u, U0, z0, y0, Q, R_eff,
                      F, *out, *scratch], params, device)
    LAUNCHES["fused_stagewise_solve_srb"] += 1
    return tuple(out)


def _fused_stagewise_solve_cuda(
    Ad, Bd, c, x0, x_ref, Q, R_eff, F, l, u, U0, z0, y0,
    iters, rho, over_relax, ns_it, srb_ad,
):
    """Allocate outputs and scratch, launch the kernel (inputs checked)."""
    Bn, h = x_ref.shape[0], x_ref.shape[1]
    device = x0.device
    with torch.cuda.device(device):
        out, scratch = _resident_buffers(Bn, h, dict(dtype=torch.float32, device=device))
        params = _params(Bn, h, iters, rho, over_relax, ns_it, srb_ad=int(bool(srb_ad)),
                         c_per_step=int(c.ndim == 3))
        source, fn = ((SOURCE_SOLVE, "stagewise_solve_launch") if srb_ad
                      else (SOURCE_SOLVE_DENSE, "stagewise_solve_dense_launch"))
        build.launch(source, fn,
                     [Ad, Bd, c, x0, x_ref, l, u, U0, z0, y0, Q, R_eff, F, *out, *scratch],
                     params, device)
    LAUNCHES["fused_stagewise_solve"] += 1
    return tuple(out)


def _fused_stagewise_solve_stream_cuda(
    Ad, Bd, c, x0, x_ref, Q, R_eff, F, l, u, U0, z0, y0,
    iters, rho, over_relax, ns_it,
):
    """Copy the warm start into the outputs (the kernel updates them in
    place), allocate scratch, launch the kernel (inputs checked)."""
    Bn, h = x_ref.shape[0], x_ref.shape[1]
    device = x0.device
    with torch.cuda.device(device):
        f32 = dict(dtype=torch.float32, device=device)
        U, z, y = U0.clone(), z0.clone(), y0.clone()
        K, Minv, Pc, v, P = _gain_scratch(Bn, h, NPACK, f32)
        params = _params(Bn, h, iters, rho, over_relax, ns_it, srb_ad=1,
                         c_per_step=int(c.ndim == 3))
        build.launch(SOURCE_STREAM, "stagewise_stream_launch",
                     [Ad, Bd, c, x0, x_ref, l, u, Q, R_eff, F, U, z, y, K, Minv, Pc, v, P],
                     params, device)
    LAUNCHES["fused_stagewise_solve_stream"] += 1
    return U, z, y


def _srb_build_dump_cuda(R, r_feet, x_drag, f_est, dt, mass, i_inv_diag):
    """Allocate the outputs, launch the dump kernel (inputs checked)."""
    Bn = x_drag.shape[0]
    device = x_drag.device
    with torch.cuda.device(device):
        f32 = dict(dtype=torch.float32, device=device)
        Ad = torch.empty(Bn, NX, NX, **f32)
        Bd = torch.empty(Bn, NX, NU, **f32)
        c = torch.empty(Bn, NX, **f32)
        d = [float(v) for v in i_inv_diag]
        params = _Params(B=Bn, d0=d[0], d1=d[1], d2=d[2],
                         **_constants(float(dt), float(mass)))
        build.launch(SOURCE, "srb_build_dump_launch",
                     [R, r_feet, x_drag, f_est, Ad, Bd, c], params, device)
    LAUNCHES["srb_build_dump"] += 1
    return Ad, Bd, c
