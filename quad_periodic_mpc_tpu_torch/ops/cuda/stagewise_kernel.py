"""Fused-build stagewise Riccati-ADMM solve: CUDA kernel, wrapper and its
plain PyTorch version.

Replaces ``quad_periodic_mpc_tpu/ops/pallas/stagewise_kernel.py
::fused_stagewise_solve_srb`` (``_kernel_srb``).  The kernel source is
``quad_periodic_mpc_tpu_torch/csrc/stagewise_srb.cu``; its header note
says what it computes, what bounds it on an H100 and how the design is
laid out (one thread per instance, gains in instance-minor device
scratch).

- ``fused_stagewise_solve_srb``: the wrapper.  CUDA tensors launch the
  kernel (or raise); CPU tensors take the plain version.
- ``fused_stagewise_solve_srb_reference``: the plain version, the same
  sequential algorithm in batched torch ops in the same elimination order.
  The tests use it, and ``control/mpc.mpc_step`` uses it on the CPU.
- ``srb_assemble``: the in-kernel SRB build written in torch (the
  counterpart of the reference's ``srb_build_dump`` audit).
- ``LAUNCHES``: kernel launches since the count was last reset.

NS rescue semantics: a stage whose warm Newton-Schulz inverse fails the
2e-3 residual gate restarts cold on its own instance.  The TPU kernel
decided per 128-lane chunk and then ran the extra rounds on every lane of
the chunk, good lanes included; so the port differs from the JAX kernel,
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
SOURCE = "stagewise_srb.cu"
# structured Ad = I + N: live rows / columns of N (reference _N_ROWS/_N_COLS)
N_ROWS = (0, 1, 2, 3, 4, 5, 11)
N_COLS = (6, 7, 8, 9, 10, 11, 12)

LAUNCHES = 0


class _Params(ctypes.Structure):
    _fields_ = (
        [(n, ctypes.c_int) for n in ("B", "h", "iters", "ns_it", "ns_warm")]
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


def fused_stagewise_solve_srb_reference(
    R, r_feet, x_drag, f_est, x0, x_ref, Q, R_eff, F, l, u, U0, z0, y0,
    iters: int, rho: float, over_relax: float = 1.6, ns_it: int = 16,
    dt: float = 0.026, mass: float = 12.0,
    i_inv_diag: tuple = (1 / 0.07, 1 / 0.26, 1 / 0.242),
    stats: dict | None = None,
):
    """Plain PyTorch version of the kernel.  Returns (U, z, y).

    stats: optional dict; receives "rescued", the number of
    (instance, stage) pairs whose warm NS inverse failed the gate and
    restarted cold (the data-dependent part of the kernel's work)."""
    Ad, Bd, c = srb_assemble(R, r_feet, x_drag, f_est, dt, mass, i_inv_diag)
    Bn, h = x_ref.shape[0], x_ref.shape[1]
    dtype, device = x0.dtype, x0.device
    N = Ad - torch.eye(NX, dtype=dtype, device=device)
    Bd12 = Bd[:, :NU, :]                 # Bd row 12 is structurally zero
    Bd12T = Bd12.transpose(1, 2)
    ns_warm = ns_warm_rounds(ns_it)
    rescued = 0

    # ---- backward Riccati ----
    Qm = torch.diag(Q).expand(Bn, NX, NX)
    P = Qm.clone()
    K_s, M_s, Pc_s = [None] * h, [None] * h, [None] * h
    X = torch.zeros(Bn, NU, NU, dtype=dtype, device=device)
    for kk in range(h):
        k = h - 1 - kk
        BtP = Bd12T @ P[:, :NU, :]                       # (B, 12, 13)
        Quu = R_eff + BtP[:, :, :NU] @ Bd12
        X, n_bad = stage_quu_inverse(Quu, X, kk == 0, ns_it, ns_warm)
        rescued += n_bad
        Qux = BtP
        for m in N_ROWS:                                 # BtP Ad
            Qux = Qux + BtP[:, :, m:m + 1] * N[:, None, m, :]
        K = X @ Qux
        K_s[k], M_s[k] = K, X
        Pc_s[k] = (P @ c[..., None])[..., 0]
        AtP = P
        for m in N_ROWS:                                 # Ad^T P
            AtP = AtP + N[:, m, :, None] * P[:, None, m, :]
        ata = AtP
        for m in N_ROWS:                                 # Ad^T P Ad
            ata = ata + AtP[:, :, m:m + 1] * N[:, None, m, :]
        Pn = (Qm + ata) - Qux.transpose(1, 2) @ K
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
            s = (Bd12T @ v[:, :NU, None])[..., 0] - rk
            atv = v
            for m in N_ROWS:                             # Ad^T v
                atv = atv + N[:, m, :] * v[:, m:m + 1]
            p = (q_s[k] + atv) - (K_s[k].transpose(1, 2) @ s[..., None])[..., 0]
        x = x0
        for k in range(h):
            s = (Bd12T @ v_s[k][:, :NU, None])[..., 0] - r_s[k]
            kff = (M_s[k] @ s[..., None])[..., 0]
            ut = -(K_s[k] @ x[..., None])[..., 0] - kff
            ax = x
            for m in N_COLS:                             # Ad x
                ax = ax + N[:, :, m] * x[:, m:m + 1]
            x = (ax + (Bd @ ut[..., None])[..., 0]) + c
            U[:, k] = a * ut + (1.0 - a) * U[:, k]
            Fu = (F * ut.reshape(Bn, 4, 1, 3)).sum(-1).reshape(Bn, NC)
            fur = a * Fu + (1.0 - a) * z[:, k]
            zn = torch.clamp(fur + rho_inv * y[:, k], l[:, k], u[:, k])
            y[:, k] = y[:, k] + rho * (fur - zn)
            z[:, k] = zn
    if stats is not None:
        stats["rescued"] = rescued
    return U, z, y


def _check_inputs(R, r_feet, x_drag, f_est, x0, x_ref, Q, R_eff, F, l, u, U0, z0, y0):
    """Raise on what the kernel does not take (on every device)."""
    Bn, h = x_ref.shape[0], x_ref.shape[1]
    device = x0.device
    named = {
        "R": (R, (Bn, 3, 3)), "r_feet": (r_feet, (Bn, 4, 3)),
        "x_drag": (x_drag, (Bn,)), "f_est": (f_est, (Bn, 6)),
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
    _check_inputs(*args)
    if x0.device.type == "cpu":
        return fused_stagewise_solve_srb_reference(*args, **kw)
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    return _fused_stagewise_solve_srb_cuda(*args, **kw)


def _fused_stagewise_solve_srb_cuda(
    R, r_feet, x_drag, f_est, x0, x_ref, Q, R_eff, F, l, u, U0, z0, y0,
    iters, rho, over_relax, ns_it, dt, mass, i_inv_diag,
):
    """Allocate outputs and scratch, launch the kernel (inputs checked)."""
    global LAUNCHES
    Bn, h = x_ref.shape[0], x_ref.shape[1]
    device = x0.device
    with torch.cuda.device(device):
        f32 = dict(dtype=torch.float32, device=device)
        U = torch.empty(Bn, h, NU, **f32)
        z = torch.empty(Bn, h, NC, **f32)
        y = torch.empty(Bn, h, NC, **f32)
        # per-stage gains, instance-minor: [stage][row][col][B]
        scratch = [
            torch.empty(h * NU * NX * Bn, **f32),   # K
            torch.empty(h * NU * NU * Bn, **f32),   # Quu^{-1}
            torch.empty(h * NX * Bn, **f32),        # P c
            torch.empty(h * NX * Bn, **f32),        # v = Pc + p
            torch.empty(h * NU * Bn, **f32),        # r_lin
            torch.empty(h * NX * Bn, **f32),        # q_stage
            torch.empty(NX * NX * Bn, **f32),       # Riccati carry P
        ]
        k = _constants(float(dt), float(mass))
        d = [float(v) for v in i_inv_diag]
        params = _Params(
            B=Bn, h=h, iters=int(iters), ns_it=int(ns_it),
            ns_warm=ns_warm_rounds(int(ns_it)), rho=float(rho),
            rho_inv=1.0 / float(rho), a=float(over_relax),
            one_minus_a=1.0 - float(over_relax), d0=d[0], d1=d[1], d2=d[2],
            **k,
        )
        build.launch(SOURCE, "stagewise_srb_launch",
                     [R, r_feet, x_drag, f_est, x0, x_ref, l, u, U0, z0, y0, Q, R_eff,
                      F, U, z, y, *scratch], params, device)
    LAUNCHES += 1
    return U, z, y
