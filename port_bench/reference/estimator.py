"""Periodic external-disturbance estimator, batched, in the mode the
configurations run ("ls").

Each MPC solve extracts a disturbance residual from the previous solve's
round-tripped data (``residual_discrete``), pushes it into a sliding
window, and ``update`` turns the window into the wrench the QP consumes:
Gaussian blur (sigma_fast), FFT-peak frequency guess refined on a
two-stage grid, and a linear least-squares fit of c + B sin(wt) + D cos(wt)
(SolverMPC.cpp:1106-1235); released once count >= ls_release."""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from port_bench.reference.config import EstimatorConfig
from port_bench.reference.consts import const


class EstimatorState(NamedTuple):
    times: torch.Tensor        # (..., window) ordered, newest last
    diffs: torch.Tensor        # (..., window) component-3 series
    wrench_hist: torch.Tensor  # (..., window, 6) full residual history
    count: torch.Tensor        # (...,) int32 samples pushed
    est_amp: torch.Tensor
    est_freq: torch.Tensor
    est_phase: torch.Tensor
    est_stat: torch.Tensor
    est_sin: torch.Tensor
    est_cos: torch.Tensor
    est6_freq: torch.Tensor    # (..., 6)
    est6_stat: torch.Tensor
    est6_sin: torch.Tensor
    est6_cos: torch.Tensor
    f_est: torch.Tensor        # (..., 6)
    f_est_smoothed: torch.Tensor
    f_est_static: torch.Tensor


def init(batch: tuple = (), window: int = 400, dtype=torch.float32,
         device="cuda") -> EstimatorState:
    z = lambda *s: torch.zeros(batch + s, dtype=dtype, device=device)
    return EstimatorState(
        times=z(window), diffs=z(window), wrench_hist=z(window, 6),
        count=torch.zeros(batch, dtype=torch.int32, device=device),
        est_amp=z(), est_freq=z(), est_phase=z(), est_stat=z(),
        est_sin=z(), est_cos=z(),
        est6_freq=z(6), est6_stat=z(6), est6_sin=z(6), est6_cos=z(6),
        f_est=z(6), f_est_smoothed=z(6), f_est_static=z(6),
    )


@functools.lru_cache(maxsize=8)
def _gauss_kernel(sigma: float) -> np.ndarray:
    """Normalized Gaussian kernel, radius ceil(3 sigma)
    (gaussian_filter, SolverMPC.cpp:404-419)."""
    radius = int(np.ceil(3 * sigma))
    i = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * i * i / (sigma * sigma))
    return k / k.sum()


@functools.lru_cache(maxsize=16)
def _gauss_band_matrix(sigma: float, length: int) -> np.ndarray:
    """Banded correlation matrix (length, length + 2 radius) of
    ``_gauss_kernel(sigma)``."""
    k = _gauss_kernel(sigma)
    M = np.zeros((length, length + k.shape[0] - 1), np.float64)
    for r in range(length):
        M[r, r: r + k.shape[0]] = k
    return M


def gaussian_filter(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Edge-replicated 1-D Gaussian blur along the last axis, as one shared
    banded matrix product: out[i] = sum_j k[j] xp[i + j]."""
    M = const(_gauss_band_matrix(sigma, x.shape[-1]), x.dtype, x.device)
    r = (M.shape[1] - x.shape[-1]) // 2
    lo = x[..., :1].expand(x.shape[:-1] + (r,))
    hi = x[..., -1:].expand(x.shape[:-1] + (r,))
    xp = torch.cat([lo, x, hi], dim=-1)
    return xp @ M.T


class SinFit(NamedTuple):
    amp: torch.Tensor
    freq: torch.Tensor
    phase: torch.Tensor
    offset: torch.Tensor


def fit_sin_ls(times: torch.Tensor, y: torch.Tensor):
    """Least-squares sinusoid fit: FFT-peak frequency guess, a two-stage
    17-point grid around it (net resolution bin/64), and at each candidate
    the Tikhonov-regularized 3x3 normal equations of
    y ~ B sin(wt) + D cos(wt) + c solved by Cramer's rule.

    Returns (SinFit, B, D) with y(t) ~ c + B sin(w t) + D cos(w t).
    """
    dtype = y.dtype
    n = y.shape[-1]
    dt = times[..., 1] - times[..., 0]
    ym = y - y.mean(dim=-1, keepdim=True)
    spec = torch.abs(torch.fft.rfft(ym, dim=-1))
    mag = spec.clone()
    mag[..., 0].fill_(-float("inf"))
    k = torch.argmax(mag, dim=-1)
    kc = torch.clamp(k, 1, spec.shape[-1] - 2).to(dtype)
    bin_f = 1.0 / (n * dt)
    yy = (y * y).sum(dim=-1)
    pi = const(np.pi, dtype, y.device)

    def ls_at(freq):
        w = 2.0 * pi * freq
        s = torch.sin(w[..., None] * times)
        c = torch.cos(w[..., None] * times)
        inv_n = 1.0 / n
        ss = (s * s).sum(-1) * inv_n
        cc = (c * c).sum(-1) * inv_n
        sc = (s * c).sum(-1) * inv_n
        s1 = s.sum(-1) * inv_n
        c1 = c.sum(-1) * inv_n
        ys = (y * s).sum(-1) * inv_n
        yc = (y * c).sum(-1) * inv_n
        y1 = y.mean(dim=-1)
        reg = 1e-6
        g11 = ss + reg
        g22 = cc + reg
        g33 = 1.0 + reg
        a11 = g22 * g33 - c1 * c1
        a12 = s1 * c1 - sc * g33
        a13 = sc * c1 - g22 * s1
        a22 = g11 * g33 - s1 * s1
        a23 = sc * s1 - g11 * c1
        a33 = g11 * g22 - sc * sc
        det = g11 * a11 + sc * a12 + s1 * a13
        inv_det = 1.0 / det
        cb = (a11 * ys + a12 * yc + a13 * y1) * inv_det
        cd = (a12 * ys + a22 * yc + a23 * y1) * inv_det
        co = (a13 * ys + a23 * yc + a33 * y1) * inv_det
        coef = torch.stack([cb, cd, co], dim=-1)
        gq = (
            cb * (g11 * cb + sc * cd + s1 * co)
            + cd * (sc * cb + g22 * cd + c1 * co)
            + co * (s1 * cb + c1 * cd + g33 * co)
        )
        sse = yy * inv_n - 2.0 * (cb * ys + cd * yc + co * y1) + gq
        return sse, coef

    offsets = const(np.linspace(-1.0, 1.0, 17), dtype, y.device)

    def grid_pick(center, half_span):
        cand = center[..., None] + offsets * half_span[..., None]   # (..., 17)
        cand = torch.maximum(cand, 0.1 * bin_f[..., None])
        cand_t = torch.movedim(cand, -1, 0)                         # (17, ...)
        sse, coef = ls_at(cand_t)
        best = torch.argmin(sse, dim=0)
        freq = torch.gather(cand_t, 0, best[None])[0]
        coef = torch.gather(
            coef, 0, best[None, ..., None].expand((1,) + coef.shape[1:]))[0]
        return freq, coef

    freq, _ = grid_pick(kc * bin_f, bin_f)
    freq, coef = grid_pick(freq, bin_f / 8.0)
    B, D, off = coef[..., 0], coef[..., 1], coef[..., 2]
    amp = torch.sqrt(B * B + D * D)
    ph = torch.atan2(D, B)
    return SinFit(amp=amp, freq=freq, phase=ph, offset=off), B, D


def update(
    state: EstimatorState,
    sim_time: torch.Tensor,
    f_ext: torch.Tensor,
    cfg: EstimatorConfig,
) -> tuple[EstimatorState, torch.Tensor]:
    """One estimator step (per MPC solve) in mode "ls".  Returns
    (new_state, f_for_qp)."""
    if cfg.mode != "ls":
        raise ValueError(f"estimator mode {cfg.mode!r}: the reference runs \"ls\" only")
    ema_smooth, ema_static = cfg.ema_smooth, cfg.ema_static
    dtype = state.diffs.dtype
    times = torch.cat(
        [state.times[..., 1:], sim_time[..., None].to(dtype)], dim=-1)
    diffs = torch.cat(
        [state.diffs[..., 1:], f_ext[..., 3:4].to(dtype)], dim=-1)
    wrench_hist = torch.cat(
        [state.wrench_hist[..., 1:, :], f_ext[..., None, :].to(dtype)], dim=-2)
    count = state.count + 1
    two_pi = const(2.0 * np.pi, dtype, diffs.device)
    have_fit = count >= cfg.window

    f_est_static = state.f_est_static.clone()
    f_est_static[..., 3] = (
        ema_static * state.f_est_static[..., 3]
        + (1.0 - ema_static) * f_ext[..., 3]
    )
    fit, B, D = fit_sin_ls(times, gaussian_filter(diffs, cfg.sigma_fast))
    fit_active = have_fit
    est_sin = torch.where(fit_active, B, state.est_sin)
    est_cos = torch.where(fit_active, D, state.est_cos)
    est_amp = torch.where(fit_active, fit.amp, state.est_amp)
    est_freq = torch.where(fit_active, fit.freq, state.est_freq)
    est_phase = torch.where(fit_active, fit.phase, state.est_phase)
    est_stat = torch.where(fit_active, fit.offset, state.est_stat)
    wt = two_pi * est_freq * sim_time
    comp = est_stat + est_sin * torch.sin(wt) + est_cos * torch.cos(wt)
    release = count >= cfg.ls_release

    f_est = state.f_est.clone()
    f_est[..., 3] = torch.where(have_fit, comp, state.f_est[..., 3])
    f_est_smoothed = ema_smooth * state.f_est_smoothed + (1.0 - ema_smooth) * f_est

    new_state = state._replace(
        times=times, diffs=diffs, wrench_hist=wrench_hist, count=count,
        est_amp=est_amp, est_freq=est_freq, est_phase=est_phase,
        est_stat=est_stat, est_sin=est_sin, est_cos=est_cos,
        f_est=f_est, f_est_smoothed=f_est_smoothed, f_est_static=f_est_static,
    )
    f_for_qp = torch.where(release[..., None], f_est, torch.zeros_like(f_est))
    return new_state, f_for_qp


def residual_discrete(
    x_k: torch.Tensor,
    x_prev: torch.Tensor,
    u_prev_forces: torch.Tensor,
    R_prev: torch.Tensor,
    r_feet_prev: torch.Tensor,
    mass,
    I_body_diag,
    x_drag_prev,
    dt,
) -> torch.Tensor:
    """Discrete disturbance residual: the least-squares w of
    Qd w = x_k - Ad x_prev - Bd u_prev, matrix-free through the nilpotent
    structure (A^2 has only row 5; A^3 = 0), with the 6x6 normal equations
    solved by ``linalg.spd_inverse``.  u_prev are the world-frame MPC
    reaction forces Fr_des."""
    from port_bench.reference import linalg

    dtype, device = x_k.dtype, x_k.device
    dts = const(dt, dtype, device)
    xd = const(x_drag_prev, dtype, device)
    RT = R_prev.transpose(-1, -2)

    def mv(M, v):
        return (M @ v[..., None])[..., 0]

    def apply_A(v):
        """Continuous A @ v: rows 0:3 = R^T v[6:9], rows 3:6 = v[9:12],
        row 11 = x_drag v[9] + v[12], everything else zero."""
        top = mv(RT, v[..., 6:9])
        mid = v[..., 9:12]
        z3 = torch.zeros_like(top)
        z1 = torch.zeros_like(v[..., 0:1])
        row11 = xd[..., None] * v[..., 9:10] + v[..., 12:13]
        return torch.cat([top, mid, z3, z1, z1, row11, z1], dim=-1)

    def a2_row5(v):
        return xd * v[..., 9] + v[..., 12]

    def apply_Phi(v):
        out = dts * v + (dts * dts / 2.0) * apply_A(v)
        out[..., 5] = out[..., 5] + (dts ** 3 / 6.0) * a2_row5(v)
        return out

    I_inv_diag = 1.0 / const(I_body_diag, dtype, device)
    tau_w = torch.linalg.cross(r_feet_prev, u_prev_forces, dim=-1).sum(dim=-2)
    omega_dot = mv(R_prev, I_inv_diag * mv(RT, tau_w))
    v_dot = u_prev_forces.sum(dim=-2) / const(mass, dtype, device)
    z3 = torch.zeros_like(v_dot)
    z1 = torch.zeros_like(v_dot[..., 0:1])
    Bu = torch.cat([z3, z3, omega_dot, v_dot, z1], dim=-1)

    Adt_x = x_prev + dts * apply_A(x_prev)
    Adt_x[..., 5] = Adt_x[..., 5] + (dts * dts / 2.0) * a2_row5(x_prev)
    xi = x_k - Adt_x - apply_Phi(Bu)

    batch = xi.shape[:-1]
    cols = []
    for i in range(6):
        e = torch.zeros(batch + (13,), dtype=dtype, device=device)
        e[..., 6 + i].fill_(1.0)
        cols.append(apply_Phi(e))
    Qdt = torch.stack(cols, dim=-1)                          # (..., 13, 6)
    G = Qdt.transpose(-1, -2) @ Qdt
    b = mv(Qdt.transpose(-1, -2), xi)
    return mv(linalg.spd_inverse(G), b)
