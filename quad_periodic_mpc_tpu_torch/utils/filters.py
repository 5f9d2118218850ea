"""Scalar/vector signal filters, functional and batched (counterpart of
``quad_periodic_mpc_tpu/utils/filters.py``).

Rebuilds src/common/Utilities/filters.{h,cpp} (butterworth, digital
low-pass, moving average, low-passed derivative) as pure
(state, x) -> (state, y) transitions: the reference's mutable filter
objects become explicit state tuples of tensors.

Every step computes in its input's dtype.  The biquad's coefficients are
Python floats here; the reference builds them as numpy float64 scalars, so
with JAX's 64-bit mode on its float32 inputs come out float64 (without it,
as on the TPU, they stay float32, as here).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class LowPassState(NamedTuple):
    y: torch.Tensor


def first_order_lp(state: LowPassState, x, alpha) -> tuple[LowPassState, torch.Tensor]:
    """y' = (1 - alpha) y + alpha x (FirstOrderIIRFilter.h; also the
    velocity-command filter at ConvexMPCLocomotion.cpp:106-117)."""
    y = (1.0 - alpha) * state.y + alpha * x
    return LowPassState(y), y


class BiquadState(NamedTuple):
    x1: torch.Tensor
    x2: torch.Tensor
    y1: torch.Tensor
    y2: torch.Tensor


def _zero_state(shape, dtype, device) -> BiquadState:
    return BiquadState(*(torch.zeros(shape, dtype=dtype, device=device) for _ in range(4)))


def make_digital_lp(w_c: float, t_s: float):
    """Second-order digital low-pass (digital_lp_filter, filters.cpp):
    Tustin discretization of wc^2 / (s^2 + sqrt(2) wc s + wc^2).

    Returns (init_state_fn, step_fn)."""
    lam = 2.0 / t_s
    den = lam * lam + math.sqrt(2.0) * w_c * lam + w_c * w_c
    b = [w_c * w_c / den, 2 * w_c * w_c / den, w_c * w_c / den]
    a = [1.0, (2 * w_c * w_c - 2 * lam * lam) / den,
         (lam * lam - math.sqrt(2.0) * w_c * lam + w_c * w_c) / den]

    def init(shape=(), dtype=torch.float32, device="cuda") -> BiquadState:
        return _zero_state(shape, dtype, device)

    def step(state: BiquadState, x):
        y = (b[0] * x + b[1] * state.x1 + b[2] * state.x2
             - a[1] * state.y1 - a[2] * state.y2)
        return BiquadState(x, state.x1, y, state.y1), y

    return init, step


def make_deriv_lp(w_c: float, t_s: float):
    """Low-passed differentiator (deriv_lp_filter, filters.cpp):
    s * wc / (s + wc), Tustin."""
    lam = 2.0 / t_s
    den = lam + w_c
    b1 = w_c * lam / den
    a1 = (w_c - lam) / den

    def init(shape=(), dtype=torch.float32, device="cuda") -> BiquadState:
        return _zero_state(shape, dtype, device)

    def step(state: BiquadState, x):
        y = b1 * (x - state.x1) - a1 * state.y1
        return BiquadState(x, state.x1, y, state.y1), y

    return init, step


class MovingAverageState(NamedTuple):
    buf: torch.Tensor    # (..., n)
    count: torch.Tensor  # (...,) int32


def moving_average_init(n: int, shape=(), dtype=torch.float32,
                        device="cuda") -> MovingAverageState:
    return MovingAverageState(
        buf=torch.zeros(tuple(shape) + (n,), dtype=dtype, device=device),
        count=torch.zeros(shape, dtype=torch.int32, device=device))


def moving_average(state: MovingAverageState, x) -> tuple[MovingAverageState, torch.Tensor]:
    """Windowed mean (moving_average_filter, filters.cpp), warmup-aware."""
    n = state.buf.shape[-1]
    x = torch.as_tensor(x, dtype=state.buf.dtype, device=state.buf.device)
    buf = torch.cat([state.buf[..., 1:], x[..., None]], dim=-1)
    count = torch.clamp(state.count + 1, max=n)
    mask = torch.arange(n, device=buf.device) >= (n - count[..., None])
    y = torch.sum(buf * mask, dim=-1) / torch.clamp(count, min=1)
    return MovingAverageState(buf, count), y
