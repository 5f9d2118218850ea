"""Offset-duration gait timing, vectorized
(frozen copy of the port's ``quad_periodic_mpc_tpu_torch/ops/gait.py``).

A gait is (offsets[4], durations[4], n_segments) in MPC segments
(OffsetDurationGait, Gait.cpp); phases and the horizon contact table are
functions of the global control-tick counter.  The presets reproduce
ConvexMPCLocomotion.cpp:41-52 at the runtime period (default 16).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class GaitParams(NamedTuple):
    """Gait parameters; every field may carry batch dims."""

    offsets: torch.Tensor      # (..., 4) int segments
    durations: torch.Tensor    # (..., 4) int segments (stance length)
    n_segments: torch.Tensor   # (...,) int period in MPC segments


def _preset_tables(period: int) -> dict[str, tuple[tuple[int, ...], tuple[int, ...]]]:
    """(offsets, durations) per gait (ConvexMPCLocomotion.cpp:41-52,
    CMPC_Locomotion.cpp:52-70)."""
    p = period
    return {
        "trotting": ((0, p // 2, p // 2, 0), (p // 2,) * 4),
        "bounding": ((5, 5, 0, 0), (4, 4, 4, 4)),
        "pronking": ((0, 0, 0, 0), (8, 8, 8, 8)),
        "jumping": ((0, 0, 0, 0), (2, 2, 2, 2)),
        "galloping": ((0, 2, 7, 9), (4, 4, 4, 4)),
        "standing": ((0, 0, 0, 0), (p,) * 4),
        "trot_running": ((0, 5, 5, 0), (4, 4, 4, 4)),
        "walking": ((2 * p // 4, 0, p // 4, 3 * p // 4), (int(0.75 * p),) * 4),
        "walking2": ((0, 5, 5, 0), (7, 7, 7, 7)),
        "pacing": ((5, 0, 5, 0), (5, 5, 5, 5)),
        "trot_long": ((0, 16, 16, 0), (24, 24, 24, 24)),
        "trot_contact": ((0, p // 2, p // 2, 0), (p // 4,) * 4),
        "give_hand": ((0, 0, 0, 0), (p,) * 4),
        "two_leg_balance": ((0, 0, 0, 0), (p, p, p, 0)),
    }


# period hardwired regardless of the gait_period dyn param
# (_gait_period_long = 32, CMPC_Locomotion.cpp:46)
_FIXED_PERIODS: dict[str, int] = {"trot_long": 32}

DEFAULT_PERIOD = 16
PRESET_GAITS = _preset_tables(DEFAULT_PERIOD)
PRESET_NAMES = tuple(PRESET_GAITS)


def preset(name: str, period: int = DEFAULT_PERIOD, dtype=torch.int32,
           device="cuda") -> GaitParams:
    period = _FIXED_PERIODS.get(name, period)
    off, dur = _preset_tables(period)[name]
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return GaitParams(offsets=t(off), durations=t(dur), n_segments=t(period))


def phase(gait: GaitParams, iteration: torch.Tensor, iters_per_mpc: int) -> torch.Tensor:
    """Global gait phase in [0, 1) (setIterations, Gait.cpp:218-226)."""
    period_iters = iters_per_mpc * gait.n_segments
    return (iteration % period_iters).float() / period_iters.float()


def segment_index(
    gait: GaitParams, iteration: torch.Tensor, iters_per_mpc: int
) -> torch.Tensor:
    """Current MPC segment in [0, n_segments) (Gait.cpp:221)."""
    return (iteration // iters_per_mpc) % gait.n_segments


def contact_state(gait: GaitParams, ph: torch.Tensor) -> torch.Tensor:
    """(..., 4) stance progress in (0, 1], 0 if in swing (Gait.cpp:47-74)."""
    seg = gait.n_segments.float()[..., None]
    offset = gait.offsets.float() / seg
    duration = gait.durations.float() / seg
    offset = torch.where(offset < 0, offset + 1.0, offset)
    progress = ph[..., None] - offset
    progress = torch.where(progress < 0, progress + 1.0, progress)
    # duration 0 = always-swing leg (two_leg_balance): guard the 0/0
    return torch.where(
        (progress > duration) | (duration <= 0.0),
        torch.zeros_like(progress),
        progress / torch.where(duration > 0, duration, torch.ones_like(duration)),
    )


def swing_state(gait: GaitParams, ph: torch.Tensor) -> torch.Tensor:
    """(..., 4) swing progress in (0, 1), 0 if in stance (Gait.cpp:102-135)."""
    seg = gait.n_segments.float()[..., None]
    offset = gait.offsets.float() / seg
    duration = gait.durations.float() / seg
    swing_offset = offset + duration
    swing_offset = torch.where(swing_offset > 1.0, swing_offset - 1.0, swing_offset)
    swing_duration = 1.0 - duration
    progress = ph[..., None] - swing_offset
    progress = torch.where(progress < 0, progress + 1.0, progress)
    return torch.where(
        progress >= swing_duration,
        torch.zeros_like(progress),
        progress / torch.where(swing_duration > 0, swing_duration,
                               torch.ones_like(swing_duration)),
    )


def mpc_table(gait: GaitParams, seg_idx: torch.Tensor, horizon: int) -> torch.Tensor:
    """(..., horizon, 4) int32 contact table for the QP (getMpcTable,
    Gait.cpp:159-188): step i looks at segment (i + seg_idx + 1) mod n."""
    i = torch.arange(horizon, dtype=seg_idx.dtype, device=seg_idx.device)
    n = gait.n_segments[..., None, None]
    iter_h = (i[:, None] + seg_idx[..., None, None] + 1) % n
    progress = iter_h - gait.offsets[..., None, :]
    progress = torch.where(progress < 0, progress + n, progress)
    return (progress < gait.durations[..., None, :]).to(torch.int32)


def swing_time(gait: GaitParams, dt_mpc: float) -> torch.Tensor:
    """(..., 4) swing duration in seconds (Gait.cpp:252-256, per leg)."""
    return dt_mpc * (gait.n_segments[..., None] - gait.durations).float()


def stance_time(gait: GaitParams, dt_mpc: float) -> torch.Tensor:
    """(..., 4) stance duration in seconds (Gait.cpp:263-267)."""
    return dt_mpc * gait.durations.float()
