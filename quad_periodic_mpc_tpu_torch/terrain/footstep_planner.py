"""Footstep planning on the elevation grid (counterpart of
``quad_periodic_mpc_tpu/terrain/footstep_planner.py``).

The reference ships only a scaffold (src/common/FootstepPlanner/
GraphSearch.{h,cpp}).  Instead of a sequential A*, a dense value-iteration
cost-to-go over the grid:

    V <- min_{8-neighbourhood} (V_nbr + edge_cost)

with edge_cost = step length + slope penalty + non-traversability penalty.
Each sweep is a batched stencil (shifted adds + min); K sweeps propagate
the frontier K cells.  Greedy descent on V gives paths from any start.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from quad_periodic_mpc_tpu_torch.terrain.heightmap import HeightMap, div, sample, sqrt

_BIG = 1e9

# 8-neighbourhood (dr, dc) and step lengths
_OFFS = np.array(
    [(-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (-1, 1), (1, -1), (1, 1)], np.int32)
_LENS = np.array([1.0, 1.0, 1.0, 1.0] + [np.sqrt(2.0)] * 4, np.float32)


class Plan(NamedTuple):
    value: torch.Tensor      # (..., H, W) cost-to-go
    step_cost: torch.Tensor  # (..., H, W) per-cell entry cost


def cell_costs(hm: HeightMap, slope_weight: float = 20.0,
               traversability_min: float = 0.5) -> torch.Tensor:
    """Per-cell entry cost from terrain: slope + traversability gate."""
    h = hm.elevation
    dr = div(torch.abs(torch.roll(h, -1, -2) - torch.roll(h, 1, -2)), 2 * hm.resolution)
    dc = div(torch.abs(torch.roll(h, -1, -1) - torch.roll(h, 1, -1)), 2 * hm.resolution)
    slope = sqrt(dr * dr + dc * dc)
    blocked = hm.traversability < traversability_min
    return slope_weight * slope * hm.resolution + torch.where(
        blocked, torch.full_like(h, _BIG), torch.zeros_like(h))


def _shift(v: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """Shift with a +_BIG fill at the borders (no wrap-around paths)."""
    out = torch.roll(v, (dr, dc), dims=(-2, -1))
    H, W = v.shape[-2:]
    r = torch.arange(H, device=v.device)[:, None]
    c = torch.arange(W, device=v.device)[None, :]
    invalid = torch.zeros((H, W), dtype=torch.bool, device=v.device)
    if dr > 0:
        invalid = invalid | (r < dr)
    elif dr < 0:
        invalid = invalid | (r >= H + dr)
    if dc > 0:
        invalid = invalid | (c < dc)
    elif dc < 0:
        invalid = invalid | (c >= W + dc)
    return torch.where(invalid, torch.full_like(out, _BIG), out)


def plan(
    hm: HeightMap,
    goal_rc: torch.Tensor,          # (..., 2) goal cell
    sweeps: int | None = None,
    slope_weight: float = 20.0,
    traversability_min: float = 0.5,
) -> Plan:
    """Cost-to-go by parallel value iteration."""
    H, W = hm.elevation.shape[-2:]
    dtype, device = hm.elevation.dtype, hm.elevation.device
    sweeps = sweeps or (H + W)
    entry = cell_costs(hm, slope_weight, traversability_min)

    r = torch.arange(H, device=device)[:, None]
    c = torch.arange(W, device=device)[None, :]
    is_goal = (r == goal_rc[..., 0, None, None]) & (c == goal_rc[..., 1, None, None])
    V = torch.where(is_goal, torch.zeros((), dtype=dtype, device=device),
                    torch.full((), _BIG, dtype=dtype, device=device))
    step_len = torch.as_tensor(_LENS, dtype=dtype, device=device) * hm.resolution
    for _ in range(sweeps):
        cands = [_shift(V, int(dr), int(dc)) + step_len[i] + entry
                 for i, (dr, dc) in enumerate(_OFFS)]
        V = torch.minimum(V, torch.stack(cands, 0).min(0).values)
    return Plan(value=V, step_cost=entry)


def next_step(plan_: Plan, rc: torch.Tensor) -> torch.Tensor:
    """Greedy descent: best neighbour cell (..., 2) from rc (the first of
    equal values, in _OFFS order)."""
    H, W = plan_.value.shape[-2:]
    offs = torch.as_tensor(_OFFS, dtype=torch.int64, device=rc.device)
    cand = rc[..., None, :].long() + offs                    # (..., 8, 2)
    cand = torch.stack([cand[..., 0].clamp(0, H - 1), cand[..., 1].clamp(0, W - 1)], dim=-1)
    best = torch.argmin(sample(plan_.value, cand), dim=-1)
    return torch.gather(cand, -2, best[..., None, None].expand(best.shape + (1, 2)))[..., 0, :]


def extract_path(plan_: Plan, start_rc: torch.Tensor, n_steps: int) -> torch.Tensor:
    """(..., n_steps+1, 2) greedy path from start toward the goal."""
    path = [start_rc.long()]
    for _ in range(n_steps):
        path.append(next_step(plan_, path[-1]))
    return torch.stack(path, dim=-2)
