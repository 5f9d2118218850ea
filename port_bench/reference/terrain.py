"""The terrain tier of configuration ``a1_terrain_loop_h10``: a staircase
ground truth, its elevation map, and the map lookups of the CMPCLocomotion_Cv
loop (CMPC_Locomotion_cv.cpp:768-940), in plain float32 PyTorch.

- ``ground_z``: the staircase's height under world xy (the plant's true
  surface);
- ``build_map``: the staircase sampled onto a world-anchored grid (row r,
  col c at world xy = center + res ((W//2) - c, r - (H//2))) with its
  slope-and-roughness traversability layer;
- ``world_to_index`` / ``sample``: the grid lookups (``ceil`` of the
  position over the resolution, clamped to the grid);
- ``select_foothold`` / ``foothold_update``: each Raibert target snapped to
  the first traversable cell (> 0.8) in spiral order within 0.10 m
  (``_idxMapChecking``), its own xy kept when its own cell is valid; z
  relative to the swing-start cell, the step clamped at 0.17 m
  (``MAX_STEP_HEIGHT``, CMPC_Locomotion_cv.h:24);
- ``terrain_command``: the body-height command raised by the mean map
  elevation under the feet (:885-891).

Each lookup is a decision on a rounded coordinate.  ``cell_margin``,
``step_margin`` and the traversability margin of ``select_foothold`` give
how far each decision's input lay from the value at which it would have
gone the other way, for the decision-aware comparison.

Division by the resolution or the tread is one IEEE division (not a
multiply by the reciprocal), and a float32 square root is the correctly
rounded one: both decide which cell a point falls in."""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from port_bench.reference.consts import const


class TerrainConfig(NamedTuple):
    """The loop's terrain settings (search radius of _idxMapChecking :921,
    traversability threshold, MAX_STEP_HEIGHT, the map body-height
    command)."""

    search_radius_m: float = 0.10
    traversability_min: float = 0.8
    max_step_height: float = 0.17
    body_height_from_map: bool = True


class Stairs(NamedTuple):
    """Ascending staircase along +x: flat at 0 before ``edge_x``, then
    ``n_steps`` risers of ``riser`` every ``tread`` m."""

    edge_x: torch.Tensor   # (B,)
    riser: torch.Tensor    # (B,)
    tread: float
    n_steps: int


class HeightMap(NamedTuple):
    elevation: torch.Tensor       # (..., H, W)
    traversability: torch.Tensor  # (..., H, W)
    center: torch.Tensor          # (..., 2)
    resolution: float


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as one IEEE division."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root (float32 through float64)."""
    return torch.sqrt(x.double()).to(x.dtype) if x.dtype == torch.float32 else torch.sqrt(x)


def _expand(terrain: Stairs, n: int) -> Stairs:
    idx = (Ellipsis,) + (None,) * n
    return terrain._replace(edge_x=terrain.edge_x[idx], riser=terrain.riser[idx])


def step_index(terrain: Stairs, x: torch.Tensor) -> torch.Tensor:
    """The step under world x (0 before the first riser), as a float."""
    extra = x.dim() - terrain.edge_x.dim()
    if extra > 0:
        terrain = _expand(terrain, extra)
    k = torch.floor(div(x - terrain.edge_x, terrain.tread)) + 1.0
    return torch.clamp(k, 0.0, float(terrain.n_steps))


def ground_z(terrain: Stairs, xy: torch.Tensor) -> torch.Tensor:
    """Ground elevation under world xy (..., 2) -> (...,); the terrain's
    batch axis leads."""
    k = step_index(terrain, xy[..., 0])
    extra = xy.dim() - 1 - terrain.edge_x.dim()
    riser = terrain.riser[(Ellipsis,) + (None,) * extra] if extra > 0 else terrain.riser
    return riser * k


def step_margin(terrain: Stairs, x: torch.Tensor) -> torch.Tensor:
    """|x - the nearest riser's x| (m): how far ``step_index`` lay from
    another step."""
    extra = x.dim() - terrain.edge_x.dim()
    t = _expand(terrain, extra) if extra > 0 else terrain
    return torch.stack([(x - (t.edge_x + j * t.tread)).abs()
                        for j in range(terrain.n_steps)]).amin(0)


def traversability(elevation: torch.Tensor, res: float, critical_slope: float = 0.7,
                   critical_roughness: float = 0.06) -> torch.Tensor:
    """Slope and 3 x 3 roughness against their critical values, the mean of
    the two scores (every cell of a built map is observed)."""
    e = elevation
    roll = torch.roll
    dzdx = div(roll(e, -1, -1) - roll(e, 1, -1), 2 * res)
    dzdy = div(roll(e, -1, -2) - roll(e, 1, -2), 2 * res)
    slope = sqrt(dzdx ** 2 + dzdy ** 2)
    acc = torch.zeros_like(e)
    acc2 = torch.zeros_like(e)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            v = roll(roll(e, dr, -2), dc, -1)
            acc = acc + v
            acc2 = acc2 + v * v
    mean = div(acc, 9.0)
    rough = sqrt(torch.clamp(div(acc2, 9.0) - mean ** 2, min=0.0))
    t_slope = 1.0 - torch.clamp(div(slope, critical_slope), max=1.0)
    t_rough = 1.0 - torch.clamp(div(rough, critical_roughness), max=1.0)
    return 0.5 * t_slope + 0.5 * t_rough


def build_map(terrain: Stairs, size: int, resolution: float) -> HeightMap:
    """Each scenario's map of its staircase, centred on the world origin."""
    H = W = size
    device, dtype = terrain.edge_x.device, terrain.edge_x.dtype
    batch = tuple(terrain.edge_x.shape)
    center = torch.zeros(batch + (2,), dtype=dtype, device=device)
    xs = resolution * ((W // 2) - torch.arange(W, dtype=dtype, device=device))
    ys = resolution * (torch.arange(H, dtype=dtype, device=device) - (H // 2))
    x = center[..., 0, None, None] + xs[None, :]
    y = center[..., 1, None, None] + ys[:, None]
    xy = torch.stack([x.expand(batch + (H, W)), y.expand(batch + (H, W))], dim=-1)
    z = ground_z(terrain, xy)
    return HeightMap(z, traversability(z, resolution), center, resolution)


def world_to_index(hm: HeightMap, xy: torch.Tensor) -> torch.Tensor:
    """World xy (..., 2) -> (row, col) int64, clamped to the grid: +x
    lowers the column, +y raises the row (CMPC_Locomotion_cv.cpp:805-821)."""
    H, W = hm.elevation.shape[-2:]
    rel = div(xy - hm.center, hm.resolution)
    col = (W // 2) - torch.ceil(rel[..., 0]).long()
    row = (H // 2) + torch.ceil(rel[..., 1]).long()
    return torch.stack([row.clamp(0, H - 1), col.clamp(0, W - 1)], dim=-1)


def cell_margin(hm: HeightMap, xy: torch.Tensor) -> torch.Tensor:
    """(...,) m: how far xy lay from the nearest cell boundary of
    ``world_to_index`` (the whole multiples of the resolution from the
    centre, where ``ceil`` steps), in x or in y."""
    rel = div(xy - hm.center, hm.resolution).double()
    return (hm.resolution * (rel - torch.round(rel)).abs()).amin(-1).float()


def sample(grid: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """grid (..., H, W) at (row, col) (..., k, 2), leading axes broadcast."""
    W = grid.shape[-1]
    flat = idx[..., 0] * W + idx[..., 1]
    g = grid.flatten(-2)
    batch = torch.broadcast_shapes(g.shape[:-1], flat.shape[:-1])
    return torch.gather(g.expand(batch + g.shape[-1:]), -1, flat.expand(batch + flat.shape[-1:]))


@functools.lru_cache(maxsize=8)
def spiral(radius_cells: int) -> np.ndarray:
    """(dr, dc) within the radius, nearest first, then by dr and dc: the
    SpiralIterator's order."""
    offs = sorted((dr * dr + dc * dc, dr, dc)
                  for dr in range(-radius_cells, radius_cells + 1)
                  for dc in range(-radius_cells, radius_cells + 1)
                  if dr * dr + dc * dc <= radius_cells * radius_cells)
    return np.array([(dr, dc) for _, dr, dc in offs], np.int64)


def select_foothold(hm: HeightMap, pf: torch.Tensor, cfg: TerrainConfig):
    """The first traversable cell in spiral order within the radius; the
    target's own xy where its own cell is taken, the cell's xy where
    another is, the target's xy where none is valid; z the cell's
    elevation.  Returns (xyz (..., 3), the smallest |traversability -
    threshold| over the candidates the spiral read up to the one taken)."""
    H, W = hm.elevation.shape[-2:]
    device = pf.device
    r_cells = max(1, int(np.ceil(cfg.search_radius_m / hm.resolution)))
    offs = const(spiral(r_cells), torch.int64, device)
    k = offs.shape[0]
    own = world_to_index(hm, pf[..., 0:2])
    cand = own[..., None, :] + offs
    cand = torch.stack([cand[..., 0].clamp(0, H - 1), cand[..., 1].clamp(0, W - 1)], dim=-1)
    trav = sample(hm.traversability, cand)
    valid = trav > cfg.traversability_min
    any_valid = valid.any(-1)
    order = torch.arange(k, device=device)
    first = torch.where(valid, order, torch.full_like(order, k)).amin(-1)
    first = torch.where(any_valid, first, torch.zeros_like(first))
    taken = torch.gather(cand, -2, first[..., None, None].expand(first.shape + (1, 2)))[..., 0, :]
    read = order <= torch.where(any_valid, first, torch.full_like(first, k - 1))[..., None]
    margin = torch.where(read, (trav - cfg.traversability_min).abs(),
                         torch.full_like(trav, float("inf"))).amin(-1)
    z = sample(hm.elevation, taken[..., None, :])[..., 0]
    rel = torch.stack([((W // 2) - taken[..., 1]).to(z.dtype),
                       (taken[..., 0] - (H // 2)).to(z.dtype)], dim=-1)
    xy = hm.center + hm.resolution * rel
    unmoved = (taken == own).all(-1)
    xy = torch.where((unmoved | ~any_valid)[..., None], pf[..., 0:2], xy)
    return torch.cat([xy, z[..., None]], dim=-1), margin


def per_leg(hm: HeightMap) -> HeightMap:
    """The map broadcast over a leg axis."""
    return hm._replace(elevation=hm.elevation.unsqueeze(-3),
                       traversability=hm.traversability.unsqueeze(-3),
                       center=hm.center.unsqueeze(-2))


def foothold_update(hm: HeightMap, pf_raibert: torch.Tensor, p0: torch.Tensor,
                    cfg: TerrainConfig):
    """_updateFoothold: (the swing target (..., 4, 3), the search's
    traversability margin).  z = p0_z + (the taken cell's elevation - the
    swing-start cell's), the rise clamped at ``max_step_height``."""
    leg_hm = per_leg(hm)
    xyz, trav_margin = select_foothold(leg_hm, pf_raibert, cfg)
    start = world_to_index(leg_hm, p0[..., 0:2])
    z0 = sample(leg_hm.elevation, start[..., None, :])[..., 0]
    dz = torch.clamp(xyz[..., 2] - z0, max=cfg.max_step_height)
    return torch.cat([xyz[..., 0:2], (p0[..., 2] + dz)[..., None]], dim=-1), trav_margin


def terrain_command(hm: HeightMap, body_height: torch.Tensor, p_feet: torch.Tensor,
                    cfg: TerrainConfig) -> torch.Tensor:
    """The commanded body height plus the mean map elevation under the four
    feet."""
    if not cfg.body_height_from_map:
        return body_height
    idx = world_to_index(hm._replace(center=hm.center[..., None, :]), p_feet[..., 0:2])
    return body_height + sample(hm.elevation, idx).mean(dim=-1)
