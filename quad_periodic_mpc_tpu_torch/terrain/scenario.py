"""Analytic terrain scenarios: the ground truth behind the heightmap
(counterpart of ``quad_periodic_mpc_tpu/terrain/scenario.py``).

A batched staircase height field that (a) drives the SRB plant's ground
contact, (b) generates the elevation map the controller queries, and (c)
parameterizes the terrain-scenario axis of a sweep (BASELINE config 4).
The reference validates its terrain tier on RaiSim scenes with stairs and
doorsteps (raisim_unitree_ros_driver `scene:=2`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quad_periodic_mpc_tpu_torch.terrain import heightmap as hmap


class StairsTerrain(NamedTuple):
    """Ascending staircase along +x: flat at z=0 for x < edge_x, then
    ``n_steps`` risers of height ``riser`` every ``tread`` meters, flat at
    the top beyond.  riser/edge_x are tensors (scenario axes); tread and
    n_steps are Python numbers."""

    edge_x: torch.Tensor   # (...,) world x of the first riser
    riser: torch.Tensor    # (...,) step height, m
    tread: float = 0.25
    n_steps: int = 4

    @staticmethod
    def single_step(edge_x: float = 0.30, height: float = 0.08, batch: tuple = (),
                    dtype=torch.float32, device="cuda") -> "StairsTerrain":
        """One doorstep (CMPC_Locomotion_cv.cpp `_doorstep_case`)."""
        return StairsTerrain(
            edge_x=torch.full(batch, edge_x, dtype=dtype, device=device),
            riser=torch.full(batch, height, dtype=dtype, device=device),
            tread=10.0, n_steps=1)

    @staticmethod
    def flat(batch: tuple = (), dtype=torch.float32, device="cuda") -> "StairsTerrain":
        return StairsTerrain(
            edge_x=torch.full(batch, 1e6, dtype=dtype, device=device),
            riser=torch.zeros(batch, dtype=dtype, device=device))


def ground_z(terrain: StairsTerrain, xy: torch.Tensor) -> torch.Tensor:
    """Ground elevation under world xy (..., 2) -> (...,); the terrain's
    batch axes lead, xy may carry more (feet, grid) after them."""
    x = xy[..., 0]
    extra = x.dim() - terrain.edge_x.dim()
    if extra > 0:
        terrain = tree_expand(terrain, extra)
    k = torch.floor(hmap.div(x - terrain.edge_x, terrain.tread)) + 1.0
    k = torch.clamp(k, 0.0, float(terrain.n_steps))
    return terrain.riser * k


def build_map(
    terrain: StairsTerrain,
    size: int = 64,
    resolution: float = 0.03,
    center_xy=None,
    noise_std: float = 0.0,
    generator: torch.Generator | None = None,
    dtype=torch.float32,
) -> hmap.HeightMap:
    """Sample the analytic terrain onto a HeightMap grid (row r, col c at
    world xy = center + resolution ((W//2) - c, r - (H//2))) and compute its
    traversability layer.  noise_std > 0 adds iid Gaussian measurement noise
    drawn from ``generator`` (on the terrain's device)."""
    H = W = size
    device = terrain.edge_x.device
    batch = tuple(terrain.edge_x.shape)
    if center_xy is None:
        center_xy = torch.zeros(batch + (2,), dtype=dtype, device=device)
    center_xy = torch.as_tensor(center_xy, dtype=dtype, device=device)

    r = torch.arange(H, dtype=dtype, device=device)
    c = torch.arange(W, dtype=dtype, device=device)
    xs = resolution * ((W // 2) - c)                      # (W,)
    ys = resolution * (r - (H // 2))                      # (H,)
    x = center_xy[..., 0, None, None] + xs[None, :]       # (..., 1, W)
    y = center_xy[..., 1, None, None] + ys[:, None]       # (..., H, 1)
    xy = torch.stack([x.expand(batch + (H, W)), y.expand(batch + (H, W))], dim=-1)
    z = ground_z(terrain, xy)
    if noise_std > 0.0:
        z = z + noise_std * torch.randn(z.shape, generator=generator, dtype=dtype,
                                        device=device)
    hm = hmap.HeightMap(
        elevation=z.to(dtype),
        variance=torch.full(batch + (H, W), 1e-4, dtype=dtype, device=device),
        traversability=torch.ones(batch + (H, W), dtype=dtype, device=device),
        center=center_xy,
        resolution=resolution,
    )
    return hmap.compute_traversability(hm)


def tree_expand(terrain: StairsTerrain, n: int) -> StairsTerrain:
    """Append n singleton axes to every tensor field (broadcast helper)."""
    idx = (Ellipsis,) + (None,) * n
    return terrain._replace(edge_x=terrain.edge_x[idx], riser=terrain.riser[idx])
