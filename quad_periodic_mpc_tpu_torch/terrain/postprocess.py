"""Elevation-map postprocessing (counterpart of
``quad_periodic_mpc_tpu/terrain/postprocess.py``).

The reference runs elevation_mapping's PostprocessorPool
(elevation_mapping/src/postprocessing/PostprocessorPool.cpp): a chain of
grid_map filters applied to each fused map on worker threads.  Here the
same chain is batched stencil operations over (..., H, W) maps:

- median_filter: k x k ordered-statistic smoothing (MedianFillFilter);
- inpaint: fill invalid cells by iterative valid-neighbour averaging (the
  dense counterpart of grid_map_cv::InpaintFilter);
- box_smooth: k x k mean (grid_map_filters::MeanInRadiusFilter).
"""

from __future__ import annotations

import math

import torch

from quad_periodic_mpc_tpu_torch.terrain.heightmap import HeightMap


def _neighborhood(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k*k shifted copies of x: (..., H, W) -> (k*k, ..., H, W); edge
    cells replicate the border."""
    r = k // 2
    H, W = x.shape[-2:]
    offs = torch.arange(-r, r + 1, device=x.device)
    rows = (torch.arange(H, device=x.device)[:, None] + offs[None]).clamp(0, H - 1)
    cols = (torch.arange(W, device=x.device)[:, None] + offs[None]).clamp(0, W - 1)
    out = []
    for i in range(k):
        xi = torch.index_select(x, -2, rows[:, i])
        for j in range(k):
            out.append(torch.index_select(xi, -1, cols[:, j]))
    return torch.stack(out, 0)


def median_filter(x: torch.Tensor, k: int = 3) -> torch.Tensor:
    """k x k median, batched.  An even count takes the mean of the two
    middle values, and a NaN anywhere in the window gives NaN (the
    reference's median)."""
    nb = _neighborhood(x, k)
    s = torch.sort(nb, dim=0).values
    n = s.shape[0]
    med = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    return torch.where(torch.isnan(nb).any(0), torch.full_like(med, math.nan), med)


def box_smooth(x: torch.Tensor, k: int = 3) -> torch.Tensor:
    """k x k mean smoothing."""
    return torch.mean(_neighborhood(x, k), dim=0)


def inpaint(x: torch.Tensor, valid: torch.Tensor, iters: int = 16) -> torch.Tensor:
    """Fill invalid cells by iterative valid-neighbour averaging: each sweep
    replaces invalid cells with the mean of their currently valid 3x3
    neighbours (cells with no valid neighbour wait for the front); `iters`
    sweeps propagate the fill `iters` cells inward.  Valid cells are never
    modified."""
    z, w = x, valid.to(x.dtype)
    for _ in range(iters):
        s = _neighborhood(z * w, 3).sum(0)
        c = _neighborhood(w, 3).sum(0)
        fill = s / torch.clamp(c, min=1.0)
        newly = (c > 0.0) & (w == 0.0)
        z = torch.where(w > 0.0, z, torch.where(newly, fill, z))
        w = torch.where(newly, torch.ones_like(w), w)
    return torch.where(valid, x, z)


def postprocess(
    hm: HeightMap,
    variance_valid: float = 1e2,
    inpaint_iters: int = 16,
    median_k: int = 3,
) -> HeightMap:
    """Inpaint unobserved cells, then median-denoise (the reference's
    filter-chain order, elevation_mapping config/postprocessor_pipeline.yaml).
    Inpainted cells get the validity-threshold variance."""
    valid = hm.variance < variance_valid
    z = inpaint(hm.elevation, valid, inpaint_iters)
    z = median_filter(z, median_k)
    var = torch.where(valid, hm.variance, torch.full_like(hm.variance, variance_valid))
    return hm._replace(elevation=z, variance=var)
