"""Body-centered elevation grid: Kalman fusion + foothold selection
(counterpart of ``quad_periodic_mpc_tpu/terrain/heightmap.py``).

- elevation_mapping's per-cell Kalman fusion (ElevationMap::add /
  fuseAll, elevation_mapping/src/ElevationMap.cpp): each cell carries
  (height, variance); point measurements combine by precision weighting,
  as scatter passes over the flattened grid;
- the map-aware foothold adjustment of VisionMPCLocomotion::
  _updateFoothold (VisionMPCLocomotion.cpp:549-640) and
  CMPCLocomotion_Cv::{_updateFoothold,_idxMapChecking}
  (CMPC_Locomotion_cv.cpp:768-940): a precomputed spiral candidate table,
  batched gathers and a first-valid argmax.

Every function takes maps with any leading batch axes.  A batched map's
``center`` is (..., 2); functions that take points per map (``fuse_points``,
``visibility_cleanup``) treat the points' axes as following the map's batch
axes, the reference's vmap over maps.  ``resolution`` stays a Python float.

Division by the resolution (and by any other Python constant that feeds a
comparison) goes through a 0-dim tensor on the map's device: CUDA divides
by a host scalar as a multiply by its reciprocal, which moves points on a
cell boundary to the next cell.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from quad_periodic_mpc_tpu_torch.utils.consts import const


class HeightMap(NamedTuple):
    """Body-centered 2.5-D grid (rows = y, cols = x, like grid_map)."""

    elevation: torch.Tensor       # (..., H, W)
    variance: torch.Tensor        # (..., H, W)
    traversability: torch.Tensor  # (..., H, W) in [0, 1]
    center: torch.Tensor          # (..., 2) world xy of the grid center
    resolution: float


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded as one IEEE division (not x * (1/c)) on any device."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device: torch's
    vectorised sqrt on the CPU is off by an ulp for about 1 % of inputs,
    CUDA's and the reference's are not.  float32 goes through float64, whose
    error of at most an ulp vanishes in the rounding back; float64 is
    torch's own."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).to(torch.float32)
    return torch.sqrt(x)


def create(
    size: int = 64, resolution: float = 0.03, batch: tuple = (),
    dtype=torch.float32, init_variance: float = 1e4, device="cuda",
) -> HeightMap:
    kw = dict(dtype=dtype, device=device)
    return HeightMap(
        elevation=torch.zeros(batch + (size, size), **kw),
        variance=torch.full(batch + (size, size), init_variance, **kw),
        traversability=torch.ones(batch + (size, size), **kw),
        center=torch.zeros(batch + (2,), **kw),
        resolution=resolution,
    )


def world_to_index(hm: HeightMap, xy: torch.Tensor) -> torch.Tensor:
    """World xy (..., 2) -> (row, col) int64 indices, clamped to the grid.

    The body sits at the grid center; +x decreases the column index, +y
    increases the row index (CMPC_Locomotion_cv.cpp:805-821).
    """
    H, W = hm.elevation.shape[-2:]
    rel = div(xy - hm.center, hm.resolution)
    col = (W // 2) - torch.ceil(rel[..., 0]).long()
    row = (H // 2) + torch.ceil(rel[..., 1]).long()
    return torch.stack([row.clamp(0, H - 1), col.clamp(0, W - 1)], dim=-1)


def _gather_flat(g: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """g (..., N) at int64 flat (..., k), leading axes broadcast."""
    batch = torch.broadcast_shapes(g.shape[:-1], flat.shape[:-1])
    return torch.gather(g.expand(batch + g.shape[-1:]), -1,
                        flat.expand(batch + flat.shape[-1:]))


def sample(grid: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather grid (..., H, W) at integer (row, col) (..., k, 2)."""
    W = grid.shape[-1]
    flat = idx[..., 0].long() * W + idx[..., 1].long()
    return _gather_flat(grid.flatten(-2), flat)


def _points_map(hm: HeightMap, n_axes: int) -> HeightMap:
    """The map with n_axes singleton axes after the center's batch axes, so
    that world_to_index reads points (..., p_1..p_n, 2) against their map."""
    return hm._replace(center=hm.center.reshape(
        hm.center.shape[:-1] + (1,) * n_axes + (2,)))


def fuse_points(
    hm: HeightMap,
    points: torch.Tensor,          # (..., n, 3) world points
    meas_variance: torch.Tensor,   # (..., n)
    mahalanobis_threshold: float = 0.0,
    multi_height_noise: float = 9e-7,
    valid_mask: torch.Tensor | None = None,   # (..., n) bool
) -> HeightMap:
    """Precision-weighted Kalman fusion of point measurements into cells
    (the scalar-KF update of ElevationMap::add, batched + scattered):

      1/var' = 1/var + sum 1/var_m;  h' = var' (h/var + sum z/var_m)

    With mahalanobis_threshold > 0, the reference's multi-height handling
    (ElevationMap.cpp:152-166): points whose |z - h| / sqrt(var) exceeds the
    threshold do not fuse; a higher one replaces the cell (a scatter-max,
    applied last, with the smallest such point's variance, a scatter-min), a
    lower one inflates the cell's variance by multi_height_noise.  Points
    outside ``valid_mask`` carry no weight and replace nothing.
    """
    H, W = hm.elevation.shape[-2:]
    idx = world_to_index(_points_map(hm, 1), points[..., 0:2])
    flat = idx[..., 0] * W + idx[..., 1]                      # (..., n)
    gshape = hm.elevation.shape[:-2] + (H * W,)
    h_old = hm.elevation.reshape(gshape)
    var_old = hm.variance.reshape(gshape)
    dtype, device = h_old.dtype, h_old.device

    z = points[..., 2]
    w = 1.0 / meas_variance
    if valid_mask is not None:
        w = torch.where(valid_mask, w, torch.zeros_like(w))
    if mahalanobis_threshold > 0.0:
        h_at = torch.gather(h_old, -1, flat)
        var_at = torch.gather(var_old, -1, flat)
        outlier = torch.abs(z - h_at) / sqrt(var_at) > mahalanobis_threshold
        if valid_mask is not None:
            outlier = outlier & valid_mask
        higher = outlier & (z > h_at)
        lower = outlier & ~higher
        w_fuse = torch.where(outlier, torch.zeros_like(w), w)
    else:
        w_fuse = w

    zeros = torch.zeros(gshape, dtype=dtype, device=device)
    dnum = zeros.scatter_add(-1, flat, z * w_fuse)
    dden = zeros.scatter_add(-1, flat, w_fuse)
    prec_new = 1.0 / var_old + dden
    h_new = (h_old / var_old + dnum) / prec_new
    var_new = 1.0 / prec_new

    if mahalanobis_threshold > 0.0:
        bump = torch.where(lower, torch.full_like(z, multi_height_noise), torch.zeros_like(z))
        var_new = var_new + zeros.scatter_add(-1, flat, bump)
        neg_inf = torch.full_like(z, -math.inf)
        repl = torch.full(gshape, -math.inf, dtype=dtype, device=device).scatter_reduce(
            -1, flat, torch.where(higher, z, neg_inf), "amax", include_self=True)
        replaced = repl > -math.inf
        meas_var_grid = torch.full(gshape, math.inf, dtype=dtype, device=device).scatter_reduce(
            -1, flat, torch.where(higher, meas_variance, torch.full_like(z, math.inf)), "amin",
            include_self=True)
        h_new = torch.where(replaced, repl, h_new)
        var_new = torch.where(replaced, meas_var_grid, var_new)

    return hm._replace(elevation=h_new.reshape(hm.elevation.shape),
                       variance=var_new.reshape(hm.variance.shape))


def wecdf_quantile(
    values: torch.Tensor,    # (..., m)
    weights: torch.Tensor,   # (..., m); zero-weight entries are ignored
    q: float,
) -> torch.Tensor:
    """Batched weighted empirical quantile with the reference's WECDF
    semantics (WeightedEmpiricalCumulativeDistributionFunction.hpp):
    duplicate values merge their weights, the smallest observation maps to
    probability 0 and the largest to 1, linear interpolation between nodes,
    clamped outside [0, 1].  Degenerate inputs (one distinct value, or all
    weights zero) return the smallest retained value.
    """
    m = values.shape[-1]
    dtype, device = values.dtype, values.device
    big = torch.full((), 3e38, dtype=dtype, device=device)
    tiny = 1e-30
    keep = weights > 0
    v = torch.where(keep, values, big)
    order = torch.argsort(v, dim=-1, stable=True)
    v = torch.gather(v, -1, order)
    w = torch.gather(torch.where(keep, weights, torch.zeros_like(weights)), -1, order)
    c = torch.cumsum(w, dim=-1)

    # duplicate runs: every entry takes its run's last cumulative weight,
    # the suffix minimum of c over run-last positions
    is_last = torch.cat([v[..., 1:] != v[..., :-1],
                         torch.ones(v.shape[:-1] + (1,), dtype=torch.bool, device=device)], -1)
    cl = torch.where(is_last, c, big)
    cl = torch.flip(torch.cummin(torch.flip(cl, [-1]), dim=-1).values, [-1])

    w_first = cl[..., 0]
    span = c[..., -1] - w_first
    p = (cl - w_first[..., None]) / torch.clamp(span, min=tiny)[..., None]

    qc = torch.clamp(torch.full((), q, dtype=dtype, device=device), 0.0, 1.0)
    i_up = torch.clamp((p < qc).sum(-1), 0, m - 1)
    i_low = torch.clamp(i_up - 1, 0, m - 1)
    take = lambda a, i: torch.gather(a, -1, i[..., None])[..., 0]
    p_up, p_lo = take(p, i_up), take(p, i_low)
    v_up, v_lo = take(v, i_up), take(v, i_low)
    frac = (qc - p_lo) / torch.clamp(p_up - p_lo, min=tiny)
    out = v_lo + frac * (v_up - v_lo)
    out = torch.where(i_up == 0, v[..., 0], out)
    return torch.where(span <= 0, v[..., 0], out)


def _gauss_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(x / sqrt(torch.full((), 2.0, dtype=x.dtype,
                                                            device=x.device))))


def fuse_area(
    hm: HeightMap,
    radius_cells: int = 2,
    sigma: float = 0.05,
    min_weight: float = 1e-6,
    valid_var_max: float = 1e3,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused map layers (elevation, lower_bound, upper_bound), the rebuild of
    ElevationMap::fuseArea (ElevationMap.cpp:320-410) on a fixed
    (2 radius_cells + 1)^2 stencil: weights are products of per-axis Gaussian
    cell-overlap probabilities of spread ``sigma`` [m] (floored at
    min_weight), the elevation their weighted mean, the bounds the WECDF
    quantiles 0.01 / 0.99 of z -/+ 2 sqrt(var).  Cells with no valid
    neighbour keep (raw, raw -/+ 2 sqrt(var)) (ElevationMap.cpp:381-390).
    """
    r = radius_cells
    res = hm.resolution
    dtype, device = hm.elevation.dtype, hm.elevation.device
    H, W = hm.elevation.shape[-2:]
    pad = lambda x, v: torch.nn.functional.pad(x, (r, r, r, r), value=v)
    zp, vp = pad(hm.elevation, 0.0), pad(hm.variance, 1e30)

    zs, vs, ws = [], [], []
    sig = torch.clamp(torch.full((), sigma, dtype=dtype, device=device), min=1e-6)
    edge = lambda d, s: _gauss_cdf(torch.full((), abs(d) * res + s * res / 2, dtype=dtype,
                                              device=device) / sig)
    floor = torch.full((), min_weight, dtype=dtype, device=device)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            zs.append(zp[..., r + dy:r + dy + H, r + dx:r + dx + W])
            vs.append(vp[..., r + dy:r + dy + H, r + dx:r + dx + W])
            p1 = edge(dx, 1) - edge(dx, -1)
            p2 = edge(dy, 1) - edge(dy, -1)
            ws.append(torch.maximum(floor, p1 * p2))
    z_n = torch.stack(zs, -1)                        # (..., H, W, m)
    v_n = torch.stack(vs, -1)
    valid = v_n < valid_var_max
    w_n = torch.where(valid, torch.stack(ws).expand(z_n.shape), torch.zeros_like(z_n))
    any_valid = valid.any(-1)

    wsum = torch.clamp(w_n.sum(-1), min=1e-30)
    mean = (w_n * z_n).sum(-1) / wsum
    sd = sqrt(torch.where(valid, v_n, torch.zeros_like(v_n)))
    lower = wecdf_quantile(z_n - 2.0 * sd, w_n, 0.01)
    upper = wecdf_quantile(z_n + 2.0 * sd, w_n, 0.99)

    raw_sd = sqrt(hm.variance)
    mean = torch.where(any_valid, mean, hm.elevation)
    lower = torch.where(any_valid, lower, hm.elevation - 2.0 * raw_sd)
    upper = torch.where(any_valid, upper, hm.elevation + 2.0 * raw_sd)
    return mean, lower, upper


def predict(hm: HeightMap, process_variance: float) -> HeightMap:
    """Variance growth per update cycle (RobotMotionMapUpdater analog)."""
    return hm._replace(variance=hm.variance + process_variance)


def motion_update(
    hm: HeightMap,
    position_cov: torch.Tensor,   # (..., 3, 3) relative pose position covariance
    R_map_to_body: torch.Tensor,  # (..., 3, 3)
    covariance_scale: float = 1.0,
) -> HeightMap:
    """Pose-uncertainty variance growth, RobotMotionMapUpdater::update
    (RobotMotionMapUpdater.cpp:30-118): the vertical bump J_t Sigma_p J_t^T
    with J_t = -R^T, the same for every cell."""
    J = -R_map_to_body.transpose(-1, -2)
    cov = covariance_scale * position_cov
    bump = torch.einsum("...ij,...jk,...ik->...i", J, cov, J)[..., 2]
    return hm._replace(variance=hm.variance + bump[..., None, None])


def move(hm: HeightMap, new_center: torch.Tensor) -> HeightMap:
    """Shift the grid to a new world center, keeping world-anchored data
    (ElevationMap::move): the shift snaps to whole cells (half to even),
    cells in view keep their estimates, newly exposed strips reset to the
    uninformative prior.  Per-instance shifts by gathers."""
    H, W = hm.elevation.shape[-2:]
    device = hm.elevation.device
    shift_cells = torch.round(div(new_center - hm.center, hm.resolution)).long()
    snapped = hm.center + shift_cells.to(hm.center.dtype) * hm.resolution
    sx, sy = shift_cells[..., 0], shift_cells[..., 1]
    # destination (r, c) pulls from source (r + sy, c - sx)
    src_r = torch.arange(H, device=device) + sy[..., None]        # (..., H)
    src_c = torch.arange(W, device=device) - sx[..., None]        # (..., W)
    valid = (((src_r >= 0) & (src_r < H))[..., :, None]
             & ((src_c >= 0) & (src_c < W))[..., None, :])
    src_r = src_r.clamp(0, H - 1)
    src_c = src_c.clamp(0, W - 1)

    def shift(grid, fill):
        g = torch.gather(grid, -2, src_r[..., :, None].expand(grid.shape))
        g = torch.gather(g, -1, src_c[..., None, :].expand(grid.shape))
        return torch.where(valid, g, torch.full_like(g, fill))

    return hm._replace(
        elevation=shift(hm.elevation, 0.0),
        variance=shift(hm.variance, 1e4),
        traversability=shift(hm.traversability, 1.0),
        center=snapped,
    )


def _linspace01(n: int, dtype, device) -> torch.Tensor:
    """The reference's linspace(0, 1, n): i / (n - 1) in the dtype, 1 last."""
    if n == 1:
        return torch.zeros(1, dtype=dtype, device=device)
    fr = div(torch.arange(n - 1, dtype=dtype, device=device), float(n - 1))
    return torch.cat([fr, torch.ones(1, dtype=dtype, device=device)])


def visibility_cleanup(
    hm: HeightMap,
    points: torch.Tensor,          # (..., n, 3) latest scan, world
    meas_variance: torch.Tensor,   # (..., n)
    sensor_pos: torch.Tensor,      # (..., 3) sensor origin, world
    ray_samples: int = 12,
) -> HeightMap:
    """Remove ghost cells the latest scan saw through, ElevationMap::
    visibilityCleanup (ElevationMap.cpp:435-531): every sensor->point ray,
    sampled at ray_samples fixed fractions, bounds the height of each cell
    it crosses (one scatter-min of the interpolated ray heights); cells whose
    elevation minus 3 sigma exceeds that bound reset to the prior."""
    H, W = hm.elevation.shape[-2:]
    dtype, device = hm.elevation.dtype, hm.elevation.device
    gshape = hm.elevation.shape[:-2] + (H * W,)

    z_low = points[..., 2] + 3.0 * sqrt(meas_variance)    # (..., n)
    fr = _linspace01(ray_samples, dtype, device)                 # (S,)
    seg = points - sensor_pos[..., None, :]                      # (..., n, 3)
    xy = sensor_pos[..., None, None, 0:2] + fr[:, None] * seg[..., :, None, 0:2]
    ray_h = (sensor_pos[..., None, None, 2]
             + fr * (z_low[..., None] - sensor_pos[..., None, None, 2]))   # (..., n, S)
    idx = world_to_index(_points_map(hm, 2), xy)                 # (..., n, S, 2)
    del xy, seg
    flat = (idx[..., 0] * W + idx[..., 1]).reshape(idx.shape[:-3] + (-1,))
    del idx
    heights = ray_h.reshape(ray_h.shape[:-2] + (-1,))
    max_h = torch.full(gshape, math.inf, dtype=dtype, device=device).scatter_reduce(
        -1, flat, heights, "amin", include_self=True)
    del flat, heights, ray_h

    elev = hm.elevation.reshape(gshape)
    var = hm.variance.reshape(gshape)
    ghost = elev - 3.0 * sqrt(var) > max_h
    return hm._replace(
        elevation=torch.where(ghost, torch.zeros_like(elev), elev).reshape(hm.elevation.shape),
        variance=torch.where(ghost, torch.full_like(var, 1e4), var).reshape(hm.variance.shape),
    )


def compute_traversability(
    hm: HeightMap,
    critical_slope: float = 0.7,
    critical_roughness: float = 0.06,
) -> HeightMap:
    """Slope + roughness traversability layer (the reference's
    postprocessor filter chain, elevation_mapping_demos
    postprocessor_pipeline.yaml): central-difference slope and 3x3 local
    standard deviation, each scaled against its critical value; cells with
    high prior variance (never observed) stay traversable."""
    e = hm.elevation
    res = hm.resolution
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
    trav = 0.5 * t_slope + 0.5 * t_rough
    return hm._replace(traversability=torch.where(hm.variance > 1e2, torch.ones_like(trav), trav))


@functools.lru_cache(maxsize=8)
def spiral_offsets(radius_cells: int) -> np.ndarray:
    """Ordered (dr, dc) offsets within a radius, center-out: the
    SpiralIterator search order (grid_map_utils::SpiralIterator)."""
    offs = []
    for dr in range(-radius_cells, radius_cells + 1):
        for dc in range(-radius_cells, radius_cells + 1):
            d2 = dr * dr + dc * dc
            if d2 <= radius_cells * radius_cells:
                offs.append((d2, dr, dc))
    offs.sort()
    return np.array([(dr, dc) for _, dr, dc in offs], np.int32)


def spiral_table(hm: HeightMap, search_radius_m: float, dtype=torch.int64) -> torch.Tensor:
    """The (k, 2) spiral offsets of a search within ``search_radius_m`` on
    ``hm``'s grid, as a cached device constant (``utils/consts.const``): a
    captured step finds them made."""
    r_cells = max(1, int(np.ceil(search_radius_m / hm.resolution)))
    return const(spiral_offsets(r_cells), dtype, hm.elevation.device)


def select_foothold(
    hm: HeightMap,
    pf: torch.Tensor,               # (..., 3) Raibert target, world
    search_radius_m: float = 0.10,
    traversability_min: float = 0.8,
    foot_offset: float = 0.0,
    keep_xy_if_unmoved: bool = False,
    return_moved: bool = False,
):
    """Map-aware foothold: snap pf to the first traversable cell in spiral
    order and take its elevation (_idxMapChecking + _updateFoothold,
    CMPC_Locomotion_cv.cpp:768-940).  keep_xy_if_unmoved: when the search
    keeps the target's own cell, return the exact Raibert xy instead of the
    (ceil-quantized) cell center.  return_moved: also return (...,) bool,
    the targets the search moved off their own cell or found no valid cell
    for.  The spiral's offsets are ``spiral_table``'s."""
    H, W = hm.elevation.shape[-2:]
    device = hm.elevation.device
    offs = spiral_table(hm, search_radius_m)
    k = offs.shape[0]

    center_idx = world_to_index(hm, pf[..., 0:2])                # (..., 2)
    cand = center_idx[..., None, :] + offs                        # (..., k, 2)
    cand = torch.stack([cand[..., 0].clamp(0, H - 1), cand[..., 1].clamp(0, W - 1)], dim=-1)
    valid = sample(hm.traversability, cand) > traversability_min  # (..., k)
    # first valid in spiral order; fall back to the center cell
    order_score = torch.where(valid, torch.arange(k, 0, -1, device=device),
                              torch.zeros((), dtype=torch.int64, device=device))
    best = torch.argmax(order_score, dim=-1)
    any_valid = valid.any(-1)
    sel = torch.gather(cand, -2, best[..., None, None].expand(best.shape + (1, 2)))[..., 0, :]
    sel = torch.where(any_valid[..., None], sel, center_idx)

    z = sample(hm.elevation, sel[..., None, :])[..., 0]
    rel_col = (W // 2) - sel[..., 1]
    rel_row = sel[..., 0] - (H // 2)
    xy = hm.center + hm.resolution * torch.stack(
        [rel_col.to(z.dtype), rel_row.to(z.dtype)], dim=-1)
    xy = torch.where(any_valid[..., None], xy, pf[..., 0:2])
    if keep_xy_if_unmoved or return_moved:
        unmoved = (sel == center_idx).all(-1)
    if keep_xy_if_unmoved:
        xy = torch.where(unmoved[..., None], pf[..., 0:2], xy)
    out = torch.cat([xy, (z + foot_offset)[..., None]], dim=-1)
    if return_moved:
        return out, ~unmoved | ~any_valid
    return out
