"""CMPC-variant locomotion features (counterpart of
``quad_periodic_mpc_tpu/control/cmpc_variant.py``, the newer
CMPCLocomotion driver, src/controllers/CMPC/CMPC_Locomotion.cpp).

- ``pitch_reference``: desired pitch from the estimated stance plane plus a
  velocity-dependent offset (CMPC_Locomotion.cpp:676-695);
- ``terrain_foothold``: map-aware Raibert target adjustment through
  terrain/heightmap.select_foothold (CMPC_Locomotion_cv.cpp:768-940,
  VisionMPCLocomotion.cpp:549-640);
- ``foothold_update``: the full _updateFoothold semantics, the terrain
  loop's foothold hook; on a card one launch of ``csrc/foothold.cu``
  (``foothold_update_kernel``), on the CPU ``foothold_update_plain``.

- ``adaptive_gait_update``: early-contact gait reshaping through
  ops/gait_scheduler.early_contact_handle (the Gait_contact behavior,
  Gait_contact.cpp:108-220, active at CMPC_Locomotion.cpp:652).

The four legs run as one more batch axis: the map gains a singleton leg
axis, the reference's vmap over legs with the map broadcast.

``FOOTHOLD_MOVED`` counts, on each device, the targets that
``foothold_update``'s spiral search moved off their own Raibert cell or
found no valid cell for, and ``FOOTHOLD_SEARCHED`` the targets it searched
(``foothold_counts()`` reads both).  Each is a counter on the device that
the update adds to, so every replay of a graph captured after it was made
counts too.
"""

from __future__ import annotations

import torch

from quad_periodic_mpc_tpu_torch.estimation.kf import plane_body_height
from quad_periodic_mpc_tpu_torch.ops import gait as gait_ops
from quad_periodic_mpc_tpu_torch.ops.cuda import foothold_kernel
from quad_periodic_mpc_tpu_torch.ops.gait_scheduler import early_contact_handle
from quad_periodic_mpc_tpu_torch.terrain import heightmap as hmap

# device -> int64 counter on it, made by the first update there outside a
# capture (an update captured before then is not counted)
FOOTHOLD_MOVED: dict[str, torch.Tensor] = {}
FOOTHOLD_SEARCHED: dict[str, torch.Tensor] = {}


def _counter(table: dict, device) -> torch.Tensor | None:
    counter = table.get(str(device))
    if counter is None and not (device.type == "cuda"
                                and torch.cuda.is_current_stream_capturing()):
        counter = table[str(device)] = torch.zeros((), dtype=torch.int64, device=device)
    return counter


def foothold_counts() -> tuple[int, int]:
    """(moved, searched) foothold targets, summed over the devices (a host
    read: call it after the work)."""
    return (sum(int(c) for c in FOOTHOLD_MOVED.values()),
            sum(int(c) for c in FOOTHOLD_SEARCHED.values()))


def pitch_reference(
    pitch_cmd: torch.Tensor,
    rpy: torch.Tensor,
    p_feet_body: torch.Tensor,
    x_vel_des: torch.Tensor,
    max_vel_x: float,
    standing=False,
) -> torch.Tensor:
    """Desired pitch = cmd + actual pitch + stance-plane pitch +
    velocity-dependent crouch (CMPC_Locomotion.cpp:676-695).  p_feet_body:
    (..., 4, 3) last stance footholds in the body frame."""
    _, est_pitch_plane = plane_body_height(p_feet_body)
    vel_term = torch.where(x_vel_des > 0, -0.3 * x_vel_des / max_vel_x,
                           -0.2 * x_vel_des / max_vel_x)
    pitch = pitch_cmd + rpy[..., 1] + est_pitch_plane + vel_term
    standing = torch.as_tensor(standing, device=pitch.device)
    return torch.where(standing, torch.zeros_like(pitch), pitch)


def adaptive_gait_update(
    gait: gait_ops.GaitParams,
    swing_state: torch.Tensor,
    phase: torch.Tensor,
    foot_sensor: torch.Tensor,
) -> gait_ops.GaitParams:
    """Early-contact gait reshaping on integer gait params: converts to
    phase fractions (float32, as the reference), applies
    earlyContactHandle, converts back with truncation toward zero
    (Gait.cpp:282-302 semantics on the OffsetDurationGait tables)."""
    seg = gait.n_segments.to(torch.float32)[..., None]
    off_f = gait.offsets.to(torch.float32) / seg
    dur_f = gait.durations.to(torch.float32) / seg
    off2, dur2 = early_contact_handle(off_f, dur_f, swing_state, phase, foot_sensor,
                                      gait.n_segments)
    return gait._replace(offsets=(off2 * seg).to(gait.offsets.dtype),
                         durations=(dur2 * seg).to(gait.durations.dtype))


def _per_leg(hm: hmap.HeightMap) -> hmap.HeightMap:
    """The map with a singleton axis before its grid (and center) axes, to
    broadcast against a leg axis."""
    return hmap.HeightMap(
        elevation=hm.elevation.unsqueeze(-3), variance=hm.variance.unsqueeze(-3),
        traversability=hm.traversability.unsqueeze(-3), center=hm.center.unsqueeze(-2),
        resolution=hm.resolution)


def terrain_foothold(
    hm: hmap.HeightMap,
    pf_raibert: torch.Tensor,      # (..., 4, 3)
    search_radius_m: float = 0.10,
    foot_offset: float = 0.0,
) -> torch.Tensor:
    """Adjust all four Raibert targets against the elevation map."""
    return hmap.select_foothold(_per_leg(hm), pf_raibert, search_radius_m=search_radius_m,
                                foot_offset=foot_offset)


def foothold_update(
    hm: hmap.HeightMap,
    pf_raibert: torch.Tensor,      # (..., 4, 3) Raibert targets, world
    p0: torch.Tensor,              # (..., 4, 3) swing-start foot positions, world
    search_radius_m: float = 0.10,
    traversability_min: float = 0.8,
    max_step_height: float = 0.17,
    first_swing: torch.Tensor | None = None,   # (..., 4) bool
    p_feet: torch.Tensor | None = None,        # (..., 4, 3) feet, world
) -> torch.Tensor:
    """Full _updateFoothold semantics (CMPC_Locomotion_cv.cpp:768-883):

    xy: each Raibert target snaps to the first valid cell in spiral order
    within ``search_radius_m`` (``_idxMapChecking``:913-940, validity =
    traversability > traversability_min), keeping the exact xy when its own
    cell is valid;

    z: relative to the swing-start cell, pf_z = p0_z + (pf_h - p0_h), the
    step clamped from above at MAX_STEP_HEIGHT (CMPC_Locomotion_cv.h:24 =
    0.17; :878-882 clamps only upward).

    ``first_swing`` and ``p_feet``, where given: a leg whose swing starts
    this tick (first_swing) starts from its foot, the others from ``p0``
    (the swing-start point the terrain loop's hook hands in).

    The grid is world-anchored (``hm.center``), so a frozen map answers the
    same world-frame lookup.  Every target adds to ``FOOTHOLD_SEARCHED``,
    and one moved off its cell or with no valid cell to ``FOOTHOLD_MOVED``.

    On a card ``foothold_update_kernel``, on the CPU ``foothold_update_plain``."""
    update = foothold_update_kernel if pf_raibert.device.type == "cuda" else foothold_update_plain
    return update(hm, pf_raibert, p0, search_radius_m, traversability_min, max_step_height,
                  first_swing, p_feet)


def foothold_update_kernel(hm, pf_raibert, p0, search_radius_m=0.10, traversability_min=0.8,
                           max_step_height=0.17, first_swing=None, p_feet=None):
    """``foothold_update_plain``'s update as one launch of a CUDA kernel
    (``ops/cuda/foothold_kernel``), which adds to the counters on the
    device."""
    moved = _counter(FOOTHOLD_MOVED, pf_raibert.device)
    searched = None if moved is None else _counter(FOOTHOLD_SEARCHED, pf_raibert.device)
    return foothold_kernel.launch(
        hm, pf_raibert, p0, hmap.spiral_table(hm, search_radius_m, torch.int32),
        traversability_min, max_step_height, first_swing, p_feet, moved=moved,
        searched=searched)


def foothold_update_plain(hm, pf_raibert, p0, search_radius_m=0.10, traversability_min=0.8,
                          max_step_height=0.17, first_swing=None, p_feet=None):
    """``foothold_update`` in PyTorch operations, the plain version of
    ``foothold_update_kernel``."""
    if first_swing is not None:
        p0 = torch.where(first_swing[..., None], p_feet, p0)
    leg_hm = _per_leg(hm)
    sel, moved = hmap.select_foothold(leg_hm, pf_raibert, search_radius_m=search_radius_m,
                                      traversability_min=traversability_min,
                                      keep_xy_if_unmoved=True, return_moved=True)
    moved_count = _counter(FOOTHOLD_MOVED, moved.device)
    if moved_count is not None:
        moved_count.add_(moved.sum())
        _counter(FOOTHOLD_SEARCHED, moved.device).add_(moved.numel())
    idx0 = hmap.world_to_index(leg_hm, p0[..., 0:2])
    z0 = hmap.sample(leg_hm.elevation, idx0[..., None, :])[..., 0]
    dz = torch.clamp(sel[..., 2] - z0, max=max_step_height)
    return torch.cat([sel[..., 0:2], (p0[..., 2] + dz)[..., None]], dim=-1)
