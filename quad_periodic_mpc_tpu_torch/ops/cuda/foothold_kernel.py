"""The terrain tier's foothold update: CUDA kernel and its wrapper.

Replaces no TPU kernel: the JAX package's
``control/cmpc_variant.py::foothold_update`` is one XLA fusion, while the
port's plain version, ``control/cmpc_variant.foothold_update_plain``,
passes some hundred PyTorch operations over (B, 4, 49) candidate tensors a
tick.  The kernel computes the same update, one thread per (instance, leg);
its source is ``quad_periodic_mpc_tpu_torch/csrc/foothold.cu``.
``cmpc_variant.foothold_update`` takes it (``foothold_update_kernel``) for
card tensors, ``foothold_update_plain`` for CPU tensors.

- ``launch``: the wrapper, one launch; float32 and float64 each have a
  kernel, any other dtype raises.
- ``LAUNCHES``: launches made outside a graph capture since the count was
  last reset.  A capture launches nothing and a replay runs no Python, so
  a captured update's launches are not counted: the wrapper is not one of
  ``runtime/graphs._COUNTED``'s.
"""

from __future__ import annotations

import ctypes
import math

import torch

from quad_periodic_mpc_tpu_torch.ops.cuda import build

SOURCE = "foothold.cu"
_ENTRY = {torch.float32: "foothold_launch_f32", torch.float64: "foothold_launch_f64"}
MAX_OFFSETS = 6144      # (row, col) int32 pairs in 48 KB of shared memory

LAUNCHES = 0

_INPUTS = ("pf", "swing_p0", "p_feet", "first_swing", "elevation", "traversability", "center")


class _Params(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int) for n in ("n", "legs", "H", "W", "k")]
                + [(n, ctypes.c_double) for n in ("res", "trav_min", "max_step")]
                + [("offsets", ctypes.c_void_p)]
                + [(n, build.Strided) for n in _INPUTS]
                + [(n, ctypes.c_void_p) for n in ("out", "moved", "searched")])


def launch(hm, pf_raibert: torch.Tensor, p0: torch.Tensor, offsets: torch.Tensor,
           traversability_min: float, max_step_height: float, first_swing=None, p_feet=None,
           moved=None, searched=None) -> torch.Tensor:
    """``cmpc_variant.foothold_update_plain``'s update in one launch.

    ``hm`` is a ``heightmap.HeightMap`` with (..., H, W) layers and a
    (..., 2) center; ``pf_raibert`` and ``p0`` are (..., legs, 3);
    ``first_swing`` (..., legs) bool and ``p_feet`` (..., legs, 3), where
    given, start a leg's swing at its foot where first_swing is set.  The
    batch axes broadcast, all float tensors of one dtype, float32 or
    float64, on one device.  ``offsets`` is the spiral's (k, 2) int32
    table (``heightmap.spiral_table``).  ``moved`` and ``searched`` are
    int64 counters (0-dim) that the kernel adds to, or None.  Returns the
    swing targets (..., legs, 3).  Nothing is read back to the host, so a
    graph can capture it."""
    global LAUNCHES
    device, dtype = pf_raibert.device, pf_raibert.dtype
    if dtype not in _ENTRY:
        raise TypeError(f"pf_raibert: expected float32 or float64, got {dtype}")
    if (first_swing is None) != (p_feet is None):
        raise ValueError("first_swing and p_feet come together")
    legs = pf_raibert.shape[-2]
    H, W = hm.elevation.shape[-2:]
    shapes = [pf_raibert.shape[:-2], p0.shape[:-2], hm.elevation.shape[:-2],
              hm.traversability.shape[:-2], hm.center.shape[:-1]]
    if first_swing is not None:
        shapes += [first_swing.shape[:-1], p_feet.shape[:-2]]
    lead = torch.broadcast_shapes(*shapes)
    B = math.prod(lead)
    if B < 1 or H < 1 or W < 1:
        raise ValueError("need a batch of at least one instance and a grid of one cell")
    k = offsets.shape[0]
    if offsets.dtype != torch.int32 or tuple(offsets.shape) != (k, 2) or not (
            1 <= k <= MAX_OFFSETS) or offsets.device != device or not offsets.is_contiguous():
        raise ValueError(f"offsets: expected a contiguous ({k}, 2) int32 table of 1 to "
                         f"{MAX_OFFSETS} rows on {device}")
    keep, ins = [offsets], {}

    def add(name, t, shape, dt=dtype):
        view, strided = build.rows(name, t, lead, shape, device, dt)
        keep.append(view)
        ins[name] = strided

    add("pf", pf_raibert, (legs, 3))
    add("swing_p0", p0, (legs, 3))
    if first_swing is None:
        ins["p_feet"] = ins["first_swing"] = build.Strided(None, 0, 0)
    else:
        add("p_feet", p_feet, (legs, 3))
        add("first_swing", first_swing, (legs,), torch.bool)
    add("elevation", hm.elevation, (H, W))
    add("traversability", hm.traversability, (H, W))
    add("center", hm.center, (2,))
    counters = {}
    for name, c in (("moved", moved), ("searched", searched)):
        if c is not None:
            build.check(name, c, (), device, torch.int64)
        counters[name] = None if c is None else c.data_ptr()

    out = torch.empty(lead + (legs, 3), dtype=dtype, device=device)
    kp = _Params(n=B * legs, legs=legs, H=H, W=W, k=k, res=float(hm.resolution),
                 trav_min=float(traversability_min), max_step=float(max_step_height),
                 offsets=offsets.data_ptr(), **ins, out=out.data_ptr(), **counters)
    with torch.cuda.device(device):
        build.launch(SOURCE, _ENTRY[dtype], [], kp, device)
    # (CPU tensors: the tests' emulation of the kernel, never captured)
    if device.type != "cuda" or not torch.cuda.is_current_stream_capturing():
        LAUNCHES += 1
    return out
