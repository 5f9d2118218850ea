"""One SRB plant step: CUDA kernel and its wrapper.

Replaces no TPU kernel: the JAX package's ``sim/srb_sim.py::step`` is one
XLA fusion, while the port's plain version, ``sim/srb_sim.step_dense``,
dispatches about a hundred operations a step (the dense A / B / Qc build,
the batched GEMMs of the nilpotent ZOH, three matrix-vector products).
The kernel evaluates the same exact ZOH matrix-free, one thread per
instance; its source is ``quad_periodic_mpc_tpu_torch/csrc/srb_plant.cu``.
``srb_sim.step`` takes the kernel (``step_kernel``) for card tensors,
``step_dense`` for CPU tensors, and clamps the feet onto a terrain after
either.

- ``srb_plant_step``: the wrapper, ``srb_sim.step_kernel``'s launch; float32
  and float64 each have a kernel, any other dtype raises.
- ``LAUNCHES``: launches made outside a graph capture since the count was
  last reset.  A capture launches nothing and a replay runs no Python, so
  a captured step's launches are not counted: the wrapper is not one of
  ``runtime/graphs._COUNTED``'s.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from quad_periodic_mpc_tpu_torch.ops.cuda import build

SOURCE = "srb_plant.cu"
_ENTRY = {torch.float32: ("srb_plant_launch_f32", np.float32),
          torch.float64: ("srb_plant_launch_f64", np.float64)}

LAUNCHES = 0


class _Params(ctypes.Structure):
    _fields_ = [("B", ctypes.c_int), ("wrench", ctypes.c_int), ("dt", ctypes.c_double),
                ("mass", ctypes.c_double), ("two_pi", ctypes.c_double),
                ("inv_inertia", ctypes.c_double * 3)]


def srb_plant_step(x, p_feet, t, forces, p_foot_des, stance_mask, dist, wrench: bool,
                   mass: float, inertia_body, dt: float):
    """One plant step of length dt, one launch.

    x (..., 13), p_feet / forces / p_foot_des (..., 4, 3), t and
    stance_mask (...,) and (..., 4); dist the four tensors (static, amp,
    freq, phase) of a ``DisturbanceParams``, each broadcast to (...,), or of
    a ``WrenchDisturbance`` (``wrench``), each to (..., 6).  All float32 or
    all float64, on one card.  Nothing is read back to the host, so a graph
    can capture it.  Returns (x', p_feet', t')."""
    global LAUNCHES
    device, dtype = x.device, x.dtype
    if dtype not in _ENTRY:
        raise TypeError(f"x: expected float32 or float64, got {dtype}")
    entry, np_dtype = _ENTRY[dtype]
    lead = x.shape[:-1]
    B = math.prod(lead)
    if B < 1:
        raise ValueError("need a batch of at least one instance")
    nw = (6,) if wrench else ()
    flat = lambda a, *shape: torch.broadcast_to(a, lead + shape).reshape((B,) + shape).contiguous()
    ins = {"x": flat(x, 13), "p_feet": flat(p_feet, 4, 3), "t": flat(t),
           "forces": flat(forces, 4, 3), "p_foot_des": flat(p_foot_des, 4, 3),
           "stance": flat(stance_mask, 4)}
    ins.update({f"dist.{k}": flat(v, *nw)
                for k, v in zip(("static", "amp", "freq", "phase"), dist)})
    for name, a in ins.items():
        build.check(name, a, a.shape, device, dtype)
    # each scalar rounded to the tensors' type, as the plain version rounds it
    inv_inertia = np_dtype(1.0) / np.asarray(inertia_body, np_dtype)
    kp = _Params(B=B, wrench=int(wrench), dt=float(np_dtype(dt)), mass=float(np_dtype(mass)),
                 two_pi=float(np_dtype(2.0 * math.pi)),
                 inv_inertia=(ctypes.c_double * 3)(*inv_inertia.tolist()))
    with torch.cuda.device(device):
        like = dict(dtype=dtype, device=device)
        outs = [torch.empty(B, 13, **like), torch.empty(B, 4, 3, **like), torch.empty(B, **like)]
        build.launch(SOURCE, entry, list(ins.values()) + outs, kp, device)
    # (CPU tensors: the tests' emulation of the kernel, never captured)
    if device.type != "cuda" or not torch.cuda.is_current_stream_capturing():
        LAUNCHES += 1
    x_new, feet, t_new = outs
    return x_new.reshape(lead + (13,)), feet.reshape(lead + (4, 3)), t_new.reshape(lead)
