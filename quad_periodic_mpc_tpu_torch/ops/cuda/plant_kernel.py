"""Fused articulated-plant substeps: CUDA kernel, wrapper and its plain
PyTorch version.

Replaces ``quad_periodic_mpc_tpu/ops/pallas/plant_kernel.py::
fused_substeps`` (``_kernel``): ``substeps`` semi-implicit Euler steps on
the tick-frozen model (cached A^{-1}, G, C and contact Jacobian, integrated
foot positions), with penalty contact, stiction anchors, the Coulomb cap
and the manifold quaternion update.  The kernel source is
``quad_periodic_mpc_tpu_torch/csrc/plant.cu``.

- ``fused_substeps``: the wrapper.  CUDA tensors launch the kernel (or
  raise); CPU tensors take the plain version.
- ``fused_substeps_reference``: the plain version, ``substeps`` chained
  ``articulated_sim.step_fast`` calls, with the clock advanced once by
  ``dt * substeps`` as the kernel's caller advances it.
- ``LAUNCHES``: kernel launches since the count was last reset.
"""

from __future__ import annotations

import ctypes

import torch

from quad_periodic_mpc_tpu_torch.models import floating_base as fb
from quad_periodic_mpc_tpu_torch.ops.cuda import build
from quad_periodic_mpc_tpu_torch.sim import articulated_sim as art

ND = 18
SOURCE = "plant.cu"

LAUNCHES = 0


class _Params(ctypes.Structure):
    _fields_ = (
        [("B", ctypes.c_int), ("substeps", ctypes.c_int)]
        + [(n, ctypes.c_float) for n in (
            "dt", "k_normal", "d_normal", "mu", "k_tangent", "d_tangent")]
    )


def fused_substeps_reference(state: art.ArtState, tau_joints, dt: float,
                             params: art.ContactParams, cache, Jc, p_foot,
                             substeps: int):
    """Plain version: returns (state', p_foot')."""
    s, pf = state, p_foot
    for _ in range(substeps):
        s, pf, _ = art.step_fast(s, tau_joints, dt, params, cache, Jc, pf)
    return s._replace(t=state.t + dt * substeps), pf


def fused_substeps(state: art.ArtState, tau_joints, dt: float,
                   params: art.ContactParams, cache, Jc, p_foot, substeps: int):
    """``substeps`` chained step_fast substeps in one launch.

    state: ArtState with any leading batch dims; tau_joints (..., 4, 3) or
    (..., 12); cache = (A^{-1}, G, C) of the tick; Jc (..., 4, 3, 18) and
    p_foot (..., 4, 3) the tick-frozen contact kinematics.  float32.
    Returns (state', p_foot')."""
    device = state.fb.pos.device
    if device.type == "cpu":
        return fused_substeps_reference(state, tau_joints, dt, params, cache, Jc,
                                        p_foot, substeps)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return _fused_substeps_cuda(state, tau_joints, dt, params, cache, Jc, p_foot, substeps)


def _fused_substeps_cuda(state: art.ArtState, tau_joints, dt: float, params: art.ContactParams,
            cache, Jc, p_foot, substeps: int):
    """Flatten and check the inputs, allocate the outputs, launch the
    kernel; returns (state', p_foot')."""
    global LAUNCHES
    s = state.fb
    device = s.pos.device
    lead = s.pos.shape[:-1]
    B = s.pos.reshape(-1, 3).shape[0]
    if B < 1 or substeps < 1:
        raise ValueError("need a batch of at least one instance and substeps >= 1")
    A_inv, G, C = cache
    flat = lambda t, *shape: t.reshape((B,) + shape).contiguous()
    ins = {"quat": flat(s.quat, 4), "pos": flat(s.pos, 3), "v_body": flat(s.v_body, 6),
           "q": flat(s.q, 12), "qd": flat(s.qd, 12), "anchor": flat(state.anchor, 8),
           "tau": flat(tau_joints, 12), "A_inv": flat(A_inv, ND, ND),
           "G": flat(G, ND), "C": flat(C, ND), "Jc": flat(Jc, 12, ND),
           "p_foot": flat(p_foot, 12)}
    for name, t in ins.items():
        build.check(name, t, t.shape, device)
    kp = _Params(B=B, substeps=int(substeps), dt=float(dt), k_normal=params.k_normal,
                 d_normal=params.d_normal, mu=params.mu, k_tangent=params.k_tangent,
                 d_tangent=params.d_tangent)
    with torch.cuda.device(device):
        f32 = dict(dtype=torch.float32, device=device)
        outs = [torch.empty(B, n, **f32) for n in (4, 3, 6, 12, 12, 8, 12, 4)]
        build.launch(SOURCE, "plant_launch", list(ins.values()) + outs, kp, device)
    LAUNCHES += 1
    quat, pos, vb, q, qd, anchor, pf, contact = outs
    new_state = art.ArtState(
        fb=fb.FBState(quat=quat.reshape(lead + (4,)), pos=pos.reshape(lead + (3,)),
                      v_body=vb.reshape(lead + (6,)), q=q.reshape(lead + (12,)),
                      qd=qd.reshape(lead + (12,))),
        t=state.t + dt * substeps,
        anchor=anchor.reshape(lead + (4, 2)),
        in_contact=contact.reshape(lead + (4,)),
    )
    return new_state, pf.reshape(lead + (4, 3))
