"""Fused model evaluation and contact kinematics: CUDA kernels, wrappers
and their plain PyTorch versions.

Replaces ``quad_periodic_mpc_tpu/ops/pallas/kinematics_kernel.py``:

- ``fused_model_eval`` (``_model_kernel``): forward kinematics with rotors,
  the CRBA mass matrix A, its inverse by the recursive Schur complement
  (split at (n+1)//2), generalized gravity and Coriolis, and the contact
  kinematics (Jc, Jc qdot, foot positions), in one launch.  Its plain
  version is ``floating_base.mass_matrix``/``generalized_gravity``/
  ``generalized_coriolis``/``contact_jacobians`` with
  ``linalg.spd_inverse``.
- ``fused_contact_kinematics`` (``_kernel``): the contact kinematics alone
  (no rotors); its plain version is ``floating_base.contact_jacobians``.

Both kernels live in ``quad_periodic_mpc_tpu_torch/csrc/kinematics.cu``,
whose header note says what bounds them on an H100 and how they are laid
out (three warps per instance for the model evaluation, one for the
contact kinematics; a leg per lane; the instance's tree in shared memory).
They take the A1's tree (four legs of three joints); ``_tree`` checks it.
CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise.
``LAUNCHES`` counts kernel launches by kernel name.
"""

from __future__ import annotations

import ctypes

import torch

from quad_periodic_mpc_tpu_torch.models import floating_base as fb
from quad_periodic_mpc_tpu_torch.ops import linalg
from quad_periodic_mpc_tpu_torch.ops.cuda import build

N_DOF = fb.N_DOF
SOURCE = "kinematics.cu"

LAUNCHES = {"fused_model_eval": 0, "fused_contact_kinematics": 0}


class _Tree(ctypes.Structure):
    """The tree's topology and static scalars (csrc/kinematics.cu Tree);
    the kernels assume the A1's topology, which ``_tree`` checks."""

    _fields_ = [
        ("parents", ctypes.c_int * 12), ("axis", ctypes.c_int * 12),
        ("gc_body", ctypes.c_int * 4), ("gear", ctypes.c_float * 12),
        ("gravity", ctypes.c_float * 3), ("B", ctypes.c_int),
    ]


def model_eval_reference(state: fb.FBState, mc: fb.ModelConstants):
    """Plain version of the fused model evaluation: (A, Ainv, G, C,
    ContactInfo)."""
    A = fb.mass_matrix(state, mc)
    return (A, linalg.spd_inverse(A), fb.generalized_gravity(state, mc),
            fb.generalized_coriolis(state, mc), fb.contact_jacobians(state, mc))


A1_PARENTS = (0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11)   # four legs of three joints
A1_GC_BODY = (3, 6, 9, 12)                             # the calves


def _tree(mc: fb.ModelConstants, B: int) -> _Tree:
    if len(mc.gear_static) != 12 or len(mc.gravity_static) != 3:
        raise ValueError("ModelConstants lacks gear_static / gravity_static")
    if tuple(mc.parents) != A1_PARENTS or tuple(mc.gc_body) != A1_GC_BODY:
        raise ValueError("the kinematics kernels take the A1's tree: parents "
                         f"{A1_PARENTS}, contact bodies {A1_GC_BODY}")
    return _Tree(
        parents=(ctypes.c_int * 12)(*mc.parents),
        axis=(ctypes.c_int * 12)(*({"x": 0, "y": 1}[a] for a in mc.axes)),
        gc_body=(ctypes.c_int * 4)(*mc.gc_body),
        gear=(ctypes.c_float * 12)(*mc.gear_static),
        gravity=(ctypes.c_float * 3)(*mc.gravity_static), B=B)


def _launch(name: str, state: fb.FBState, consts: dict, n_outs: tuple, mc):
    """Flatten and check the inputs, allocate the outputs, launch kernel
    ``name`` (C entry point ``<name without fused_>_launch``); returns
    (leading dims, outputs)."""
    lead = state.pos.shape[:-1]
    B = state.pos.reshape(-1, 3).shape[0]
    if B < 1:
        raise ValueError("need a batch of at least one instance")
    device = state.pos.device
    parts = [t.reshape(B, n).contiguous() for t, n in zip(state, (4, 3, 6, 12, 12))]
    for field, t, n in zip(fb.FBState._fields, parts, (4, 3, 6, 12, 12)):
        build.check(field, t, (B, n), device)
    for field, (t, shape) in consts.items():
        build.check(field, t, shape, device)
    with torch.cuda.device(device):
        outs = [torch.empty((B,) + n, dtype=torch.float32, device=device) for n in n_outs]
        build.launch(SOURCE, name.removeprefix("fused_") + "_launch",
                     [*parts, *(c for c, _ in consts.values()), *outs], _tree(mc, B), device)
    LAUNCHES[name] += 1
    return lead, outs


def _model_eval_cuda(state: fb.FBState, mc: fb.ModelConstants):
    consts = {"Xtree": (mc.Xtree, (12, 6, 6)), "Xrot": (mc.Xrot, (12, 6, 6)),
              "I_link": (mc.I_link, (12, 6, 6)), "I_rotor": (mc.I_rotor, (12, 6, 6)),
              "I_base": (mc.I_base, (6, 6)), "gc_location": (mc.gc_location, (4, 3))}
    lead, (A, Ainv, G, C, Jc, Jcdqd, p_foot) = _launch(
        "fused_model_eval", state, consts,
        ((N_DOF, N_DOF), (N_DOF, N_DOF), (N_DOF,), (N_DOF,), (12, N_DOF), (12,), (12,)), mc)
    info = fb.ContactInfo(Jc=Jc.reshape(lead + (4, 3, N_DOF)),
                          Jcdqd=Jcdqd.reshape(lead + (4, 3)),
                          p_foot=p_foot.reshape(lead + (4, 3)))
    return (A.reshape(lead + (N_DOF, N_DOF)), Ainv.reshape(lead + (N_DOF, N_DOF)),
            G.reshape(lead + (N_DOF,)), C.reshape(lead + (N_DOF,)), info)


def _contact_kinematics_cuda(state: fb.FBState, mc: fb.ModelConstants) -> fb.ContactInfo:
    consts = {"Xtree": (mc.Xtree, (12, 6, 6)), "gc_location": (mc.gc_location, (4, 3))}
    lead, (Jc, Jcdqd, p_foot) = _launch("fused_contact_kinematics", state, consts,
                                        ((12, N_DOF), (12,), (12,)), mc)
    return fb.ContactInfo(Jc=Jc.reshape(lead + (4, 3, N_DOF)),
                          Jcdqd=Jcdqd.reshape(lead + (4, 3)),
                          p_foot=p_foot.reshape(lead + (4, 3)))


def fused_model_eval(state: fb.FBState, mc: fb.ModelConstants):
    """One-launch model evaluation: returns (A, Ainv, G, C, ContactInfo),
    everything the composed tick needs (WBC dynamics, plant substep cache,
    observation kinematics).  State fields carry any leading batch dims;
    float32.  CPU tensors take the plain version."""
    device = state.pos.device
    if device.type == "cpu":
        return model_eval_reference(state, mc)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return _model_eval_cuda(state, mc)


def fused_contact_kinematics(state: fb.FBState, mc: fb.ModelConstants) -> fb.ContactInfo:
    """One-launch contact kinematics (FK without rotors, foot Jacobians,
    Jc qdot, foot positions): the fused replacement for
    ``floating_base.contact_jacobians``.  CPU tensors take the plain
    version."""
    device = state.pos.device
    if device.type == "cpu":
        return fb.contact_jacobians(state, mc)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return _contact_kinematics_cuda(state, mc)
