"""Fused whole-body control (KinWBC + WBIC + cone PDIP): CUDA kernel,
wrapper and its plain PyTorch version.

Replaces ``quad_periodic_mpc_tpu/ops/pallas/wbc_kernel.py::fused_wbc``
(``_kernel``).  The kernel source is ``quad_periodic_mpc_tpu_torch/csrc/
wbc.cu``; its header note says what bounds it on an H100 and how it is
laid out (one warp per instance, the instance's matrices in shared
memory).

- ``fused_wbc``: the wrapper.  CUDA tensors launch the kernel (or raise);
  CPU tensors take the plain version.
- ``fused_wbc_reference``: the plain version, ``control/wbc.kin_wbc`` and
  ``wbic`` on the task set the kernel rebuilds from its inputs, with the
  PDIP's KKT solve on the ``"spd"`` path (Schur inverse plus one
  refinement step) whatever ``pdip.kkt`` says, as the kernel does.
- ``LAUNCHES``: kernel launches since the count was last reset.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from quad_periodic_mpc_tpu_torch.config import PDIPConfig
from quad_periodic_mpc_tpu_torch.ops.cuda import build

ND = 18          # generalized dofs
NJ = 12          # actuated joints
SOURCE = "wbc.cu"

LAUNCHES = 0


class _Params(ctypes.Structure):
    _fields_ = (
        [("B", ctypes.c_int), ("pdip_iters", ctypes.c_int)]
        + [(n, ctypes.c_float) for n in (
            "damping", "w_floating", "w_rf", "mu", "max_fz", "pdip_reg",
            "pdip_tau", "pdip_mu_min", "pdip_slack_floor", "pdip_big_clamp")]
    )


def fused_wbc_reference(A, Ainv, bvec, Jc, Jcdqd, cmask, R, err, vel, cmd,
                        jdqd, fr_des, q, gains, pdip: PDIPConfig):
    """Plain version of the fused WBC.  Inputs as ``fused_wbc``'s; returns
    (des_jpos, des_jvel, tau, fr), each (B, 12)."""
    from quad_periodic_mpc_tpu_torch.control import wbc
    from quad_periodic_mpc_tpu_torch.models import floating_base as fb

    B = q.shape[0]
    J_ori = torch.zeros(B, 3, ND, dtype=q.dtype, device=q.device)
    J_pos = torch.zeros_like(J_ori)
    J_ori[..., 0:3] = R
    J_pos[..., 3:6] = R
    Jc4 = Jc.reshape(B, 4, 3, ND)
    J_feet = Jc4 * (1.0 - cmask)[..., None, None]
    jacobians = [J_ori, J_pos] + [J_feet[:, k] for k in range(4)]
    split = lambda v: [v[:, 3 * i:3 * i + 3] for i in range(6)]
    Jc_masked = Jc4 * cmask[..., None, None]
    Jcdqd_masked = Jcdqd.reshape(B, 4, 3) * cmask[..., None]
    state = fb.FBState(quat=None, pos=None, v_body=None, q=q, qd=None)
    des_jpos, des_jvel = wbc.kin_wbc(state, Jc_masked, jacobians, split(err),
                                     split(vel), gains)
    tau, fr, _ = wbc.wbic(state, A, Ainv, bvec, torch.zeros_like(bvec), Jc_masked,
                          Jcdqd_masked, jacobians, split(cmd), split(jdqd), fr_des,
                          cmask, gains, dataclasses.replace(pdip, kkt="spd"))
    return des_jpos, des_jvel, tau, fr


def fused_wbc(A, Ainv, bvec, Jc, Jcdqd, cmask, R, err, vel, cmd, jdqd,
              fr_des, q, gains, pdip: PDIPConfig):
    """Fused WBC solve.  A, Ainv (B,18,18); bvec = C + G (B,18); Jc (B,12,18)
    and Jcdqd (B,12) unmasked; cmask (B,4) stance mask (1 stance, 0 swing);
    R (B,3,3) body->world; err, vel, cmd, jdqd (B,18) the six tasks' kin
    errors, velocities, acceleration commands and Jdot qdot, pre-masked;
    fr_des (B,12) pre-masked MPC forces; q (B,12).  All float32 and
    contiguous.  ``gains`` is a WBCGains.  Returns (des_jpos, des_jvel, tau,
    fr), each (B, 12)."""
    device = q.device
    if device.type == "cpu":
        return fused_wbc_reference(A, Ainv, bvec, Jc, Jcdqd, cmask, R, err, vel,
                                   cmd, jdqd, fr_des, q, gains, pdip)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return _fused_wbc_cuda(A, Ainv, bvec, Jc, Jcdqd, cmask, R, err, vel, cmd, jdqd,
                           fr_des, q, gains, pdip)


def _fused_wbc_cuda(A, Ainv, bvec, Jc, Jcdqd, cmask, R, err, vel, cmd, jdqd, fr_des, q,
                    gains, pdip: PDIPConfig):
    """Check the inputs, allocate the outputs, launch the kernel."""
    global LAUNCHES
    B = q.shape[0]
    device = q.device
    if B < 1:
        raise ValueError("need a batch of at least one instance")
    named = {"A": (A, (B, ND, ND)), "Ainv": (Ainv, (B, ND, ND)),
             "bvec": (bvec, (B, ND)), "Jc": (Jc, (B, NJ, ND)), "Jcdqd": (Jcdqd, (B, NJ)),
             "cmask": (cmask, (B, 4)), "R": (R, (B, 3, 3)), "err": (err, (B, ND)),
             "vel": (vel, (B, ND)), "cmd": (cmd, (B, ND)), "jdqd": (jdqd, (B, ND)),
             "fr_des": (fr_des, (B, NJ)), "q": (q, (B, NJ))}
    for name, (t, shape) in named.items():
        build.check(name, t, shape, device)
    params = _Params(
        B=B, pdip_iters=int(pdip.iterations), damping=gains.pinv_damping,
        w_floating=gains.w_floating, w_rf=gains.w_rf, mu=gains.mu,
        max_fz=gains.max_fz, pdip_reg=pdip.reg, pdip_tau=pdip.tau,
        pdip_mu_min=pdip.mu_min, pdip_slack_floor=pdip.slack_floor,
        pdip_big_clamp=pdip.big_clamp)
    with torch.cuda.device(device):
        outs = [torch.empty(B, NJ, dtype=torch.float32, device=device) for _ in range(4)]
        build.launch(SOURCE, "wbc_launch",
                     [t for t, _ in named.values()] + outs, params, device)
    LAUNCHES += 1
    return tuple(outs)
