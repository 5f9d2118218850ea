"""Fused Kalman predict + innovation (18 states, 28 measurements): CUDA
kernel, wrapper and its plain PyTorch version.

Replaces ``quad_periodic_mpc_tpu/ops/pallas/kf_kernel.py::fused_kf_innovate``
(``_kernel``).  The kernel source is ``quad_periodic_mpc_tpu_torch/csrc/
kf.cu``; its header note says what bounds it on an H100 and how it is laid
out (two warps per instance, the covariance chain in shared memory).

- ``fused_kf_innovate``: the wrapper.  CUDA tensors launch the kernel (or
  raise); CPU tensors take the plain version.
- ``fused_kf_innovate_reference``: the plain version, the kernel's
  structured arithmetic in batch-leading PyTorch: the shifted-add predict,
  C's row and column combinations instead of products, the Schur inverse
  of S with one refinement step on both solves, symmetrise, the xy reset.
  It is not the dense chain of ``estimation/kf.update(backend="xla")``,
  which differs from it by f32 conditioning through the start-up transient.
- ``LAUNCHES``: kernel launches since the count was last reset.
"""

from __future__ import annotations

import ctypes

import torch

from quad_periodic_mpc_tpu_torch.ops import linalg
from quad_periodic_mpc_tpu_torch.ops.cuda import build

NX = 18
NY = 28
_ZIDX = (8, 11, 14, 17)          # foot-z state indices (C rows 24..27)
SOURCE = "kf.cu"

LAUNCHES = 0


class _Params(ctypes.Structure):
    _fields_ = [("B", ctypes.c_int), ("dt", ctypes.c_float)]


def _cp_rows(M: torch.Tensor) -> torch.Tensor:
    """C @ M for the structured C: (B, 18, s) -> (B, 28, s) by row
    combination (no product)."""
    top = M[:, 0:3]
    rows = [top - M[:, 6 + 3 * i:9 + 3 * i] for i in range(4)]
    rows += [M[:, 3:6]] * 4
    rows.append(M[:, list(_ZIDX)])
    return torch.cat(rows, dim=1)


def fused_kf_innovate_reference(xhat, P, a, y, q_diag, r_diag, dt: float):
    """Plain version of the fused predict + innovate.  Inputs as
    ``fused_kf_innovate``'s; returns (xhat', P')."""
    dtype, device = xhat.dtype, xhat.device
    xp = torch.cat([xhat[:, 0:3] + dt * xhat[:, 3:6], xhat[:, 3:6] + dt * a,
                    xhat[:, 6:]], dim=1)
    P1 = torch.cat([P[:, 0:3] + dt * P[:, 3:6], P[:, 3:]], dim=1)
    Pm = torch.cat([P1[:, :, 0:3] + dt * P1[:, :, 3:6], P1[:, :, 3:]], dim=2)
    Pm = Pm + torch.diag_embed(q_diag)

    ey = y - _cp_rows(xp[..., None])[..., 0]
    CP = _cp_rows(Pm)                                   # (B, 28, 18)
    PCt = CP.transpose(1, 2)
    S = _cp_rows(PCt) + torch.diag_embed(r_diag)        # C Pm C^T + diag(r)
    S_inv = linalg.spd_inverse_sym(S)    # the kernel's SpdInv<28>
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    S_ey = mv(S_inv, ey)
    S_ey = S_ey + mv(S_inv, ey - mv(S, S_ey))
    x_new = xp + mv(PCt, S_ey)
    M1 = S_inv @ CP
    M1 = M1 + S_inv @ (CP - S @ M1)
    P_new = Pm - PCt @ M1
    P_new = (P_new + P_new.transpose(1, 2)) / 2.0

    # xy blow-up reset (PositionVelocityEstimator.cpp:233-239)
    det2 = P_new[:, 0, 0] * P_new[:, 1, 1] - P_new[:, 0, 1] * P_new[:, 1, 0]
    blowup = (det2 > 1e-6).to(dtype)[:, None, None]
    is_xy = torch.arange(NX, device=device) < 2
    cross = (is_xy[:, None] ^ is_xy[None, :]).to(dtype)
    xyblk = (is_xy[:, None] & is_xy[None, :]).to(dtype)
    scale = 1.0 - blowup * cross - blowup * xyblk * 0.9
    return x_new, P_new * scale


def fused_kf_innovate(xhat, P, a, y, q_diag, r_diag, dt: float):
    """Fused predict + innovate.  xhat (B, 18); P (B, 18, 18); a (B, 3) world
    acceleration with gravity added; y (B, 28) measurements; q_diag (B, 18)
    and r_diag (B, 28) the trust-inflated noise diagonals.  Any B >= 1.
    Returns (xhat', P')."""
    device = xhat.device
    if device.type == "cpu":
        return fused_kf_innovate_reference(xhat, P, a, y, q_diag, r_diag, dt)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return _fused_kf_innovate_cuda(xhat, P, a, y, q_diag, r_diag, dt)


def _fused_kf_innovate_cuda(xhat, P, a, y, q_diag, r_diag, dt: float):
    """Check the inputs, allocate the outputs, launch the kernel."""
    global LAUNCHES
    B = xhat.shape[0]
    device = xhat.device
    if B < 1:
        raise ValueError("need a batch of at least one instance")
    named = {"xhat": (xhat, (B, NX)), "P": (P, (B, NX, NX)), "a": (a, (B, 3)),
             "y": (y, (B, NY)), "q_diag": (q_diag, (B, NX)), "r_diag": (r_diag, (B, NY))}
    for name, (t, shape) in named.items():
        build.check(name, t, shape, device)
    with torch.cuda.device(device):
        outs = [torch.empty(B, NX, dtype=torch.float32, device=device),
                torch.empty(B, NX, NX, dtype=torch.float32, device=device)]
        build.launch(SOURCE, "kf_launch", [t for t, _ in named.values()] + outs,
                     _Params(B=B, dt=dt), device)
    LAUNCHES += 1
    return tuple(outs)
