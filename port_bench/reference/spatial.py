"""6-D spatial vector algebra (Featherstone), batched (a frozen copy of the port's
``quad_periodic_mpc_tpu_torch/models/spatial.py``).

Conventions of src/common/Dynamics/spatial.h and SpatialInertia.h: motion
vectors [omega; v], Plucker motion transforms X = [[R, 0], [-R [r]x, R]]
(createSXform, spatial.h:149-159), motion and force cross products
(spatial.h:49-74), spatial inertia [[I + m cx cx^T, m cx], [m cx^T, m 1]].
All functions broadcast over leading batch dims.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference.rotations import skew


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis (the component formula of jnp.cross)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def sxform(R: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Motion transform child-from-parent: X = [[R, 0], [-R [r]x, R]]."""
    batch = torch.broadcast_shapes(R.shape[:-2], r.shape[:-1])
    R = R.expand(batch + (3, 3))
    X = torch.zeros(batch + (6, 6), dtype=R.dtype, device=R.device)
    X[..., 0:3, 0:3] = R
    X[..., 3:6, 3:6] = R
    X[..., 3:6, 0:3] = -R @ skew(r)
    return X


def sxform_inv_T(X: torch.Tensor) -> torch.Tensor:
    """Force transform X^{-T} of a motion transform X."""
    out = torch.zeros_like(X)
    out[..., 0:3, 0:3] = X[..., 0:3, 0:3]
    out[..., 3:6, 3:6] = X[..., 0:3, 0:3]
    out[..., 0:3, 3:6] = X[..., 3:6, 0:3]          # -R [r]x
    return out


def motion_cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """crm(a) @ b (spatial.h:81-97)."""
    w, v = a[..., 0:3], a[..., 3:6]
    bw, bv = b[..., 0:3], b[..., 3:6]
    return torch.cat([cross(w, bw), cross(v, bw) + cross(w, bv)], dim=-1)


def force_cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """crf(a) @ b = -crm(a)^T b (spatial.h:100-116)."""
    w, v = a[..., 0:3], a[..., 3:6]
    bn, bf = b[..., 0:3], b[..., 3:6]
    return torch.cat([cross(w, bn) + cross(v, bf), cross(w, bf)], dim=-1)


def spatial_inertia(mass, com: torch.Tensor, I_rot: torch.Tensor) -> torch.Tensor:
    """Mass + CoM + rotational inertia about the CoM -> 6x6 spatial inertia
    (SpatialInertia.h constructor)."""
    c = skew(com)
    m = torch.as_tensor(mass, dtype=com.dtype, device=com.device)
    batch = torch.broadcast_shapes(com.shape[:-1], I_rot.shape[:-2], m.shape)
    out = torch.zeros(batch + (6, 6), dtype=com.dtype, device=com.device)
    mc = m[..., None, None] * c
    out[..., 0:3, 0:3] = I_rot + mc @ c.transpose(-1, -2)
    out[..., 0:3, 3:6] = mc
    out[..., 3:6, 0:3] = mc.transpose(-1, -2)
    out[..., 3:6, 3:6] = m[..., None, None] * torch.eye(
        3, dtype=com.dtype, device=com.device)
    return out


def flip_inertia_y(mass: float, com, I_rot):
    """Mirror (mass, com, I) across the XZ plane (flipAlongAxis(Y),
    SpatialInertia.h) for right-side legs."""
    P = np.diag([1.0, -1.0, 1.0])
    return mass, P @ np.asarray(com), P @ np.asarray(I_rot) @ P


def rot_x(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[1, 0, 0], [0, c, s], [0, -s, c]])


def rot_y(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])


def rot_z(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])


def joint_rotation(axis: str, q: torch.Tensor) -> torch.Tensor:
    """Coordinate rotation about a named axis (orientation_tools.h:66-89:
    coordinate rotations, i.e. transposes of active rotations)."""
    c, s = torch.cos(q), torch.sin(q)
    zero = torch.zeros_like(q)
    one = torch.ones_like(q)
    if axis == "x":
        rows = [one, zero, zero, zero, c, s, zero, -s, c]
    elif axis == "y":
        rows = [c, zero, -s, zero, one, zero, s, zero, c]
    elif axis == "z":
        rows = [c, s, zero, -s, c, zero, zero, zero, one]
    else:
        raise ValueError(axis)
    return torch.stack(rows, dim=-1).reshape(q.shape + (3, 3))


def joint_motion_subspace(axis: str, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Revolute joint motion subspace S (6,)."""
    S = torch.zeros(6, dtype=dtype, device=device)
    S[{"x": 0, "y": 1, "z": 2}[axis]] = 1.0
    return S
