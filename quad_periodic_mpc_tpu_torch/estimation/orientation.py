"""Quaternion helpers (counterpart of
``quad_periodic_mpc_tpu/estimation/orientation.py``).  Only ``quat_product``
is ported: the WBC orientation task and the articulated plant need it.  The
orientation estimator itself (``run``) is not ported yet (ROADMAP.md
Queue 1)."""

from __future__ import annotations

import torch


def quat_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product (wxyz), matching ori::quatProduct."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )
