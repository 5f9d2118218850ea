"""Small dense linear algebra (counterpart of
``quad_periodic_mpc_tpu/ops/linalg.py``).  Only ``spd_inverse`` is ported:
the discrete disturbance residual (ops/estimator.py) needs it."""

from __future__ import annotations

import torch


def spd_inverse(M: torch.Tensor) -> torch.Tensor:
    """Exact batched inverse of a small SPD matrix via recursive Schur
    complements with a 3x3 Cramer base case.

      M = [[A, B], [B^T, D]],  S = D - B^T A^{-1} B,
      M^{-1} = [[A^{-1} + W S^{-1} W^T, -W S^{-1}], [-S^{-1} W^T, S^{-1}]],
      W = A^{-1} B.

    The split is at (n + 1) // 2, as in the reference: elimination order
    is a numerical choice (docs/KERNELS.md design rule 2).
    """
    n = M.shape[-1]
    if n == 1:
        return 1.0 / M
    if n == 2:
        a = M[..., 0, 0]
        b = M[..., 0, 1]
        d = M[..., 1, 1]
        det = a * d - b * M[..., 1, 0]
        row0 = torch.stack([d, -b], dim=-1)
        row1 = torch.stack([-M[..., 1, 0], a], dim=-1)
        return torch.stack([row0, row1], dim=-2) / det[..., None, None]
    if n == 3:
        a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
        d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
        g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
        A00 = e * i - f * h
        A01 = c * h - b * i
        A02 = b * f - c * e
        A10 = f * g - d * i
        A11 = a * i - c * g
        A12 = c * d - a * f
        A20 = d * h - e * g
        A21 = b * g - a * h
        A22 = a * e - b * d
        det = a * A00 + b * A10 + c * A20
        adj = torch.stack(
            [
                torch.stack([A00, A01, A02], dim=-1),
                torch.stack([A10, A11, A12], dim=-1),
                torch.stack([A20, A21, A22], dim=-1),
            ],
            dim=-2,
        )
        return adj / det[..., None, None]
    k = (n + 1) // 2
    A = M[..., :k, :k]
    B = M[..., :k, k:]
    D = M[..., k:, k:]
    Ai = spd_inverse(A)
    W = Ai @ B
    S = D - B.transpose(-1, -2) @ W
    Si = spd_inverse(S)
    WSi = W @ Si
    TL = Ai + WSi @ W.transpose(-1, -2)
    top = torch.cat([TL, -WSi], dim=-1)
    bot = torch.cat([-WSi.transpose(-1, -2), Si], dim=-1)
    return torch.cat([top, bot], dim=-2)
