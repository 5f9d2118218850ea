"""Small dense linear algebra: the exact batched inverses of small SPD
matrices by recursive Schur complements (the discrete disturbance
residual, the WBC, the model evaluation), an SPD solve and a block-diagonal
add.  Every product is a full float32 product with TF32 off."""

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


def spd_inverse_sym(M: torch.Tensor) -> torch.Tensor:
    """``spd_inverse`` for a matrix known to be symmetric: the same Schur
    recursion, split at (n + 1) // 2, with closed forms at n <= 3 that read
    the upper triangle only, and one off-diagonal block serving both sides.  This
    is the form the fused KF kernel evaluates (the reference's
    ``wbc_kernel._spd_inv_rec``).  On the Kalman filter's cold-start S
    (28x28, cond ~5e5) its float32 residual |S^-1 S - I| measures 0.03
    against 0.5-0.8 for ``spd_inverse``'s two-triangle closed forms."""
    n = M.shape[-1]
    if n == 1:
        return 1.0 / M
    if n == 2:
        a, b, d = M[..., 0, 0], M[..., 0, 1], M[..., 1, 1]
        inv_det = 1.0 / (a * d - b * b)
        return torch.stack([torch.stack([d, -b], -1),
                            torch.stack([-b, a], -1)], -2) * inv_det[..., None, None]
    if n == 3:
        a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
        d, e, f = M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]
        co00, co01, co02 = d * f - e * e, c * e - b * f, b * e - c * d
        co11, co12, co22 = a * f - c * c, b * c - a * e, a * d - b * b
        inv_det = 1.0 / (a * co00 + b * co01 + c * co02)
        return torch.stack([torch.stack([co00, co01, co02], -1),
                            torch.stack([co01, co11, co12], -1),
                            torch.stack([co02, co12, co22], -1)], -2) * inv_det[..., None, None]
    k = (n + 1) // 2
    A, B, D = M[..., :k, :k], M[..., :k, k:], M[..., k:, k:]
    Ai = spd_inverse_sym(A)
    AiB = Ai @ B
    Si = spd_inverse_sym(D - B.transpose(-1, -2) @ AiB)
    TR = -(AiB @ Si)
    TL = Ai - TR @ AiB.transpose(-1, -2)
    return torch.cat([torch.cat([TL, TR], -1), torch.cat([TR.transpose(-1, -2), Si], -1)], -2)


def spd_solve(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve via spd_inverse; rhs (..., n) or (..., n, k)."""
    Mi = spd_inverse(M)
    if rhs.ndim == M.ndim - 1:
        return (Mi @ rhs[..., None])[..., 0]
    return Mi @ rhs


def add_block_diag(K: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """K + blockdiag(G): K (..., k*b, k*b), G (..., k, b, b)."""
    batch = K.shape[:-2]
    k, b = G.shape[-3], G.shape[-1]
    Kb = K.reshape(batch + (k, b, k, b)).clone()
    idx = torch.arange(k, device=K.device)
    Kb[..., idx, :, idx, :] += G.movedim(-3, 0)
    return Kb.reshape(batch + (k * b, k * b))
