"""Small dense linear algebra (counterpart of
``quad_periodic_mpc_tpu/ops/linalg.py``).  Ported: ``spd_inverse`` (the
discrete disturbance residual, the WBC and the model evaluation's plain
version), ``spd_solve``, ``add_block_diag``, the Cholesky pair the PDIP
uses with ``kkt="cholesky"``, and the Newton-Schulz inverses of the
stagewise scan path (``ns_inverse``, ``ns_posspec_inverse``)."""

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


def cholesky_factor(K: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cholesky(K)


def cho_solve(chol: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve K x = rhs given chol(K); rhs (..., n) or (..., n, r)."""
    if rhs.ndim == chol.ndim - 1:
        return torch.cholesky_solve(rhs[..., None], chol)[..., 0]
    return torch.cholesky_solve(rhs, chol)


def _inf_norm(M: torch.Tensor) -> torch.Tensor:
    return M.abs().sum(-1).amax(-1)


def ns_posspec_inverse(M: torch.Tensor, iters: int) -> torch.Tensor:
    """Newton-Schulz inverse of a block family (..., n, n) with real
    spectrum bounded below (SPD, or I + PSD * PSD products) from the
    scalar seed I / ||M||_inf: every iterate is a polynomial in M, so each
    eigenvalue's residual squares per round.  The reference's
    ``lane_ns_inverse`` in batch-leading layout; exact f32 (or f64)
    products."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    X = eye / _inf_norm(M)[..., None, None]
    for _ in range(iters):
        X = X @ (2.0 * eye - M @ X)
    return X


def ns_inverse(K: torch.Tensor, iters: int = 30, X0: torch.Tensor | None = None,
               warm_iters: int = 3, polish: int = 0) -> torch.Tensor:
    """Newton-Schulz iteration X <- X (2I - K X) for K^{-1} of a symmetric
    PD batch, from the seed I / ||K||_inf or a warm X0.

    A warm X0 is guarded per instance: seeds with ||I - X0 K||_inf >= 0.9
    (the all-zeros first step included) fall back to the cold seed.  The
    trip count adapts over the whole batch: ``warm_iters`` rounds if every
    seed is contractive, else the full ``iters``.  ``polish`` adds rounds
    (the reference runs them at a higher matmul precision; here every
    product is full precision already)."""
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    norminf = _inf_norm(K)[..., None, None]
    X_cold = eye.expand(K.shape) / norminf
    if X0 is None:
        X, rounds = X_cold, iters
    else:
        # the seed-residual product doubles as the first round:
        # X (2I - K X) == (2I - X K) X
        M = X0 @ K
        contractive = _inf_norm(eye - M) < 0.9
        c = contractive[..., None, None]
        X = (2.0 * eye - torch.where(c, M, K / norminf)) @ torch.where(c, X0, X_cold)
        rounds = max((warm_iters if bool(contractive.all()) else iters) - 1, 0)
    for _ in range(rounds + polish):
        X = X @ (2.0 * eye - K @ X)
    return X
