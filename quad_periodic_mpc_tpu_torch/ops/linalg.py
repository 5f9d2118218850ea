"""Small dense linear algebra (counterpart of
``quad_periodic_mpc_tpu/ops/linalg.py``).  Ported: ``spd_inverse`` (the
discrete disturbance residual, the WBC and the model evaluation's plain
version), ``spd_inverse_sym`` (the Kalman filter's S), ``spd_solve``,
``add_block_diag``, the Cholesky helpers
(``cholesky_factor``, ``cho_solve``, ``cho_inverse``) and the Newton-Schulz
inverses (``ns_inverse``, ``ns_inverse_bucket``, ``ns_posspec_inverse``), and the Riccati solvers
of the VBL balance controller (``dare_doubling``, ``care``: batched
``torch.linalg`` solves and inverses, as the reference's are XLA's).

The reference's ``precision=`` arguments choose how many bf16 passes a
float32 product takes on a TPU's matrix unit.  Here every product is a full
float32 (or float64) product, TF32 off; the Newton-Schulz functions accept
the same ``precision`` values and ignore them.  The reference's lane-major
helpers (``lane_mm``, ``lane_t``, ``lane_ns_inverse``) are TPU layout: in
batch-leading layout they are ``@``, ``transpose(-1, -2)`` and
``ns_posspec_inverse``."""

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


def cholesky_factor(K: torch.Tensor) -> torch.Tensor:
    """chol(K); an instance whose K is not positive definite gets a factor
    of NaNs, as the reference's (XLA's) Cholesky gives, and raises nothing:
    the PDIP's late-path NaN freeze then keeps its iterate.  Nothing reads
    the status back to the host, so on a card the call does not
    synchronise."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info != 0)[..., None, None], torch.full_like(L, float("nan")), L)


def cho_solve(chol: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve K x = rhs given chol(K); rhs (..., n) or (..., n, r)."""
    if rhs.ndim == chol.ndim - 1:
        return torch.cholesky_solve(rhs[..., None], chol)[..., 0]
    return torch.cholesky_solve(rhs, chol)


def cho_inverse(chol: torch.Tensor) -> torch.Tensor:
    """Explicit K^{-1} from chol(K) (for repeated solves as products)."""
    eye = torch.eye(chol.shape[-1], dtype=chol.dtype, device=chol.device)
    return cho_solve(chol, eye.expand(chol.shape))


def _inf_norm(M: torch.Tensor) -> torch.Tensor:
    return M.abs().sum(-1).amax(-1)


def _ns_rounds(K: torch.Tensor, X: torch.Tensor, rounds: int) -> torch.Tensor:
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    for _ in range(rounds):
        X = X @ (2.0 * eye - K @ X)
    return X


def ns_posspec_inverse(M: torch.Tensor, iters: int) -> torch.Tensor:
    """Newton-Schulz inverse of a block family (..., n, n) with real
    spectrum bounded below (SPD, or I + PSD * PSD products) from the
    scalar seed I / ||M||_inf: every iterate is a polynomial in M, so each
    eigenvalue's residual squares per round.  The reference's
    ``lane_ns_inverse`` in batch-leading layout; exact f32 (or f64)
    products."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return _ns_rounds(M, eye / _inf_norm(M)[..., None, None], iters)


def ns_inverse(K: torch.Tensor, iters: int = 30, X0: torch.Tensor | None = None,
               warm_iters: int = 3, precision=None, polish: int = 0) -> torch.Tensor:
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
    return _ns_rounds(K, X, rounds + polish)



def ns_inverse_bucket(K: torch.Tensor, X0: torch.Tensor, warm_iters: int = 1,
                      cold_iters: int = 12, bucket_frac: int = 4, polish: int = 0,
                      precision=None) -> torch.Tensor:
    """Newton-Schulz inverse with top-k cold-restart escalation; K, X0
    (B, n, n) flat-batched.

    One warm round for everyone (the seed product X0 K doubles as round 1),
    then the k = B / bucket_frac instances with the worst seed residuals
    ||I - X0 K||_inf continue for ``cold_iters`` more rounds and are
    scattered back.  A non-contractive warm seed (residual >= 0.9) is not
    restarted cold but rescaled by 1.8 / (1 + r), which makes it spectrally
    contractive; a degenerate seed (trace(X0 K) <= 0.1 n: the all-zeros first
    step) restarts from I / ||K||_inf.  A bucket instance whose residual
    after the extra rounds is not <= 0.9 (an indefinite carried seed) is
    rescued from the cold seed.  When more than k seeds are non-contractive
    (the all-cold first step) the whole batch continues instead.

    The reference takes both decisions (more than k bad seeds; any failed
    bucket instance) on the device under ``lax.cond``; here each is a host
    decision, one device-to-host read each per call.  ``torch.topk`` may
    order equal residuals differently from ``lax.top_k``: that changes which
    of two tied instances gets the extra rounds, not the fixed point."""
    B, n = K.shape[0], K.shape[-1]
    k = max(B // bucket_frac, 1)
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    norminf = _inf_norm(K)[..., None, None]
    X_cold = eye.expand(K.shape) / norminf

    # seed gate (one product, reused as warm round 1)
    M = X0 @ K
    r = _inf_norm(eye - M)
    contractive = r < 0.9
    usable = (M.diagonal(dim1=-2, dim2=-1).sum(-1) > 0.1 * n)[..., None, None]
    alpha = (1.8 / (1.0 + r))[..., None, None]
    c = contractive[..., None, None]
    X = torch.where(c, X0, torch.where(usable, alpha * X0, X_cold))
    M = torch.where(c, M, torch.where(usable, alpha * M, K / norminf))
    X = (2.0 * eye - M) @ X
    X = _ns_rounds(K, X, warm_iters - 1)

    if int((~contractive).sum()) <= k:
        idx = torch.topk(r, k).indices
        Ksub = K[idx]
        Xsub = _ns_rounds(Ksub, X[idx], cold_iters)     # continue from the scaled seed
        # ~(x <= t) rather than x > t, so that NaN counts as failed
        failed = ~(_inf_norm(eye - Xsub @ Ksub) <= 0.9)
        if bool(failed.any()):
            f = failed[..., None, None]
            Xr = _ns_rounds(Ksub, torch.where(f, X_cold[idx], Xsub), cold_iters)
            Xsub = torch.where(f, Xr, Xsub)
        X = X.index_copy(0, idx, Xsub)
    else:
        # all-cold branch (first step): the cold-seeded majority reaches
        # cold_iters rounds in total
        X = _ns_rounds(K, X, max(cold_iters - warm_iters, 0))
    return _ns_rounds(K, X, polish)


def dare_doubling(Ad: torch.Tensor, Bd: torch.Tensor, Qd: torch.Tensor, Rd: torch.Tensor,
                  iters: int = 30) -> torch.Tensor:
    """Discrete algebraic Riccati solution via the structure-preserving
    doubling algorithm (quadratic convergence, batched products + solves):

        A_{k+1} = A_k (I + G_k H_k)^{-1} A_k
        G_{k+1} = G_k + A_k (I + G_k H_k)^{-1} G_k A_k^T
        H_{k+1} = H_k + A_k^T H_k (I + G_k H_k)^{-1} A_k
        P = lim H_k
    """
    n = Ad.shape[-1]
    eye = torch.eye(n, dtype=Ad.dtype, device=Ad.device)
    A, G, H = Ad, Bd @ torch.linalg.solve(Rd, Bd.transpose(-1, -2)), Qd
    for _ in range(iters):
        M = torch.linalg.inv(eye + G @ H)
        MA = M @ A
        A, G, H = (A @ MA, G + A @ M @ G @ A.transpose(-1, -2),
                   H + A.transpose(-1, -2) @ H @ MA)
    return (H + H.transpose(-1, -2)) / 2.0


def care(A: torch.Tensor, B: torch.Tensor, Q: torch.Tensor, R: torch.Tensor,
         dt: float = 1e-3, iters: int = 30) -> torch.Tensor:
    """Continuous algebraic Riccati equation, batched: an Euler
    discretisation (Ad = I + dt A, Bd = dt B, Qd = dt Q, Rd = dt R), then
    DARE doubling (the reference's replacement for the Hamiltonian
    eigendecomposition of BalanceControllerVBL.cpp:414-455; O(dt) bias)."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return dare_doubling(eye + dt * A, dt * B, dt * Q, dt * R, iters) / 1.0
