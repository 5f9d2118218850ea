"""Fused ADMM iterations with K^{-1} held on chip: CUDA kernel, wrapper and
its plain PyTorch version.

Replaces ``quad_periodic_mpc_tpu/ops/pallas/admm_kernel.py::
fused_admm_iterations`` (``_kernel``).  The kernel source is
``quad_periodic_mpc_tpu_torch/csrc/admm.cu``; its header note says what
bounds it on an H100 (K^{-1} read once, then each iteration's chain of n
dependent FMAs a variable), how it is laid out (one thread block per
instance, a thread per variable and a warp per ten foot-steps, the first
120 columns of K^{-1} in each thread's registers and the rest in dynamic
shared memory, one barrier an iteration) and up to which horizon K^{-1} is
resident (f32 h <= 22, bf16 h <= 30).  Past that it is read from device
memory in every iteration, up to ``MAX_VARIABLES`` (n = 1920, h = 160).

- ``fused_admm_iterations``: the wrapper.  CUDA tensors launch the kernel
  (or raise); CPU tensors take the plain version.
- ``fused_admm_iterations_reference``: the plain version, the kernel's loop
  on ``constraints.apply`` / ``apply_T``; with ``kinv_bf16`` K^{-1} is
  rounded to bfloat16 and widened back before the loop.
- ``kinv_resident`` / ``kinv_shared_bytes``: the kernel's own rule for
  holding K^{-1} on chip, and the shared memory a block takes to do so.
- ``LAUNCHES``: kernel launches since the count was last reset.
"""

from __future__ import annotations

import ctypes

import torch

from quad_periodic_mpc_tpu_torch.ops import constraints as con
from quad_periodic_mpc_tpu_torch.ops.cuda import build

SOURCE = "admm.cu"

LAUNCHES = 0
# the most variables a block takes: 32 warps of 30 variables, two a thread
MAX_VARIABLES = 1920


class _Params(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int) for n in ("B", "n", "m", "iters", "kinv_bf16")]
                + [("sigma", ctypes.c_float), ("over_relax", ctypes.c_float)])


def fused_admm_iterations_reference(K_inv, q, l, u, rho, F, x0, z0, y0, iters: int = 100,
                                    sigma: float = 1e-6, over_relax: float = 1.6,
                                    kinv_bf16: bool = False):
    """Plain version of the fused ADMM loop.  Inputs as
    ``fused_admm_iterations``'s; returns (x, z, y)."""
    if kinv_bf16:
        K_inv = K_inv.to(torch.bfloat16).to(K_inv.dtype)
    Kt = K_inv.transpose(-1, -2)     # the kernel reads the symmetric K^{-1} by columns
    a = over_relax
    rho_inv = 1.0 / rho
    x, z, y = x0, z0, y0
    for _ in range(iters):
        rhs = sigma * x - q + con.apply_T(F, rho * z - y)
        x_t = (Kt @ rhs[..., None])[..., 0]
        x = a * x_t + (1.0 - a) * x
        z_r = a * con.apply(F, x_t) + (1.0 - a) * z
        z_new = torch.clamp(z_r + rho_inv * y, l, u)
        y = y + rho * (z_r - z_new)
        z = z_new
    return x, z, y


def fused_admm_iterations(K_inv, q, l, u, rho, F, x0, z0, y0, iters: int = 100,
                          sigma: float = 1e-6, over_relax: float = 1.6,
                          kinv_bf16: bool = False):
    """Run ``iters`` OSQP iterations with K^{-1} read once.  K_inv (B, n, n)
    symmetric; q, x0 (B, n); l, u, rho, z0, y0 (B, m); F (5, 3) the pyramid
    block, n = 3k, m = 5k for k foot-steps, n <= MAX_VARIABLES on the card.
    All float32 and contiguous, any B >= 1.  kinv_bf16 stores K^{-1} on chip
    as bfloat16 (round to nearest even) and accumulates in float32.  Returns
    (x, z, y)."""
    device = q.device
    if device.type == "cpu":
        return fused_admm_iterations_reference(K_inv, q, l, u, rho, F, x0, z0, y0, iters,
                                               sigma, over_relax, kinv_bf16)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return _fused_admm_iterations_cuda(K_inv, q, l, u, rho, F, x0, z0, y0, iters, sigma,
                                       over_relax, kinv_bf16)


def _fused_admm_iterations_cuda(K_inv, q, l, u, rho, F, x0, z0, y0, iters: int = 100,
                                sigma: float = 1e-6, over_relax: float = 1.6,
                                kinv_bf16: bool = False):
    """Check the inputs, allocate the outputs, launch the kernel."""
    global LAUNCHES
    B, n = q.shape
    m = l.shape[-1]
    device = q.device
    if B < 1:
        raise ValueError("need a batch of at least one instance")
    if n % 3 or m != 5 * (n // 3):
        raise ValueError(f"expected n = 3k and m = 5k, got n={n}, m={m}")
    if n > MAX_VARIABLES:
        raise ValueError(f"the kernel takes n <= {MAX_VARIABLES} variables "
                         f"(h <= {MAX_VARIABLES // 12}), got n={n}")
    named = {"K_inv": (K_inv, (B, n, n)), "q": (q, (B, n)), "l": (l, (B, m)),
             "u": (u, (B, m)), "rho": (rho, (B, m)), "F": (F, (5, 3)), "x0": (x0, (B, n)),
             "z0": (z0, (B, m)), "y0": (y0, (B, m))}
    for name, (t, shape) in named.items():
        build.check(name, t, shape, device)
    params = _Params(B=B, n=n, m=m, iters=int(iters), kinv_bf16=int(bool(kinv_bf16)),
                     sigma=sigma, over_relax=over_relax)
    with torch.cuda.device(device):
        outs = [torch.empty(B, w, dtype=torch.float32, device=device) for w in (n, m, m)]
        build.launch(SOURCE, "admm_launch", [t for t, _ in named.values()] + outs, params,
                     device)
    LAUNCHES += 1
    return tuple(outs)


def kinv_resident(n: int, m: int, kinv_bf16: bool = False) -> bool:
    """Whether the kernel holds K^{-1} of an (n, m) problem on chip, in
    registers and shared memory (else it reads it from device memory in
    every iteration)."""
    fn = build.load(SOURCE).admm_resident
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    return bool(fn(n, m, int(bool(kinv_bf16))))


def kinv_shared_bytes(n: int, m: int, kinv_bf16: bool = False) -> int:
    """Bytes of dynamic shared memory a block takes with K^{-1} of an (n, m)
    problem held on chip; ``kinv_resident`` holds it there where these fit
    a block."""
    fn = build.load(SOURCE).admm_shared_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_long
    return int(fn(n, m, int(bool(kinv_bf16))))
