"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and the CUDA toolkit; elsewhere they skip.
The module imports nothing of JAX, so it also runs where JAX is not
installed (the repository's conftest does import JAX, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from quad_periodic_mpc_tpu_torch.config import ADMMConfig, MPCConfig
from quad_periodic_mpc_tpu_torch.ops import gait, problem, qp_stagewise
from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel as SK
from quad_periodic_mpc_tpu_torch.ops.rotations import quat_to_rotmat, rpy_to_quat


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _inputs(B, h, seed, device):
    """Well-posed fused-solve inputs made with numpy from a seed, built
    through the port's own stagewise problem assembly."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    hips = np.array([[0.18, -0.13, -0.27], [0.18, 0.13, -0.27],
                     [-0.18, -0.13, -0.27], [-0.18, 0.13, -0.27]])
    quat = rpy_to_quat(t(rng.uniform(-0.15, 0.15, (B, 3))))
    obs = problem.RobotObs(
        p=t(np.tile([0.0, 0.0, 0.27], (B, 1))), v=t(rng.uniform(-0.3, 0.3, (B, 3))),
        quat=quat, omega=t(rng.uniform(-0.2, 0.2, (B, 3))),
        r_feet=t(hips + rng.uniform(-0.03, 0.03, (B, 4, 3))))
    xref = torch.zeros(B, h, 13, device=device)
    xref[..., 5] = 0.27
    seg = torch.as_tensor(rng.integers(0, 16, B), dtype=torch.int32, device=device)
    table = gait.mpc_table(gait.preset("trotting", device=device), seg, h)
    f_est, x_drag = t(rng.uniform(-3, 3, (B, 6))), t(rng.uniform(-0.5, 0.5, B))
    sw, x0 = problem.build_stagewise(obs, xref, table, MPCConfig(horizon=h),
                                     f_est=f_est, x_drag=x_drag)
    rho = ADMMConfig().rho
    R_eff = torch.diag(sw.R) + rho * torch.kron(torch.eye(4, device=device), sw.F.T @ sw.F)
    z = lambda r: torch.zeros(B, h, r, device=device)
    args = [quat_to_rotmat(quat), obs.r_feet, x_drag, f_est, x0, sw.x_ref, sw.Q,
            R_eff, sw.F, sw.l, sw.u, z(12), z(20), z(20)]
    kw = dict(iters=30, rho=rho, ns_it=qp_stagewise.ns_combine_iters(h))
    return [a.contiguous() for a in args], kw, sw


@pytest.mark.gpu
@pytest.mark.parametrize("B,h", [(37, 10), (300, 48)])
def test_stagewise_kernel_matches_plain_version(cuda, B, h):
    """U and z to atol 2e-3 (forces ~100 N; FMA contraction and summation
    order differ, amplified through 30 ADMM sweeps); y to 1e-5
    (rho-scaled).  One launch per call."""
    args, kw, _ = _inputs(B, h, seed=B, device=cuda)
    before = SK.LAUNCHES
    got = SK.fused_stagewise_solve_srb(*args, **kw)
    torch.cuda.synchronize()
    assert SK.LAUNCHES == before + 1
    want = SK.fused_stagewise_solve_srb_reference(*args, **kw)
    for g, w, tol in zip(got, want, (2e-3, 2e-3, 1e-5)):
        assert bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) < tol


@pytest.mark.gpu
def test_stagewise_kernel_warm_start_matches_plain_version(cuda):
    """Seeded with a previous answer (the warm-start carry of mpc_step),
    kernel and plain version still agree: same tolerances as above."""
    args, kw, _ = _inputs(256, 10, seed=3, device=cuda)
    torch.manual_seed(0)
    warm = SK.fused_stagewise_solve_srb_reference(*args, **kw)
    warm = [(w + s * torch.randn_like(w)).contiguous()
            for w, s in zip(warm, (0.5, 0.5, 1e-4))]   # N, N, rho-scaled
    got = SK.fused_stagewise_solve_srb(*args[:11], *warm, **kw)
    want = SK.fused_stagewise_solve_srb_reference(*args[:11], *warm, **kw)
    for g, w, tol in zip(got, want, (2e-3, 2e-3, 1e-5)):
        assert float((g - w).abs().max()) < tol
