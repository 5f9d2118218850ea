"""The plain versions of the port's caller-built stagewise kernels
(``fused_stagewise_solve``, ``fused_stagewise_solve_stream``,
``srb_build_dump``; ``ops/cuda/stagewise_kernel.py``) against the JAX
package's Pallas kernels.

Inputs are made with numpy from a seed and handed to both packages
(tests/_torch_stagewise_cases.py).  The JAX kernels run in interpret mode
on the CPU, as the JAX package's own tests run them, and only at h <= 16;
the port runs the kernels' plain versions, which is what the wrappers take
for CPU tensors.  The CUDA kernels themselves are held to the plain
versions by tests/test_torch_cuda_emulated.py here and on the card by
tests/test_torch_kernels_gpu.py and chip_smoke.py.  ``qp_stagewise.solve``
and what surrounds it are in tests/test_torch_qp_stagewise.py.
"""

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

import jax.numpy as jnp
from _torch_stagewise_cases import F32, close, jax_problem, kernel_args, port, to_torch

from quad_periodic_mpc_tpu.ops.pallas import stagewise_kernel as SK
from quad_periodic_mpc_tpu.ops.rotations import quat_to_rotmat
from quad_periodic_mpc_tpu_torch.ops import qp_stagewise as t_qp
from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel as TK


@pytest.mark.parametrize("per_step_c", [False, True])
def test_plain_solve_matches_jax_interpret_kernel(per_step_c):
    """fused_stagewise_solve, B = 3, h = 10, 80 cold ADMM iterations at
    rho = 3e-4, shared and per-step c.  U and z (forces, ~100 N) to 2e-3,
    the gate the JAX kernel is held to against its XLA path; y (rho-scaled)
    to 1e-6.  No instance is rescued (asserted), so the per-instance and
    per-chunk rescue rules run the same rounds."""
    sw, _ = jax_problem(11, B=3, h=10, per_step_c=per_step_c)
    args = kernel_args(sw, 3e-4)
    kw = dict(iters=80, rho=3e-4, ns_it=16)
    U_j, z_j, y_j = SK.fused_stagewise_solve(*args, interpret=True, **kw)
    stats = {}
    before = dict(TK.LAUNCHES)
    U_t, z_t, y_t = TK.fused_stagewise_solve(*to_torch(args), **kw)
    assert TK.LAUNCHES == before                       # CPU tensors launch nothing
    # rescues happen in the Riccati pass, whatever the iteration count
    TK.fused_stagewise_solve_reference(*to_torch(args), stats=stats, **dict(kw, iters=1))
    assert stats["rescued"] == 0
    close(U_t, U_j, atol=2e-3)
    close(z_t, z_j, atol=2e-3)
    close(y_t, y_j, atol=1e-6)
    res = t_qp.kkt_residuals(port(sw), U_t, z_t, y_t)
    assert float(res["primal"].max()) < 6e-3 and float(res["dual"].max()) < 1e-3


def test_srb_ad_structured_matches_dense():
    """srb_ad=True and srb_ad=False run the same math on a problem with the
    SRB sparsity (the analog of the reference test of that name, its
    tolerances: U and z 2e-4, y 2e-3 at rho = 0.12), and the dense plain
    version matches the JAX kernel's dense variant at the kernel gate."""
    sw, _ = jax_problem(12, B=3, h=10)
    args = kernel_args(sw, 0.12)
    kw = dict(iters=30, rho=0.12, ns_it=16)
    targs = to_torch(args)
    U_s, z_s, y_s = TK.fused_stagewise_solve(*targs, srb_ad=True, **kw)
    U_d, z_d, y_d = TK.fused_stagewise_solve(*targs, srb_ad=False, **kw)
    close(U_s, U_d, atol=2e-4)
    close(z_s, z_d, atol=2e-4)
    close(y_s, y_d, atol=2e-3)
    U_j, z_j, y_j = SK.fused_stagewise_solve(*args, srb_ad=False, interpret=True, **kw)
    close(U_d, U_j, atol=2e-3)
    close(z_d, z_j, atol=2e-3)
    close(y_d, y_j, atol=2e-3)


def test_dense_ad_differs_where_ad_is_dense():
    """On an Ad without the SRB sparsity the structured products drop real
    terms: srb_ad=False is the one that satisfies the dense problem's KKT
    gates (primal 6e-3, dual 1e-3 after 150 sweeps)."""
    sw, _ = jax_problem(13, B=3, h=10)
    rng = np.random.default_rng(14)
    sw = sw._replace(Ad=sw.Ad + jnp.asarray(rng.uniform(-2e-3, 2e-3, (3, 13, 13)), F32))
    kw = dict(iters=150, rho=3e-4, ns_it=16)
    targs = to_torch(kernel_args(sw, 3e-4))
    dense = TK.fused_stagewise_solve(*targs, srb_ad=False, **kw)
    sparse = TK.fused_stagewise_solve(*targs, srb_ad=True, **kw)
    res = t_qp.kkt_residuals(port(sw), *dense)
    assert float(res["primal"].max()) < 6e-3 and float(res["dual"].max()) < 1e-3
    assert float((dense[0] - sparse[0]).abs().max()) > 1e-2


def test_stream_plain_matches_resident_and_jax_stream():
    """The streamed variant at h = 16, B = 2 (a horizon both run), 30
    iterations at rho = 0.12: against the port's resident plain version and
    against the JAX streaming kernel in interpret mode, U and z 1e-3, y 1e-2
    (test_stream_kernel_matches_resident's tolerances: the packed Quu^{-1}
    is symmetrised, the resident one is not)."""
    sw, _ = jax_problem(9, B=2, h=16, per_step_c=True)
    args = kernel_args(sw, 0.12)
    kw = dict(iters=30, rho=0.12, ns_it=16)
    targs = to_torch(args)
    U_s, z_s, y_s = TK.fused_stagewise_solve_stream(*targs, **kw)
    U_r, z_r, y_r = TK.fused_stagewise_solve(*targs, **kw)
    U_j, z_j, y_j = SK.fused_stagewise_solve_stream(*args, interpret=True, **kw)
    for ref in ((U_r, z_r, y_r), (U_j, z_j, y_j)):
        close(U_s, ref[0], atol=1e-3)
        close(z_s, ref[1], atol=1e-3)
        close(y_s, ref[2], atol=1e-2)


def test_stream_rejects_horizons_off_the_block_grid():
    sw, _ = jax_problem(9, B=3, h=10)
    with pytest.raises(ValueError):
        TK.fused_stagewise_solve_stream(*to_torch(kernel_args(sw, 3e-4)), iters=2, rho=3e-4)


def test_srb_build_dump_matches_jax_dump_and_problem_build():
    """srb_build_dump (on the CPU: srb_assemble) against the JAX dump kernel
    in interpret mode and against build_stagewise's Ad, Bd, c, both the
    port's and JAX's: atol 1e-6 (the same entries in exact f32; only the 3x3
    products inside may round differently)."""
    sw, (obs, _, _, f_est, x_drag, _) = jax_problem(15, B=3, h=10)
    args = (quat_to_rotmat(obs.quat), obs.r_feet, x_drag, f_est)
    dumped_j = SK.srb_build_dump(*args, interpret=True)
    before = dict(TK.LAUNCHES)
    dumped_t = TK.srb_build_dump(*to_torch(args))
    assert TK.LAUNCHES == before
    for g, w, b in zip(dumped_t, dumped_j, (sw.Ad, sw.Bd, sw.c)):
        close(g, w, atol=1e-6)
        close(g, b, atol=1e-6)


@pytest.mark.parametrize("fault", ["float64", "c_shape", "noncontiguous"])
def test_solve_wrappers_reject_what_the_kernels_do_not_take(fault):
    sw, _ = jax_problem(9, B=3, h=10)
    targs = to_torch(kernel_args(sw, 3e-4))
    if fault == "float64":
        targs[0], err = targs[0].double(), TypeError
    elif fault == "c_shape":
        targs[2], err = targs[2][:, None, :].expand(3, 5, 13).contiguous(), ValueError
    else:
        targs[1], err = targs[1].transpose(1, 2).contiguous().transpose(1, 2), ValueError
    with pytest.raises(err):
        TK.fused_stagewise_solve(*targs, iters=2, rho=3e-4)
