"""Seeded stagewise problems shared by tests/test_torch_stagewise_solve.py
and tests/test_torch_qp_stagewise.py: made with numpy from a seed, built by
the JAX package, carried to the port with ``convert.stagewise_problem``."""

import numpy as np
import torch

import jax.numpy as jnp

from quad_periodic_mpc_tpu import config as jc
from quad_periodic_mpc_tpu.ops import gait as j_gait
from quad_periodic_mpc_tpu.ops import problem as j_problem
from quad_periodic_mpc_tpu.ops.rotations import rpy_to_quat
from quad_periodic_mpc_tpu_torch import convert

F32 = jnp.float32


def jax_problem(seed, B, h, per_step_c=False, dtype=np.float32):
    """A batch of trot problems from the JAX build, on seeded numpy
    observations; per_step_c: a wrench that varies over the horizon.
    Returns (StagewiseProblem of JAX arrays, the observation pieces)."""
    rng = np.random.default_rng(seed)
    hips = np.array([[0.18, -0.13, -0.27], [0.18, 0.13, -0.27],
                     [-0.18, -0.13, -0.27], [-0.18, 0.13, -0.27]])
    J = lambda a: jnp.asarray(np.asarray(a, dtype))
    quat = rpy_to_quat(J(rng.uniform(-0.15, 0.15, (B, 3))))
    obs = j_problem.RobotObs(
        p=J(np.tile([0.0, 0.0, 0.27], (B, 1))), v=J(rng.uniform(-0.3, 0.3, (B, 3))),
        quat=quat, omega=J(rng.uniform(-0.2, 0.2, (B, 3))),
        r_feet=J(hips + rng.uniform(-0.03, 0.03, (B, 4, 3))))
    xref = np.zeros((B, h, 13), dtype)
    xref[..., 5] = 0.27
    seg = jnp.asarray(rng.integers(0, 16, B), jnp.int32)
    table = j_gait.mpc_table(j_gait.preset("trotting"), seg, h)
    f_est, x_drag = J(rng.uniform(-3, 3, (B, 6))), J(rng.uniform(-0.5, 0.5, B))
    f_steps = None
    if per_step_c:
        k = np.arange(h)[None, :, None]
        f_steps = J(rng.uniform(-3, 3, (B, 1, 6)) + rng.uniform(-2, 2, (B, 1, 6)) * np.sin(
            0.054 * k + rng.uniform(0, 6, (B, 1, 6))))
    sw, _, _ = j_problem.build_stagewise(
        obs, J(xref), table, jc.MPCConfig(horizon=h), f_est=f_est, x_drag=x_drag,
        f_est_steps=f_steps)
    return sw, (obs, J(xref), table, f_est, x_drag, f_steps)


def port(sw):
    return convert.stagewise_problem(sw, "cpu")


def kernel_args(sw, rho):
    """The 13 positional arguments of the solve kernels, as JAX arrays."""
    B, h = sw.x_ref.shape[:2]
    R_eff = jnp.diag(sw.R) + rho * jnp.kron(jnp.eye(4, dtype=F32), sw.F.T @ sw.F)
    z = lambda r: jnp.zeros((B, h, r), F32)
    return (sw.Ad, sw.Bd, sw.c, sw.x0, sw.x_ref, sw.Q, R_eff.astype(F32), sw.F,
            sw.l, sw.u, z(12), z(20), z(20))


def to_torch(args):
    return [torch.from_numpy(np.array(a)).contiguous() for a in args]


def close(tt, jj, atol, rtol=0.0, name=""):
    np.testing.assert_allclose(np.asarray(tt), np.asarray(jj), atol=atol, rtol=rtol,
                               err_msg=name)
