"""The port's fused stagewise solve (quad_periodic_mpc_tpu_torch/ops/cuda/
stagewise_kernel.py) against the JAX package's Pallas kernel.

The JAX kernel runs in interpret mode on the CPU, as the JAX package's own
tests run it; the port runs its plain PyTorch version, which is what the
wrapper takes for CPU tensors.  The CUDA kernel itself is held to the
plain version on the card by tests/test_torch_kernels_gpu.py and
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

import jax.numpy as jnp

from quad_periodic_mpc_tpu.config import MPCConfig
from quad_periodic_mpc_tpu.ops import gait as gait_ops
from quad_periodic_mpc_tpu.ops import problem, qp_stagewise
from quad_periodic_mpc_tpu.ops.pallas import stagewise_kernel as SK
from quad_periodic_mpc_tpu.ops.rotations import quat_to_rotmat, rpy_to_quat
from quad_periodic_mpc_tpu_torch.ops import problem as t_problem
from quad_periodic_mpc_tpu_torch.ops import qp_stagewise as t_qp
from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel as TK

RHO = 3e-4
F32 = jnp.float32


def _case(seed=11, B=3, h=10):
    """Well-posed inputs made with numpy from a seed (the recipe of
    tests/test_stagewise.py::test_fused_srb_build_matches_xla_build).
    Returns (JAX RobotObs, x_ref, table, f_est, x_drag, cfg)."""
    rng = np.random.default_rng(seed)
    cfg = MPCConfig(horizon=h)
    rpy = rng.uniform(-0.15, 0.15, (B, 3))
    quat = np.asarray(rpy_to_quat(jnp.asarray(rpy)))
    hips = np.array([[0.18, -0.13, -0.27], [0.18, 0.13, -0.27],
                     [-0.18, -0.13, -0.27], [-0.18, 0.13, -0.27]])
    obs = problem.RobotObs(
        p=jnp.asarray(np.tile([0.0, 0.0, 0.27], (B, 1)), F32),
        v=jnp.asarray(rng.uniform(-0.3, 0.3, (B, 3)), F32),
        quat=jnp.asarray(quat, F32),
        omega=jnp.asarray(rng.uniform(-0.2, 0.2, (B, 3)), F32),
        r_feet=jnp.asarray(hips + rng.uniform(-0.03, 0.03, (B, 4, 3)), F32),
    )
    xref = np.zeros((B, h, 13), np.float32)
    xref[..., 5] = 0.27
    g = gait_ops.preset("trotting")
    table = jnp.broadcast_to(
        gait_ops.mpc_table(g, jnp.asarray(1, jnp.int32), h), (B, h, 4))
    f_est = jnp.asarray(rng.uniform(-3, 3, (B, 6)), F32)
    x_drag = jnp.asarray(rng.uniform(-0.5, 0.5, (B,)), F32)
    return obs, jnp.asarray(xref), table, f_est, x_drag, cfg


def _solver_args(case):
    """The kernel's positional arguments (JAX arrays) and keywords."""
    obs, xref, table, f_est, x_drag, cfg = case
    sw, _, _ = problem.build_stagewise(
        obs, xref, table, cfg, f_est=f_est, x_drag=x_drag)
    B, h = xref.shape[:2]
    R_eff = jnp.diag(sw.R.astype(F32)) + RHO * jnp.kron(
        jnp.eye(4, dtype=F32), jnp.swapaxes(sw.F, -1, -2) @ sw.F)
    zeros = lambda r: jnp.zeros((B, h, r), F32)
    args = (quat_to_rotmat(obs.quat), obs.r_feet, x_drag, f_est,
            sw.x0.astype(F32), sw.x_ref.astype(F32), sw.Q.astype(F32),
            R_eff.astype(F32), sw.F.astype(F32), sw.l.astype(F32),
            sw.u.astype(F32), zeros(12), zeros(20), zeros(20))
    kw = dict(rho=RHO, ns_it=qp_stagewise.ns_combine_iters(h),
              dt=cfg.dt_mpc, mass=cfg.mass,
              i_inv_diag=tuple(1.0 / np.asarray(cfg.inertia_body)))
    return args, kw


def _torch(args, device="cpu"):
    return [torch.from_numpy(np.array(a, np.float32)).to(device) for a in args]


def _port_problem(case):
    obs, xref, table, f_est, x_drag, cfg = case
    t = lambda a: torch.from_numpy(np.array(a))
    tobs = t_problem.RobotObs(*(t(v) for v in obs))
    sw, _ = t_problem.build_stagewise(
        tobs, t(xref), t(table), cfg_port(cfg), f_est=t(f_est), x_drag=t(x_drag))
    return sw


def cfg_port(cfg):
    from quad_periodic_mpc_tpu_torch.config import MPCConfig as TMPCConfig
    return TMPCConfig(horizon=cfg.horizon)


def test_srb_build_matches_jax_kernel_build():
    """The in-kernel SRB build: the port's srb_assemble against the JAX
    kernel's own build (srb_build_dump).  atol 1e-6: both assemble the
    same entries in exact f32; only the 3x3 products inside may round
    differently."""
    args, kw = _solver_args(_case(seed=3, B=5))
    Ad, Bd, c = SK.srb_build_dump(
        *args[:4], dt=kw["dt"], mass=kw["mass"], i_inv_diag=kw["i_inv_diag"],
        interpret=True)
    Ad_t, Bd_t, c_t = TK.srb_assemble(
        *_torch(args[:4]), dt=kw["dt"], mass=kw["mass"],
        i_inv_diag=kw["i_inv_diag"])
    np.testing.assert_allclose(Ad_t.numpy(), np.asarray(Ad), atol=1e-6)
    np.testing.assert_allclose(Bd_t.numpy(), np.asarray(Bd), atol=1e-6)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c), atol=1e-6)


def test_plain_solve_matches_jax_interpret_kernel():
    """80 cold ADMM iterations, h = 10, B = 3.  U to atol 2e-3: the gate
    tests/test_stagewise.py holds the JAX kernel to against the XLA path
    (it also covers the per-instance vs per-chunk NS rescue, which differs
    only inside the 2e-3 residual gate).  The KKT gates (primal 6e-3,
    dual 1e-3) are the bench's, evaluated on the port's own independent
    problem build."""
    case = _case()
    args, kw = _solver_args(case)
    U_j, z_j, y_j = SK.fused_stagewise_solve_srb(
        *args, iters=80, interpret=True, **kw)
    U_t, z_t, y_t = TK.fused_stagewise_solve_srb(*_torch(args), iters=80, **kw)
    np.testing.assert_allclose(U_t.numpy(), np.asarray(U_j), atol=2e-3)
    # z lives on the same force scale (F u, ~100 N); y is rho-scaled
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=2e-3)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-6)

    sw = _port_problem(case)
    res = t_qp.kkt_residuals(sw, U_t, z_t, y_t)
    assert float(res["primal"].max()) < 6e-3
    assert float(res["dual"].max()) < 1e-3


def test_port_problem_build_matches_jax():
    """problem.build_stagewise (the audit build): same problem as the JAX
    build to f32 roundoff (atol 1e-6 on O(1) entries; the bounds exactly)."""
    case = _case(seed=4, B=4)
    obs, xref, table, f_est, x_drag, cfg = case
    sw_j, _, _ = problem.build_stagewise(
        obs, xref, table, cfg, f_est=f_est, x_drag=x_drag)
    sw_t = _port_problem(case)
    for name in ("Ad", "Bd", "c", "x0", "x_ref", "Q", "R", "F"):
        np.testing.assert_allclose(
            getattr(sw_t, name).numpy(), np.asarray(getattr(sw_j, name)),
            atol=1e-6, err_msg=name)
    for name in ("l", "u"):
        np.testing.assert_array_equal(
            getattr(sw_t, name).numpy(), np.asarray(getattr(sw_j, name)))


@pytest.mark.parametrize("seed_name", ["zeros", "huge", "nan"])
def test_stage_quu_inverse_rescue_recovers_bad_seed(seed_name):
    """A garbage warm seed fails the 2e-3 residual gate and is rescued
    from the cold seed, per instance; the result matches the JAX helper
    (every lane is bad here, so the per-chunk and per-instance rules run
    the same rounds: rel 1e-4 allows reordered f32 sums)."""
    rng = np.random.default_rng(5)
    C, NU = 8, 12
    Ms = []
    for _ in range(C):
        q, _ = np.linalg.qr(rng.normal(size=(NU, NU)))
        Ms.append(q @ np.diag(np.logspace(0, 3, NU)) @ q.T)
    Quu = np.stack(Ms).astype(np.float32)                       # (C, 12, 12)
    seed = {"zeros": np.zeros((C, NU, NU)), "huge": 1e8 * np.ones((C, NU, NU)),
            "nan": np.full((C, NU, NU), np.nan)}[seed_name].astype(np.float32)

    X, n_bad = TK.stage_quu_inverse(
        torch.from_numpy(Quu), torch.from_numpy(seed), False, 30, 6)
    X = X.numpy()
    assert n_bad == C
    resid = np.abs(Quu @ X - np.eye(NU)).max()
    assert np.isfinite(resid) and resid < 5e-3
    true_inv = np.linalg.inv(Quu.astype(np.float64))
    assert np.abs(X - true_inv).max() / np.abs(true_inv).max() < 1e-2

    X_j = SK._stage_quu_inverse(
        jnp.asarray(np.moveaxis(Quu, 0, -1)), jnp.asarray(np.moveaxis(seed, 0, -1)),
        first=jnp.asarray(False), eyeu=jnp.eye(NU, dtype=F32)[:, :, None],
        C=C, ns_it=30, ns_warm=6)
    X_j = np.moveaxis(np.asarray(X_j), -1, 0)
    assert np.abs(X - X_j).max() / np.abs(X_j).max() < 1e-4


def test_wrapper_routes_cpu_tensors_to_plain_version():
    """CPU tensors take the plain version (bit-identical) and launch
    nothing."""
    args, kw = _solver_args(_case(seed=7, B=2))
    targs = _torch(args)
    before = dict(TK.LAUNCHES)
    out = TK.fused_stagewise_solve_srb(*targs, iters=5, **kw)
    ref = TK.fused_stagewise_solve_srb_reference(*targs, iters=5, **kw)
    assert TK.LAUNCHES == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fault", ["float64", "shape", "noncontiguous"])
def test_wrapper_rejects_what_the_kernel_does_not_take(fault):
    args, kw = _solver_args(_case(seed=7, B=2))
    targs = _torch(args)
    if fault == "float64":
        targs[4] = targs[4].double()
        err = TypeError
    elif fault == "shape":
        targs[6] = targs[6][:12]
        err = ValueError
    else:
        targs[0] = targs[0].transpose(1, 2)
        err = ValueError
    with pytest.raises(err):
        TK.fused_stagewise_solve_srb(*targs, iters=5, **kw)
