"""The port's condensed QP path (condensation, build_qp, the Newton-Schulz
inverses, the condensed ADMM solve and its fused kernel's plain version,
equilibration) against the JAX package, on seeded numpy inputs on the CPU.

JAX runs its Pallas ADMM kernel in interpret mode; the port runs the
kernel's plain version.  float64 comparisons hold the same arithmetic to
roundoff; float32 ones state their tolerance at the test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quad_periodic_mpc_tpu import config as jc
from quad_periodic_mpc_tpu.models import srb as j_srb
from quad_periodic_mpc_tpu.ops import condense as j_condense
from quad_periodic_mpc_tpu.ops import equilibrate as j_equil
from quad_periodic_mpc_tpu.ops import gait as j_gait
from quad_periodic_mpc_tpu.ops import linalg as j_linalg
from quad_periodic_mpc_tpu.ops import problem as j_problem
from quad_periodic_mpc_tpu.ops import qp_admm as j_admm
from quad_periodic_mpc_tpu.ops.pallas import admm_kernel as j_kernel
from quad_periodic_mpc_tpu.testing.fixtures import make_mpc_qp
from quad_periodic_mpc_tpu_torch import config as tc
from quad_periodic_mpc_tpu_torch import convert
from quad_periodic_mpc_tpu_torch.models import srb as t_srb
from quad_periodic_mpc_tpu_torch.ops import condense as t_condense
from quad_periodic_mpc_tpu_torch.ops import equilibrate as t_equil
from quad_periodic_mpc_tpu_torch.ops import gait as t_gait
from quad_periodic_mpc_tpu_torch.ops import linalg as t_linalg
from quad_periodic_mpc_tpu_torch.ops import problem as t_problem
from quad_periodic_mpc_tpu_torch.ops import qp_admm as t_admm
from quad_periodic_mpc_tpu_torch.ops.cuda import admm_kernel as t_kernel

T64 = dict(dtype=torch.float64, device="cpu")


def _np(a):
    return np.asarray(a)


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(got.numpy(), _np(want), atol=atol, rtol=0, err_msg=msg)


def _obs(B, h, seed, dtype=np.float64):
    """Random trot observations as numpy: the fields of RobotObs, x_ref,
    gait segment, f_est, x_drag, a per-step wrench."""
    rng = np.random.default_rng(seed)
    from quad_periodic_mpc_tpu.ops.rotations import rpy_to_quat
    hips = np.array([[0.18, -0.13, -0.27], [0.18, 0.13, -0.27],
                     [-0.18, -0.13, -0.27], [-0.18, 0.13, -0.27]])
    c = lambda v: np.asarray(v, dtype)
    obs = dict(p=c(np.tile([0.0, 0.0, 0.27], (B, 1))), v=c(rng.uniform(-0.3, 0.3, (B, 3))),
               quat=c(_np(rpy_to_quat(jnp.asarray(rng.uniform(-0.15, 0.15, (B, 3)))))),
               omega=c(rng.uniform(-0.2, 0.2, (B, 3))),
               r_feet=c(hips + rng.uniform(-0.03, 0.03, (B, 4, 3))))
    xref = np.zeros((B, h, 13), dtype)
    xref[..., 5] = 0.27
    xref[..., 9] = 0.3
    k = np.arange(h)[None, :, None]
    f_steps = c(rng.uniform(-3, 3, (B, 1, 6)) + rng.uniform(-2, 2, (B, 1, 6)) * np.sin(0.054 * k))
    return (obs, xref, rng.integers(0, 16, B).astype(np.int32), c(rng.uniform(-3, 3, (B, 6))),
            c(rng.uniform(-0.5, 0.5, B)), f_steps)


def _predictions(B, h, seed):
    obs, xref, seg, f_est, x_drag, f_steps = _obs(B, h, seed)
    from quad_periodic_mpc_tpu.ops.rotations import quat_to_rotmat
    R = _np(quat_to_rotmat(jnp.asarray(obs["quat"])))
    cfg = jc.MPCConfig(horizon=h)
    ct_j = j_srb.ct_dynamics(jnp.asarray(R), jnp.asarray(obs["r_feet"]), cfg.mass,
                             jnp.asarray(cfg.inertia_body), jnp.asarray(x_drag))
    ct_t = t_srb.ct_dynamics(torch.as_tensor(R), torch.as_tensor(obs["r_feet"]), cfg.mass,
                             cfg.inertia_body, torch.as_tensor(x_drag))
    pred_j = j_condense.build_prediction(*ct_j, cfg.dt_mpc)
    pred_t = t_condense.build_prediction(*ct_t, cfg.dt_mpc)
    x0 = np.random.default_rng(seed + 1).normal(size=(B, 13))
    x0[:, 12] = -9.8
    return pred_j, pred_t, x0, xref, f_est, f_steps, cfg


@pytest.mark.parametrize("h", [10, 16])
def test_condense_matches_jax(h):
    """Every function of ops/condense at B = 3 in float64: 1e-9 on entries
    up to ~1e3 (the cost Hessian), the same contractions."""
    pred_j, pred_t, x0, xref, f_est, f_steps, cfg = _predictions(3, h, seed=h)
    for f in t_condense.Prediction._fields:
        _close(getattr(pred_t, f), getattr(pred_j, f), 1e-12, f)
    tables_j, tables_t = j_condense.coeff_tables(h), t_condense.coeff_tables(h)
    for f in t_condense.CoeffTables._fields:
        np.testing.assert_array_equal(getattr(tables_t, f), getattr(tables_j, f))
    w = np.asarray(cfg.weights)
    tt, jj = torch.as_tensor, jnp.asarray
    _close(t_condense.state_response(pred_t, tt(x0), h),
           j_condense.state_response(pred_j, jj(x0), h), 1e-10)
    _close(t_condense.disturbance_response(pred_t, tt(f_est), h),
           j_condense.disturbance_response(pred_j, jj(f_est), h), 1e-10)
    _close(t_condense.disturbance_response_timevarying(pred_t, tt(f_steps), h),
           j_condense.disturbance_response_timevarying(pred_j, jj(f_steps), h), 1e-10)
    for name in ("materialize_A_qp", "materialize_B_qp", "materialize_Q_qp"):
        _close(getattr(t_condense, name)(pred_t, h), getattr(j_condense, name)(pred_j, h),
               1e-10, name)
    H_t = t_condense.cost_hessian(pred_t, tt(w), cfg.alpha, h)
    _close(H_t, j_condense.cost_hessian(pred_j, jj(w), cfg.alpha, h), 1e-9)
    for steps_t, steps_j in ((None, None), (tt(f_steps), jj(f_steps))):
        _close(t_condense.cost_gradient(pred_t, tt(w), tt(x0), tt(xref), tt(f_est), h, steps_t),
               j_condense.cost_gradient(pred_j, jj(w), jj(x0), jj(xref), jj(f_est), h, steps_j),
               1e-9)
    Hn_t, gn_t = t_condense.cost_naive(pred_t, tt(w), cfg.alpha, tt(x0), tt(xref), tt(f_est), h)
    Hn_j, gn_j = j_condense.cost_naive(pred_j, jj(w), cfg.alpha, jj(x0), jj(xref), jj(f_est), h)
    _close(Hn_t, Hn_j, 1e-9)
    _close(gn_t, gn_j, 1e-9)
    # the structured assembly is the materialized one
    np.testing.assert_allclose(H_t.numpy(), Hn_t.numpy(), atol=1e-9, rtol=0)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("per_step", [False, True])
@pytest.mark.parametrize("h", [10, 16])
def test_build_qp_matches_jax(h, per_step, dtype):
    """problem.build_qp at B = 4 with a released wrench, with and without
    its per-step prediction.  float64: 1e-9.  float32: P (entries up to
    ~1e3) to 2e-3 and q (up to ~1e4) to 2e-2, f32 sums in another order,
    relative 2e-6."""
    npd = np.float64 if dtype == "float64" else np.float32
    obs, xref, seg, f_est, x_drag, f_steps = _obs(4, h, seed=3 * h, dtype=npd)
    table_j = j_gait.mpc_table(j_gait.preset("trotting"), jnp.asarray(seg), h)
    table_t = t_gait.mpc_table(t_gait.preset("trotting", device="cpu"), torch.as_tensor(seg), h)
    tt, jj = torch.as_tensor, jnp.asarray
    qp_j, _, x0_j = j_problem.build_qp(
        j_problem.RobotObs(**{k: jj(v) for k, v in obs.items()}), jj(xref), table_j,
        jc.MPCConfig(horizon=h), f_est=jj(f_est), x_drag=jj(x_drag),
        f_est_steps=jj(f_steps) if per_step else None)
    qp_t, pred_t, x0_t = t_problem.build_qp(
        t_problem.RobotObs(**{k: tt(v) for k, v in obs.items()}), tt(xref), table_t,
        tc.MPCConfig(horizon=h), f_est=tt(f_est), x_drag=tt(x_drag),
        f_est_steps=tt(f_steps) if per_step else None)
    assert qp_t.P.dtype == getattr(torch, dtype) and qp_t.P.shape == (4, 12 * h, 12 * h)
    tol_P, tol_q = (1e-9, 1e-9) if dtype == "float64" else (2e-3, 2e-2)
    _close(qp_t.P, qp_j.P, tol_P, "P")
    _close(qp_t.q, qp_j.q, tol_q, "q")
    _close(x0_t, x0_j, 1e-6)
    # the reference's bounds are float32 whatever the problem's dtype (5e10
    # rounds by 2e-8 there); the port's take the problem's dtype
    for f in ("F", "l", "u"):
        assert getattr(qp_t, f).dtype == qp_t.P.dtype
        np.testing.assert_allclose(getattr(qp_t, f).numpy(), _np(getattr(qp_j, f)),
                                   rtol=1e-7, atol=0, err_msg=f)


def test_build_qp_tunable_raises():
    obs, xref, seg, *_ = _obs(1, 4, seed=0)
    table = t_gait.mpc_table(t_gait.preset("trotting", device="cpu"), torch.as_tensor(seg), 4)
    with pytest.raises(NotImplementedError):
        t_problem.build_qp(t_problem.RobotObs(**{k: torch.as_tensor(v) for k, v in obs.items()}),
                           torch.as_tensor(xref), table, tc.MPCConfig(horizon=4),
                           tunable=object())


def _spd_batch(seed, B, n):
    G = np.random.default_rng(seed).normal(size=(B, n, n))
    K = np.asarray(G @ np.swapaxes(G, -1, -2) + 5.0 * np.eye(n), np.float32)
    return K, np.linalg.inv(K.astype(np.float64))


@pytest.mark.parametrize("case", ["mixed", "all_bad", "indefinite"])
def test_ns_inverse_bucket_matches_jax(case):
    """The seeds of the reference's test_linalg bucket tests (warm majority
    with four jumped seeds; all-zero seeds, which take the whole-batch
    branch; an indefinite seed, which the rescue restarts cold), float32:
    the reference's residual gate 5e-3, and the inverse itself to 1e-5
    against JAX's (entries ~0.2; the seeds' residuals are distinct, so both
    top-k pick the same instances and only f32 roundoff remains)."""
    if case == "indefinite":
        K, K_inv = _spd_batch(5, 16, 24)
        X0 = np.array(K_inv, np.float32)
        Rm = np.eye(24)
        Rm[0, 0] = -1.0
        X0[0] = (Rm @ K_inv[0]).astype(np.float32)
        kw = dict(warm_iters=1, cold_iters=14)
    else:
        K, K_inv = _spd_batch(2, 32, 24)
        X0 = np.array(K_inv, np.float32)
        if case == "mixed":
            X0[[3, 9, 17, 30]] *= 7.0
            kw = dict(warm_iters=1, cold_iters=14)
        else:
            X0 = np.zeros_like(X0)
            kw = dict(warm_iters=1, cold_iters=20)
    X_t = t_linalg.ns_inverse_bucket(torch.as_tensor(K), torch.as_tensor(X0), **kw)
    X_j = j_linalg.ns_inverse_bucket(jnp.asarray(K), jnp.asarray(X0), **kw)
    r = np.abs(X_t.numpy() @ K - np.eye(24)).max(axis=(-2, -1))
    assert np.isfinite(r).all() and r.max() < 5e-3
    _close(X_t, X_j, 1e-5)


def test_cho_inverse_and_ns_inverse_match_jax():
    """cho_inverse and the cold, warm and polished ns_inverse in float64 on
    an SPD batch: 1e-10."""
    K, K_inv = _spd_batch(11, 4, 24)
    K = K.astype(np.float64)
    _close(t_linalg.cho_inverse(t_linalg.cholesky_factor(torch.as_tensor(K))),
           j_linalg.cho_inverse(j_linalg.cholesky_factor(jnp.asarray(K))), 1e-10)
    for kw_np in (dict(), dict(X0=K_inv * 1.05, warm_iters=3), dict(iters=8, polish=2)):
        kw_t = {k: torch.as_tensor(v) if k == "X0" else v for k, v in kw_np.items()}
        kw_j = {k: jnp.asarray(v) if k == "X0" else v for k, v in kw_np.items()}
        _close(t_linalg.ns_inverse(torch.as_tensor(K), **kw_t),
               j_linalg.ns_inverse(jnp.asarray(K), **kw_j), 1e-10)


def _qp_pair(h, B, seed, dtype="float64"):
    """The reference's fixture QP (through its build_qp) and its copy in
    the port; upper bounds as built (5e10 on the friction rows)."""
    qp_j, _, _ = make_mpc_qp(horizon=h, batch=(B,), seed=seed)
    qp_j = jax.tree.map(lambda a: a.astype(dtype), qp_j)
    return qp_j, convert.qp_data(qp_j, "cpu")


SOLVE_CASES = {
    "cholesky": dict(kkt="cholesky"),
    "cholesky_refine": dict(kkt="cholesky", refine=1),
    "ns_global_cold": dict(kkt="ns", ns_escalate="global"),
    "ns_global_refine": dict(kkt="ns", ns_escalate="global", refine=1),
    "ns_bucket_cold": dict(kkt="ns"),
    "woodbury": dict(kkt="ns", eq_mode="woodbury"),
    "cholesky_woodbury_rho": dict(kkt="cholesky", eq_mode="woodbury"),
    "pallas": dict(kkt="ns", backend="pallas"),
}


@pytest.mark.parametrize("case", sorted(SOLVE_CASES))
def test_qp_admm_solve_matches_jax(case):
    """qp_admm.solve, cold, 40 iterations at h = 6, B = 3, every branch of
    the K^{-1} build.  float64 on both sides: x and z (forces ~100 N) to
    1e-7, y to 1e-9, kinv to 1e-9: the same iteration, products summed in
    another order.  The fused-kernel backend is float32 inside on both
    sides: x and z to 2e-3, y to 1e-5 (the reference's kernel gate)."""
    qp_j, qp_t = _qp_pair(6, 3, seed=7)
    kw = dict(iterations=40, **SOLVE_CASES[case])
    x_j, st_j = j_admm.solve(qp_j, jc.ADMMConfig(**kw))
    x_t, st_t = t_admm.solve(qp_t, tc.ADMMConfig(**kw))
    assert x_t.dtype == torch.float64
    tol_x, tol_y = (2e-3, 1e-5) if case == "pallas" else (1e-7, 1e-9)
    _close(x_t, x_j, tol_x, "x")
    _close(st_t.z, st_j.z, tol_x, "z")
    _close(st_t.y, st_j.y, tol_y, "y")
    _close(st_t.kinv, st_j.kinv, 1e-9, "kinv")


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_qp_admm_warm_bucket_solve_matches_jax(backend):
    """Two chained float32 solves at B = 8, h = 10 with the default
    Newton-Schulz bucket: the second is seeded with the first's state and
    K0^{-1} against a QP from drifted observations, so the bucket path runs
    (warm round, top-k continuation).  x and z to 2e-3 (the ADMM gate of
    the kernel tests: f32 over 30 iterations), the carried inverse to
    1e-4 relative to its largest entry."""
    h, B = 10, 8
    cfg_j = jc.ADMMConfig(iterations=30, backend=backend)
    cfg_t = tc.ADMMConfig(iterations=30, backend=backend)
    qp1_j, qp1_t = _qp_pair(h, B, seed=20, dtype="float32")
    qp2_j, qp2_t = _qp_pair(h, B, seed=20, dtype="float32")
    drift = 1.0 + 0.02 * np.random.default_rng(5).uniform(-1, 1, (B, 1, 1)).astype(np.float32)
    qp2_j = qp2_j._replace(P=qp2_j.P * jnp.asarray(drift))
    qp2_t = qp2_t._replace(P=qp2_t.P * torch.as_tensor(drift))
    _, st_j = j_admm.solve(qp1_j, cfg_j)
    _, st_t = t_admm.solve(qp1_t, cfg_t)
    x_j, st_j = j_admm.solve(qp2_j, cfg_j, warm=st_j)
    x_t, st_t = t_admm.solve(qp2_t, cfg_t, warm=st_t)
    _close(x_t, x_j, 2e-3, "x")
    _close(st_t.z, st_j.z, 2e-3, "z")
    scale = float(np.abs(_np(st_j.kinv)).max())
    _close(st_t.kinv, st_j.kinv, 1e-4 * scale, "kinv")
    res = t_admm.kkt_residuals(qp2_t, x_t, st_t.z, st_t.y)
    res_j = j_admm.kkt_residuals(qp2_j, x_j, st_j.z, st_j.y)
    for k in ("primal", "dual", "feas"):
        _close(res[k], res_j[k], 2e-3, k)


def test_woodbury_kkt_inverse_exact():
    """The reference's test_woodbury_kkt_inverse_exact on the port: the
    corrected inverse inverts the bumped K, the carried one the uniform-rho
    K0, both to 1e-5 in float64 (the Newton-Schulz floor)."""
    _, qp = _qp_pair(6, 1, seed=1)
    qp = t_admm.QPData(qp.P[0], qp.q[0], qp.F, qp.l[0], qp.u[0])
    cfg = tc.ADMMConfig(kkt="ns")
    rho = t_admm.rho_vector(qp.l, qp.u, cfg)
    assert float(rho.max()) == pytest.approx(cfg.rho * cfg.eq_scale)
    K_inv, k0_inv = t_admm._kkt_inverse_woodbury(qp, rho, cfg, None)
    eye = torch.eye(72, **T64)
    assert float((eye - K_inv @ t_admm.build_kkt(qp, rho, cfg)).abs().max()) < 1e-5
    K0 = t_admm.build_kkt(qp, torch.full_like(rho, cfg.rho), cfg)
    assert float((eye - k0_inv @ K0).abs().max()) < 1e-5


def test_kkt_assembly_matches_jax():
    """rho_vector, build_kkt, build_kkt_uniform, build_kkt_inverse (both
    backends) and kkt_residuals in float64: 1e-9."""
    qp_j, qp_t = _qp_pair(6, 3, seed=9)
    cfg_j, cfg_t = jc.ADMMConfig(), tc.ADMMConfig()
    rho_j, rho_t = j_admm.rho_vector(qp_j.l, qp_j.u, cfg_j), t_admm.rho_vector(qp_t.l, qp_t.u, cfg_t)
    _close(rho_t, rho_j, 1e-15)
    _close(t_admm.build_kkt(qp_t, rho_t, cfg_t), j_admm.build_kkt(qp_j, rho_j, cfg_j), 1e-9)
    _close(t_admm.build_kkt_uniform(qp_t, cfg_t), j_admm.build_kkt_uniform(qp_j, cfg_j), 1e-9)
    for kkt in ("ns", "cholesky"):
        _close(t_admm.build_kkt_inverse(qp_t, rho_t, tc.ADMMConfig(kkt=kkt)),
               j_admm.build_kkt_inverse(qp_j, rho_j, jc.ADMMConfig(kkt=kkt)), 1e-9, kkt)
    rng = np.random.default_rng(2)
    x, z, y = rng.normal(size=(3, 72)), rng.normal(size=(3, 120)), rng.normal(size=(3, 120))
    res_t = t_admm.kkt_residuals(qp_t, *(torch.as_tensor(v) for v in (x, z, y)))
    res_j = j_admm.kkt_residuals(qp_j, *(jnp.asarray(v) for v in (x, z, y)))
    assert set(res_t) == set(res_j) == {"primal", "dual", "feas"}
    for k in res_t:
        _close(res_t[k], res_j[k], 1e-9, k)


@pytest.mark.parametrize("kinv_bf16", [False, True])
def test_plain_fused_admm_matches_jax_kernel(kinv_bf16):
    """The plain version against JAX's interpret-mode kernel at B = 3,
    h = 10, 50 iterations, on the reference kernel test's problem (eq-scaled
    rho, K^{-1} from a float64 Cholesky): atol 2e-3 on x and z as there, 1e-5
    on y.  With bfloat16 storage both round K^{-1} the same way (nearest
    even), so the same tolerance holds; against the float32 answer the bias
    stays under the reference's 0.08 relative bound."""
    qp_j, qp_t = _qp_pair(10, 3, seed=30, dtype="float32")
    qp_j = qp_j._replace(u=jnp.minimum(qp_j.u, 1e6))
    qp_t = qp_t._replace(u=torch.clamp(qp_t.u, max=1e6))
    cfg = jc.ADMMConfig(iterations=50, kkt="cholesky", eq_mode="woodbury")
    rho = j_admm.rho_vector(qp_j.l, qp_j.u, cfg).astype(jnp.float32)
    K = j_admm.build_kkt(qp_j, rho, cfg)
    K_inv = j_linalg.cho_inverse(j_linalg.cholesky_factor(K.astype(jnp.float64))).astype(
        jnp.float32)
    zn, zm = np.zeros((3, 120), np.float32), np.zeros((3, 200), np.float32)
    kw = dict(iters=50, sigma=cfg.sigma, over_relax=cfg.over_relax, kinv_bf16=kinv_bf16)
    out_j = j_kernel.fused_admm_iterations(
        K_inv, qp_j.q, qp_j.l, qp_j.u, rho, qp_j.F, jnp.asarray(zn), jnp.asarray(zm),
        jnp.asarray(zm), interpret=True, **kw)
    before = t_kernel.LAUNCHES
    out_t = t_kernel.fused_admm_iterations(
        torch.as_tensor(_np(K_inv)), qp_t.q, qp_t.l, qp_t.u, torch.as_tensor(_np(rho)), qp_t.F,
        torch.as_tensor(zn), torch.as_tensor(zm), torch.as_tensor(zm), **kw)
    assert t_kernel.LAUNCHES == before           # no launch on CPU tensors
    for g, w, tol, name in zip(out_t, out_j, (2e-3, 2e-3, 1e-5), "xzy"):
        _close(g, w, tol, name)
    if kinv_bf16:
        x_ref, _ = j_admm.solve(qp_j, cfg)
        rel = float(np.abs(out_t[0].numpy() - _np(x_ref)).max() / np.abs(_np(x_ref)).max())
        assert rel < 0.08


def test_bf16_rounding_is_nearest_even():
    """The storage rounding the plain version uses is jnp's
    astype(bfloat16), bit for bit, on values across the float32 range."""
    v = np.random.default_rng(3).normal(size=4096).astype(np.float32) * np.float32(10.0) ** (
        np.random.default_rng(4).integers(-20, 20, 4096).astype(np.float32))
    got = torch.as_tensor(v).to(torch.bfloat16).to(torch.float32).numpy()
    want = _np(jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("warm", [False, True])
def test_equilibrate_matches_jax(warm):
    """equilibrate.compute / scale / solve in float64 (Cholesky K^{-1}, 40
    iterations), cold and from a carried state: scaling to 1e-12, x to 1e-7."""
    qp_j, qp_t = _qp_pair(6, 3, seed=12)
    s_j, s_t = j_equil.compute(qp_j), t_equil.compute(qp_t)
    for f in t_equil.Scaling._fields:
        _close(getattr(s_t, f), getattr(s_j, f), 1e-12, f)
    _close(t_equil.scale(qp_t, s_t).P, j_equil.scale(qp_j, s_j).P, 1e-9)
    cfg_j, cfg_t = (c(iterations=40, kkt="cholesky") for c in (jc.ADMMConfig, tc.ADMMConfig))
    w_j = w_t = None
    if warm:
        _, w_j = j_equil.solve(qp_j, cfg_j)
        w_t = convert.admm_state(w_j, "cpu")
    x_j, st_j = j_equil.solve(qp_j, cfg_j, warm=w_j)
    x_t, st_t = t_equil.solve(qp_t, cfg_t, warm=w_t)
    _close(x_t, x_j, 1e-7, "x")
    _close(st_t.z, st_j.z, 1e-7, "z")
    _close(st_t.y, st_j.y, 1e-9, "y")


def test_admm_state_converts_with_and_without_kinv():
    st = j_admm.ADMMState(x=jnp.ones((2, 12)), z=jnp.zeros((2, 20)), y=jnp.zeros((2, 20)))
    got = convert.admm_state(st, "cpu")
    assert got.kinv is None and got.x.shape == (2, 12)
    got = convert.admm_state(st._replace(kinv=jnp.eye(12)[None]), "cpu")
    assert got.kinv.shape == (1, 12, 12)
