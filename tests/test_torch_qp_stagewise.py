"""The port's ``ops/qp_stagewise`` against the JAX package: ``solve`` and
its dispatch, the scan path, ``lqr_solve``, ``kkt_residuals`` with a
per-step c; and what this path needs around it:
``problem.build_stagewise`` with ``f_est_steps``,
``estimator.predict_horizon``, the Newton-Schulz inverses and
``convert.stagewise_problem``.

Inputs are made with numpy from a seed and handed to both packages
(tests/_torch_stagewise_cases.py).  JAX runs its XLA path; its h >= 72
interpret-mode kernel program is never run in-process.
"""

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
from _torch_stagewise_cases import F32, close, jax_problem, port

from quad_periodic_mpc_tpu import config as jc
from quad_periodic_mpc_tpu.ops import estimator as j_est
from quad_periodic_mpc_tpu.ops import linalg as j_linalg
from quad_periodic_mpc_tpu.ops import qp_stagewise as j_qp
from quad_periodic_mpc_tpu_torch import config as tc
from quad_periodic_mpc_tpu_torch import convert
from quad_periodic_mpc_tpu_torch.ops import estimator as t_est
from quad_periodic_mpc_tpu_torch.ops import linalg as t_linalg
from quad_periodic_mpc_tpu_torch.ops import problem as t_problem
from quad_periodic_mpc_tpu_torch.ops import qp_stagewise as t_qp
from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel as TK


@pytest.mark.parametrize("per_step_c", [False, True])
def test_kkt_residuals_match_jax(per_step_c):
    """kkt_residuals with a shared and a per-step c, on an arbitrary
    (U, z, y): the same formulas in f32, sums in another order.  Residuals
    are O(10-1000) here, so rtol 1e-5 (measured 2e-7)."""
    sw, _ = jax_problem(1, B=3, h=10, per_step_c=per_step_c)
    rng = np.random.default_rng(2)
    U, z, y = (rng.normal(0, s, (3, 10, r)).astype(np.float32)
               for s, r in ((20.0, 12), (20.0, 20), (0.01, 20)))
    res_j = j_qp.kkt_residuals(sw, jnp.asarray(U), jnp.asarray(z), jnp.asarray(y))
    res_t = t_qp.kkt_residuals(port(sw), *(torch.from_numpy(a) for a in (U, z, y)))
    for name in ("primal", "dual", "feas"):
        close(res_t[name], res_j[name], atol=1e-5, rtol=1e-5, name=name)


def test_build_stagewise_per_step_c_matches_jax():
    """problem.build_stagewise with f_est_steps: c is (B, h, 13), equal to
    the JAX build's to f32 roundoff (atol 1e-6 on entries up to ~0.1), and it
    varies over the horizon."""
    sw, (obs, xref, table, f_est, x_drag, f_steps) = jax_problem(3, B=3, h=10, per_step_c=True)
    t = lambda a: torch.from_numpy(np.array(a))
    sw_t, _ = t_problem.build_stagewise(
        t_problem.RobotObs(*(t(v) for v in obs)), t(xref), t(table), tc.MPCConfig(horizon=10),
        f_est=t(f_est), x_drag=t(x_drag), f_est_steps=t(f_steps))
    assert sw_t.c.shape == (3, 10, 13)
    assert float((sw_t.c[:, 0] - sw_t.c[:, -1]).abs().max()) > 1e-3
    for name in ("Ad", "Bd", "c", "x0"):
        close(getattr(sw_t, name), getattr(sw, name), atol=1e-6, name=name)


@pytest.mark.parametrize("mode,count", [("ls", 60), ("ls", 10), ("static", 600), ("off", 10)])
def test_predict_horizon_matches_jax(mode, count):
    """The per-step wrench (B, h, 6): the fit evaluated at t + k dt, zero
    before release.  atol 2e-5 on values of ~3 N: f32 sin/cos of arguments
    up to ~30 rad differ by a few ulp of the argument between libm and
    torch."""
    rng = np.random.default_rng(4)
    B, h = 3, 10
    st = j_est.init((B,), 48, F32)
    f = lambda lo, hi: jnp.asarray(rng.uniform(lo, hi, B), F32)
    st = st._replace(
        est_freq=f(0.2, 0.5), est_stat=f(-2, 2), est_sin=f(-2, 2), est_cos=f(-2, 2),
        est_amp=f(0, 2), est_phase=f(-3, 3), count=jnp.full((B,), count, jnp.int32))
    cfg_kw = dict(window=48, ls_release=48, mode=mode, predictive=True)
    t_now = rng.uniform(5, 10, B).astype(np.float32)
    w_j = j_est.predict_horizon(st, jnp.asarray(t_now), 0.026, h, jc.EstimatorConfig(**cfg_kw))
    w_t = t_est.predict_horizon(convert.estimator_state(st, "cpu"), torch.from_numpy(t_now),
                                0.026, h, tc.EstimatorConfig(**cfg_kw))
    assert w_t.shape == (B, h, 6)
    assert bool((np.asarray(w_j) != 0).any()) == (count >= 48)
    close(w_t, w_j, atol=2e-5)


@pytest.mark.parametrize("warm", ["cold", "warm", "bad_seed"])
def test_ns_inverse_matches_jax(warm):
    """ns_inverse on SPD 12x12 blocks (cond ~1e3), cold, from a contractive
    warm seed (3 rounds) and from a seed that fails the 0.9 gate (cold
    fallback, full rounds): rel 1e-4 of the largest entry (f32 products in
    another order through up to 30 squarings)."""
    rng = np.random.default_rng(5)
    Ks = []
    for _ in range(4):
        q, _ = np.linalg.qr(rng.normal(size=(12, 12)))
        Ks.append(q @ np.diag(np.logspace(0, 3, 12)) @ q.T)
    K = np.stack(Ks).astype(np.float32)
    X0 = None
    if warm != "cold":
        X0 = np.linalg.inv(K.astype(np.float64)) * (1.02 if warm == "warm" else 3.0)
        X0 = X0.astype(np.float32)
    kw = dict(iters=30, warm_iters=3)
    X_j = j_linalg.ns_inverse(jnp.asarray(K), X0=None if X0 is None else jnp.asarray(X0),
                              precision="highest", **kw)
    X_t = t_linalg.ns_inverse(torch.from_numpy(K),
                              X0=None if X0 is None else torch.from_numpy(X0), **kw)
    scale = float(np.abs(np.asarray(X_j)).max())
    close(X_t, X_j, atol=1e-4 * scale)
    assert np.abs(K @ X_t.numpy() - np.eye(12)).max() < 5e-3


def test_ns_posspec_inverse_matches_jax_lane_version():
    """The scan's combine inverse (I + C J)^{-1}, nonsymmetric with real
    spectrum >= 1, against lane_ns_inverse on the lane-major copy: rel 1e-4."""
    rng = np.random.default_rng(6)
    a, b = rng.normal(size=(2, 5, 13, 13))
    M = (np.eye(13) + (a @ a.transpose(0, 2, 1)) @ (b @ b.transpose(0, 2, 1)) * 0.05)
    M = M.astype(np.float32)
    X_j = np.moveaxis(np.asarray(j_linalg.lane_ns_inverse(
        jnp.asarray(np.moveaxis(M, 0, -1)), 22)), -1, 0)
    X_t = t_linalg.ns_posspec_inverse(torch.from_numpy(M), 22)
    close(X_t, X_j, atol=1e-4 * float(np.abs(X_j).max()))


def test_convert_stagewise_problem_keeps_either_rank_of_c():
    for per_step_c in (False, True):
        sw, _ = jax_problem(7, B=3, h=10, per_step_c=per_step_c)
        sw_t = port(sw)
        assert sw_t.c.shape == ((3, 10, 13) if per_step_c else (3, 13))
        for name in sw._fields:
            got = getattr(sw_t, name)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(sw, name)))



def test_lqr_solve_matches_jax():
    """The sequential oracle in float64: 1e-9 of forces up to ~100 N (two
    exact solvers of the same LQR, LU against LU)."""
    sw, _ = jax_problem(16, B=2, h=8, dtype=np.float64)
    rng = np.random.default_rng(17)
    r_lin = rng.normal(0, 5.0, (2, 8, 12))
    G = 1e-3 * np.asarray(sw.F.T @ sw.F)
    U_j = jax.jit(j_qp.lqr_solve)(sw, jnp.asarray(G), jnp.asarray(r_lin))
    U_t = t_qp.lqr_solve(port(sw), torch.from_numpy(G), torch.from_numpy(r_lin))
    close(U_t, U_j, atol=1e-9, rtol=1e-9)


@pytest.mark.parametrize("h", [4, 10, 33])
def test_scan_factorization_matches_sequential_lqr(h):
    """lqr_factorize_packed + lqr_apply_packed (the hand-written doubling
    scans) reproduce lqr_solve in float64: both are exact solvers of the
    same equality-constrained LQT (the reference's
    test_parallel_lqr_matches_sequential, its rtol 1e-6 / atol 1e-7); h = 33
    is an element count that is not a power of two plus one."""
    sw = port(jax_problem(20 + h, B=2, h=h, dtype=np.float64)[0])
    rng = np.random.default_rng(h)
    r_lin = torch.from_numpy(rng.normal(0, 5.0, (2, h, 12)))
    G = 1e-3 * (sw.F.T @ sw.F)
    U_seq = t_qp.lqr_solve(sw, G, r_lin)
    c = sw.c[:, None]
    gains = t_qp.lqr_factorize_packed(sw.Ad, sw.Bd, c, sw.x_ref, sw.Q, sw.R, G)
    U_par = t_qp.lqr_apply_packed(gains, sw.Bd, c, sw.x0, r_lin)
    close(U_par, U_seq, atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("dtype,per_step_c", [(np.float32, False), (np.float32, True),
                                              (np.float64, True)])
def test_scan_path_matches_jax_xla_solve(dtype, per_step_c):
    """solve(backend="xla"), 60 iterations, h = 10, B = 3, against the JAX
    package's XLA path.  float64: 1e-6 (the same algorithm; only the
    prefix-scan's association order differs).  float32: U and z 2e-3 (the
    tolerance the reference holds its two layouts of this path to,
    test_packed_solve_matches_blocked), y 1e-5 (rho-scaled)."""
    sw, _ = jax_problem(30, B=3, h=10, per_step_c=per_step_c, dtype=dtype)
    U_j, info_j = jax.jit(lambda p: j_qp.solve(p, jc.ADMMConfig(iterations=60)))(sw)
    U_t, info_t = t_qp.solve(port(sw), tc.ADMMConfig(iterations=60))
    assert U_t.dtype == (torch.float64 if dtype == np.float64 else torch.float32)
    tol, ytol = (1e-6, 1e-8) if dtype == np.float64 else (2e-3, 1e-5)
    close(U_t, U_j, atol=tol)
    close(info_t["z"], info_j["z"], atol=tol)
    close(info_t["y"], info_j["y"], atol=ytol)


def test_solve_leading_batch_dims_and_warm_round_trip():
    """A (2, 2) leading batch through both branches of solve equals the
    flat batch (1e-5), and the warm carry contract holds: the outputs feed
    the next call, and 20 warm iterations keep the KKT gates (primal 6e-3,
    dual 1e-3) that 120 cold ones reach
    (test_fused_stagewise_kernel_matches_xla)."""
    sw = port(jax_problem(31, B=4, h=10, per_step_c=True)[0])
    sw4 = sw._replace(**{n: getattr(sw, n).reshape((2, 2) + getattr(sw, n).shape[1:])
                         for n in ("Ad", "Bd", "c", "x0", "x_ref", "l", "u")})
    for backend in ("pallas", "xla"):
        few = tc.ADMMConfig(iterations=10, backend=backend)
        U_flat, _ = t_qp.solve(sw, few)
        close(t_qp.solve(sw4, few)[0].reshape(4, 10, 12), U_flat, atol=1e-5)
        U, info = t_qp.solve(sw4, tc.ADMMConfig(iterations=120, backend=backend))
        assert U.shape == (2, 2, 10, 12) and info["z"].shape == (2, 2, 10, 20)
        U_w, info_w = t_qp.solve(sw4, tc.ADMMConfig(iterations=20, backend=backend),
                                 warm=(U, info["z"], info["y"]))
        res = t_qp.kkt_residuals(sw4, U_w, info_w["z"], info_w["y"])
        assert float(res["primal"].max()) < 6e-3 and float(res["dual"].max()) < 1e-3


@pytest.mark.parametrize("dtype,h,backend,expected", [
    (torch.float32, 10, "pallas", "resident"), (torch.float32, 64, "pallas", "resident"),
    (torch.float32, 72, "pallas", "stream"), (torch.float32, 128, "pallas", "stream"),
    (torch.float32, 130, "pallas", "scan"), (torch.float32, 68, "pallas", "scan"),
    (torch.float64, 10, "pallas", "scan"), (torch.float32, 10, "xla", "scan"),
    (torch.float32, 72, "xla", "scan"),
])
def test_solve_dispatch(monkeypatch, dtype, h, backend, expected):
    """Which branch solve takes, as the reference's dispatch
    (qp_stagewise.py:646-690): the wrappers and the scan factorization are
    patched to record the call and stop."""
    class Taken(Exception):
        pass

    def stop(name):
        def fn(*a, **k):
            raise Taken(name)
        return fn

    monkeypatch.setattr(TK, "fused_stagewise_solve", stop("resident"))
    monkeypatch.setattr(TK, "fused_stagewise_solve_stream", stop("stream"))
    monkeypatch.setattr(t_qp, "lqr_factorize_packed", stop("scan"))
    z = lambda *s: torch.zeros(s, dtype=dtype)
    prob = t_qp.StagewiseProblem(
        Ad=torch.eye(13, dtype=dtype).expand(2, 13, 13), Bd=z(2, 13, 12), c=z(2, 13),
        x0=z(2, 13), x_ref=z(2, h, 13), Q=torch.ones(13, dtype=dtype),
        R=torch.ones(12, dtype=dtype), F=z(5, 3), l=z(2, h, 20), u=z(2, h, 20))
    with pytest.raises(Taken, match=expected):
        t_qp.solve(prob, tc.ADMMConfig(iterations=1, backend=backend))


def test_stream_h72_matches_scan_path_and_kkt_gates():
    """64 < h <= 128 goes to the streamed solve; at h = 72 (a 24-stage trot
    problem tiled three times) it is held to the port's own scan path and
    the KKT gates of the reference's test_stream_kernel_h72_end_to_end:
    primal 2e-2, dual 3e-3, U 5e-2.  100 cold iterations, where the
    reference runs 60 on one milder problem: these seeded instances reach
    primal 6.6e-2 after 60 and 1.9e-3 after 100.  (The JAX h = 72 interpret
    program is never run in-process.)"""
    sw = port(jax_problem(6, B=2, h=24)[0])
    tile = lambda t: t.repeat(1, 3, 1)
    sw = sw._replace(x_ref=tile(sw.x_ref), l=tile(sw.l), u=tile(sw.u))
    U_x, _ = t_qp.solve(sw, tc.ADMMConfig(iterations=100))
    U_p, info_p = t_qp.solve(sw, tc.ADMMConfig(iterations=100, backend="pallas"))
    res = t_qp.kkt_residuals(sw, U_p, info_p["z"], info_p["y"])
    assert float(res["primal"].max()) < 2e-2
    assert float(res["dual"].max()) < 3e-3
    close(U_p, U_x, atol=5e-2)
