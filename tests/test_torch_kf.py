"""The port's state-estimation tick against the JAX package.

The same seeded numpy inputs go through the JAX function and its
counterpart in the port, on the CPU.  JAX runs its Pallas KF kernel in
interpret mode; the port runs the kernel's plain version.  Each tolerance is
stated with its reason at the test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quad_periodic_mpc_tpu.estimation import be2r_height as j_be2r
from quad_periodic_mpc_tpu.estimation import container as j_container
from quad_periodic_mpc_tpu.estimation import kf as j_kf
from quad_periodic_mpc_tpu.estimation import orientation as j_ori
from quad_periodic_mpc_tpu.ops.pallas import kf_kernel as j_kernel
from quad_periodic_mpc_tpu_torch import convert
from quad_periodic_mpc_tpu_torch.estimation import be2r_height as t_be2r
from quad_periodic_mpc_tpu_torch.estimation import container as t_container
from quad_periodic_mpc_tpu_torch.estimation import kf as t_kf
from quad_periodic_mpc_tpu_torch.estimation import orientation as t_ori
from quad_periodic_mpc_tpu_torch.ops.cuda import kf_kernel as t_kernel
from quad_periodic_mpc_tpu_torch.testing import kernel_cases as KC

NP_DTYPE = {"float32": np.float32, "float64": np.float64}
Q_STAND = np.tile([0.0, 0.67, -1.3], (4, 1))


def _tt(a, dtype="float32"):
    return torch.as_tensor(np.asarray(a, NP_DTYPE[dtype]))


def _jj(a, dtype="float32"):
    return jnp.asarray(np.asarray(a, NP_DTYPE[dtype]))


def _np(a):
    return np.asarray(a)


def _dense_oracle(xhat, P, a, y, qd, rd, dt):
    """float64 numpy transliteration of the predict + innovation
    (tests/test_kf.py's oracle)."""
    A = np.eye(18)
    A[0:3, 3:6] = dt * np.eye(3)
    Bm = np.zeros((18, 3))
    Bm[3:6, :] = dt * np.eye(3)
    C = np.zeros((28, 18))
    for i in range(4):
        C[3 * i:3 * i + 3, 0:3] = np.eye(3)
        C[12 + 3 * i:15 + 3 * i, 3:6] = np.eye(3)
    C[0:12, 6:18] = -np.eye(12)
    C[24, 8] = C[25, 11] = C[26, 14] = C[27, 17] = 1
    xo, Po = [], []
    for b in range(xhat.shape[0]):
        xp = A @ xhat[b] + Bm @ a[b]
        Pm = A @ P[b] @ A.T + np.diag(qd[b])
        Si = np.linalg.inv(C @ Pm @ C.T + np.diag(rd[b]))
        xo.append(xp + Pm @ C.T @ Si @ (y[b] - C @ xp))
        Pn = (np.eye(18) - Pm @ C.T @ Si @ C) @ Pm
        Pn = (Pn + Pn.T) / 2
        if Pn[0, 0] * Pn[1, 1] - Pn[0, 1] * Pn[1, 0] > 1e-6:
            m = np.ones((18, 18))
            m[0:2, 2:] = 0
            m[2:, 0:2] = 0
            Pn = Pn * m
            Pn[0:2, 0:2] /= 10
        Po.append(Pn)
    return np.stack(xo), np.stack(Po)


def test_plain_kf_innovate_matches_jax_kernel_and_float64_oracle():
    """The plain version on the reference kernel test's inputs (B = 5,
    conditioned states): against JAX's interpret-mode kernel to that test's
    atol (x 2e-3, P 5e-3; measured 1e-4 and 2e-5: the same arithmetic, sums
    in another order), and against a float64 dense oracle to
    ``KC.KF_TOL`` (x 5e-3, P 2e-4), the kernel-vs-plain gate."""
    args = KC.kf_case(5, seed=0, device="cpu")
    x_t, P_t = t_kernel.fused_kf_innovate(*args, dt=KC.KF_DT)
    x_j, P_j = j_kernel.fused_kf_innovate(*(jnp.asarray(a.numpy()) for a in args),
                                          dt=KC.KF_DT, interpret=True)
    np.testing.assert_allclose(x_t.numpy(), _np(x_j), atol=2e-3, rtol=0)
    np.testing.assert_allclose(P_t.numpy(), _np(P_j), atol=5e-3, rtol=0)
    x_o, P_o = _dense_oracle(*(a.double().numpy() for a in args), KC.KF_DT)
    np.testing.assert_allclose(x_t.numpy(), x_o, atol=KC.KF_TOL["x"], rtol=0)
    np.testing.assert_allclose(P_t.numpy(), P_o, atol=KC.KF_TOL["P"], rtol=0)


def test_plain_kf_innovate_tracks_jax_kernel_through_the_transient():
    """Inputs from ticks 0 and 3 of a cold start (P0 = 100 I): the plain
    version against JAX's interpret-mode kernel within
    ``KC.KF_TOL_TRANSIENT`` (x 2e-3, P 2e-2; kernel_cases says why the
    transient gets the looser gate and why tick 1 gets none)."""
    for ticks in (0, 3):
        args = KC.kf_transient_case(8, ticks=ticks, seed=1, device="cpu")
        x_t, P_t = t_kernel.fused_kf_innovate(*args, dt=KC.KF_DT)
        x_j, P_j = j_kernel.fused_kf_innovate(*(jnp.asarray(a.numpy()) for a in args),
                                              dt=KC.KF_DT, interpret=True)
        np.testing.assert_allclose(x_t.numpy(), _np(x_j), atol=KC.KF_TOL_TRANSIENT["x"], rtol=0)
        np.testing.assert_allclose(P_t.numpy(), _np(P_j), atol=KC.KF_TOL_TRANSIENT["P"], rtol=0)


def test_kf_wrapper_on_cpu_launches_no_kernel():
    before = t_kernel.LAUNCHES
    t_kernel.fused_kf_innovate(*KC.kf_case(2, device="cpu"), dt=KC.KF_DT)
    assert t_kernel.LAUNCHES == before


def _standing_inputs(B, dtype, seed=0):
    """A standing robot, slightly tilted per instance: the arguments of
    kf.update after the state, as numpy."""
    rng = np.random.default_rng(seed)
    feet_w = np.array([[0.18, -0.13, 0.0], [0.18, 0.13, 0.0],
                       [-0.18, -0.13, 0.0], [-0.18, 0.13, 0.0]])
    p_rel = feet_w - np.array([0.0, 0.0, 0.3]) + rng.uniform(-0.01, 0.01, (B, 4, 3))
    rpy = rng.uniform(-0.05, 0.05, (B, 3))
    from quad_periodic_mpc_tpu.ops.rotations import rpy_to_rotmat
    Rbody = np.swapaxes(_np(rpy_to_rotmat(jnp.asarray(rpy))), -1, -2)
    cast = lambda v: np.asarray(v, NP_DTYPE[dtype])
    return (cast(np.tile([0.0, 0.0, 9.81], (B, 1))), cast(Rbody), cast(np.zeros((B, 3))),
            cast(p_rel), cast(np.zeros((B, 4, 3))))


def _phase(k, B, dtype):
    """Contact phases of tick k, (B, 4): a trot's two diagonal pairs half a
    cycle apart, advancing 0.011 a tick."""
    ph = (0.011 * k + np.array([0.0, 0.5, 0.5, 0.0])) % 1.0
    return np.asarray(ph * np.ones((B, 4)), NP_DTYPE[dtype])


@pytest.mark.parametrize("backend,dtype", [("xla", "float64"), ("pallas", "float64"),
                                          ("xla", "float32"), ("pallas", "float32")])
def test_kf_update_matches_jax_over_standing_loop(backend, dtype):
    """kf.update over a 100-tick standing loop at B = 3 from a cold start
    (P0 = 100 I), the contact phase advancing so the trust window opens and
    closes and two legs start at trust 0.  float64 (both backends take the
    dense chain there): 1e-9, the same arithmetic.  float32: the state to
    2e-3 (the reference's own gate between its kernel and its XLA chain
    after 100 ticks; measured 5e-6 on the dense chain), at rest below 5e-3."""
    B, pr_j, pr_t = 3, j_kf.KFParams(), t_kf.KFParams()
    inputs = _standing_inputs(B, dtype)
    phases = [_phase(k, B, dtype) for k in range(100)]
    st_j = j_kf.init((B,), jnp.dtype(dtype))
    st_t = t_kf.init((B,), getattr(torch, dtype), "cpu")
    step_j = jax.jit(lambda s, ph: j_kf.update(
        s, *(jnp.asarray(v) for v in inputs), ph, pr_j, backend=backend))
    for ph in phases:
        st_j = step_j(st_j, jnp.asarray(ph))
        st_t = t_kf.update(st_t, *(torch.as_tensor(v.copy()) for v in inputs),
                           torch.as_tensor(ph), pr_t, backend=backend)
    assert st_t.xhat.dtype == getattr(torch, dtype)
    tol = 1e-9 if dtype == "float64" else 2e-3
    np.testing.assert_allclose(st_t.xhat.numpy(), _np(st_j.xhat), atol=tol, rtol=0)
    np.testing.assert_allclose(st_t.P.numpy(), _np(st_j.P), atol=tol, rtol=0)
    assert float(st_t.xhat[:, 3:6].abs().max()) < 5e-3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_float32_dense_chain_survives_a_cold_start_with_a_leg_at_trust_zero(seed):
    """The inputs on which the float32 dense chain once went NaN at tick 3
    (P0 = 100 I, legs 0 and 3 at trust 0, cond(S) ~ 5e5): every tick stays
    finite; from tick 3 on the state is within 2e-3 and the covariance within
    1e-3 of the reference's float32 chain (measured 3e-4 at tick 3, 2e-5 at
    tick 19), and within 5e-3 / 1e-3 of the port's own float64 run, which is
    as near as the reference's float32 chain comes to it (1.9e-3 / 3.3e-4 at
    tick 3).  Ticks 0 to 2 carry no tolerance: there no float32 evaluation
    is near float64 (the reference's is 0.2 off on P at tick 0)."""
    B, pr_j, pr_t = 3, j_kf.KFParams(), t_kf.KFParams()
    inputs, inputs64 = _standing_inputs(B, "float32", seed), _standing_inputs(B, "float64", seed)
    st_j = j_kf.init((B,), jnp.float32)
    st_t, st_d = t_kf.init((B,), torch.float32, "cpu"), t_kf.init((B,), torch.float64, "cpu")
    step_j = jax.jit(lambda s, ph: j_kf.update(
        s, *(jnp.asarray(v) for v in inputs), ph, pr_j, backend="xla"))
    for k in range(20):
        ph = _phase(k, B, "float32")
        st_j = step_j(st_j, jnp.asarray(ph))
        st_t = t_kf.update(st_t, *(torch.as_tensor(v.copy()) for v in inputs),
                           torch.as_tensor(ph), pr_t, backend="xla")
        st_d = t_kf.update(st_d, *(torch.as_tensor(v.copy()) for v in inputs64),
                           torch.as_tensor(ph).double(), pr_t, backend="xla")
        assert bool(torch.isfinite(st_t.xhat).all() and torch.isfinite(st_t.P).all()), k
        if k >= 3:
            np.testing.assert_allclose(st_t.xhat.numpy(), _np(st_j.xhat), atol=2e-3, rtol=0)
            np.testing.assert_allclose(st_t.P.numpy(), _np(st_j.P), atol=1e-3, rtol=0)
            np.testing.assert_allclose(st_t.xhat.numpy(), st_d.xhat.numpy(), atol=5e-3, rtol=0)
            np.testing.assert_allclose(st_t.P.numpy(), st_d.P.numpy(), atol=1e-3, rtol=0)


def test_trust_from_phase_matches_jax():
    ph = np.random.default_rng(3).uniform(0.0, 1.3, (7, 4))
    got = t_kf.trust_from_phase(torch.as_tensor(ph), t_kf.KFParams())
    np.testing.assert_allclose(got.numpy(), _np(j_kf.trust_from_phase(jnp.asarray(ph),
                                                                      j_kf.KFParams())),
                               atol=1e-12, rtol=0)


def test_plane_body_height_matches_jax():
    """Flat ground gives the height back; tilted random footholds match JAX
    to 1e-9 in float64."""
    feet = np.array([[0.18, -0.13, -0.27], [0.18, 0.13, -0.27],
                     [-0.18, -0.13, -0.27], [-0.18, 0.13, -0.27]])
    z, pitch = t_kf.plane_body_height(torch.as_tensor(feet))
    assert abs(float(z) - 0.27) < 1e-6 and abs(float(pitch)) < 1e-6
    P = feet + np.random.default_rng(4).uniform(-0.03, 0.03, (6, 4, 3))
    got, want = t_kf.plane_body_height(torch.as_tensor(P)), j_kf.plane_body_height(jnp.asarray(P))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-9, rtol=0)


def _imu(B, seed):
    from quad_periodic_mpc_tpu.ops.rotations import rpy_to_quat
    rng = np.random.default_rng(seed)
    quat = _np(rpy_to_quat(jnp.asarray(rng.uniform(-0.2, 0.2, (B, 3))
                                       + np.array([0.0, 0.0, 1.0]) * rng.uniform(-3, 3, (B, 1)))))
    return quat, rng.normal(size=(B, 3)) * 0.2, rng.normal(size=(B, 3)) + [0, 0, 9.81]


def test_orientation_matches_jax():
    """initial_yaw_correction and run in float64: 1e-12."""
    quat, gyro, acc = _imu(6, 5)
    corr_t = t_ori.initial_yaw_correction(torch.as_tensor(quat))
    corr_j = j_ori.initial_yaw_correction(jnp.asarray(quat))
    np.testing.assert_allclose(corr_t.numpy(), _np(corr_j), atol=1e-12, rtol=0)
    res_t = t_ori.run(*(torch.as_tensor(v) for v in (quat, gyro, acc)), corr_t)
    res_j = j_ori.run(*(jnp.asarray(v) for v in (quat, gyro, acc)), corr_j)
    for f in t_ori.OrientationResult._fields:
        np.testing.assert_allclose(getattr(res_t, f).numpy(), _np(getattr(res_j, f)),
                                   atol=1e-12, rtol=0, err_msg=f)
    assert float(res_t.rpy[:, 2].abs().max()) < 1e-9      # the yaw is zeroed


@pytest.mark.parametrize("backend,dtype", [("xla", "float64"), ("xla", "float32"),
                                          ("pallas", "float32")])
def test_container_update_matches_jax(backend, dtype):
    """container.update over 60 ticks at B = 3 (per-instance IMU yaw, joint
    angles around the stand pose, the contact phase advancing): float64 to
    1e-9; float32 to 2e-3 on position and velocity (the KF gate above),
    orientation outputs to 1e-5.  The yaw is zeroed on the first visit and
    the correction kept."""
    B = 3
    quat, _, _ = _imu(B, 6)
    rng = np.random.default_rng(7)
    q = Q_STAND + rng.uniform(-0.05, 0.05, (B, 4, 3))
    cast = lambda v: np.asarray(v, NP_DTYPE[dtype])
    fixed = [cast(v) for v in (quat, np.zeros((B, 3)), np.tile([0.0, 0.0, 9.81], (B, 1)),
                               q, np.zeros((B, 4, 3)))]
    st_j = j_container.init((B,), jnp.dtype(dtype))
    st_t = t_container.init((B,), getattr(torch, dtype), "cpu")
    step_j = jax.jit(lambda s, ph: j_container.update(
        s, *(jnp.asarray(v) for v in fixed), ph, kf_backend=backend))
    for k in range(60):
        ph = _phase(k, B, dtype)
        st_j, est_j = step_j(st_j, jnp.asarray(ph))
        st_t, est_t = t_container.update(st_t, *(torch.as_tensor(v) for v in fixed),
                                         torch.as_tensor(ph), kf_backend=backend)
    tol_kf, tol_ori = (1e-9, 1e-9) if dtype == "float64" else (2e-3, 1e-5)
    for f in t_container.StateEstimate._fields:
        tol = tol_kf if f in ("position", "v_world", "v_body") else tol_ori
        np.testing.assert_allclose(getattr(est_t, f).numpy(), _np(getattr(est_j, f)),
                                   atol=tol, rtol=0, err_msg=f)
    np.testing.assert_allclose(st_t.yaw_correction.numpy(), _np(st_j.yaw_correction),
                               atol=tol_ori, rtol=0)
    assert bool(st_t.initialized.all())
    assert float(est_t.rpy[:, 2].abs().max()) < 1e-6
    # the state converts across and back
    back = convert.estimation_state(st_j, "cpu")
    assert back.kf.P.shape == (B, 18, 18) and back.initialized.dtype == torch.bool
    np.testing.assert_array_equal(convert.to_numpy(back).kf.xhat, _np(st_j.kf.xhat))
    np.testing.assert_array_equal(convert.kf_state(st_j.kf, "cpu").P.numpy(), _np(st_j.kf.P))


def test_container_stationary_convergence():
    """The reference's test_container_stationary_convergence on the port,
    in float32 through the kernel's plain version: yaw zeroed, velocity to
    5e-3, body height above the feet within 0.02 of the leg FK."""
    from quad_periodic_mpc_tpu_torch.control import leg_controller as lc
    from quad_periodic_mpc_tpu_torch.models.a1 import A1
    from quad_periodic_mpc_tpu_torch.ops.rotations import rpy_to_quat

    st = t_container.init((), device="cpu")
    q = _tt(Q_STAND)
    quat_imu = rpy_to_quat(torch.tensor([0.0, 0.0, 0.3]))
    for _ in range(200):
        st, est = t_container.update(
            st, quat_imu, torch.zeros(3), torch.tensor([0.0, 0.0, 9.81]), q,
            torch.zeros(4, 3), torch.full((4,), 0.5), kf_backend="pallas")
    assert abs(float(est.rpy[2])) < 1e-6
    assert float(est.v_world.abs().max()) < 5e-3
    foot_z = float(lc.update_data(q, torch.zeros(4, 3), A1).p[0, 2])
    assert abs(float(est.position[2]) - float(st.kf.xhat[8]) + foot_z) < 0.02


def test_cheater_matches_jax():
    rng = np.random.default_rng(8)
    quat, gyro, acc = _imu(4, 9)
    args = (rng.normal(size=(4, 3)), rng.normal(size=(4, 3)), quat, gyro, acc, np.ones((4, 4)))
    got = t_container.cheater(*(torch.as_tensor(v) for v in args))
    want = j_container.cheater(*(jnp.asarray(v) for v in args))
    for f in t_container.StateEstimate._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(), _np(getattr(want, f)),
                                   atol=1e-12, rtol=0, err_msg=f)


@pytest.mark.parametrize("case", ["calibrating", "running", "mixed_batch", "shared_state"])
def test_be2r_height_step_matches_jax(case):
    """be2r_height.step on the cases of the reference's test_be2r_height
    (hold during calibration, the filter after it, a mixed-phase batch, the
    shared-state mode), 50 ticks of seeded noise in float32: 1e-6 (the same
    elementwise arithmetic; z ~ 0.06)."""
    rng = np.random.default_rng(10)
    B = 3
    count = {"calibrating": [0, 0, 0], "running": [600, 600, 600],
             "mixed_batch": [600, 10, 0], "shared_state": [600, 600, 600]}[case]
    shared = case == "shared_state"
    s_j = j_be2r.init((B,))._replace(count=jnp.asarray(count, jnp.int32))
    s_t = t_be2r.init((B,), device="cpu")._replace(count=torch.tensor(count, dtype=torch.int32))
    for _ in range(50):
        a = np.asarray(rng.normal(0, 0.5, (B, 3)), np.float32)
        v = np.asarray(rng.normal(0.05, 0.1, B), np.float32)
        s_j = j_be2r.step(s_j, jnp.asarray(a), jnp.asarray(v), 0.002, shared_state=shared)
        s_t = t_be2r.step(s_t, torch.as_tensor(a), torch.as_tensor(v), 0.002,
                          shared_state=shared)
    flat_j, flat_t = jax.tree.leaves(s_j), jax.tree.leaves(convert.to_numpy(s_t))
    assert len(flat_j) == len(flat_t) == 9
    for g, w in zip(flat_t, flat_j):
        np.testing.assert_allclose(g, _np(w), atol=1e-6, rtol=0)
    if case == "calibrating":
        assert np.allclose(s_t.z.numpy(), 0.056) and s_t.count.tolist() == [50, 50, 50]
    if case == "mixed_batch":
        assert float(s_t.z[0]) != 0.056 and np.allclose(s_t.z[1:].numpy(), 0.056)
