"""The port's stand-balance QP (control/balance), VBL-LQR controller
(control/balance_vbl) and Riccati solvers (ops/linalg.care,
dare_doubling) against the JAX package: the five tests of
tests/test_balance.py and the five of tests/test_balance_vbl.py, each run
in both packages on the same inputs (JAX jitted), then the JAX test's own
gates on the port's answer; and seeded batches.

Tolerances (float64 unless stated): forces within 1e-7 N of JAX's after
PDIP-25 (the same iterations, products summed in another order: ~1e-12
per iteration, grown by the interior point's late conditioning); the
balance QP in float32 is held to float64 (see its test).  CARE / DARE within 1e-9 relative of JAX's P (LU
solves and 30-40 doublings in another order) and to scipy under the JAX
test's own 2e-3 / 1e-3.  reference_grf: the stance legs within 1e-9
relative; the pinned legs' ~0 forces to 1e-9 absolute (the 1e-9 penalty
makes that solve badly conditioned)."""

import numpy as np
import scipy.linalg
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from quad_periodic_mpc_tpu.control import balance as j_balance
from quad_periodic_mpc_tpu.control import balance_vbl as j_vbl
from quad_periodic_mpc_tpu.ops import linalg as j_linalg
from quad_periodic_mpc_tpu.ops import rotations as j_rot
from quad_periodic_mpc_tpu_torch import convert
from quad_periodic_mpc_tpu_torch.control import balance
from quad_periodic_mpc_tpu_torch.control import balance_vbl as vbl
from quad_periodic_mpc_tpu_torch.ops import linalg
from quad_periodic_mpc_tpu_torch.ops.rotations import rpy_to_rotmat, yaw_rotmat

FEET = np.array([[0.18, -0.13, -0.29], [0.18, 0.13, -0.29],
                 [-0.18, -0.13, -0.29], [-0.18, 0.13, -0.29]])
F_ATOL = 1e-7

_j_solve = jax.jit(j_balance.solve, static_argnums=(8, 9))
_j_vbl = jax.jit(j_vbl.solve, static_argnames=("cfg", "pdip"))


def T(a):
    return torch.from_numpy(np.array(a))


def close(t, j, atol=0.0, rtol=0.0):
    t, j = convert.to_numpy(t), np.asarray(j)
    assert t.dtype == j.dtype and t.shape == j.shape, (t.dtype, j.dtype, t.shape, j.shape)
    np.testing.assert_allclose(t, j, rtol=rtol, atol=atol)


def setup(contact=(1, 1, 1, 1), dtype=np.float64):
    f = lambda a: np.asarray(a, dtype)
    p_com = f([0.0, 0.0, 0.29])
    cmd = (p_com, f(np.zeros(3)), f(np.zeros(3)), f(np.eye(3)), f(np.zeros(3)))
    return [p_com, f(np.zeros(3)), f(np.eye(3)), f(np.zeros(3)), f(0.0), f(FEET),
            f(contact), cmd]


def solve_both(args, cfg=balance.BalanceSettings()):
    """balance.solve in both packages on numpy args; returns the port's."""
    *arrays, cmd = args
    f = balance.solve(*map(T, arrays), balance.BalanceCommand(*map(T, cmd)), cfg)
    j_cfg = j_balance.BalanceSettings(**vars(cfg))
    ref = _j_solve(*map(jnp.asarray, arrays), j_balance.BalanceCommand(*map(jnp.asarray, cmd)),
                   j_cfg, j_balance.PDIPConfig(iterations=25))
    close(f, ref, atol=F_ATOL)
    return f.numpy()


def test_settings_equal_reference():
    import dataclasses

    assert dataclasses.asdict(balance.BalanceSettings()) == dataclasses.asdict(
        j_balance.BalanceSettings())
    assert dataclasses.asdict(vbl.VBLSettings()) == dataclasses.asdict(j_vbl.VBLSettings())
    assert balance.BalanceCommand._fields == j_balance.BalanceCommand._fields


def test_yaw_rotmat_matches():
    yaw = np.random.default_rng(0).uniform(-4, 4, 64)
    close(yaw_rotmat(T(yaw)), j_rot.yaw_rotmat(jnp.asarray(yaw)), atol=1e-15)


def test_stand_supports_weight():
    f = solve_both(setup())
    cfg = balance.BalanceSettings()
    assert abs(f[:, 2].sum() - cfg.mass * 9.81) < 2.0
    assert f[:, 2].std() < 6.0
    torque = np.sum(np.cross(FEET, f), axis=0)
    assert np.abs(torque).max() < 2.0
    assert (f[:, 2] >= cfg.min_force - 1e-4).all()
    assert (np.abs(f[:, 0]) <= cfg.mu * f[:, 2] + 1e-6).all()


def test_three_leg_stance_pins_swing():
    f = solve_both(setup(contact=(0.0, 1.0, 1.0, 1.0)))
    np.testing.assert_allclose(f[0], 0.0, atol=1e-4)
    assert abs(f[1:, 2].sum() - balance.BalanceSettings().mass * 9.81) < 3.0


def test_position_error_pushes_back():
    args = setup()
    args[-1] = (np.array([-0.03, 0.0, 0.29]),) + args[-1][1:]
    f = solve_both(args)
    assert f[:, 0].sum() < -3.0


def test_matrix_log_rot():
    for axis, ang in [(0, 0.3), (1, -0.4), (2, 1.0)]:
        rpy = np.zeros(3)
        rpy[axis] = ang
        R = rpy_to_rotmat(T(rpy))
        w = balance.matrix_log_rot(R)
        close(w, j_balance.matrix_log_rot(j_rot.rpy_to_rotmat(jnp.asarray(rpy))), atol=1e-15)
        expected = np.zeros(3)
        expected[axis] = ang
        np.testing.assert_allclose(w.numpy(), expected, atol=1e-9)
    np.testing.assert_allclose(balance.matrix_log_rot(torch.eye(3, dtype=torch.float64)).numpy(),
                               0.0, atol=1e-12)


def test_batched_balance():
    args = setup()
    B = 4
    bx = lambda x: np.broadcast_to(x, (B,) + np.shape(x)).copy()
    *arrays, cmd = args
    arrays = [bx(a) for a in arrays]
    f_b = solve_both(arrays + [tuple(bx(c) for c in cmd)])
    f_1 = solve_both(args)
    np.testing.assert_allclose(f_b[2], f_1, atol=1e-9)


def seeded_stances(B: int, seed: int = 17):
    """Seeded stances: tilted and yawed bodies, CoM and velocity errors,
    feet spread around the nominal stance, each of the 16 contact patterns
    (the first half in full contact); float64 numpy."""
    rng = np.random.default_rng(seed)
    rpy = rng.uniform([-0.2, -0.2, -3.0], [0.2, 0.2, 3.0], (B, 3))
    R = np.asarray(j_rot.rpy_to_rotmat(jnp.asarray(rpy)))
    p = np.array([0.0, 0.0, 0.29]) + rng.uniform(-0.03, 0.03, (B, 3))
    v = rng.uniform(-0.2, 0.2, (B, 3))
    w = rng.uniform(-0.5, 0.5, (B, 3))
    feet = FEET + rng.uniform(-0.03, 0.03, (B, 4, 3))
    contact = ((np.arange(B)[:, None] >> np.arange(4)) & 1).astype(float)
    contact[: B // 2] = 1.0
    cmd = (np.tile([0.0, 0.0, 0.29], (B, 1)), np.zeros((B, 3)), np.zeros((B, 3)),
           np.tile(np.eye(3), (B, 1, 1)), np.zeros((B, 3)))
    return [p, v, R, w, rpy[:, 2], feet, contact, cmd]


def test_seeded_balance_equal_reference():
    """128 seeded stances in float64: the port's forces within 1e-7 N of
    JAX's; swing feet pinned."""
    args = seeded_stances(128)
    out = solve_both(args)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out[args[6] == 0], 0.0, atol=1e-3)


def test_seeded_balance_float32_against_float64():
    """The same stances in float32.  PDIP-25 in float32 ends far from the
    float64 answer on some of them in both packages (JAX's XLA path: median
    ~1 N, worst ~75 N over these 128), and the two float32 runs part where
    the interior point's late Newton systems lose their digits.  So each
    package's float32 answer is held to the float64 one, the port's no
    further from it than JAX's: its median and its 90th percentile within
    1.5x of JAX's plus 0.05 N."""
    args = seeded_stances(128)
    *arrays, cmd = args
    f64 = balance.solve(*map(T, arrays), balance.BalanceCommand(*map(T, cmd))).numpy()
    a32 = [np.asarray(a, np.float32) for a in arrays]
    c32 = tuple(np.asarray(c, np.float32) for c in cmd)
    f32 = balance.solve(*map(T, a32), balance.BalanceCommand(*map(T, c32))).numpy()
    j32 = np.asarray(_j_solve(*map(jnp.asarray, a32), j_balance.BalanceCommand(
        *map(jnp.asarray, c32)), j_balance.BalanceSettings(), j_balance.PDIPConfig(iterations=25)))
    assert f32.dtype == np.float32 and np.isfinite(f32).all()
    e_port = np.abs(f32 - f64).max(axis=(1, 2))
    e_jax = np.abs(j32 - f64).max(axis=(1, 2))
    for q in (50, 90):
        assert np.percentile(e_port, q) <= 1.5 * np.percentile(e_jax, q) + 0.05, (
            q, np.percentile(e_port, q), np.percentile(e_jax, q))


def test_care_matches_scipy():
    rng = np.random.default_rng(0)
    n, m = 6, 3
    j_care = jax.jit(j_linalg.care, static_argnames=("dt", "iters"))
    for _ in range(3):
        A = rng.normal(size=(n, n)) * 0.5
        B = rng.normal(size=(n, m))
        Q = np.eye(n) * rng.uniform(1, 5)
        R = np.eye(m) * rng.uniform(0.1, 1)
        P_ref = scipy.linalg.solve_continuous_are(A, B, Q, R)
        P = linalg.care(T(A), T(B), T(Q), T(R), dt=1e-4, iters=40)
        P_jax = j_care(*map(jnp.asarray, (A, B, Q, R)), dt=1e-4, iters=40)
        close(P, P_jax, rtol=1e-9, atol=1e-9 * np.abs(P_ref).max())
        np.testing.assert_allclose(P.numpy(), P_ref, rtol=2e-3, atol=1e-3)


def test_dare_fixed_point():
    rng = np.random.default_rng(1)
    n, m = 5, 2
    Ad = np.eye(n) + 0.01 * rng.normal(size=(n, n))
    Bd = 0.01 * rng.normal(size=(n, m))
    Qd = np.eye(n) * 0.01
    Rd = np.eye(m) * 0.01
    P_t = linalg.dare_doubling(T(Ad), T(Bd), T(Qd), T(Rd), 40)
    P_j = jax.jit(j_linalg.dare_doubling, static_argnums=(4,))(
        *map(jnp.asarray, (Ad, Bd, Qd, Rd)), 40)
    P = P_t.numpy()
    close(P_t, P_j, rtol=1e-9, atol=1e-9 * np.abs(P).max())
    S = Rd + Bd.T @ P @ Bd
    resid = Ad.T @ P @ Ad - P - Ad.T @ P @ Bd @ np.linalg.solve(S, Bd.T @ P @ Ad) + Qd
    assert np.abs(resid).max() < 1e-8 * max(1.0, np.abs(P).max())


def grf_both(feet, contact):
    f = vbl.reference_grf(T(feet), T(contact))
    ref = np.asarray(jax.jit(j_vbl.reference_grf)(jnp.asarray(feet), jnp.asarray(contact)))
    fz, j_fz, c = f.numpy()[..., 2], ref[..., 2], np.broadcast_to(contact, ref.shape[:-1])
    np.testing.assert_allclose(fz[c > 0], j_fz[c > 0], rtol=1e-9)
    np.testing.assert_allclose(fz[c == 0], j_fz[c == 0], atol=1e-9)
    np.testing.assert_array_equal(f.numpy()[..., :2], ref[..., :2])
    return f.numpy()


def test_reference_grf_distributes_weight():
    f = grf_both(FEET, np.ones(4))
    cfg = vbl.VBLSettings()
    assert abs(f[:, 2].sum() - cfg.mass * 9.81) < 1.0
    np.testing.assert_allclose(f[:, 2], f[0, 2], rtol=1e-6)
    np.testing.assert_allclose(f[:, 0:2], 0.0)
    f3 = grf_both(FEET, np.array([0.0, 1.0, 1.0, 1.0]))
    assert abs(f3[0, 2]) < 1e-5
    assert abs(f3[1:, 2].sum() - cfg.mass * 9.81) < 1.5
    torque = np.sum(np.cross(FEET, f3), axis=0)
    assert np.abs(torque[:2]).max() < 0.5


def test_seeded_reference_grf():
    rng = np.random.default_rng(2)
    B = 256
    feet = FEET + rng.uniform(-0.04, 0.04, (B, 4, 3))
    contact = np.ones((B, 4))
    contact[np.arange(B // 4), rng.integers(0, 4, B // 4)] = 0.0
    f = grf_both(feet, contact)
    np.testing.assert_allclose(f[..., 2].sum(-1), vbl.VBLSettings().mass * 9.81, rtol=2e-3)


def vbl_both(x_off=0.0, v_off=0.0, dtype=np.float64, **over):
    eye = np.eye(3, dtype=dtype)
    kw = dict(x_com=np.array([x_off, 0.0, 0.29], dtype), v_com=np.array([v_off, 0.0, 0.0], dtype),
              R_body=eye, omega_world=np.zeros(3, dtype), p_feet_des_rel=FEET.astype(dtype),
              x_des=np.array([0.0, 0.0, 0.29], dtype), v_des=np.zeros(3, dtype), R_des=eye,
              omega_des_world=np.zeros(3, dtype), contact=np.ones(4, dtype))
    kw.update(over)
    f = vbl.solve(**{k: T(v) for k, v in kw.items()})
    ref = _j_vbl(**{k: jnp.asarray(v) for k, v in kw.items()})
    close(f, ref, atol=F_ATOL)
    return f.numpy()


def test_vbl_equilibrium():
    f = vbl_both()
    f_ref = vbl.reference_grf(T(FEET), torch.ones(4, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(f, f_ref, atol=0.5)


def test_vbl_restoring_force():
    f = vbl_both(x_off=0.05)
    assert f[:, 0].sum() < -5.0
    cfg = vbl.VBLSettings()
    f_ref = vbl.reference_grf(T(FEET), torch.ones(4, dtype=torch.float64)).numpy()
    dfx = np.abs(f[:, 0] - f_ref[:, 0])
    assert (dfx <= cfg.mu * 0.7071 * f_ref[:, 2] + 1e-4).all()


def test_seeded_vbl_equal_reference():
    """64 seeded VBL solves: CoM, velocity, attitude and rate errors, a
    desired yaw rate, a quarter on three legs, a previous dF: the forces
    within F_ATOL of JAX's, and the CARE's P symmetric positive definite
    (the reference's solve does not return P; test_care_matches_scipy holds
    care itself to JAX's and to scipy)."""
    rng = np.random.default_rng(3)
    B = 64
    rpy = rng.uniform(-0.15, 0.15, (B, 3))
    R = np.asarray(j_rot.rpy_to_rotmat(jnp.asarray(rpy)))
    contact = np.ones((B, 4))
    contact[np.arange(B // 4), rng.integers(0, 4, B // 4)] = 0.0
    kw = dict(x_com=np.array([0, 0, 0.29]) + rng.uniform(-0.04, 0.04, (B, 3)),
              v_com=rng.uniform(-0.2, 0.2, (B, 3)), R_body=R,
              omega_world=rng.uniform(-0.4, 0.4, (B, 3)),
              p_feet_des_rel=FEET + rng.uniform(-0.03, 0.03, (B, 4, 3)),
              x_des=np.tile([0.0, 0.0, 0.29], (B, 1)), v_des=np.zeros((B, 3)),
              R_des=np.tile(np.eye(3), (B, 1, 1)),
              omega_des_world=np.stack([np.zeros(B), np.zeros(B), rng.uniform(-0.3, 0.3, B)], -1),
              contact=contact, dF_prev=rng.uniform(-2.0, 2.0, (B, 12)))
    on = {k: T(v) for k, v in kw.items()}
    f = vbl.solve(**on)
    P = vbl.variation_lqr(**{k: v for k, v in on.items() if k != "dF_prev"}).P
    ref = _j_vbl(**{k: jnp.asarray(v) for k, v in kw.items()})
    close(f, ref, atol=F_ATOL)
    assert np.isfinite(P.numpy()).all()
    # P is symmetric positive definite
    np.testing.assert_allclose(P.numpy(), P.numpy().transpose(0, 2, 1), atol=1e-12)
    assert (np.linalg.eigvalsh(P.numpy()) > 0).all()
