"""The port's pose behaviors, signal filters and plan playback against the
JAX package: the six pose and filter tests of tests/test_poses_filters.py,
the three of tests/test_playback.py, a plan saved by each package and loaded
by the other, and seeded batches.  Each runs the JAX function (jitted) on
the same inputs.

Tolerances: the poses, the playback and the first-order and moving-average
filters compute the same float operations: 1e-6 (float32) and 1e-12
(float64) absolute.  The biquad (make_digital_lp): the reference builds its
coefficients as numpy float64 scalars, so under the tests' 64-bit mode its
float32 inputs come out float64 while the port computes in its input's
dtype (as JAX does without 64-bit mode, as on the TPU).  Its float64 inputs
are held to 1e-12; its float32 outputs to the float64 reference within
2e-5 relative to the signal's peak (float32 rounding of the states through
the filter's recursion), and their dtype is float32."""

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from quad_periodic_mpc_tpu.control import playback as j_pb
from quad_periodic_mpc_tpu.control import poses as j_poses
from quad_periodic_mpc_tpu.utils import filters as j_filters
from quad_periodic_mpc_tpu_torch import convert
from quad_periodic_mpc_tpu_torch.control import playback, poses
from quad_periodic_mpc_tpu_torch.utils import filters

CPU = "cpu"
ATOL = {np.dtype(np.float32): 1e-6, np.dtype(np.float64): 1e-12}


def close(t, j, atol=None):
    t, j = convert.to_numpy(t), np.asarray(j)
    assert t.dtype == j.dtype and t.shape == j.shape, (t.dtype, j.dtype, t.shape, j.shape)
    if t.dtype.kind in "biu":
        np.testing.assert_array_equal(t, j)
    else:
        np.testing.assert_allclose(t, j, rtol=0, atol=ATOL[t.dtype] if atol is None else atol)


def close_tuple(t, j):
    for tl, jl in zip(t, j):
        close(tl, jl)


def test_pose_tables_equal_reference():
    assert poses.FOLD_JPOS == j_poses.FOLD_JPOS
    assert poses.STAND_JPOS == j_poses.STAND_JPOS
    assert poses.ROLL_JPOS == j_poses.ROLL_JPOS
    assert (playback.PLAN_COLS, playback.TAU_OFFSET) == (j_pb.PLAN_COLS, j_pb.TAU_OFFSET)


def test_stand_up_ramp():
    ini = np.array([[0.0, -0.08, -0.1]] * 4, np.float32)
    R = np.eye(3, dtype=np.float32)
    outs = {}
    for tt in (0.0, 1.0, 2.0):
        out = poses.stand_up_impedance(torch.tensor(tt), torch.from_numpy(ini),
                                       torch.from_numpy(R))
        ref = jax.jit(j_poses.stand_up_impedance)(jnp.asarray(tt, jnp.float32),
                                                  jnp.asarray(ini), jnp.asarray(R))
        close_tuple(out, ref)
        outs[tt] = out
    np.testing.assert_allclose(outs[0.0].p_des.numpy(), ini, atol=1e-7)
    np.testing.assert_allclose(outs[2.0].p_des.numpy()[:, 2], -0.33, atol=1e-7)
    np.testing.assert_allclose(outs[2.0].force_ff.numpy()[:, 2], -6.0 * 9.81 / 4, atol=1e-5)
    np.testing.assert_allclose(outs[1.0].p_des.numpy()[:, 2], 0.5 * (-0.33) + 0.5 * (-0.1),
                               atol=1e-6)


def test_recovery_ramps():
    q0 = np.zeros((4, 3), np.float32)
    mid = poses.joint_ramp(torch.tensor(0.5), torch.from_numpy(q0), "fold", 1.0)
    close_tuple(mid, j_poses.joint_ramp(jnp.asarray(0.5, jnp.float32), jnp.asarray(q0),
                                        "fold", 1.0))
    np.testing.assert_allclose(mid.q_des.numpy()[0], [0.0, -0.7, 1.35], atol=1e-6)
    end = poses.joint_ramp(torch.tensor(2.0), torch.from_numpy(q0), "stand", 1.0)
    close_tuple(end, j_poses.joint_ramp(jnp.asarray(2.0, jnp.float32), jnp.asarray(q0),
                                        "stand", 1.0))
    np.testing.assert_allclose(end.q_des.numpy()[0], [0.0, -0.8, 1.6], atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_seeded_poses_equal_reference(dtype):
    """The three pose generators on 256 seeded instances (times past both
    ends of each ramp, random body rotations, all three named recovery
    poses and a tensor target)."""
    rng = np.random.default_rng(31)
    B = 256
    t = rng.uniform(-0.5, 2.5, B).astype(dtype)
    feet = rng.uniform(-0.3, 0.1, (B, 4, 3)).astype(dtype)
    q, _ = np.linalg.qr(rng.normal(size=(B, 3, 3)))
    R = q.astype(dtype)
    z0 = rng.uniform(-0.15, -0.05, (B, 4)).astype(dtype)
    T, J = (lambda a: torch.from_numpy(a)), jnp.asarray
    close_tuple(poses.stand_up_impedance(T(t), T(feet), T(R)),
                jax.jit(j_poses.stand_up_impedance)(J(t), J(feet), J(R)))
    close_tuple(poses.lay_down(T(t), T(feet), T(z0)),
                jax.jit(j_poses.lay_down)(J(t), J(feet), J(z0)))
    for target in ("fold", "stand", "rollover"):
        close_tuple(poses.joint_ramp(T(t), T(feet), target, 1.5),
                    j_poses.joint_ramp(J(t), J(feet), target, 1.5))
    close_tuple(poses.joint_ramp(T(t), T(feet), T(feet[::-1].copy()), 0.7),
                j_poses.joint_ramp(J(t), J(feet), J(feet[::-1].copy()), 0.7))


def test_first_order_lp():
    st, j_st = filters.LowPassState(torch.tensor(0.0)), j_filters.LowPassState(
        jnp.asarray(0.0, jnp.float32))
    j_lp = jax.jit(j_filters.first_order_lp)
    for _ in range(100):
        st, y = filters.first_order_lp(st, torch.tensor(1.0), 0.1)
        j_st, j_y = j_lp(j_st, jnp.asarray(1.0, jnp.float32), 0.1)
        close(y, j_y)
    assert abs(float(y) - 1.0) < 1e-4


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_digital_lp_dc_gain(dtype):
    init, step = filters.make_digital_lp(w_c=50.0, t_s=0.002)
    j_init, j_step = j_filters.make_digital_lp(w_c=50.0, t_s=0.002)
    j_step = jax.jit(j_step)
    st, j_st = init(dtype=getattr(torch, np.dtype(dtype).name), device=CPU), j_init(dtype=dtype)
    for _ in range(500):
        st, y = step(st, torch.tensor(2.5, dtype=st.x1.dtype))
        j_st, j_y = j_step(j_st, jnp.asarray(2.5, dtype))
        if dtype == np.float64:
            close(y, j_y)
        else:
            # the reference promotes float32 to float64 here (module docstring)
            assert y.dtype == torch.float32 and np.asarray(j_y).dtype == np.float64
            np.testing.assert_allclose(float(y), float(j_y), rtol=0, atol=2e-5 * 2.5)
    assert abs(float(y) - 2.5) < 1e-3


def test_deriv_lp_of_ramp():
    init, step = filters.make_deriv_lp(w_c=100.0, t_s=0.001)
    j_init, j_step = j_filters.make_deriv_lp(w_c=100.0, t_s=0.001)
    j_step = jax.jit(j_step)
    st, j_st = init(device=CPU), j_init()
    for k in range(2000):
        st, y = step(st, torch.tensor(k * 0.001))
        j_st, j_y = j_step(j_st, jnp.asarray(k * 0.001, jnp.float32))
        # its coefficients are Python floats in both: float32 stays float32
        close(y, j_y, atol=1e-6 * max(1.0, abs(float(j_y))))
    assert abs(float(y) - 1.0) < 0.05


def test_moving_average_warmup():
    st, j_st = filters.moving_average_init(4, device=CPU), j_filters.moving_average_init(4)
    close_tuple(st, j_st)
    outs = []
    for v in [4.0, 8.0, 0.0, 0.0, 0.0, 0.0]:
        st, y = filters.moving_average(st, torch.tensor(v))
        j_st, j_y = j_filters.moving_average(j_st, jnp.asarray(v, jnp.float32))
        close(y, j_y)
        close_tuple(st, j_st)
        outs.append(float(y))
    assert outs[0] == 4.0
    assert outs[1] == 6.0
    assert outs[-1] == 0.0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_seeded_filters_equal_reference(dtype):
    """Every filter over 300 ticks of a seeded noisy signal at B = 64."""
    rng = np.random.default_rng(9)
    B, n = 64, 300
    x = (np.sin(np.arange(n)[:, None] * 0.05 + rng.uniform(0, 6, B))
         + 0.1 * rng.normal(size=(n, B))).astype(dtype)
    tdt = getattr(torch, np.dtype(dtype).name)
    lp, j_lp = filters.LowPassState(torch.zeros(B, dtype=tdt)), j_filters.LowPassState(
        jnp.zeros(B, dtype))
    bi_init, bi = filters.make_digital_lp(30.0, 0.002)
    jbi_init, jbi = j_filters.make_digital_lp(30.0, 0.002)
    de_init, de = filters.make_deriv_lp(60.0, 0.002)
    jde_init, jde = j_filters.make_deriv_lp(60.0, 0.002)
    b, j_b = bi_init((B,), tdt, CPU), jbi_init((B,), dtype)
    d, j_d = de_init((B,), tdt, CPU), jde_init((B,), dtype)
    m, j_m = filters.moving_average_init(7, (B,), tdt, CPU), j_filters.moving_average_init(
        7, (B,), dtype)
    j_all = jax.jit(lambda lp, b, d, m, xk: (j_filters.first_order_lp(lp, xk, 0.2), jbi(b, xk),
                                             jde(d, xk), j_filters.moving_average(m, xk)))
    for k in range(n):
        xk = torch.from_numpy(x[k])
        (lp, y1), (b, y2), (d, y3), (m, y4) = (filters.first_order_lp(lp, xk, 0.2), bi(b, xk),
                                                de(d, xk), filters.moving_average(m, xk))
        (j_lp, j1), (j_b, j2), (j_d, j3), (j_m, j4) = j_all(j_lp, j_b, j_d, j_m,
                                                             jnp.asarray(x[k]))
        close(y1, j1)
        close(y4, j4)
        close(y3, j3, atol=ATOL[np.dtype(dtype)] * 100)  # |y| ~ 1 / dt-scaled slope
        if dtype == np.float64:
            close(y2, j2)
        else:
            assert y2.dtype == torch.float32
            np.testing.assert_allclose(y2.numpy(), np.asarray(j2), rtol=0, atol=2e-5 * 1.3)


def test_plan_roundtrip(tmp_path):
    plan = playback.synthesize_jump_plan(200)
    np.testing.assert_array_equal(plan, j_pb.synthesize_jump_plan(200))
    path = tmp_path / "test_plan.dat"
    playback.save_plan(str(path), plan)
    loaded = playback.load_plan(str(path), device=CPU)
    np.testing.assert_allclose(loaded.numpy(), plan, atol=1e-7)
    close(loaded, j_pb.load_plan(str(path)))


def test_plan_saved_by_each_loads_in_the_other(tmp_path):
    plan = j_pb.synthesize_jump_plan(321)
    j_path, t_path = tmp_path / "jax.dat", tmp_path / "torch.dat"
    j_pb.save_plan(str(j_path), plan)
    playback.save_plan(str(t_path), torch.from_numpy(plan))
    assert j_path.read_bytes() == t_path.read_bytes()
    close(playback.load_plan(str(j_path), device=CPU), j_pb.load_plan(str(t_path)))
    bad = tmp_path / "bad.dat"
    np.zeros(23, np.float32).tofile(bad)
    with pytest.raises(ValueError):
        playback.load_plan(str(bad), device=CPU)


def test_playback_phases():
    plan_np = playback.synthesize_jump_plan(800)
    plan, j_plan = torch.from_numpy(plan_np), jnp.asarray(plan_np)
    out = playback.playback_command(plan, 350)
    close_tuple(out, j_pb.playback_command(j_plan, 350))
    row = plan_np[350]
    np.testing.assert_allclose(out.q_des.numpy()[0], [0.0, row[3], row[4]], atol=1e-6)
    np.testing.assert_allclose(out.tau_ff.numpy()[0, 1], 1.2 * row[14] / 2.0, atol=1e-6)
    np.testing.assert_allclose(out.kp_joint.numpy(), 10.0)
    prep = playback.playback_command(plan, 350, preparation=True)
    close_tuple(prep, j_pb.playback_command(j_plan, 350, preparation=True))
    np.testing.assert_allclose(prep.tau_ff.numpy(), 0.0, atol=1e-9)
    out_end = playback.playback_command(plan, 650)
    close_tuple(out_end, j_pb.playback_command(j_plan, 650))
    np.testing.assert_allclose(out_end.q_des.numpy()[0], [-0.2, -0.8425, 1.70], atol=1e-5)
    np.testing.assert_allclose(out_end.q_des.numpy()[3], [0.2, -1.0525, 1.65], atol=1e-5)
    np.testing.assert_allclose(out_end.kp_joint.numpy(), 25.0)
    np.testing.assert_allclose(out_end.tau_ff.numpy(), 0.0, atol=1e-9)


def test_playback_batched():
    plan_np = playback.synthesize_jump_plan(800)
    plan = torch.from_numpy(plan_np)
    its = np.array([0, 350, 650, 900], np.int32)
    out = playback.playback_command(plan, torch.from_numpy(its))
    close_tuple(out, jax.jit(j_pb.playback_command)(jnp.asarray(plan_np), jnp.asarray(its)))
    assert out.q_des.shape == (4, 4, 3)
    np.testing.assert_allclose(out.q_des[3].numpy(),
                               playback.playback_command(plan, 799).q_des.numpy(), atol=1e-6)


def test_playback_seeded_equal_reference():
    """Every iteration of a 700-row plan (so the ramp's row is clamped too)
    and past both ends, with preparation on a seeded half."""
    rng = np.random.default_rng(4)
    plan_np = playback.synthesize_jump_plan(700)
    its = np.arange(-5, 760, dtype=np.int32)
    prep = rng.uniform(size=its.size) > 0.5
    out = playback.playback_command(torch.from_numpy(plan_np), torch.from_numpy(its),
                                    torch.from_numpy(prep))
    ref = jax.jit(j_pb.playback_command)(jnp.asarray(plan_np), jnp.asarray(its),
                                         jnp.asarray(prep))
    close_tuple(out, ref)
