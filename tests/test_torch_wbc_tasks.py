"""The port's extra WBC tasks (control/wbc_tasks) against the JAX package:
the eight tests of tests/test_wbc_tasks.py, each run in both packages on the
same inputs, composed through the port's kin_wbc / wbic as extra task lists
the way the reference test composes them, then the reference test's own
gates on the port's answers; and a seeded batch of all six builders.

Tolerances (float64): the task tuples within 1e-12 of their largest
magnitude (elementwise math and 3x3 products); kin_wbc's outputs within 1e-9 and wbic's tau, Fr and qddot
within 1e-6 relative of their size (pseudo-inverses and the relaxation
PDIP summed in another order); in float32 the builders within 2e-6."""

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from quad_periodic_mpc_tpu.control import wbc as j_wbc
from quad_periodic_mpc_tpu.control import wbc_tasks as j_tasks
from quad_periodic_mpc_tpu.models import floating_base as j_fb
from quad_periodic_mpc_tpu.ops import rotations as j_rot
from quad_periodic_mpc_tpu_torch import convert
from quad_periodic_mpc_tpu_torch.control import wbc, wbc_tasks
from quad_periodic_mpc_tpu_torch.models import floating_base as fb
from quad_periodic_mpc_tpu_torch.ops.rotations import quat_to_rotmat, rpy_to_quat

CPU = "cpu"
MC = fb.build_a1_constants("float64", device=CPU)
J_MC = j_fb.build_a1_constants("float64")
ATOL = {np.dtype(np.float64): 1e-12, np.dtype(np.float32): 2e-6}


def close(t, j, atol=None, rtol=0.0):
    """Within ``atol``, by default ATOL of the leaf's largest magnitude (at
    least 1: commands reach ~50 through kp = 350)."""
    t, j = convert.to_numpy(t), np.asarray(j)
    assert t.dtype == j.dtype and t.shape == j.shape, (t.dtype, j.dtype, t.shape, j.shape)
    if atol is None:
        atol = ATOL[t.dtype] * max(1.0, float(np.abs(j).max(initial=0.0)))
    np.testing.assert_allclose(t, j, rtol=rtol, atol=atol)


def close_task(t, j):
    for tl, jl in zip(t, j):
        close(tl, jl)


def standing(h=0.29, rpy=(0.0, 0.0, 0.0)):
    """The reference test's standing state as numpy leaves, then in each
    package."""
    quat = np.asarray(j_rot.rpy_to_quat(jnp.asarray(rpy, jnp.float64)))
    leaves = dict(quat=quat, pos=np.array([0.0, 0.0, h]), v_body=np.zeros(6),
                  q=np.array([0.0, 0.8, -1.6] * 4), qd=np.zeros(12))
    return both_states(leaves)


def both_states(leaves):
    return (fb.FBState(**{k: torch.from_numpy(np.array(v)) for k, v in leaves.items()}),
            j_fb.FBState(**{k: jnp.asarray(v) for k, v in leaves.items()}))


def test_jpos_task_jacobian_and_command():
    st, j_st = standing()
    q_des = st.q + 0.1
    task = wbc_tasks.jpos_task(st, q_des, kp=50.0, kd=5.0)
    close_task(task, j_tasks.jpos_task(j_st, jnp.asarray(q_des.numpy()), kp=50.0, kd=5.0))
    J, err, vel, cmd, jdqd = task
    assert J.shape == (12, 18)
    np.testing.assert_allclose(J[:, 6:].numpy(), np.eye(12))
    np.testing.assert_allclose(J[:, :6].numpy(), 0.0)
    np.testing.assert_allclose(err.numpy(), 0.1, atol=1e-12)
    np.testing.assert_allclose(cmd.numpy(), 5.0, atol=1e-9)


def test_jpos_task_in_kinwbc_with_fixed_body():
    st, j_st = standing()
    q_des = st.q + torch.tensor([0.05, -0.03, 0.08] * 4, dtype=torch.float64)
    Jc, Jcdqd, Uf, ieq = wbc_tasks.fixed_body_contact(dtype=torch.float64, device=CPU)
    close_task((Jc, Jcdqd, Uf, ieq), j_tasks.fixed_body_contact(dtype=jnp.float64))
    task = wbc_tasks.jpos_task(st, q_des)
    j_task = j_tasks.jpos_task(j_st, jnp.asarray(q_des.numpy()))
    des_jpos, des_jvel = wbc.kin_wbc(st, Jc, [task[0]], [task[1]], [task[2]], wbc.WBCGains())
    j_pos, j_vel = jax.jit(j_wbc.kin_wbc, static_argnums=(5,))(
        j_st, jnp.asarray(Jc.numpy()), [j_task[0]], [j_task[1]], [j_task[2]], j_wbc.WBCGains())
    close(des_jpos, j_pos, atol=1e-9)
    close(des_jvel, j_vel, atol=1e-9)
    np.testing.assert_allclose(des_jpos.numpy(), q_des.numpy(), atol=1e-3)
    np.testing.assert_allclose(des_jvel.numpy(), 0.0, atol=1e-9)


def test_fixed_body_contact_shapes():
    out = wbc_tasks.fixed_body_contact((5,), torch.float64, CPU)
    close_task(out, j_tasks.fixed_body_contact((5,), jnp.float64))
    Jc, Jcdqd, Uf, ieq = out
    assert Jc.shape == (5, 6, 18)
    np.testing.assert_allclose(Jc[0, :, :6].numpy(), np.eye(6))
    assert Jcdqd.shape == (5, 6)
    np.testing.assert_allclose(Uf.numpy(), 0.0)
    np.testing.assert_allclose(ieq.numpy(), 0.0)


def test_body_ryrz_leaves_roll_free():
    st, j_st = standing(rpy=(0.3, 0.0, 0.0))
    task = wbc_tasks.body_ryrz_task_rpy(st, torch.zeros(3, dtype=torch.float64))
    close_task(task, j_tasks.body_ryrz_task_rpy(j_st, jnp.zeros(3)))
    J, err, vel, cmd, _ = task
    np.testing.assert_allclose(err.numpy(), 0.0, atol=1e-9)
    np.testing.assert_allclose(cmd.numpy(), 0.0, atol=1e-7)
    assert J.shape == (2, 18)
    np.testing.assert_allclose(J[0].numpy(), np.eye(18)[1])
    np.testing.assert_allclose(J[1].numpy(), np.eye(18)[2])
    st2, j_st2 = standing(rpy=(0.0, 0.2, -0.1))
    task2 = wbc_tasks.body_ryrz_task_rpy(st2, torch.zeros(3, dtype=torch.float64))
    close_task(task2, j_tasks.body_ryrz_task_rpy(j_st2, jnp.zeros(3)))
    np.testing.assert_allclose(task2[1].numpy(), [-0.2, 0.1], atol=0.01)


def test_local_pos_task_jacobian_consistency():
    rng = np.random.default_rng(0)
    st, _ = standing()
    leaves = {f: getattr(st, f).numpy() for f in fb.FBState._fields}
    leaves["qd"] = rng.uniform(-0.5, 0.5, 12)
    leaves["v_body"] = rng.uniform(-0.2, 0.2, 6)
    st, j_st = both_states(leaves)
    info = fb.contact_jacobians(st, MC)
    j_info = j_fb.contact_jacobians(j_st, J_MC)
    rel_des = info.p_foot[0] - info.p_foot[1]
    task = wbc_tasks.local_pos_task(st, info, 0, 1, rel_des)
    close_task(task, j_tasks.local_pos_task(j_st, j_info, 0, 1,
                                            j_info.p_foot[0] - j_info.p_foot[1]))
    J, err = task[0], task[1]
    np.testing.assert_allclose(err.numpy(), 0.0, atol=1e-12)
    # finite difference of the relative foot position along the generalized velocity
    from quad_periodic_mpc_tpu_torch.estimation.orientation import quat_product

    eps = 1e-6
    dq = 0.5 * quat_product(st.quat, torch.cat([torch.zeros(1, dtype=torch.float64),
                                                st.v_body[:3]]))
    st2 = fb.FBState(quat=st.quat + eps * dq,
                     pos=st.pos + eps * quat_to_rotmat(st.quat) @ st.v_body[3:6],
                     v_body=st.v_body, q=st.q + eps * st.qd, qd=st.qd)
    info2 = fb.contact_jacobians(st2, MC)
    v_fd = ((info2.p_foot[0] - info2.p_foot[1]) - (info.p_foot[0] - info.p_foot[1])) / eps
    v_task = J @ torch.cat([st.v_body, st.qd])
    np.testing.assert_allclose(v_task.numpy(), v_fd.numpy(), atol=1e-4)


def _wbic_both(st, j_st, tasks, j_tasks_):
    """wbic with the extra task list in both packages; returns the port's
    (tau, fr, qddot)."""
    A = fb.mass_matrix(st, MC)
    args = (A, torch.linalg.inv(A), fb.generalized_coriolis(st, MC),
            fb.generalized_gravity(st, MC))
    info = fb.contact_jacobians(st, MC)
    j_A = j_fb.mass_matrix(j_st, J_MC)
    j_args = (j_A, jnp.linalg.inv(j_A), j_fb.generalized_coriolis(j_st, J_MC),
              j_fb.generalized_gravity(j_st, J_MC))
    j_info = j_fb.contact_jacobians(j_st, J_MC)
    p = fb.A1ModelParams()
    m_tot = p.body_mass + 4 * (p.abad_mass + p.hip_mass + p.knee_mass + 3 * p.rotor_mass)
    batch = st.pos.shape[:-1]
    fr_des = np.zeros(batch + (4, 3))
    fr_des[..., 2] = m_tot * 9.81 / 4
    mask = np.ones(batch + (4,))
    out = wbc.wbic(st, *args, info.Jc, info.Jcdqd, [t[0] for t in tasks], [t[3] for t in tasks],
                   [t[4] for t in tasks], torch.from_numpy(fr_des), torch.from_numpy(mask),
                   wbc.WBCGains())
    ref = jax.jit(j_wbc.wbic, static_argnums=(12,))(
        j_st, *j_args, j_info.Jc, j_info.Jcdqd, [t[0] for t in j_tasks_],
        [t[3] for t in j_tasks_], [t[4] for t in j_tasks_], jnp.asarray(fr_des),
        jnp.asarray(mask), j_wbc.WBCGains())
    for tl, jl in zip(out, ref):
        scale = max(1.0, float(np.abs(np.asarray(jl)).max()))
        close(tl, jl, atol=1e-6 * scale)
    return out, fr_des


def test_variants_compose_in_wbic():
    st, j_st = standing()
    tasks = [wbc_tasks.body_ryrz_task_rpy(st, torch.zeros(3, dtype=torch.float64)),
             wbc_tasks.jpos_task(st, st.q)]
    j_tl = [j_tasks.body_ryrz_task_rpy(j_st, jnp.zeros(3)), j_tasks.jpos_task(j_st, j_st.q)]
    (tau, fr, qddot), fr_des = _wbic_both(st, j_st, tasks, j_tl)
    assert np.abs(qddot.numpy()).max() < 5.0
    assert np.isfinite(tau.numpy()).all()
    np.testing.assert_allclose(fr.numpy().reshape(4, 3)[:, 2], fr_des[:, 2], rtol=0.5)


def test_body_posture_task_six_dof():
    st, j_st = standing(rpy=(0.0, 0.1, 0.0))
    quat_des = rpy_to_quat(torch.zeros(3, dtype=torch.float64))
    pos_des = st.pos + torch.tensor([0.0, 0.0, 0.02], dtype=torch.float64)
    task = wbc_tasks.body_posture_task(st, quat_des, pos_des)
    close_task(task, j_tasks.body_posture_task(j_st, jnp.asarray(quat_des.numpy()),
                                               jnp.asarray(pos_des.numpy())))
    J, err = task[0], task[1]
    assert J.shape == (6, 18)
    R = quat_to_rotmat(st.quat).numpy()
    np.testing.assert_allclose(J[0:3, 0:3].numpy(), R, atol=1e-12)
    np.testing.assert_allclose(J[3:6, 3:6].numpy(), R, atol=1e-12)
    np.testing.assert_allclose(J[:, 6:].numpy(), 0.0)
    assert abs(float(err[1]) + 0.1) < 5e-3
    np.testing.assert_allclose(float(err[5]), 0.02, atol=1e-9)


def test_local_roll_task_scalar():
    st, j_st = standing(rpy=(0.15, 0.0, 0.0))
    task = wbc_tasks.local_roll_task(st, torch.tensor(0.0, dtype=torch.float64))
    close_task(task, j_tasks.local_roll_task(j_st, jnp.asarray(0.0)))
    J, err, vel, cmd, _ = task
    assert J.shape == (1, 18)
    np.testing.assert_allclose(J[0].numpy(), np.eye(18)[0])
    np.testing.assert_allclose(float(err[0]), -0.15, atol=1e-7)
    np.testing.assert_allclose(float(cmd[0]), 350.0 * -0.15, atol=1e-4)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_seeded_builders_equal_reference(dtype):
    """The six builders on 64 seeded states (tilted, moving, bent legs) and
    desired poses; in float64 a composition without redundant rows (pitch
    and yaw, then roll, then a foot relative to another) through wbic
    beside JAX's.  A list that repeats a task's rows leaves a near-zero
    projected Jacobian whose damped pseudo-inverse amplifies roundoff by
    the inverse damping, in either package."""
    rng = np.random.default_rng(6)
    B = 64
    rpy = rng.uniform(-0.3, 0.3, (B, 3))
    leaves = dict(quat=np.asarray(j_rot.rpy_to_quat(jnp.asarray(rpy))),
                  pos=np.array([0.0, 0.0, 0.29]) + rng.uniform(-0.02, 0.02, (B, 3)),
                  v_body=rng.uniform(-0.3, 0.3, (B, 6)),
                  q=np.tile([0.0, 0.8, -1.6], 4) + rng.uniform(-0.2, 0.2, (B, 12)),
                  qd=rng.uniform(-1.0, 1.0, (B, 12)))
    leaves = {k: v.astype(dtype) for k, v in leaves.items()}
    st, j_st = both_states(leaves)
    mc = fb.build_a1_constants(np.dtype(dtype).name, device=CPU)
    j_mc = j_fb.build_a1_constants(np.dtype(dtype).name)
    info, j_info = fb.contact_jacobians(st, mc), j_fb.contact_jacobians(j_st, j_mc)
    close(info.Jc, j_info.Jc, atol=ATOL[np.dtype(dtype)] * 10)
    T, J = (lambda a: torch.from_numpy(np.array(a))), jnp.asarray
    q_des = (leaves["q"] + 0.05).astype(dtype)
    rpy_des = rng.uniform(-0.1, 0.1, (B, 3)).astype(dtype)
    quat_des = np.asarray(j_rot.rpy_to_quat(J(rpy_des)))
    pos_des = (leaves["pos"] + 0.01).astype(dtype)
    rel = (np.asarray(j_info.p_foot[:, 2] - j_info.p_foot[:, 3]) + 0.01).astype(dtype)
    roll = rng.uniform(-0.1, 0.1, B).astype(dtype)
    tasks = [wbc_tasks.jpos_task(st, T(q_des)), wbc_tasks.body_ryrz_task(st, T(quat_des)),
             wbc_tasks.body_ryrz_task_rpy(st, T(rpy_des)),
             wbc_tasks.local_pos_task(st, convert.contact_info(j_info, CPU), 2, 3, T(rel)),
             wbc_tasks.body_posture_task(st, T(quat_des), T(pos_des)),
             wbc_tasks.local_roll_task(st, T(roll))]
    j_tl = [j_tasks.jpos_task(j_st, J(q_des)), j_tasks.body_ryrz_task(j_st, J(quat_des)),
            j_tasks.body_ryrz_task_rpy(j_st, J(rpy_des)),
            j_tasks.local_pos_task(j_st, j_info, 2, 3, J(rel)),
            j_tasks.body_posture_task(j_st, J(quat_des), J(pos_des)),
            j_tasks.local_roll_task(j_st, J(roll))]
    for t, j in zip(tasks, j_tl):
        close_task(t, j)
    if dtype == np.float64:
        pick = [1, 5, 3]
        (tau, fr, qddot), _ = _wbic_both(st, j_st, [tasks[i] for i in pick],
                                         [j_tl[i] for i in pick])
        assert np.isfinite(tau.numpy()).all()


def _perturbed_stances(B=512, seed=0):
    """B standing states on the ground, each perturbed in position, joint
    angles and velocity, as numpy float64 leaves."""
    from quad_periodic_mpc_tpu_torch.sim import articulated_sim as art

    rng = np.random.default_rng(seed)
    s = art.init_on_ground((B,), penetration=3.8e-3, dtype=torch.float64, device=CPU).fb
    return dict(quat=s.quat.numpy(), pos=s.pos.numpy() + rng.uniform(-0.005, 0.005, (B, 3)),
                v_body=rng.uniform(-0.005, 0.005, (B, 6)),
                q=s.q.numpy() + rng.uniform(-0.01, 0.01, (B, 12)), qd=s.qd.numpy())


def _wbic_ref_list(leaves, dtype):
    """wbic with the reference test's list (RyRz, then the joint task at the
    current q, tests/test_wbc_tasks.py:130) on the given leaves in ``dtype``:
    the port's tau and JAX's (XLA path), numpy."""
    from quad_periodic_mpc_tpu.ops import linalg as j_linalg
    from quad_periodic_mpc_tpu_torch.control.force_stand import total_mass
    from quad_periodic_mpc_tpu_torch.ops import linalg

    leaves = {k: np.asarray(v, dtype) for k, v in leaves.items()}
    st, j_st = both_states(leaves)
    name = np.dtype(dtype).name
    mc, j_mc = fb.build_a1_constants(name, device=CPU), j_fb.build_a1_constants(name)
    B = leaves["pos"].shape[0]
    fr_des = np.zeros((B, 4, 3), dtype)
    fr_des[..., 2] = total_mass() * 9.81 / 4
    mask = np.ones((B, 4), dtype)
    quat_des = np.tile(np.array([1.0, 0.0, 0.0, 0.0], dtype), (B, 1))

    A, info = fb.mass_matrix(st, mc), fb.contact_jacobians(st, mc)
    tl = [wbc_tasks.body_ryrz_task(st, torch.from_numpy(quat_des)), wbc_tasks.jpos_task(st, st.q)]
    tau = wbc.wbic(st, A, linalg.spd_inverse(A), fb.generalized_coriolis(st, mc),
                   fb.generalized_gravity(st, mc), info.Jc, info.Jcdqd, [t[0] for t in tl],
                   [t[3] for t in tl], [t[4] for t in tl], torch.from_numpy(fr_des),
                   torch.from_numpy(mask), wbc.WBCGains())[0].numpy()
    j_A, j_info = j_fb.mass_matrix(j_st, j_mc), j_fb.contact_jacobians(j_st, j_mc)
    j_tl = [j_tasks.body_ryrz_task(j_st, jnp.asarray(quat_des)), j_tasks.jpos_task(j_st, j_st.q)]
    j_tau = jax.jit(j_wbc.wbic, static_argnums=(12,))(
        j_st, j_A, j_linalg.spd_inverse(j_A), j_fb.generalized_coriolis(j_st, j_mc),
        j_fb.generalized_gravity(j_st, j_mc), j_info.Jc, j_info.Jcdqd, [t[0] for t in j_tl],
        [t[3] for t in j_tl], [t[4] for t in j_tl], jnp.asarray(fr_des), jnp.asarray(mask),
        j_wbc.WBCGains())[0]
    return tau, np.asarray(j_tau)


def _rel(a, ref):
    """Each instance's largest |a - ref| over its largest |ref| (at least 1)."""
    return np.abs(a - ref).max(-1) / np.maximum(np.abs(ref).max(-1), 1.0)


def test_wbic_reference_list_float32_finite_like_jax():
    """The reference test's task list on 512 perturbed stances (seed 0).
    Its damped Gram reaches cond ~1e6.  The port inverts it in the
    symmetric form (control/wbc._damped_pinv): its float32 torques are
    finite wherever JAX's are (everywhere; in the two-triangle form the
    port's went NaN on instance 114, where JAX gave tau[0] 2.632 against
    float64's 2.730), and lie within 0.2 of float64 (0.0165 on one thread,
    0.13 on four; median 6.9e-4), no farther than JAX's float32 (up to 160x
    its size from float64, median 0.022).  In float64 a 1e-14 relative
    change of q moves the port's torques by under 1e-6 (measured 8.5e-9)."""
    leaves = _perturbed_stances()
    tau32, j_tau32 = _wbic_ref_list(leaves, np.float32)
    np.testing.assert_array_equal(np.isfinite(tau32).all(-1), np.isfinite(j_tau32).all(-1))
    assert np.isfinite(tau32).all()
    tau64, _ = _wbic_ref_list(leaves, np.float64)
    err = _rel(tau32.astype(np.float64), tau64)
    j_err = _rel(j_tau32.astype(np.float64), tau64)
    print(f"float32 from float64: port max {err.max():.3g} median {np.median(err):.3g}, "
          f"JAX max {j_err.max():.3g} median {np.median(j_err):.3g}")
    assert err.max() < 0.2 and np.median(err) < 2e-3, (err.max(), np.median(err))
    assert err.max() <= j_err.max()
    moved, _ = _wbic_ref_list(dict(leaves, q=leaves["q"] * (1 + 1e-14)), np.float64)
    assert _rel(moved, tau64).max() < 1e-6, _rel(moved, tau64).max()
