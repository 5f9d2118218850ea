"""The port's ``mpc_step`` off the fused-build branch, against the JAX
package: the predictive disturbance horizon (per-step c), ``ground_truth_z``,
``backend="xla"``, float64 and the long horizons, from ``mpc_step`` itself
and through ``loop.rollout`` and ``full_stack.controller_tick``.

Both packages start from the same state (built by the JAX package and
carried across with quad_periodic_mpc_tpu_torch/convert.py).  JAX runs its
XLA stagewise path; the port runs its scan path (``backend="xla"``) or the
plain versions of the caller-built kernels (``backend="pallas"`` on CPU
tensors).  The estimator uses a short window (48 samples, released at 48)
that starts three samples short of release, so a four-period rollout
crosses release: before it the predicted wrench is zero, after it varies
over the horizon.
"""

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from quad_periodic_mpc_tpu import config as jc
from quad_periodic_mpc_tpu.control import loop as j_loop
from quad_periodic_mpc_tpu.control import mpc as j_mpc
from quad_periodic_mpc_tpu.ops import gait as j_gait
from quad_periodic_mpc_tpu.sim import srb_sim as j_sim
from quad_periodic_mpc_tpu_torch import config as tc
from quad_periodic_mpc_tpu_torch import convert
from quad_periodic_mpc_tpu_torch.control import full_stack as t_fs
from quad_periodic_mpc_tpu_torch.control import loop as t_loop
from quad_periodic_mpc_tpu_torch.control import mpc as t_mpc
from quad_periodic_mpc_tpu_torch.models import floating_base as t_fb
from quad_periodic_mpc_tpu_torch.ops import qp_stagewise as t_qp
from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel as TK
from quad_periodic_mpc_tpu_torch.sim import articulated_sim as t_art
from quad_periodic_mpc_tpu_torch.sim import srb_sim as t_sim

B, H, ITERS, VX, WINDOW = 3, 10, 30, 0.3, 48
F32 = jnp.float32
EST = dict(window=WINDOW, ls_release=WINDOW, predictive=True)


def _jax_setup(count, dtype=F32, horizon=H, batch=B):
    """The walking trot of tests/test_torch_mpc.py with a 48-sample
    estimator window holding a clear 0.33 Hz residual and ``count`` samples
    pushed."""
    plant = j_sim.init_plant((batch,), body_height=0.29, dtype=dtype)
    rng = np.random.default_rng(33)
    x = np.asarray(plant.x).copy()
    x[:, 0:3] += rng.uniform(-0.03, 0.03, (batch, 3))
    x[:, 9:12] += rng.uniform(-0.1, 0.1, (batch, 3))
    plant = plant._replace(x=jnp.asarray(x, dtype))
    obs = j_sim.observe(plant)
    ctrl = j_mpc.init_state((batch,), obs, window=WINDOW, dtype=dtype, horizon=horizon,
                            formulation="stagewise")
    times = 1.0 + 0.026 * np.arange(WINDOW)[None, :] + np.zeros((batch, 1))
    diffs = -1.0 + 1.25 * np.sin(2 * np.pi * 0.33 * times)
    est = ctrl.est._replace(times=jnp.asarray(times, dtype), diffs=jnp.asarray(diffs, dtype),
                            count=jnp.full((batch,), count, jnp.int32))
    ctrl = ctrl._replace(
        iteration=(jnp.arange(batch, dtype=jnp.int32) * 7) % 208,
        x_vel_des=jnp.full((batch,), VX, dtype), est=est)
    plant = plant._replace(t=jnp.full((batch,), 1.0 + 0.026 * WINDOW, dtype))
    cmd = j_mpc.Command(
        vx=jnp.full((batch,), VX, dtype), vy=jnp.zeros((batch,), dtype),
        yaw_rate=jnp.zeros((batch,), dtype), body_height=jnp.full((batch,), 0.29, dtype))
    return plant, ctrl, cmd, j_gait.preset("trotting"), j_sim.DisturbanceParams.reference(
        (batch,), dtype=dtype)


def _port(plant, ctrl, cmd, gait, dist):
    return (convert.plant_state(plant, "cpu"), convert.controller_state(ctrl, "cpu"),
            convert.command(cmd, "cpu"), convert.gait_params(gait, "cpu"),
            convert.disturbance(dist, "cpu"))


def _cfgs(mod, backend="xla", horizon=H, iters=ITERS, **est):
    return (mod.MPCConfig(horizon=horizon), mod.LoopConfig(),
            mod.EstimatorConfig(**{**EST, **est}),
            mod.ADMMConfig(iterations=iters, backend=backend, formulation="stagewise"))


def _np(a):
    return np.asarray(a)


def _jax_step(ctrl, plant, cmd, gait, cfgs, **kw):
    """The JAX package's setup_command + mpc_step on the plant's observation,
    as one jitted program (run op by op it takes several times as long)."""
    mj, lj, ej, sj = cfgs
    return jax.jit(lambda c, p: j_mpc.mpc_step(
        j_mpc.setup_command(c, cmd, lj), j_sim.observe(p), cmd, gait, p.t, mj, lj, ej, sj,
        **kw))(ctrl, plant)


def test_predictive_rollout_matches_jax_across_release():
    """loop.rollout for 4 MPC periods with the predictive estimator on the
    XLA / scan path, starting 3 samples short of release.  Tolerances as the
    non-predictive rollout test's: plant state 1e-4, forces 2e-3 N (two f32
    implementations of the same solve, sums in another order), the released
    wrench 1e-4.  Then one audited step: the problem that was solved has a
    per-step c that varies over the horizon and equals JAX's to 1e-5."""
    start = _jax_setup(count=WINDOW - 3)
    mj, lj, ej, sj = _cfgs(jc)
    mt, lt, et, st = _cfgs(tc)
    carry_j, tr_j = j_loop.rollout(4, *start, mj, lj, ej, sj)
    carry_t, tr_t = t_loop.rollout(4, *_port(*start), mt, lt, et, st)
    f_j = _np(tr_j.f_est)                                    # (B, 4, 6)
    assert np.all(f_j[:, :2] == 0.0) and np.abs(f_j[:, 3, 3]).min() > 0.1   # crossed release
    np.testing.assert_allclose(tr_t.f_est.numpy(), f_j, atol=1e-4)
    np.testing.assert_allclose(tr_t.x.numpy(), _np(tr_j.x), atol=1e-4)
    np.testing.assert_allclose(tr_t.forces.numpy(), _np(tr_j.forces), atol=2e-3)
    np.testing.assert_allclose(carry_t.ctrl.warm_z.numpy(), _np(carry_j.ctrl.warm_z), atol=2e-3)

    _, forces_j, qp_j = _jax_step(carry_j.ctrl, carry_j.plant, start[2], start[3],
                                  (mj, lj, ej, sj), return_qp=True)
    cmd_t, gait_t = convert.command(start[2], "cpu"), convert.gait_params(start[3], "cpu")
    ctrl_t = convert.controller_state(carry_j.ctrl, "cpu")
    plant_t = convert.plant_state(carry_j.plant, "cpu")
    state_t, forces_t, qp_t = t_mpc.mpc_step(
        t_mpc.setup_command(ctrl_t, cmd_t, lt), t_sim.observe(plant_t), cmd_t, gait_t,
        plant_t.t, mt, lt, et, st, return_qp=True)
    assert qp_t.c.shape == (B, H, 13)
    assert float((qp_t.c[:, 0] - qp_t.c[:, -1]).abs().max()) > 1e-4    # varies over h
    np.testing.assert_allclose(qp_t.c.numpy(), _np(qp_j.c), atol=1e-5)
    np.testing.assert_allclose(forces_t.numpy(), _np(forces_j), atol=2e-3)
    # the audited problem is the one that was solved: 150 more iterations on
    # it from the step's warm carry meet the KKT gates of the bench (primal
    # 6e-3, dual 1e-3; ADMM-30 alone is not there yet two periods after the
    # wrench was released)
    warm = (forces_t.reshape(B, H, 12), state_t.warm_z.reshape(B, H, 20),
            state_t.warm_y.reshape(B, H, 20))
    U, info = t_qp.solve(qp_t, tc.ADMMConfig(iterations=150), warm=warm)
    res = t_qp.kkt_residuals(qp_t, U, info["z"], info["y"])
    assert float(res["primal"].max()) < 6e-3 and float(res["dual"].max()) < 1e-3


def test_predictive_step_in_the_kernel_path_matches_jax_xla():
    """One released predictive step with backend="pallas" on the port (the
    plain version of fused_stagewise_solve with a per-step c; nothing is
    launched on CPU tensors) against JAX's XLA path, 120 cold iterations:
    forces to 2e-2 N, the tolerance the reference holds its kernel to against
    its XLA path (test_fused_stagewise_kernel_matches_xla: the two
    factorizations differ algorithmically)."""
    start = _jax_setup(count=WINDOW)
    mj, lj, ej, sj = _cfgs(jc, iters=120)
    mt, lt, et, st = _cfgs(tc, backend="pallas", iters=120)
    _, forces_j = _jax_step(start[1], start[0], start[2], start[3], (mj, lj, ej, sj))
    plant, ctrl, cmd, gait, _ = _port(*start)
    before = dict(TK.LAUNCHES)
    state, forces_t, qp = t_mpc.mpc_step(t_mpc.setup_command(ctrl, cmd, lt), t_sim.observe(plant),
                                         cmd, gait, plant.t, mt, lt, et, st, return_qp=True)
    assert TK.LAUNCHES == before
    assert qp.c.ndim == 3 and float((qp.c[:, 0] - qp.c[:, -1]).abs().max()) > 1e-4
    np.testing.assert_allclose(forces_t.numpy(), _np(forces_j), atol=2e-2)


def test_fused_build_gate_follows_the_reference(monkeypatch):
    """backend="pallas", float32, h <= 64 and no per-step wrench take the
    fused-build kernel; a predictive estimator takes build_stagewise +
    qp_stagewise.solve instead (reference mpc.py:347-351)."""
    taken = []
    real_srb, real_solve = TK.fused_stagewise_solve_srb, t_qp.solve
    monkeypatch.setattr(TK, "fused_stagewise_solve_srb",
                        lambda *a, **k: taken.append("fused_build") or real_srb(*a, **k))
    monkeypatch.setattr(t_qp, "solve",
                        lambda *a, **k: taken.append("solve") or real_solve(*a, **k))
    plant, ctrl, cmd, gait, _ = _port(*_jax_setup(count=WINDOW))
    for predictive, expected in ((False, "fused_build"), (True, "solve")):
        mt, lt, et, st = _cfgs(tc, backend="pallas", iters=2, predictive=predictive)
        t_mpc.mpc_step(ctrl, t_sim.observe(plant), cmd, gait, plant.t, mt, lt, et, st)
        assert taken.pop() == expected and not taken


def test_ground_truth_z_matches_jax():
    """ground_truth_z replaces the observed CoM height in r_feet, the
    x-drag integral and x0 (ConvexMPCLocomotion.cpp:628): forces 2e-3 N,
    round-trip state 1e-5, and it moves the answer."""
    start = _jax_setup(count=0)
    mj, lj, ej, sj = _cfgs(jc, predictive=False)
    mt, lt, et, st = _cfgs(tc, predictive=False)
    z_true = np.asarray(start[0].x[:, 5]) + np.array([0.02, -0.015, 0.01], np.float32)
    ctrl_j, forces_j = _jax_step(start[1], start[0], start[2], start[3], (mj, lj, ej, sj),
                                 ground_truth_z=jnp.asarray(z_true))
    plant, ctrl, cmd, gait, _ = _port(*start)
    run = lambda **kw: t_mpc.mpc_step(t_mpc.setup_command(ctrl, cmd, lt), t_sim.observe(plant),
                                      cmd, gait, plant.t, mt, lt, et, st, **kw)
    ctrl_t, forces_t = run(ground_truth_z=torch.from_numpy(z_true))
    np.testing.assert_allclose(forces_t.numpy(), _np(forces_j), atol=2e-3)
    for name in ("prev_x", "prev_r_feet", "x_comp_integral"):
        np.testing.assert_allclose(getattr(ctrl_t, name).numpy(), _np(getattr(ctrl_j, name)),
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(ctrl_t.prev_x[:, 5].numpy(), z_true, atol=1e-7)
    assert float((run()[1] - forces_t).abs().max()) > 0.1


def test_float64_step_matches_jax():
    """float64 observations stay float64 and take the scan path (the
    kernels are f32-internal), on both backends' settings: forces 1e-5 N
    against JAX's float64 XLA path after 30 iterations."""
    start = _jax_setup(count=WINDOW, dtype=jnp.float64)
    mj, lj, ej, sj = _cfgs(jc, backend="pallas")
    mt, lt, et, st = _cfgs(tc, backend="pallas")
    _, forces_j = _jax_step(start[1], start[0], start[2], start[3], (mj, lj, ej, sj))
    plant, ctrl, cmd, gait, _ = _port(*start)
    state, forces_t = t_mpc.mpc_step(t_mpc.setup_command(ctrl, cmd, lt), t_sim.observe(plant),
                                     cmd, gait, plant.t, mt, lt, et, st)
    assert forces_t.dtype == torch.float64 and state.warm_y.dtype == torch.float64
    np.testing.assert_allclose(forces_t.numpy(), _np(forces_j), atol=1e-5)


@pytest.mark.parametrize("h,expected", [(72, "fused_stagewise_solve_stream"),
                                        (128, "fused_stagewise_solve_stream"),
                                        (64, "fused_stagewise_solve"),
                                        (136, "scan")])
def test_long_horizons_run_through_rollout(monkeypatch, h, expected):
    """loop.rollout passes the horizon and the predictive estimator through
    to mpc_step: one period at B = 1 with 2 ADMM iterations reaches the
    streamed solve for h = 72 and 128, the resident one for a predictive
    h = 64, the scan path above 128; finite forces of the right shape."""
    taken = []
    for name in ("fused_stagewise_solve", "fused_stagewise_solve_stream"):
        real = getattr(TK, name)
        monkeypatch.setattr(TK, name, lambda *a, _n=name, _r=real, **k: taken.append(
            (_n, a[2].ndim)) or _r(*a, **k))
    real_scan = t_qp.lqr_factorize_packed
    monkeypatch.setattr(t_qp, "lqr_factorize_packed", lambda *a, **k: taken.append(
        ("scan", 3 if a[2].shape[1] > 1 else 2)) or real_scan(*a, **k))
    start = _jax_setup(count=WINDOW, horizon=h, batch=1)
    mt, lt, et, st = _cfgs(tc, backend="pallas", horizon=h, iters=2)
    carry, trace = t_loop.rollout(1, *_port(*start), mt, lt, et, st)
    assert taken == [(expected, 3)]                  # one solve, per-step c
    assert carry.ctrl.warm_x.shape == (1, 12 * h)
    assert bool(torch.isfinite(trace.forces).all()) and bool(torch.isfinite(carry.plant.x).all())


def test_full_stack_tick_passes_predictive_long_horizon_through(monkeypatch):
    """full_stack.controller_tick hands its EstimatorConfig and horizon to
    mpc_step: an MPC tick with a released predictive estimator at h = 128
    reaches the streamed solve with a per-step c."""
    taken = []
    real = TK.fused_stagewise_solve_stream
    monkeypatch.setattr(TK, "fused_stagewise_solve_stream", lambda *a, **k: taken.append(
        (a[2].shape, a[4].shape)) or real(*a, **k))
    mc = t_fb.build_a1_constants("float32", "cpu")
    plant = t_art.init_on_ground((1,), penetration=3.8e-3, device="cpu")
    obs0, _, _ = t_fs.observe_plant(plant, mc)
    ctrl = t_mpc.init_state((1,), obs0, window=WINDOW, horizon=128, formulation="stagewise")
    times = 1.0 + 0.026 * torch.arange(WINDOW, dtype=torch.float32)[None]
    ctrl = ctrl._replace(est=ctrl.est._replace(
        times=times, diffs=-1.0 + 1.25 * torch.sin(2 * np.pi * 0.33 * times),
        count=torch.full((1,), WINDOW, dtype=torch.int32)))
    plant = plant._replace(t=torch.full((1,), 1.0 + 0.026 * WINDOW))
    cmd = t_mpc.Command(vx=torch.full((1,), 0.15), vy=torch.zeros(1), yaw_rate=torch.zeros(1),
                        body_height=plant.fb.pos[..., 2].clone())
    mt, lt, et, st = _cfgs(tc, backend="pallas", horizon=128, iters=1)
    from quad_periodic_mpc_tpu_torch.ops import gait as t_gait

    ctrl, tau, _ = t_fs.controller_tick(plant, ctrl, cmd, t_gait.preset("trotting", device="cpu"),
                                        mc, True, mpc_cfg=mt, loop_cfg=lt, est_cfg=et, solver=st)
    assert taken == [((1, 128, 13), (1, 128, 13))]
    assert bool(torch.isfinite(tau).all()) and ctrl.warm_x.shape == (1, 12 * 128)


def test_jax_and_port_agree_on_the_step_signature():
    """mpc_step takes the reference's arguments in the reference's order."""
    import inspect

    names = lambda fn: list(inspect.signature(fn).parameters)
    assert names(t_mpc.mpc_step) == names(j_mpc.mpc_step)
