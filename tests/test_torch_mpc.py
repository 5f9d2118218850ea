"""The port's MPC step and closed-loop rollout against the JAX package.

Both packages start from the same state (built by the JAX package and
carried across with quad_periodic_mpc_tpu_torch/convert.py) and run the
main path: the walking trot (vx = 0.3) with the stagewise ADMM in the
fused kernel, ADMM-30, h = 10.  JAX runs its Pallas kernel in interpret
mode on the CPU; the port runs the kernel's plain version.
"""

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

import jax.numpy as jnp

from quad_periodic_mpc_tpu import config as jc
from quad_periodic_mpc_tpu.control import loop as j_loop
from quad_periodic_mpc_tpu.control import mpc as j_mpc
from quad_periodic_mpc_tpu.ops import gait as j_gait
from quad_periodic_mpc_tpu.sim import srb_sim as j_sim
from quad_periodic_mpc_tpu_torch import config as tc
from quad_periodic_mpc_tpu_torch import convert
from quad_periodic_mpc_tpu_torch.control import loop as t_loop
from quad_periodic_mpc_tpu_torch.control import mpc as t_mpc
from quad_periodic_mpc_tpu_torch.models import a1 as t_a1
from quad_periodic_mpc_tpu_torch.ops import qp_stagewise as t_qp
from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel as TK
from quad_periodic_mpc_tpu_torch.sim import srb_sim as t_sim

B, H, ITERS, VX = 4, 10, 30, 0.3
F32 = jnp.float32


def _jax_setup(prefill_estimator: bool):
    """Bench-style walking trot (bench.py make_inputs) at batch B, with
    the gait phases spread over the batch.  prefill_estimator: a full
    400-sample window of a clear 0.33 Hz residual and count 399, so the
    next update fits and releases a wrench to the QP."""
    plant = j_sim.init_plant((B,), body_height=0.29, dtype=F32)
    rng = np.random.default_rng(21)
    x = np.asarray(plant.x).copy()
    x[:, 0:3] += rng.uniform(-0.03, 0.03, (B, 3))
    x[:, 9:12] += rng.uniform(-0.1, 0.1, (B, 3))
    plant = plant._replace(x=jnp.asarray(x, F32))
    obs = j_sim.observe(plant)
    ctrl = j_mpc.init_state((B,), obs, dtype=F32, horizon=H,
                            formulation="stagewise")
    ctrl = ctrl._replace(
        iteration=(jnp.arange(B, dtype=jnp.int32) * 7) % 208,
        x_vel_des=jnp.full((B,), VX, F32),
    )
    if prefill_estimator:
        times = 1.0 + 0.026 * np.arange(400)[None, :] + np.zeros((B, 1))
        diffs = -1.0 + 1.25 * np.sin(2 * np.pi * 0.33 * times)
        est = ctrl.est._replace(
            times=jnp.asarray(times, F32), diffs=jnp.asarray(diffs, F32),
            count=jnp.full((B,), 399, jnp.int32))
        ctrl = ctrl._replace(est=est)
        plant = plant._replace(t=jnp.full((B,), 1.0 + 0.026 * 400, F32))
    cmd = j_mpc.Command(
        vx=jnp.full((B,), VX, F32), vy=jnp.zeros((B,), F32),
        yaw_rate=jnp.zeros((B,), F32), body_height=jnp.full((B,), 0.29, F32))
    gait = j_gait.preset("trotting")
    dist = j_sim.DisturbanceParams.reference((B,), dtype=F32)
    return plant, ctrl, cmd, gait, dist


def _configs():
    return (
        (jc.MPCConfig(horizon=H), jc.LoopConfig(), jc.EstimatorConfig(),
         jc.ADMMConfig(iterations=ITERS, backend="pallas", formulation="stagewise")),
        (tc.MPCConfig(horizon=H), tc.LoopConfig(), tc.EstimatorConfig(),
         tc.ADMMConfig(iterations=ITERS, backend="pallas", formulation="stagewise")),
    )


def _port(plant, ctrl, cmd, gait, dist):
    return (convert.plant_state(plant, "cpu"), convert.controller_state(ctrl, "cpu"),
            convert.command(cmd, "cpu"), convert.gait_params(gait, "cpu"),
            convert.disturbance(dist, "cpu"))


def _np(a):
    return np.asarray(a)


def test_mpc_step_matches_jax():
    """One MPC solve with the estimator releasing its first fit.  Forces
    (~40-120 N) to atol 2e-3, the kernel gate (measured gap 1.4e-4); the
    released wrench to 1e-4 N/kg (measured 5e-7: the same fit with f32
    sums in another order); the round-trip state to 1e-5."""
    plant, ctrl, cmd, gait, dist = _jax_setup(prefill_estimator=True)
    (mj, lj, ej, sj), (mt, lt, et, st) = _configs()
    obs_j = j_sim.observe(plant)
    ctrl_j = j_mpc.setup_command(ctrl, cmd, lj)
    ctrl_j, forces_j = j_mpc.mpc_step(
        ctrl_j, obs_j, cmd, gait, plant.t, mj, lj, ej, sj)

    plant_t, ctrl_t, cmd_t, gait_t, _ = _port(plant, ctrl, cmd, gait, dist)
    obs_t = t_sim.observe(plant_t)
    ctrl_t = t_mpc.setup_command(ctrl_t, cmd_t, lt)
    ctrl_t, forces_t = t_mpc.mpc_step(
        ctrl_t, obs_t, cmd_t, gait_t, plant_t.t, mt, lt, et, st)

    assert float(np.abs(_np(ctrl_j.est.f_est)).max()) > 0.5   # fit released
    np.testing.assert_allclose(forces_t.numpy(), _np(forces_j), atol=2e-3)
    np.testing.assert_allclose(ctrl_t.f_ff.numpy(), _np(ctrl_j.f_ff), atol=2e-3)
    np.testing.assert_allclose(ctrl_t.est.f_est.numpy(), _np(ctrl_j.est.f_est), atol=1e-4)
    for name in ("prev_x", "prev_R", "prev_r_feet", "x_comp_integral",
                 "world_position_desired"):
        np.testing.assert_allclose(
            getattr(ctrl_t, name).numpy(), _np(getattr(ctrl_j, name)),
            atol=1e-5, err_msg=name)
    np.testing.assert_allclose(ctrl_t.warm_z.numpy(), _np(ctrl_j.warm_z), atol=2e-3)


@pytest.mark.parametrize("rollout", ["rollout", "rollout_graphed"])
def test_rollout_matches_jax_three_periods(rollout):
    """loop.rollout for 3 MPC periods (39 control ticks: mpc_step, 13
    swing_update calls per period, plant steps), and loop.rollout_graphed,
    which runs the same period step on the CPU.  Plant state to 1e-4
    (m, m/s, rad: the 2e-3 N force gate integrated over 0.078 s through
    1/m; measured 7.5e-6), forces to the 2e-3 N kernel gate (measured
    2.8e-4), foot positions and swing targets to 1e-5 m (measured 6e-8)."""
    plant, ctrl, cmd, gait, dist = _jax_setup(prefill_estimator=False)
    (mj, lj, ej, sj), (mt, lt, et, st) = _configs()
    carry_j, tr_j = j_loop.rollout(3, plant, ctrl, cmd, gait, dist, mj, lj, ej, sj)
    args_t = _port(plant, ctrl, cmd, gait, dist)
    carry_t, tr_t = getattr(t_loop, rollout)(3, *args_t, mt, lt, et, st)
    np.testing.assert_allclose(carry_t.plant.x.numpy(), _np(carry_j.plant.x), atol=1e-4)
    np.testing.assert_allclose(
        carry_t.plant.p_feet.numpy(), _np(carry_j.plant.p_feet), atol=1e-5)
    np.testing.assert_allclose(tr_t.x.numpy(), _np(tr_j.x), atol=1e-4)
    np.testing.assert_allclose(tr_t.forces.numpy(), _np(tr_j.forces), atol=2e-3)
    np.testing.assert_array_equal(
        carry_t.ctrl.iteration.numpy(), _np(carry_j.ctrl.iteration))
    np.testing.assert_array_equal(
        carry_t.ctrl.first_swing.numpy(), _np(carry_j.ctrl.first_swing))
    np.testing.assert_allclose(
        carry_t.ctrl.swing_pf.numpy(), _np(carry_j.ctrl.swing_pf), atol=1e-5)


def test_warm_solve_passes_kkt_gates():
    """After a few warm MPC periods of the walking trot, the production
    solve (return_qp audit) meets the bench's KKT gates, primal 6e-3 and
    dual 1e-3, against the independently built problem."""
    plant, ctrl, cmd, gait, dist = _jax_setup(prefill_estimator=False)
    _, (mt, lt, et, st) = _configs()
    plant, ctrl, cmd, gait, dist = _port(plant, ctrl, cmd, gait, dist)
    carry, _ = t_loop.rollout(3, plant, ctrl, cmd, gait, dist, mt, lt, et, st)
    obs = t_sim.observe(carry.plant)
    ctrl = t_mpc.setup_command(carry.ctrl, cmd, lt)
    state, forces, qp = t_mpc.mpc_step(
        ctrl, obs, cmd, gait, carry.plant.t, mt, lt, et, st, return_qp=True)
    res = t_qp.kkt_residuals(
        qp, forces.reshape(B, H, 12), state.warm_z.reshape(B, H, 20),
        state.warm_y.reshape(B, H, 20))
    assert torch.isfinite(forces).all()
    assert float(res["primal"].max()) < 6e-3
    assert float(res["dual"].max()) < 1e-3


@pytest.mark.parametrize("what", ["heightmap", "ground_fn", "foothold_adjust"])
def test_unported_branches_raise(what):
    """The terrain hooks, which raised NotImplementedError until the terrain
    tier was ported, are taken now: each changes the result it feeds (the
    map's body-height command, the ground's clamp of the swing feet, the
    foothold hook's targets).  tests/test_torch_terrain_loop.py holds them
    to JAX."""
    from quad_periodic_mpc_tpu_torch.terrain import heightmap as t_hm

    plant, ctrl, cmd, gait, dist = _port(*_jax_setup(prefill_estimator=False))
    mt, lt, et, st = _configs()[1]
    if what == "foothold_adjust":
        run = lambda hook: t_mpc.swing_update(
            ctrl, t_sim.observe(plant), cmd, gait, t_a1.A1, tc.SwingConfig(), mt, lt,
            lt.swing_height, foothold_adjust=hook)[0].swing_pf
        shifted = run(lambda pf, s, o: pf + 0.05)
        assert torch.allclose(shifted, run(None) + 0.05 * (shifted != run(None)))
        assert not torch.equal(shifted, run(None))
        return
    if what == "heightmap":
        hm = t_hm.create(size=32, resolution=0.03, batch=(B,), device="cpu")
        hm = hm._replace(elevation=torch.full_like(hm.elevation, 0.1),
                         variance=torch.full_like(hm.variance, 1e-4))
        kw = {"heightmap": hm}
    else:
        kw = {"ground_fn": lambda xy: torch.full_like(xy[..., 0], 0.5)}
    base, _ = t_loop.rollout(1, plant, ctrl, cmd, gait, dist, mt, lt, et, st)
    hooked, _ = t_loop.rollout(1, plant, ctrl, cmd, gait, dist, mt, lt, et, st, **kw)
    if what == "ground_fn":
        # every foot lifted onto the 0.5 m ground, none below it
        z = hooked.plant.p_feet[..., 2]
        assert torch.all(z >= 0.5) and bool((z == 0.5).any())
        assert bool((base.plant.p_feet[..., 2] < 0.5).all())
    else:
        assert not torch.equal(hooked.plant.x, base.plant.x)


def test_mpc_step_on_cpu_launches_no_kernel():
    plant, ctrl, cmd, gait, dist = _port(*_jax_setup(prefill_estimator=False))
    mt, lt, et, st = _configs()[1]
    before = dict(TK.LAUNCHES)
    t_mpc.mpc_step(ctrl, t_sim.observe(plant), cmd, gait, plant.t, mt, lt, et, st)
    assert TK.LAUNCHES == before
