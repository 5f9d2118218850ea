"""The port's condensed walking period against the JAX package: mpc_step with
the condensed ADMM (loop and fused-kernel backends, both K^{-1} storage
variants) and with the PDIP, carried over warm periods; loop.rollout and
full_stack.controller_tick with the same solvers.

Both packages start from the same state (built by the JAX package, carried
across with convert.py): the bench's walking trot (vx = 0.3, gait phases
spread over the batch) at B = 4, h = 10.  JAX runs its Pallas ADMM kernel in
interpret mode; the port runs the kernel's plain version.
"""

import numpy as np
import pytest
import torch

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
from quad_periodic_mpc_tpu_torch.ops import gait as t_gait
from quad_periodic_mpc_tpu_torch.ops import qp_admm as t_admm
from quad_periodic_mpc_tpu_torch.ops.cuda import admm_kernel, stagewise_kernel
from quad_periodic_mpc_tpu_torch.sim import articulated_sim as t_art
from quad_periodic_mpc_tpu_torch.sim import srb_sim as t_sim

B, H, VX = 4, 10, 0.3
F32 = jnp.float32
SOLVERS = {
    "admm_xla": dict(iterations=30),
    "admm_pallas": dict(iterations=30, backend="pallas"),
    "admm_pallas_bf16": dict(iterations=30, backend="pallas", pallas_bf16_kinv=True),
    "pdip": None,
}


def _solver(cfg_mod, name):
    kw = SOLVERS[name]
    return cfg_mod.PDIPConfig() if kw is None else cfg_mod.ADMMConfig(**kw)


def _jax_setup():
    """bench.py's make_inputs at batch B with the condensed controller
    state (the K^{-1} carry allocated), positions and velocities perturbed."""
    plant = j_sim.init_plant((B,), body_height=0.29, dtype=F32)
    rng = np.random.default_rng(21)
    x = np.asarray(plant.x).copy()
    x[:, 0:3] += rng.uniform(-0.03, 0.03, (B, 3))
    x[:, 9:12] += rng.uniform(-0.1, 0.1, (B, 3))
    plant = plant._replace(x=jnp.asarray(x, F32))
    ctrl = j_mpc.init_state((B,), j_sim.observe(plant), dtype=F32, horizon=H)
    ctrl = ctrl._replace(iteration=(jnp.arange(B, dtype=jnp.int32) * 7) % 208,
                         x_vel_des=jnp.full((B,), VX, F32))
    cmd = j_mpc.Command(vx=jnp.full((B,), VX, F32), vy=jnp.zeros((B,), F32),
                        yaw_rate=jnp.zeros((B,), F32), body_height=jnp.full((B,), 0.29, F32))
    return plant, ctrl, cmd, j_gait.preset("trotting"), j_sim.DisturbanceParams.reference(
        (B,), dtype=F32)


def _port(plant, ctrl, cmd, gait, dist):
    return (convert.plant_state(plant, "cpu"), convert.controller_state(ctrl, "cpu"),
            convert.command(cmd, "cpu"), convert.gait_params(gait, "cpu"),
            convert.disturbance(dist, "cpu"))


def _period(M, S, G, cfg_mod, solver, where, stack, return_qp=False):
    """One MPC period in either package: setup_command -> mpc_step -> the
    first-step forces held over the period on the SRB plant, feet fixed."""
    mpc_cfg, loop_cfg, est_cfg = cfg_mod.MPCConfig(horizon=H), cfg_mod.LoopConfig(), \
        cfg_mod.EstimatorConfig()

    def period(plant, ctrl, cmd, gait, dist):
        obs = S.observe(plant)
        ctrl = M.setup_command(ctrl, cmd, loop_cfg)
        out = M.mpc_step(ctrl, obs, cmd, gait, plant.t, mpc_cfg, loop_cfg, est_cfg, solver,
                         return_qp=return_qp)
        ctrl, forces = out[0], out[1]
        seg = G.segment_index(gait, ctrl.iteration, loop_cfg.iterations_between_mpc)
        stance = G.mpc_table(gait, seg, 1)[..., 0, :]
        stance = stance.astype(F32) if where is jnp else stance.float()
        plant = S.step(plant, forces[..., 0, :, :], plant.p_feet, stance, dist, mpc_cfg,
                       loop_cfg.dt_mpc)
        ctrl = ctrl._replace(iteration=ctrl.iteration + loop_cfg.iterations_between_mpc)
        return (plant, ctrl, forces) + ((out[2],) if return_qp else ())

    return period


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_mpc_step_condensed_matches_jax_over_warm_periods(name):
    """Three MPC periods, the warm start (x, z, y and the Newton-Schulz
    K0^{-1}) carried from one to the next.  Forces (~40-120 N) to 5e-3 per
    period: float32 on both sides, the K^{-1} build (Newton-Schulz products),
    30 ADMM iterations and the plant step each summed in another order, the
    gap compounding over the periods (the stagewise path's gate is 2e-3 for
    one solve).  The carried inverse to 1e-4 of its largest entry; the
    PDIP's forces to 5e-3 as well (25 Newton steps on a float32 Cholesky).
    With bfloat16 storage the forces are held to 2 N, 2 % of the largest:
    an entry of K^{-1} that the two packages compute 1e-7 apart can round to
    neighbouring bfloat16 values, 2^-8 apart, so the two run operators that
    differ by up to the storage's own 0.4 % error, and the warm carry keeps
    what that moved (measured 1.6e-2 N in the second period, 0.4 N in the
    third; the reference bounds the variant's bias against float32 by 8 %;
    the same operator is held tightly in test_torch_condensed.py)."""
    tol = 2.0 if name == "admm_pallas_bf16" else 5e-3
    state_j = _jax_setup()
    plant_t, ctrl_t, cmd_t, gait_t, dist_t = _port(*state_j)
    plant_j, ctrl_j, cmd_j, gait_j, dist_j = state_j
    period_j = jax.jit(_period(j_mpc, j_sim, j_gait, jc, _solver(jc, name), jnp, None))
    period_t = _period(t_mpc, t_sim, t_gait, tc, _solver(tc, name), torch, None)
    before = admm_kernel.LAUNCHES
    for k in range(3):
        plant_j, ctrl_j, forces_j = period_j(plant_j, ctrl_j, cmd_j, gait_j, dist_j)
        plant_t, ctrl_t, forces_t = period_t(plant_t, ctrl_t, cmd_t, gait_t, dist_t)
        np.testing.assert_allclose(forces_t.numpy(), np.asarray(forces_j), atol=tol, rtol=0,
                                   err_msg=f"period {k}")
    assert admm_kernel.LAUNCHES == before        # CPU tensors launch nothing
    assert torch.isfinite(forces_t).all() and float(forces_t.abs().max()) > 20.0
    np.testing.assert_allclose(ctrl_t.f_ff.numpy(), np.asarray(ctrl_j.f_ff), atol=tol, rtol=0)
    np.testing.assert_allclose(plant_t.x.numpy(), np.asarray(plant_j.x),
                               atol=1e-4 if tol < 1 else 1e-2, rtol=0)
    if name != "pdip":
        scale = float(np.abs(np.asarray(ctrl_j.warm_kinv)).max())
        assert scale > 0
        np.testing.assert_allclose(ctrl_t.warm_kinv.numpy(), np.asarray(ctrl_j.warm_kinv),
                                   atol=1e-4 * scale, rtol=0)
        np.testing.assert_allclose(ctrl_t.warm_z.numpy(), np.asarray(ctrl_j.warm_z),
                                   atol=tol, rtol=0)


@pytest.mark.parametrize("name", ["admm_xla", "pdip"])
def test_rollout_condensed_matches_jax(name):
    """loop.rollout for two MPC periods (26 control ticks) with a condensed
    ADMMConfig and with a PDIPConfig: the solver reaches the solve through
    the rollout.  Plant state to 1e-4, forces to 5e-3 (as above)."""
    state_j = _jax_setup()
    cfgs = lambda m: (m.MPCConfig(horizon=H), m.LoopConfig(), m.EstimatorConfig(),
                      _solver(m, name))
    carry_j, tr_j = j_loop.rollout(2, *state_j, *cfgs(jc))
    carry_t, tr_t = t_loop.rollout(2, *_port(*state_j), *cfgs(tc))
    np.testing.assert_allclose(carry_t.plant.x.numpy(), np.asarray(carry_j.plant.x), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(tr_t.forces.numpy(), np.asarray(tr_j.forces), atol=5e-3, rtol=0)
    assert float(tr_t.forces.abs().max()) > 20.0
    if name != "pdip":
        assert float(carry_t.ctrl.warm_kinv.abs().max()) > 0


@pytest.mark.parametrize("name", ["admm_pallas", "pdip"])
def test_controller_tick_reaches_the_condensed_solve(name):
    """full_stack.controller_tick only passes ``solver`` on: with a
    condensed ADMMConfig and with a PDIPConfig its MPC tick commands exactly
    the forces mpc_step gives on the tick's own observation."""
    mc = t_fb.build_a1_constants("float32", "cpu")
    plant = t_art.init_on_ground((2,), penetration=3.8e-3, device="cpu")
    obs, _, _ = t_fs.observe_plant(plant, mc)
    ctrl = t_mpc.init_state((2,), obs, horizon=H)
    cmd = t_mpc.Command(vx=torch.full((2,), 0.15), vy=torch.zeros(2), yaw_rate=torch.zeros(2),
                        body_height=plant.fb.pos[..., 2].clone())
    gait = t_gait.preset("trotting", device="cpu")
    solver, mpc_cfg = _solver(tc, name), tc.MPCConfig(horizon=H)
    ctrl_tick, tau, _ = t_fs.controller_tick(plant, ctrl, cmd, gait, mc, True, mpc_cfg=mpc_cfg,
                                             solver=solver)
    want, _ = t_mpc.mpc_step(t_mpc.setup_command(ctrl, cmd, tc.LoopConfig()), obs, cmd, gait,
                             plant.t, mpc_cfg, tc.LoopConfig(), tc.EstimatorConfig(), solver)
    assert torch.equal(ctrl_tick.fr_des, want.fr_des)
    assert float(ctrl_tick.fr_des[..., 2].sum(-1).min()) > 50.0     # carries the weight
    assert torch.isfinite(tau).all()


def test_return_qp_is_the_condensed_problem_and_warm_solve_passes_kkt_gates():
    """After six warm periods the production condensed solve (ADMM-30 in the
    fused kernel's plain version) meets the bench's KKT gates, primal 6e-3
    and dual 1e-3, against the QPData that return_qp hands back."""
    plant, ctrl, cmd, gait, dist = _port(*_jax_setup())
    solver = _solver(tc, "admm_pallas")
    period = _period(t_mpc, t_sim, t_gait, tc, solver, torch, None)
    for _ in range(6):
        plant, ctrl, _ = period(plant, ctrl, cmd, gait, dist)
    audit = _period(t_mpc, t_sim, t_gait, tc, solver, torch, None, return_qp=True)
    plant, ctrl, forces, qp = audit(plant, ctrl, cmd, gait, dist)
    assert isinstance(qp, t_admm.QPData) and qp.P.shape == (B, 12 * H, 12 * H)
    res = t_admm.kkt_residuals(qp, forces.reshape(B, 12 * H), ctrl.warm_z, ctrl.warm_y)
    assert float(res["primal"].max()) < 6e-3
    assert float(res["dual"].max()) < 1e-3


def test_condensed_mpc_step_on_cpu_launches_no_kernel():
    plant, ctrl, cmd, gait, dist = _port(*_jax_setup())
    before = (admm_kernel.LAUNCHES, dict(stagewise_kernel.LAUNCHES))
    _period(t_mpc, t_sim, t_gait, tc, _solver(tc, "admm_pallas"), torch, None)(
        plant, ctrl, cmd, gait, dist)
    assert (admm_kernel.LAUNCHES, stagewise_kernel.LAUNCHES) == before


def _closed_loop(solver, n_steps=60):
    """tests/test_closed_loop.py's run() on the port: a single robot in
    float64, trotting at 0.3 m/s with no disturbance."""
    f64 = dict(dtype=torch.float64, device="cpu")
    plant = t_sim.init_plant((), body_height=0.29, **f64)
    ctrl = t_mpc.init_state((), t_sim.observe(plant), dtype=torch.float64)
    full = lambda v: torch.full((), v, **f64)
    cmd = t_mpc.Command(vx=full(0.3), vy=full(0.0), yaw_rate=full(0.0), body_height=full(0.29))
    return t_loop.rollout(
        n_steps, plant, ctrl, cmd, t_gait.preset("trotting", device="cpu"),
        t_sim.DisturbanceParams(*(full(0.0) for _ in range(4))), tc.MPCConfig(), tc.LoopConfig(),
        tc.EstimatorConfig(), solver)


def test_trot_admm30_warm_matches_pdip():
    """The reference's test of the same name on the port: ADMM-30 with the
    carried (x, z, y, K0^{-1}) warm start tracks the trot loop as well as the
    PDIP (mean v_x within 0.04 of the command, within 0.02 of the PDIP's
    trajectory after 20 periods)."""
    _, tr_ref = _closed_loop(tc.PDIPConfig())
    _, tr_a30 = _closed_loop(tc.ADMMConfig(iterations=30))
    vr, va = tr_ref.x[:, 9].numpy(), tr_a30.x[:, 9].numpy()
    assert abs(va[20:].mean() - 0.3) < 0.04
    assert np.abs(va[20:] - vr[20:]).max() < 0.02
