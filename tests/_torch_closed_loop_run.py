"""The closed-loop rollout shared by tests/test_torch_closed_loop_gates.py,
tests/test_torch_closed_loop_batch.py and tests/test_torch_closed_loop_gaits.py:
tests/test_closed_loop.py's run() in both packages on the same inputs, float64
and PDIP-25 on the CPU.  The JAX side is jitted (one compile per solver,
horizon, batch and tick-balance setting) and its inputs are converted to the
port's, so the two runs start from the same state."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from quad_periodic_mpc_tpu import config as jc
from quad_periodic_mpc_tpu.control import loop as j_loop
from quad_periodic_mpc_tpu.control import mpc as j_mpc
from quad_periodic_mpc_tpu.ops import gait as j_gait
from quad_periodic_mpc_tpu.sim import srb_sim as j_sim
from quad_periodic_mpc_tpu_torch import config as tc
from quad_periodic_mpc_tpu_torch import convert
from quad_periodic_mpc_tpu_torch.control import loop as t_loop

F64 = jnp.float64
CPU = "cpu"
DEFAULT_PERIOD = j_gait.DEFAULT_PERIOD

# The two packages' float64 answers differ by ~1e-12 in the first period
# (sums in another order), and the closed loop carries that along.  The
# traces are held to each other at this atol (m, rad, m/s): the largest
# gaps measured over these rollouts are 1.0e-7 for PDIP-25 (pacing, 80
# periods; the stagewise ADMM-100 at h = 32: 1.2e-8) and 9.6e-7 for the
# warm-start-free ADMM-200, whose iterates stop short of the optimum.
TRACE_ATOL = 1e-6
ADMM200_ATOL = 2e-6


def zero_dist(batch=()):
    return j_sim.DisturbanceParams.zero(batch, F64)


def solver_cfgs(kind="pdip", iterations=25, formulation="condensed"):
    """(JAX, port) solver configs."""
    if kind == "pdip":
        return jc.PDIPConfig(iterations=iterations), tc.PDIPConfig(iterations=iterations)
    return (jc.ADMMConfig(iterations=iterations, formulation=formulation),
            tc.ADMMConfig(iterations=iterations, formulation=formulation))


@functools.lru_cache(maxsize=None)
def _jax_rollout(n_steps, solver, horizon, tick_balance):
    tb = j_loop.TickBalanceGains() if tick_balance else None
    cfgs = (jc.MPCConfig(horizon=horizon), jc.LoopConfig(), jc.EstimatorConfig(), solver)
    return jax.jit(lambda p, c, cmd, g, d: j_loop.rollout(n_steps, p, c, cmd, g, d, *cfgs,
                                                          tick_balance=tb))


def _inputs(batch, vx, horizon, formulation):
    plant = j_sim.init_plant(batch, body_height=0.29, dtype=F64)
    ctrl = j_mpc.init_state(batch, j_sim.observe(plant), dtype=F64, horizon=horizon,
                            formulation=formulation)
    full = lambda v: jnp.full(batch, v, F64)
    cmd = j_mpc.Command(vx=full(vx), vy=full(0.0), yaw_rate=full(0.0), body_height=full(0.29))
    return plant, ctrl, cmd


def run_jax(gait, vx, dist, n_steps, solver=("pdip", 25), batch=(), tick_balance=False,
            horizon=10):
    """tests/test_closed_loop.py's run() in JAX: the trace's body states."""
    js, _ = solver_cfgs(*solver)
    if isinstance(gait, str):
        gait = j_gait.preset(gait)
    args = _inputs(batch, vx, horizon, getattr(js, "formulation", "condensed"))
    _, tr = _jax_rollout(n_steps, js, horizon, tick_balance)(*args, gait, dist)
    return np.asarray(tr.x)


def run_port(gait, vx, dist, n_steps, solver=("pdip", 25), batch=(), tick_balance=False,
             horizon=10):
    """The same run in the port, from the JAX inputs converted."""
    js, ts = solver_cfgs(*solver)
    if isinstance(gait, str):
        gait = j_gait.preset(gait)
    plant, ctrl, cmd = _inputs(batch, vx, horizon, getattr(js, "formulation", "condensed"))
    tb = t_loop.TickBalanceGains() if tick_balance else None
    _, tr = t_loop.rollout(
        n_steps, convert.plant_state(plant, CPU), convert.controller_state(ctrl, CPU),
        convert.command(cmd, CPU), convert.gait_params(gait, CPU),
        convert.disturbance(dist, CPU), tc.MPCConfig(horizon=horizon), tc.LoopConfig(),
        tc.EstimatorConfig(), ts, tick_balance=tb)
    return tr.x.numpy()


def run_pair(*args, **kw):
    """tests/test_closed_loop.py's run() from the standing pose in both
    packages.  ``gait`` is a preset name or a JAX GaitParams, ``dist`` a JAX
    DisturbanceParams, ``solver`` the arguments of solver_cfgs.  Returns the
    (port, JAX) traces' body states as numpy arrays, (..., n_steps, 13)."""
    return run_port(*args, **kw), run_jax(*args, **kw)


def assert_traces_agree(x_t, x_j, atol=TRACE_ATOL):
    np.testing.assert_allclose(x_t, x_j, atol=atol, rtol=0)
