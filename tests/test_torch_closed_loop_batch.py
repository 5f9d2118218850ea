"""The batch axis of the closed loop, and the long-horizon stagewise loop,
on the port's SRB plant: the torch analogs of tests/test_closed_loop.py's
test_batched_rollout_matches_single and
test_trot_stagewise_long_horizon_closed_loop (float64, the reference's
gates, each run beside JAX's rollout on the same inputs and held to it),
and a batch with a gait and period per instance, the form a sweep takes,
against scalar rollouts."""

import jax.numpy as jnp
import numpy as np
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

from quad_periodic_mpc_tpu.ops import gait as j_gait
from quad_periodic_mpc_tpu.sim import srb_sim as j_sim

from _torch_closed_loop_run import F64, assert_traces_agree, run_pair, run_port, zero_dist


def test_batched_rollout_matches_single():
    """A batch axis through the whole closed loop gives per-instance results
    identical to scalar rollouts (atol 1e-9): the property a sweep relies on."""
    f = lambda v: jnp.asarray(v, F64)
    dist3 = j_sim.DisturbanceParams(static=f([0.0, -10.0, 5.0]), amp=f([0.0, 15.0, 7.0]),
                                    freq=f([0.33, 0.33, 0.5]), phase=f([0.0, 0.0, 1.0]))
    xb, xb_j = run_pair("trotting", 0.3, dist3, 25, batch=(3,))
    assert xb.shape == (3, 25, 13)
    assert_traces_agree(xb, xb_j)
    for i in range(3):
        dist1 = j_sim.DisturbanceParams(*(v[i] for v in dist3))
        np.testing.assert_allclose(xb[i], run_port("trotting", 0.3, dist1, 25), atol=1e-9)


def test_batched_rollout_per_instance_gait_matches_single():
    """A gait and a period per instance (pacing at 10 segments, walking at
    16, trotting at 12) in one batch equal three scalar rollouts (1e-9)."""
    cases = [("pacing", 10), ("walking", 16), ("trotting", 12)]
    presets = [j_gait.preset(name, period=p) for name, p in cases]
    gait = j_gait.GaitParams(*(jnp.stack(v) for v in zip(*presets)))
    xb = run_port(gait, 0.2, zero_dist((3,)), 25, batch=(3,))
    assert np.isfinite(xb).all()
    for i, g in enumerate(presets):
        np.testing.assert_allclose(xb[i], run_port(g, 0.2, zero_dist(), 25), atol=1e-9)


def test_trot_stagewise_long_horizon_closed_loop():
    """formulation="stagewise" runs the full control loop at h = 32, past the
    condensed float32 wall, and still tracks the velocity command."""
    x, x_j = run_pair("trotting", 0.3, zero_dist(), 60, solver=("admm", 100, "stagewise"),
                      horizon=32)
    assert_traces_agree(x, x_j)
    assert abs(x[20:, 9].mean() - 0.3) < 0.04
    assert abs(x[-1, 5] - 0.29) < 0.02
