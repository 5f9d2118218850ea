"""The gait-family and tick-balance closed-loop gates on the port's SRB plant:
the torch analogs of tests/test_closed_loop.py's
test_other_gaits_hold_height (six cases) and
test_tick_balance_tightens_attitude, with the reference's gates, float64 and
PDIP-25.  The six gaits run in the port as one batch of six instances (a
gait per instance, at its own period), computed once for the module, and
each instance is held to JAX's scalar rollout of its gait, as the reference
test runs it."""

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

import jax.numpy as jnp

from quad_periodic_mpc_tpu.ops import gait as j_gait

from _torch_closed_loop_run import assert_traces_agree, run_jax, run_pair, run_port, zero_dist

# The numeric-offset gaits (offsets/durations of 5 segments,
# ConvexMPCLocomotion.cpp:45-50) only tile a 10-segment period into
# continuous support; at the 16-segment default they leave 6 segments of
# full flight per cycle.  Run them at their natural period.
GAITS = [("walking", 16), ("walking2", 16), ("pacing", 10), ("trot_running", 10),
         ("galloping", 10), ("bounding", 10)]


@pytest.fixture(scope="module")
def gait_family_trace():
    """80 periods of the six gaits at vx = 0.2: the port's batch of six
    instances and JAX's six scalar rollouts."""
    presets = [j_gait.preset(name, period=p) for name, p in GAITS]
    gait = j_gait.GaitParams(*(jnp.stack(v) for v in zip(*presets)))
    x = run_port(gait, 0.2, zero_dist((len(GAITS),)), 80, batch=(len(GAITS),))
    return x, [run_jax(g, 0.2, zero_dist(), 80) for g in presets]


@pytest.mark.parametrize("gait_name, period", GAITS)
def test_other_gaits_hold_height(gait_family_trace, gait_name, period):
    """Gait-family coverage: non-trot gaits keep the loop stable."""
    i = GAITS.index((gait_name, period))
    x = gait_family_trace[0][i]
    assert_traces_agree(x, gait_family_trace[1][i])
    assert abs(x[-1, 5] - 0.29) < 0.05
    assert abs(x[40:, 9].mean() - 0.2) < 0.08
    # pacing rides a roll limit cycle on its line support (and bounding a
    # pitch cycle on its pair support): a wider bound for those
    rp_tol = 0.3 if gait_name in ("pacing", "bounding") else 0.2
    assert np.abs(x[-1, 0:2]).max() < rp_tol


def test_tick_balance_tightens_attitude():
    """The per-tick grasp-map PD correction shrinks the attitude error an
    order of magnitude on trot and keeps pacing's roll cycle bounded."""
    runs = {"off": run_pair("trotting", 0.3, zero_dist(), 60),
            "on": run_pair("trotting", 0.3, zero_dist(), 60, tick_balance=True),
            "pace": run_pair(j_gait.preset("pacing", period=10), 0.2, zero_dist(), 80,
                             tick_balance=True)}
    for x, x_j in runs.values():
        assert_traces_agree(x, x_j)
    rp_off = np.abs(runs["off"][0][-1, 0:2]).max()
    rp_on = np.abs(runs["on"][0][-1, 0:2]).max()
    assert rp_on < rp_off
    assert rp_on < 0.01
    xp = runs["pace"][0]
    assert abs(xp[-1, 5] - 0.29) < 0.05
    assert np.abs(xp[-1, 0:2]).max() < 0.2
