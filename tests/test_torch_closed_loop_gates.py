"""The closed-loop gates the sweep rests on, on the port's SRB plant: the
torch analogs of tests/test_closed_loop.py's standing, trot-tracking and
ADMM-200 tests, with the reference's gates, float64 and PDIP-25, each run
beside JAX's rollout on the same inputs and held to it (the batched and
long-horizon tests are in test_torch_closed_loop_batch.py, the gait-family
and tick-balance tests in test_torch_closed_loop_gaits.py)."""

import numpy as np
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

from quad_periodic_mpc_tpu_torch.config import MPCConfig

from _torch_closed_loop_run import ADMM200_ATOL, assert_traces_agree, run_pair, zero_dist


def test_standing_holds_pose():
    x, x_j = run_pair("standing", 0.0, zero_dist(), 30)
    assert_traces_agree(x, x_j)
    assert abs(x[-1, 5] - 0.29) < 0.02          # height
    assert np.abs(x[-1, 0:3]).max() < 0.01      # level attitude
    assert np.abs(x[-1, 9:12]).max() < 0.01     # at rest


def test_trot_tracks_velocity():
    x, x_j = run_pair("trotting", 0.3, zero_dist(), 100)
    assert_traces_agree(x, x_j)
    assert abs(x[30:, 9].mean() - 0.3) < 0.03
    assert abs(x[-1, 5] - 0.29) < 0.02
    # distance ~ v * t
    t_total = 100 * MPCConfig(horizon=10).dt_mpc
    assert abs(x[-1, 3] - 0.3 * t_total) < 0.12 * 0.3 * t_total + 0.05


def test_trot_admm_solver_closed_loop():
    """The ADMM backend holds the loop too (warm-start-free, 200 iterations)."""
    x, x_j = run_pair("trotting", 0.3, zero_dist(), 60, solver=("admm", 200))
    assert_traces_agree(x, x_j, atol=ADMM200_ATOL)
    assert abs(x[20:, 9].mean() - 0.3) < 0.04
    assert abs(x[-1, 5] - 0.29) < 0.02
