"""Standard MPC-QP fixtures (counterpart of
``quad_periodic_mpc_tpu/testing/fixtures.py``).

The randomized A1 MPC QP of the solver tests and of ``cli.py parity``
(the reference assembles the same problem at SolverMPC.cpp:806-814 from
the robot state), built through the production ``problem.build_qp`` so the
solvers see the real condensation.  The draws are the JAX package's, from
``np.random.default_rng(seed)`` in the same order, so both packages build
the same QP from a seed.  ``golden_scene`` / ``golden_stagewise_scene``
are the scenes of the qpOASES golden checks (tests/test_golden_qpoases.py).
"""

from __future__ import annotations

import numpy as np
import torch

from quad_periodic_mpc_tpu_torch.config import MPCConfig
from quad_periodic_mpc_tpu_torch.ops import constraints
from quad_periodic_mpc_tpu_torch.ops import gait as gait_ops
from quad_periodic_mpc_tpu_torch.ops import problem
from quad_periodic_mpc_tpu_torch.ops.rotations import rpy_to_quat

HIPS = np.array([[0.18, -0.13, -0.26], [0.18, 0.13, -0.26],
                 [-0.18, -0.13, -0.26], [-0.18, 0.13, -0.26]])


def _draws(seed, batch, horizon, dtype, device):
    """The randomized perturbed stand of a seed: (RobotObs, xref (batch,
    horizon, 13)), from ``np.random.default_rng(seed)`` in JAX's order."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    rpy = rng.uniform(-0.1, 0.1, batch + (3,))
    r_feet = HIPS + rng.uniform(-0.03, 0.03, batch + (4, 3))
    obs = problem.RobotObs(
        p=t(np.zeros(batch + (3,)) + np.array([0, 0, 0.26])),
        v=t(rng.uniform(-0.3, 0.3, batch + (3,))),
        quat=rpy_to_quat(t(rpy)),
        omega=t(rng.uniform(-0.2, 0.2, batch + (3,))),
        r_feet=t(r_feet),
    )
    xref = np.zeros(batch + (horizon, 13))
    xref[..., 5] = 0.26
    return obs, t(xref)


def make_mpc_qp(horizon=4, batch=(), seed=1, gait_name="trotting",
                dtype=torch.float32, device="cuda"):
    """Randomized perturbed-stand A1 MPC QP at the given horizon, in
    ``dtype`` on ``device``.

    Returns ``(qp, cfg, mpc_table)``: the condensed ``QPData``, its
    ``MPCConfig`` and the (batch, horizon, 4) contact table as numpy."""
    cfg = MPCConfig(horizon=horizon)
    obs, xref = _draws(seed, batch, horizon, dtype, device)
    g = gait_ops.preset(gait_name, device=device)
    seg = torch.zeros(batch, dtype=torch.int32, device=device)
    table = gait_ops.mpc_table(g, seg, horizon)
    table = torch.broadcast_to(table, batch + (horizon, 4))
    qp, _, _ = problem.build_qp(obs, xref, table, cfg)
    return qp, cfg, table.cpu().numpy()


# tests/test_golden_qpoases.py's scenes: trot segments that mix stance and
# swing steps in the gait table
GOLDEN_SCENES = (
    dict(horizon=10, seed=3, segment=0),
    dict(horizon=10, seed=11, segment=2),
    dict(horizon=16, seed=5, segment=5),
)


def _trot_table(horizon, segment, device):
    """The trot's (horizon, 4) contact table from gait segment ``segment``."""
    return gait_ops.mpc_table(gait_ops.preset("trotting", device=device),
                              torch.tensor(segment, dtype=torch.int32, device=device), horizon)


def golden_scene(horizon, seed, segment, dtype=torch.float32, device="cuda"):
    """The fixture QP with the bounds of gait segment ``segment`` of the
    trot.  Returns (qp, cfg, contact table (horizon, 4) as float numpy)."""
    qp, cfg, _ = make_mpc_qp(horizon=horizon, seed=seed, dtype=dtype, device=device)
    table = _trot_table(horizon, segment, device)
    l, u = constraints.bounds(table, cfg.f_max, cfg.big_number, dtype)
    qp = qp._replace(l=l.reshape(horizon * 20), u=u.reshape(horizon * 20))
    return qp, cfg, table.cpu().numpy().astype(float)


def golden_stagewise_scene(horizon, seed, segment, dtype=torch.float32, device="cuda"):
    """``golden_scene``'s QP in the stagewise parametrization (the same
    draws, ``problem.build_stagewise``): a StagewiseProblem."""
    obs, xref = _draws(seed, (), horizon, dtype, device)
    table = _trot_table(horizon, segment, device).to(dtype)
    sw, _ = problem.build_stagewise(obs, xref, table, MPCConfig(horizon=horizon))
    return sw
