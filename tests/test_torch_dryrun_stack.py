"""Tier 3 of the port's dry run on a 2-entry CPU mesh: two MPC periods of
the full torque stack (MPC + KinWBC/WBIC + joint torques on the articulated
plant, 5 substeps) split against its unsplit oracle, the oracle against
JAX's full stack on the same inputs (float32), and the run with every
kernel's wrapper in (their plain versions on the CPU) against the "xla"
run."""

import functools

import numpy as np
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

from quad_periodic_mpc_tpu_torch.parallel import dryrun
from tools.slice7_reference import Package

CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _tier3(backend):
    return dryrun.dryrun_multichip(2, devices=[CPU] * 2, tiers=("3",), backend=backend)["3"]


def test_dryrun_full_stack_tier():
    """Tier 3's split (two chunks in lockstep, the MPC's Newton-Schulz
    decisions over the whole batch) equals its oracle bit for bit; the
    oracle is held to JAX's at the reference's tolerances."""
    out = _tier3("xla")
    assert out["batch"] == 4
    assert out["max_gap"] == 0.0 and torch.equal(out["pos"], out["oracle_pos"])
    np.testing.assert_allclose(out["oracle_pos"].numpy(), Package("jax").tier3_pos(2),
                               atol=dryrun.FS_ATOL, rtol=dryrun.RTOL)


def test_dryrun_pallas_backend_matches_xla():
    """Tier 3 with the MPC's ADMM, model evaluation, WBC and plant through
    their kernels' wrappers (the plain versions on CPU tensors) against the
    "xla" run, at tier 3's tolerance."""
    torch.testing.assert_close(_tier3("pallas")["oracle_pos"], _tier3("xla")["oracle_pos"],
                               atol=dryrun.FS_ATOL, rtol=dryrun.RTOL)
