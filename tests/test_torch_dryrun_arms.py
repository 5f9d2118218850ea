"""Tier 1b of the port's dry run on a 2-entry CPU mesh: the estimator arms
"ls", "static" and "off" as sweeps under the reference disturbance (window
16, released inside the 48 periods), each split against its oracle and each
oracle against JAX's unsplit ``run_sweep`` (float32), and the arm with the
least mean tracking error the same split, unsplit and in JAX ("ls", as in
the reference's record).  The split's chunks hold one instance each and take
the Newton-Schulz decisions over the whole batch; it is held to its oracle
within tests/test_torch_parallel.py's SPLIT_ATOL = 1e-6, for the ops named
there (at one instance, the ADMM's K^-1 product is a matrix-vector product)."""

import numpy as np
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

from quad_periodic_mpc_tpu_torch.parallel import dryrun
from tools.slice7_reference import Package


def test_dryrun_estimator_arms():
    cpu = torch.device("cpu")
    out = dryrun.dryrun_multichip(2, devices=[cpu] * 2, tiers=("1b",))["1b"]
    assert set(out["arms"]) == set(dryrun.ARMS)
    assert out["argmin"] == out["oracle_argmin"] == "ls"
    jax_ref = Package("jax")
    means = {}
    for arm, r in out["arms"].items():
        assert r["batch"] == 2 and r["max_gap"] < 1e-6, arm
        np.testing.assert_allclose(r["height_rms"].numpy(), r["oracle_height_rms"].numpy(),
                                   atol=1e-6, rtol=0, err_msg=arm)
        e = jax_ref.config.EstimatorConfig(**dryrun.arm_estimator(arm))
        vx_j = jax_ref.run_sweep(dryrun.tier_specs(2)["1b"], 48, est_cfg=e)[0]
        np.testing.assert_allclose(r["oracle_vx_rms"].numpy(), vx_j, atol=dryrun.ATOL,
                                   rtol=dryrun.RTOL, err_msg=arm)
        means[arm] = vx_j.mean()
    assert min(means, key=means.get) == "ls"
