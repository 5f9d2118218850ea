"""The port's multi-device dry run (``parallel/dryrun.py``, the counterpart
of ``__graft_entry__.dryrun_multichip``) on a 2-entry CPU mesh: tiers 1
(the condensed h = 10 terrain sweep) and 2 (the h = 32 stagewise sweep
through the fused-build kernel's plain version), each split against its
unsplit oracle (the chunks in lockstep, tier 1's Newton-Schulz decisions
over the whole batch: tier 2 bit for bit, tier 1 within TIER1_SPLIT_ATOL),
and each oracle against JAX's unsplit
``run_sweep`` on the same spec with the reference's tolerances (float32;
JAX's tier 2 on its XLA path, the kernel's plain reference).  Tier 3 is in
test_torch_dryrun_stack.py, tier 1b in test_torch_dryrun_arms.py."""

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

from quad_periodic_mpc_tpu_torch.parallel import dryrun
from quad_periodic_mpc_tpu_torch.parallel import sweep as t_sweep
from tools.slice7_reference import Package

CPU = torch.device("cpu")
JAX = Package("jax")

# Tier 1's chunks hold 16 instances where the unsplit batch holds 32.  The
# CPU's torch.atan2 computes the elements past its last whole vector step
# (32 float32 under AVX-512, 16 under AVX2) with scalar libm and the others
# with SLEEF's vector atan2, an ulp apart, and the closed loop carries that
# ulp of roll / yaw through 16 periods: 1.10e-6 on vx_rms under AVX-512, 0
# under AVX2.  Every other op of tier 1 gives a chunk the unsplit bits.
TIER1_SPLIT_ATOL = 2e-6


def _jax_oracle(tier):
    c, spec = JAX.config, dryrun.tier_specs(2)[tier]
    if tier == "1":
        return JAX.run_sweep(spec, 16)
    return JAX.run_sweep(spec, 8, mpc_cfg=c.MPCConfig(horizon=32), solver=c.ADMMConfig(
        iterations=30, formulation="stagewise", backend="xla"))


@pytest.mark.parametrize("tier", ["1", "2"])
def test_dryrun_tier(tier):
    out = dryrun.dryrun_multichip(2, devices=[CPU] * 2, tiers=(tier,))[tier]
    n = {"1": 32, "2": 4}[tier]
    assert out["batch"] == n
    atol = {"1": TIER1_SPLIT_ATOL, "2": 0.0}[tier]
    assert out["max_gap"] <= atol
    for f in ("vx_rms", "height_rms"):
        np.testing.assert_allclose(out[f].numpy(), out[f"oracle_{f}"].numpy(),
                                   atol=atol, rtol=0, err_msg=f)
    if tier == "1":
        assert torch.isfinite(out["height_rms"]).all()
        assert 0 <= out["oracle_best"] < n
    vx_j, best_j, h_j = _jax_oracle(tier)
    tol = dict(atol=dryrun.ATOL, rtol=dryrun.RTOL)
    np.testing.assert_allclose(out["oracle_vx_rms"].numpy(), vx_j, **tol)
    np.testing.assert_allclose(out["oracle_height_rms"].numpy(), h_j, **tol)
    assert t_sweep.argmin_agrees(vx_j, best_j, out["oracle_best"], dryrun.ATOL, dryrun.RTOL)


def test_dryrun_rejects_unknown_tier():
    with pytest.raises(ValueError):
        dryrun.dryrun_multichip(2, devices=[CPU] * 2, tiers=("4",))
