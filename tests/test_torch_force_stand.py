"""The port's torque-level force stand (control/force_stand.py: the balance
QP through the safety post-check and the stance LegController onto the
articulated plant, the FSM fed each tick) against the same loop on the JAX
package (tools/slice8_reference.Package), in float64 from the same start.

- the kernel convention (one model evaluation a tick, ten step_fast
  substeps; on the CPU the kernels' plain versions), two instances (target
  heights z0 and z0 + a seeded offset) over the first 150 ticks: the body
  state within 1e-9 every 10 ticks, the FSM trace and the safety masks
  equal;
- the reference capstone's own convention (art.step every substep) over 20
  ticks within 1e-9;
- the full 1,500-tick capstone with its gates (tests/test_articulated_sim.py
  :118-124), marked slow: ~100 s on one CPU thread.  chip_smoke.py's phase
  17a runs it at B = 2,048 on the card.

1e-9: float64 products and solves summed in another order (PDIP-25 and the
18 x 18 model), ~1e-13 a tick, held by the stand's stability.
"""

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

from quad_periodic_mpc_tpu_torch.control import fsm
from tools.slice8_reference import Package, stand_offsets

FIELDS = ("pos", "quat", "v_body", "q", "qd")


def run_both(B, ticks, exact, trace_every):
    t = Package("torch", "float64", exact).run(B, ticks, trace_every)
    j = Package("jax", "float64", exact).run(B, ticks, trace_every)
    assert len(t["trace"]) == len(j["trace"]) == ticks // trace_every
    for k, (ts, js) in enumerate(zip(t["trace"], j["trace"])):
        for f in FIELDS:
            np.testing.assert_allclose(ts[f], js[f], rtol=0, atol=1e-9,
                                       err_msg=f"{f} at tick {(k + 1) * trace_every}")
    np.testing.assert_array_equal(t["fsm_trace"], j["fsm_trace"])
    np.testing.assert_array_equal(t["masks_ok"], j["masks_ok"])
    np.testing.assert_array_equal(t["mode"], j["mode"])
    return t


def test_offsets_are_a_prefix():
    np.testing.assert_array_equal(stand_offsets(8), stand_offsets(2048)[:8])
    assert stand_offsets(8)[0] == 0.0 and np.abs(stand_offsets(2048)).max() <= 0.02


def test_force_stand_kernel_convention_float64_matches_jax():
    t = run_both(2, 150, exact=False, trace_every=10)
    assert t["masks_ok"].all()
    assert (t["fsm_trace"][0] == fsm.STAND_UP).all()
    assert (t["fsm_trace"][1:] == fsm.BALANCE_STAND).all()


def test_force_stand_capstone_convention_float64_matches_jax():
    t = run_both(1, 20, exact=True, trace_every=5)
    assert t["masks_ok"].all()


@pytest.mark.slow
def test_force_stand_capstone_full():
    """The capstone's 1,500 ticks in the kernel convention, float64, with
    its gates, beside JAX's within 1e-6 at the end."""
    t = Package("torch", "float64").run(2, 1500)
    j = Package("jax", "float64").run(2, 1500)
    for f in FIELDS:
        np.testing.assert_allclose(t["final"][f], j["final"][f], rtol=0, atol=1e-6)
    assert (np.abs(t["z_err"]) < 0.03).all(), t["z_err"]
    assert (np.abs(t["quat0"]) > 0.99).all()
    assert (t["vmax"] < 0.6).all()
    assert t["masks_ok"].all()
    assert (t["state"] == fsm.BALANCE_STAND).all() and (t["mode"] == fsm.NORMAL).all()
