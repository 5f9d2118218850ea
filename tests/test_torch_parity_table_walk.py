"""The port's qpOASES gap table (``quad_periodic_mpc_tpu_torch/tools/
parity_table.py``) against the JAX package's ``tools/parity_table.py`` on a
walking scene, shortened to 3 steps, on the CPU in float32: B = 1, trot at
vx = 0.3, each step a condensed ADMM-30 ``mpc_step`` with the "faithful"
estimator through the fused ADMM kernel (the port's plain version; JAX's
kernel in interpret mode at a batch of 1), the warm start carried, on the
SRB plant under the reference disturbance.

The carried production answer, its applied first step and its objective
excess over qpOASES's are held within 1e-3 of JAX's, relatively (each step
is the same arithmetic, JAX's float32 ops rounding otherwise; measured:
1.7e-4 or less).  Every other
cell is held by the tool's own rule (``evidence_cell``) to JAX's own
gap (no rounding draws here): JAX's own PDIP misses (PDIP-40 spd may lose
this solve) missed too, its ADMM misses within 2 %, else under the golden
gate or within 4/3 of JAX's."""

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

import jax

from quad_periodic_mpc_tpu_torch.tools import parity_table as pt
from quad_periodic_mpc_tpu_torch.tools.parity_table import EVIDENCE_ATOL, GOLDEN_RTOL, evidence_cell
from tools.slice12_reference import jax_tool

CPU = torch.device("cpu")
SCENE = dict(pt.SCENES[9], steps=3)
WALK_RTOL = 1e-3
CARRIED = ("production warm x6", "_walk_first_step", "_walk_obj_excess")


@pytest.fixture(scope="module")
def jax_gaps():
    with jax.enable_x64(False):
        return jax_tool("parity_table").gaps_for_scene(SCENE)


@pytest.fixture(scope="module")
def port_solves():
    return pt.solve_scene(SCENE, CPU)


def test_walk_is_the_tool_scene():
    """The shortened scene is the table's first walking scene but for its
    steps; its name says so."""
    assert {k: v for k, v in SCENE.items() if k != "steps"} == {
        k: v for k, v in pt.SCENES[9].items() if k != "steps"}
    assert pt.scene_name(SCENE) == "h=10 walking x3 trott vx=0.3 (prod warm)"


@pytest.mark.parametrize("cell", CARRIED)
def test_carried_solve_matches_jax(cell, jax_gaps, port_solves):
    gaps = pt.scene_gaps(port_solves, walking=True)
    assert list(gaps) == list(jax_gaps)
    np.testing.assert_allclose(gaps[cell], jax_gaps[cell], rtol=WALK_RTOL, atol=0)


@pytest.mark.parametrize("setting", [s for s in pt.SOLVERS
                                     if s not in ("production warm x6", "stagewise ADMM-400")])
def test_final_qp_gaps_match_jax(setting, jax_gaps, port_solves):
    """The final step's QP solved by the other settings, by 20a's rule."""
    x, x_gold = port_solves.x[setting], port_solves.x_gold
    gap = float(np.abs(x - x_gold).max())
    excess = float((np.abs(x - x_gold)
                    - (EVIDENCE_ATOL[setting] + GOLDEN_RTOL * np.abs(x_gold))).max())
    held, how = evidence_cell(gap, excess, [jax_gaps[setting]], setting, False)
    assert held, (gap, jax_gaps[setting], excess, how)
