"""A run with the timed path broken underneath comes out not correct, and
a sound run comes out correct, on the CPU at a tiny batch (the look for a
card skipped).  The faults each cell can have: a step that returns its
state unchanged; half of the batch left out (not advanced); an answer
altered where it is produced (one instance's first-step force).  No cell
spans chips, so none can leave out an exchange between them."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from port_bench.lib import harness, tree
from port_bench.tests import _cpu

CELLS = sorted(_cpu.TINY)


def unchanged(prog):
    units = {k: (lambda carry: tree.clone(carry)) for k in prog.units}
    return SimpleNamespace(**{**vars(prog), "units": units})


def half_batch(prog):
    def left_out(unit):
        def run(carry):
            before = tree.clone(carry)
            after = unit(carry)
            B = prog.instances
            keep = max(1, B // 2)
            out = []
            for new, old in zip(tree.leaves(after), tree.leaves(before)):
                new = new.clone()
                if B > 1:
                    new[keep:] = old[keep:]
                else:               # one instance: its half of the work is the whole
                    new.copy_(old)
                out.append(new)
            return tree.unflatten(after, out)
        return run
    return SimpleNamespace(**{**vars(prog), "units": {k: left_out(u) for k, u in
                                                         prog.units.items()}})


def altered_force(prog):
    def altered(unit):
        def run(carry):
            after = unit(carry)
            fr = after.ctrl.fr_des.clone()
            fr[0, 0, 2] += 1.0                 # 1 N on one foot of one instance
            return after._replace(ctrl=after.ctrl._replace(fr_des=fr))
        return run
    return SimpleNamespace(**{**vars(prog), "units": {k: altered(u) for k, u in
                                                         prog.units.items()}})


def fallen(prog):
    """Every unit leaves one instance's plant state non-finite, as a robot
    that fell through the floor would, in the units between those kept."""
    def falls(unit):
        def run(carry):
            after = unit(carry)
            plant = tree.unflatten(after.plant, [
                t.clone().index_fill_(0, torch.tensor([0]), float("nan"))
                if t.is_floating_point() else t for t in tree.leaves(after.plant)])
            return after._replace(plant=plant)
        return run
    return SimpleNamespace(**{**vars(prog), "units": {k: falls(u) for k, u in
                                                         prog.units.items()}})


@pytest.mark.parametrize("cell", CELLS)
def test_a_failed_instance_comes_out_not_correct(cell):
    checks = _cpu.run(cell, hook=fallen)["checks"]
    assert checks["failed"]["value"] > 0 and not harness.correct(checks), checks


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    assert harness.correct(_cpu.run(cell)["checks"])


@pytest.mark.parametrize("fault", (unchanged, half_batch, altered_force))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_comes_out_not_correct(cell, fault):
    checks = _cpu.run(cell, hook=fault)["checks"]
    assert not harness.correct(checks), checks
