"""The terrain cell on the CPU at a tiny batch (the look for a card
skipped): the program against its reference, correct with every number
0; the faults the terrain tier can have, each not correct; a flip at a
cell boundary taken as a terrain flip; the foothold counter's metric; and
the new entries of BENCHMARK.json."""

from __future__ import annotations

import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from port_bench.lib import harness, tree
from port_bench.stacks import srb_terrain
from port_bench.tests import _cpu

CELL = "terrain_sweep_b32768"
B = 8
ROOT = Path(__file__).resolve().parents[2]


def run(hook=None, traced=False, seconds=0.5, instances=B) -> dict:
    torch.set_num_threads(1)
    return harness.run_cell(CELL, _cpu.SEED, seconds, traced, torch.device("cpu"),
                            time.perf_counter(), instances=instances, hook=hook,
                            log=lambda s: None)


def with_units(prog, wrap):
    return SimpleNamespace(**{**vars(prog), "units": {k: wrap(u) for k, u in
                                                         prog.units.items()}})


def test_sound_run_is_correct_with_every_number_zero():
    """On the CPU the port's kernels take their plain versions, which the
    reference copies, and both sides read the same maps: every gap is 0 and
    no decision went the other way."""
    out = run()
    assert harness.correct(out["checks"]), out["checks"]
    assert {k: c["value"] for k, c in out["checks"].items()} == {
        k: 0.0 for k in out["checks"]}
    assert out["failed"] == 0 and out["attempted"] > 0


def test_a_foothold_moved_one_cell_far_from_a_boundary_is_not_correct():
    """Every swing target moved one cell (0.03 m) in x where it lies at
    least a third of a cell from a cell boundary in x and y: each such leg
    differs with no decision near it, so the run is not correct with
    unexplained flips."""
    def moved(unit):
        def step(carry):
            after = unit(carry)
            pf = after.ctrl.swing_pf.clone()
            rel = pf[..., 0:2] / 0.03
            far = ((rel - torch.round(rel)).abs() > 1 / 3).all(-1)
            pf[..., 0] += 0.03 * far
            return after._replace(ctrl=after.ctrl._replace(swing_pf=pf))
        return step

    checks = run(lambda prog: with_units(prog, moved))["checks"]
    assert checks["terrain_flips_unexplained"]["value"] > 0
    assert not harness.correct(checks), checks


def test_the_ground_clamp_skipped_is_not_correct():
    """The program's ground set flat after its maps were built (the plant
    no longer holds a foot on a riser): not correct."""
    def skipped(prog):
        prog.terrain.riser.zero_()
        return prog

    checks = run(skipped, seconds=2.0)["checks"]
    assert not harness.correct(checks), checks


def test_an_instance_map_left_unread_is_not_correct():
    """The maps of the instances that have a riser replaced by flat ground
    in the program (their own maps left unread): not correct."""
    def unread(prog):
        hm = prog.heightmap
        stepped = prog.terrain.riser > 0
        hm.elevation[stepped] = 0.0
        hm.traversability[stepped] = 1.0
        return prog

    checks = run(unread, seconds=2.0)["checks"]
    assert not harness.correct(checks), checks


def _kept_pair():
    """A kept unit of a sound run: the program's carry after it and the
    reference's answer from the state before it."""
    torch.set_num_threads(1)
    w = harness.window_run(CELL, _cpu.SEED, 0.3, False, torch.device("cpu"), time.perf_counter(),
                           instances=B, log=lambda s: None)
    ref = w.cell.stack.reference(w.cell.cfg, w.cell.wl, w.inp, torch.device("cpu"))
    kind, before, after = w.kept[-1]
    return after, ref.units[kind](tree.transplant(before, ref.start))


def test_a_flip_at_a_cell_boundary_is_a_terrain_flip():
    """One leg's swing target moved to the neighbouring cell on the
    program's side, where the reference's period took a decision of that
    leg within rounding of a boundary: a terrain flip, explained, and that
    instance's swing gap is not held.  Without the near decision the same
    move is unexplained."""
    after, want = _kept_pair()
    pf = after.ctrl.swing_pf.clone()
    pf[3, 1, 0] += 0.03
    got = after._replace(ctrl=after.ctrl._replace(swing_pf=pf))
    near = torch.zeros_like(want.near)
    near[3, 1] = True
    gaps = srb_terrain.compare(got, want._replace(near=near))
    assert gaps["terrain_flips"] == 1.0 and gaps["terrain_flips_unexplained"] == 0.0
    assert gaps["swing_m"] == 0.0 and gaps["plant"] == 0.0
    gaps = srb_terrain.compare(got, want._replace(near=torch.zeros_like(near)))
    assert gaps["terrain_flips"] == 0.0 and gaps["terrain_flips_unexplained"] == 1.0
    assert gaps["swing_m"] > 0.02


def test_foothold_moved_metric_reads_the_counters():
    """The traced run's foothold_moved_pct.terrain: 100 x the counters'
    moved over searched, above 0 on the risers; the device-trace metric
    finds nothing to read on the CPU."""
    from quad_periodic_mpc_tpu_torch.control import cmpc_variant as CV

    out = run(traced=True)
    moved, searched = CV.foothold_counts()
    value = out["metrics"]["foothold_moved_pct.terrain"]["value"]
    assert value == pytest.approx(100.0 * moved / searched) and value > 0
    assert "terrain_ms.terrain" not in out["metrics"]


def test_benchmark_json_lists_the_cell_and_its_metrics():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert cell == {**cell, "config": "a1_terrain_loop_h10", "traffic": "terrain_sweep",
                    "chips": 1}
    solves = next(m for m in bench["end_to_end"] if m["name"] == "mpc_solves_per_s")
    assert CELL in solves["workloads"]
    mine = {m["name"]: m for m in bench["per_layer"] if CELL in m.get("workloads", [])}
    assert set(mine) == {"terrain_ms.terrain", "foothold_moved_pct.terrain"}
    assert {m["layer"] for m in mine.values()} == {"terrain"}
    cfg = json.loads((ROOT / "port_bench/configs/a1_terrain_loop_h10.json").read_text())
    trot = json.loads((ROOT / "port_bench/configs/a1_srb_loop_h10.json").read_text())
    for key in ("mpc", "solver", "estimator", "loop", "swing"):
        assert cfg[key] == trot[key], key


def test_terrain_reference_imports_nothing_of_the_program_or_jax():
    import subprocess
    import sys

    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "import port_bench.reference.terrain_loop\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n" % str(ROOT))
    mods = json.loads(subprocess.run([sys.executable, "-c", code], capture_output=True,
                                     text=True, check=True, timeout=120).stdout)
    assert not set(mods) & {"jax", "jaxlib", "flax", "quad_periodic_mpc_tpu",
                            "quad_periodic_mpc_tpu_torch"}, mods


def test_control_is_not_correct():
    """The reference with TF32 products in the program's place fails at
    least one of the cell's limits (port_bench/control.py)."""
    from port_bench import control

    torch.set_num_threads(1)
    w = harness.window_run(CELL, _cpu.SEED, 0.3, False, torch.device("cpu"), time.perf_counter(),
                           instances=B, log=lambda s: None)
    gaps = control.control_gaps(w.cell, w.inp, w.start, w.kept, torch.device("cpu"))
    checks = {k: {"value": gaps[k], "limit": v} for k, v in w.cell.wl["limits"].items()}
    assert not harness.correct(checks), checks
