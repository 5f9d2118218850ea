"""The frozen plain reference against the port's plain path on the CPU, on
tiny batches of both configurations, and the modules a run loads."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench.tests import _cpu

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("cell", sorted(_cpu.TINY))
def test_reference_equals_the_ports_plain_path(cell):
    """On the CPU every kernel wrapper of the port takes its plain version,
    which the reference copies: every number compared is 0, the start and
    each kept unit (the first, from the start) alike."""
    out = _cpu.run(cell)
    assert out["checks"], "nothing was compared"
    assert {k: c["value"] for k, c in out["checks"].items()} == {
        k: 0.0 for k in out["checks"]}
    assert out["failed"] == 0 and out["attempted"] > 0


def test_reference_imports_nothing_of_the_program_or_jax():
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "import port_bench.reference.loop, port_bench.reference.full_stack\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n" % str(ROOT))
    mods = json.loads(subprocess.run([sys.executable, "-c", code], capture_output=True,
                                     text=True, check=True, timeout=120).stdout)
    assert not set(mods) & {"jax", "jaxlib", "flax", "quad_periodic_mpc_tpu",
                            "quad_periodic_mpc_tpu_torch"}, mods


def test_a_run_loads_no_jax_and_no_jax_package():
    """A whole run of a cell (harness, stack, port, reference, metrics)
    leaves no module whose top-level name is jax, jaxlib, flax or the JAX
    package, compared whole (the port's name begins with the JAX
    package's)."""
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from port_bench.tests import _cpu\n"
        "from port_bench.lib import harness\n"
        "_cpu.run('trot_fleet_b32768', traced=True)\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(json.dumps([harness.forbidden_modules(), "
        "'quad_periodic_mpc_tpu_torch' in tops]))\n" % str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    bad, port_loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert bad == [] and port_loaded


def test_forbidden_names_are_compared_whole(monkeypatch):
    from port_bench.lib import harness

    monkeypatch.setitem(sys.modules, "quad_periodic_mpc_tpu_torch_extra", sys)
    assert "quad_periodic_mpc_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "quad_periodic_mpc_tpu.ops", sys)
    assert "quad_periodic_mpc_tpu" in harness.forbidden_modules()
