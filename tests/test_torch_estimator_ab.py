"""The port's estimator A/B tool (``quad_periodic_mpc_tpu_torch/tools/
estimator_ab.py``) against the JAX package's ``tools/estimator_ab.py`` on
the CPU: on a tiny grid (one gait phase, one amplitude, one frequency, the
grid's two phases: 2 instances; window 8, so 16 periods an arm) every arm's
row against the JAX tool's own run of ``run_sweep`` (its main, unedited,
with its ``SweepSpec`` narrowed to the tiny grid, 64-bit mode off as the
tool runs) within tests/test_torch_parallel.py's float32 tolerance; the
table text of both formatters given the same rows; ``--shard`` over two
CPU mesh entries against the unsplit run bit for bit (4 instances a chunk); ``--update`` on a copy
of PERF.md; ``--cpu`` and the refusal to run without a card."""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

import jax

from quad_periodic_mpc_tpu.parallel import sweep as j_sweep
from quad_periodic_mpc_tpu_torch.parallel import mesh as mesh_lib
from quad_periodic_mpc_tpu_torch.tools import estimator_ab as ab
from tools.slice12_reference import jax_tool, run_main

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
ATOL, RTOL = 5e-4, 1e-3          # tests/test_torch_parallel.py's float32 tolerance
WINDOW = 8
TINY = dict(dist_amp=(15.0,), dist_freq=(0.33,))
ARGV = ["--est-window", str(WINDOW), "--phase-offsets", "1"]
JAX_COMMAND = "python tools/estimator_ab.py --update"


@pytest.fixture(scope="module")
def jax_run():
    """JAX's tool on the tiny grid: (its rows as it writes them to stderr,
    its table as it prints it)."""
    mod = jax_tool("estimator_ab")
    spec = j_sweep.SweepSpec
    j_sweep.SweepSpec = lambda **kw: spec(**{**kw, **TINY})
    out = io.StringIO()
    try:
        with jax.enable_x64(False), contextlib.redirect_stdout(out):
            err = run_main(mod, ARGV)
    finally:
        j_sweep.SweepSpec = spec
    rows = [json.loads(line) for line in err.splitlines() if line.startswith("{")]
    return rows, out.getvalue().rstrip("\n")


@pytest.fixture(scope="module")
def port_rows():
    spec = ab.grid(1)._replace(**TINY)
    return [ab.run_arm(arm, spec, WINDOW, device=CPU) for arm in ab.ARMS]


@pytest.mark.parametrize("arm", ab.ARMS)
def test_arm_matches_jax(arm, port_rows, jax_run):
    """Each arm's row (instances, vx RMS mean / p50 / p95, height RMS mean)
    against JAX's within atol 5e-4, rtol 1e-3."""
    jax_rows, _ = jax_run
    got = next(r for r in port_rows if r["arm"] == arm)
    want = next(r for r in jax_rows if r["arm"] == arm)
    assert got.keys() == want.keys() and got["instances"] == want["instances"] == 2
    for key in ("vx_rms_mean", "vx_rms_p50", "vx_rms_p95", "height_rms_mean"):
        np.testing.assert_allclose(got[key], want[key], atol=ATOL, rtol=RTOL, err_msg=key)


def test_table_text_matches_jax(jax_run):
    """The port's formatter given JAX's rows prints JAX's table, but for the
    command its "Generated by" sentence names (each package's own tool)."""
    rows, text = jax_run
    assert JAX_COMMAND in text
    assert ab.format_table(rows, WINDOW) == text.replace(JAX_COMMAND, ab.COMMAND)


def _main(argv, monkeypatch):
    """ab.main on the tiny grid's amplitude and frequency: (rows, table)."""
    grid = ab.grid
    monkeypatch.setattr(ab, "grid", lambda n: grid(n)._replace(**TINY))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        ab.main(argv)
    rows = [json.loads(line) for line in err.getvalue().splitlines() if line.startswith("{")]
    return rows, out.getvalue()


def test_shard_two_cpu_entries_bit_for_bit(monkeypatch):
    """``--cpu --shard`` over 8 instances (4 gait phases), its mesh made two
    CPU entries (on the CPU the tool's mesh is the CPU alone), equals the
    unsplit ``--cpu`` run bit for bit, rows and table: the chunks take the
    Newton-Schulz decisions over the whole batch."""
    argv = ["--cpu", "--est-window", str(WINDOW), "--phase-offsets", "4"]
    whole, table = _main(argv, monkeypatch)
    make_mesh, asked = mesh_lib.make_mesh, []

    def two_cpu_entries(n_devices=None, devices=None):
        asked.append(devices)
        return make_mesh(devices=[CPU, CPU])

    monkeypatch.setattr(mesh_lib, "make_mesh", two_cpu_entries)
    split, split_table = _main([*argv, "--shard"], monkeypatch)
    assert asked == [[CPU]]
    assert [r["instances"] for r in whole] == [8] * 4
    assert split == whole and split_table == table
    assert "8 instances" in table


def test_update_writes_the_block(tmp_path, monkeypatch):
    """``--cpu --update`` rewrites only what lies between the tool's markers
    of PERF.md (here a copy): the device, then the table without the JAX
    tool's reading."""
    from quad_periodic_mpc_tpu_torch import tools

    doc = tmp_path / "PERF.md"
    doc.write_text(f"before\n{ab.BEGIN}\nold\n{ab.END}\nafter\n")
    monkeypatch.setattr(tools, "PERF_MD", str(doc))
    rows, printed = _main(["--cpu", *ARGV, "--update"], monkeypatch)
    table = ab.format_table(rows, WINDOW, prose=False)
    assert printed == "" and "Reading" not in table
    assert doc.read_text() == (f"before\n{ab.BEGIN}\nOn the CPU (the kernels' plain versions):"
                               f"\n\n{table}\n{ab.END}\nafter\n")


def test_refuses_without_a_card():
    """Without a card and without --cpu the tool exits non-zero with a
    message and prints no table."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "quad_periodic_mpc_tpu_torch.tools.estimator_ab", *ARGV],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr and out.stdout == ""
