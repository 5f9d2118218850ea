"""The port's qpOASES gap table (``quad_periodic_mpc_tpu_torch/tools/
parity_table.py``) against the JAX package's ``tools/parity_table.py`` on the
CPU, in float32 (JAX's 64-bit mode off, as its tool runs; the port's kernels'
plain versions), on the h = 10 scene with the disturbance estimate (seed 6)
and the h = 10 galloping scene (seed 2):

- the two packages' QPs from ``scene_problems`` (P, q, l, u, F and the
  stagewise Ad, Bd, c) within 1e-5;
- every cell of the port's ``gaps_for_scene`` against JAX's
  ``gaps_for_scene`` by the tool's own rule (``evidence_cell``): every
  cell lies under the qpOASES golden gate (atol 2e-3 N, 3e-3 N stagewise,
  rtol 1e-3) or within 4/3 of JAX's float32 gap; on the seed-6 scene's
  PDIP-40 and PDIP-40 spd (``EVIDENCE_SPREAD``) within 4/3 of the largest
  of JAX's gap and of its solves of the same QP at 16 rounding-level
  perturbations (``tools/slice12_reference.scene_envelope``; PDIP-40 there
  gives 0.027 N and up to 0.270 N over them, so one float32 solve's gap is
  one draw of a spread; the production setting's draws run JAX's kernel in
  interpret mode and are left out here);
- the table's text from both formatters given the same gaps, ``--update``
  on a copy of PERF.md, and the refusal to run without a card.

The walking scene is tests/test_torch_parity_table_walk.py's."""

import contextlib
import io
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

from quad_periodic_mpc_tpu_torch.tools import parity_table as pt
from quad_periodic_mpc_tpu_torch.tools.parity_table import (
    EVIDENCE_ATOL, EVIDENCE_SPREAD, GOLDEN_RTOL, evidence_cell,
)
from tools.slice12_reference import jax_settings, jax_tool, run_main, scene_envelope

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SCENES = {"f_est": pt.SCENES[8], "galloping": pt.SCENES[6]}
QP_ATOL = 1e-5
JAX_COMMAND = "python tools/parity_table.py --update"


@pytest.fixture(scope="module")
def jax_pt():
    return jax_tool("parity_table")


@pytest.fixture(scope="module")
def jax_cells(jax_pt):
    """Per scene: JAX's gaps_for_scene, and [gap, largest over the draws]
    by setting."""
    settings = {k: f for k, f in jax_settings(jax_pt).items() if k != "production warm x6"}
    out = {}
    with jax.enable_x64(False):
        for key, sc in SCENES.items():
            gaps = jax_pt.gaps_for_scene(sc)
            worst = scene_envelope(jax_pt, sc, settings)
            out[key] = {k: [g, worst.get(k, g)] for k, g in gaps.items()}
    return out


@pytest.fixture(scope="module")
def port_solves():
    return {key: pt.solve_scene(sc, CPU) for key, sc in SCENES.items()}


@pytest.mark.parametrize("key", list(SCENES))
def test_scene_problems_match_jax(key, jax_pt):
    """The condensed QP and the stagewise problem of a scene, the port's
    against JAX's, every entry within 1e-5 (measured: 2e-8 or less)."""
    qp, sw, cfg = pt.scene_problems(**SCENES[key], device=CPU)
    with jax.enable_x64(False):
        jqp, jsw, jcfg = jax_pt.scene_problems(**SCENES[key])
    assert cfg.horizon == jcfg.horizon == 10
    for got, want, fields in ((qp, jqp, ("P", "q", "l", "u", "F")),
                              (sw, jsw, ("Ad", "Bd", "c", "l", "u"))):
        for f in fields:
            a, b = getattr(got, f), np.asarray(getattr(want, f))
            assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, f
            np.testing.assert_allclose(a.numpy(), b, atol=QP_ATOL, rtol=0, err_msg=f)


@pytest.mark.parametrize("setting", pt.SOLVERS)
@pytest.mark.parametrize("key", list(SCENES))
def test_gaps_match_jax(key, setting, jax_cells, port_solves):
    """One cell of the table, the port's against JAX's by 20a's rule."""
    solves = port_solves[key]
    gaps = pt.scene_gaps(solves, walking=False)
    assert list(gaps) == list(jax_cells[key])
    err = np.abs(solves.x[setting] - solves.x_gold)
    excess = float((err - (EVIDENCE_ATOL[setting] + GOLDEN_RTOL * np.abs(solves.x_gold))).max())
    spread = (pt.scene_name(SCENES[key]), setting) in EVIDENCE_SPREAD
    held, how = evidence_cell(gaps[setting], excess, jax_cells[key][setting], setting, spread)
    assert held, (gaps[setting], jax_cells[key][setting], excess, how)


def test_table_text_matches_jax(jax_pt, monkeypatch):
    """JAX's main prints, for given gaps, the port's format_table of them
    but for the command its "Generated by" sentence names."""
    def made_up(sc):
        g = {s: 10.0 ** -(i + 1) * (1 + 0.5 * sc["horizon"]) for i, s in enumerate(pt.SOLVERS)}
        if sc.get("walking"):
            del g["stagewise ADMM-400"]
            g.update(_walk_first_step=0.125, _walk_obj_excess=-5.6e-4)
        return g

    monkeypatch.setattr(jax_pt, "gaps_for_scene", made_up)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run_main(jax_pt, [])
    text = out.getvalue().rstrip("\n")
    assert JAX_COMMAND in text
    assert pt.format_table([(sc, made_up(sc)) for sc in pt.SCENES]) == text.replace(
        JAX_COMMAND, pt.COMMAND)


def test_update_writes_the_block(tmp_path, monkeypatch):
    """``--cpu --update`` (here over the galloping scene alone) rewrites only
    what lies between the tool's markers of PERF.md (here a copy): the
    device, then the tables without the JAX tool's reading."""
    from quad_periodic_mpc_tpu_torch import tools

    doc = tmp_path / "PERF.md"
    doc.write_text(f"before\n{pt.BEGIN}\nold\n{pt.END}\nafter\n")
    monkeypatch.setattr(tools, "PERF_MD", str(doc))
    monkeypatch.setattr(pt, "SCENES", [SCENES["galloping"]])
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        pt.main(["--cpu", "--update"])
    text = doc.read_text()
    inner = text.split(pt.BEGIN + "\n")[1].split("\n" + pt.END)[0]
    assert out.getvalue() == "" and text == f"before\n{pt.BEGIN}\n{inner}\n{pt.END}\nafter\n"
    device, table = inner.split("\n\n", 1)
    assert device == "On the CPU (the kernels' plain versions):"
    gaps = pt.gaps_for_scene(SCENES["galloping"], CPU)
    assert table == pt.format_table([(SCENES["galloping"], gaps)], prose=False)
    assert "bf16" not in table


def test_refuses_without_a_card():
    """Without a card and without --cpu the tool exits non-zero with a
    message and prints no table."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-m", "quad_periodic_mpc_tpu_torch.tools.parity_table"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr and out.stdout == ""
