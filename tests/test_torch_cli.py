"""The port's command-line interface (``python -m quad_periodic_mpc_tpu_torch``)
against the JAX package's ``cli``: the same flags, defaults and JSON keys,
the same numbers on the same inputs.

The port runs with ``--device cpu`` (its kernels' plain versions); JAX's
``main`` runs in this process under the tests' 64-bit mode.  One
subprocess of the port's CLI, none of JAX's.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

from quad_periodic_mpc_tpu import cli as j_cli
from quad_periodic_mpc_tpu_torch import cli as t_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float64 on both sides, condensed PDIP-25: the closed loop carries the
# solves' ~1e-12 differences to ~1e-10 on the state by period 10
# (test_torch_closed_loop.py's ROLL_TOL for the state and the fit: 2e-6 on
# the state, est_freq to the last ulp of its grid, est_amp 2e-6)
ROLL_TOL = {"est_freq": 1e-12, "est_amp": 2e-6}
STATE_TOL = 2e-6


def run_main(main, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue())


def assert_fields_close(port: dict, ref: dict, tol=STATE_TOL):
    assert set(port) == set(ref)
    for k, v in ref.items():
        if isinstance(v, str):
            assert port[k] == v, k
        else:
            np.testing.assert_allclose(port[k], v, rtol=0, atol=ROLL_TOL.get(k, tol), err_msg=k)


def test_module_rollout_matches_jax():
    """``python -m quad_periodic_mpc_tpu_torch rollout --steps 10 --f64
    --device cpu`` (a subprocess) against JAX's cmd_rollout on the same
    flags, every field."""
    out = subprocess.run(
        [sys.executable, "-m", "quad_periodic_mpc_tpu_torch", "rollout", "--steps", "10",
         "--f64", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    port = json.loads(out.stdout)
    ref = run_main(j_cli.main, ["rollout", "--steps", "10", "--f64"])
    assert_fields_close(port, ref)
    # the JAX CLI test's gate
    assert abs(port["height_final"] - 0.29) < 0.03


def test_rollout_terrain_and_viz_match_jax(tmp_path):
    """The terrain tier and --viz-svg in-process: JAX's key set and numbers,
    and an SVG that parses with JAX's marker counts."""
    flags = ["rollout", "--steps", "6", "--f64", "--terrain-step", "0.05"]
    port = run_main(t_cli.main, flags + ["--viz-svg", str(tmp_path / "port.svg"),
                                         "--device", "cpu"])
    ref = run_main(j_cli.main, flags + ["--viz-svg", str(tmp_path / "jax.svg")])
    assert port.pop("viz_svg") == str(tmp_path / "port.svg")
    ref.pop("viz_svg")
    assert_fields_close(port, ref)
    assert {"terrain_step", "ground_final", "height_above_terrain_final"} <= set(port)
    svg = (tmp_path / "port.svg").read_text()
    ref_svg = (tmp_path / "jax.svg").read_text()
    assert ET.fromstring(svg).tag.endswith("svg")
    for tag in ("<circle", "<line", "<polyline", "<rect"):
        assert svg.count(tag) == ref_svg.count(tag), tag


def test_parity_matches_jax():
    """``parity --problems 2`` in float64 against JAX's cmd_parity.  Under
    the tests' 64-bit mode JAX's fixture carries l and u in float32, so its
    ADMM's rho vector (taken in l's dtype) is float32 too; the port's is
    float64.  That moves the ADMM-200 answer by ~1.2e-5 N (measured), so
    the report is held to 5e-5 N, and the solvers themselves are held on
    JAX's own QP (converted) to 1e-10."""
    from quad_periodic_mpc_tpu.config import ADMMConfig as JADMM
    from quad_periodic_mpc_tpu.ops import qp_admm as j_admm
    from quad_periodic_mpc_tpu.testing.fixtures import make_mpc_qp as j_make
    from quad_periodic_mpc_tpu_torch.config import ADMMConfig
    from quad_periodic_mpc_tpu_torch.ops import qp_admm as t_admm

    port = t_cli.parity_report(10, 2, 200, torch.device("cpu"), torch.float64)
    ref = run_main(j_cli.main, ["parity", "--problems", "2"])
    assert port.keys() == ref.keys() and port["horizon"] == ref["horizon"]
    np.testing.assert_allclose(port["worst_force_diff_N"], ref["worst_force_diff_N"], atol=5e-5)
    for a, b in zip(port["rows"], ref["rows"]):
        assert a.keys() == b.keys() and a["seed"] == b["seed"]
        np.testing.assert_allclose(a["admm_vs_pdip_max"], b["admm_vs_pdip_max"], atol=5e-5)
        np.testing.assert_allclose([a["primal"], a["dual"]], [b["primal"], b["dual"]], atol=1e-8)

    jqp, _, _ = j_make(horizon=10, seed=1)
    x_ref, _ = j_admm.solve(jqp, JADMM(iterations=200))
    qp = t_admm.QPData(*(torch.from_numpy(np.array(v)) for v in jqp))
    x, _ = t_admm.solve(qp, ADMMConfig(iterations=200))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=1e-10)


def test_parity_cli_prints_the_report_in_float32():
    out = run_main(t_cli.main, ["parity", "--problems", "1", "--admm-iters", "20",
                                "--device", "cpu"])
    assert out.keys() == {"horizon", "worst_force_diff_N", "rows"}
    assert out["rows"][0].keys() == {"seed", "admm_vs_pdip_max", "primal", "dual"}
    assert np.isfinite(out["worst_force_diff_N"])


def test_flags_and_defaults_match_jax():
    """Every subcommand of JAX's parser is the port's with the same flags
    and defaults, plus --device (default cuda)."""
    import argparse

    def parsers(main):
        captured = {}
        real = argparse.ArgumentParser.parse_args

        def grab(self, argv=None, namespace=None):
            captured["ap"] = self
            raise SystemExit(0)

        argparse.ArgumentParser.parse_args = grab
        try:
            with pytest.raises(SystemExit):
                main([])
        finally:
            argparse.ArgumentParser.parse_args = real
        sub = next(a for a in captured["ap"]._actions
                   if isinstance(a, argparse._SubParsersAction))
        return {name: {a.dest: (a.default, tuple(a.option_strings), a.choices)
                       for a in p._actions if a.dest != "help"}
                for name, p in sub.choices.items()}

    port, ref = parsers(t_cli.main), parsers(j_cli.main)
    assert port.keys() == ref.keys() == {"rollout", "sweep", "live", "parity"}
    for name in ref:
        dev = port[name].pop("device")
        assert dev[0] == "cuda"
        assert port[name] == ref[name], name


@pytest.mark.parametrize("argv", [
    ["rollout", "--steps", "1"], ["sweep", "--mpc-steps", "1"], ["live", "--steps", "1"],
    ["parity", "--problems", "1"], ["rollout", "--steps", "1", "--device", "cuda:0"]])
def test_cuda_without_a_card_exits_nonzero(argv):
    """--device cuda (the default) on a machine without a card exits
    non-zero with a message, and runs nothing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit) as exc:
        t_cli.main(argv)
    assert exc.value.code not in (0, None)
    assert "--device cpu" in str(exc.value.code)
    assert buf.getvalue() == ""
