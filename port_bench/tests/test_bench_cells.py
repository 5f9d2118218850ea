"""BENCHMARK.json's cells and the harness's data: the last line's keys and
types, a new cell, configuration and metric found by name with no edit,
the seed's draws, and the contract's limits on the file."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from port_bench.lib import harness
from port_bench.tests import _cpu

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_benchmark_json_keeps_the_contracts_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
        assert c["file"].startswith("port_bench/") and (ROOT / c["file"]).is_file()
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
        reported = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and (ROOT / "port_bench" / "metrics" / f"{m['name']}.py").is_file()
        moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved["workloads"])


@pytest.mark.parametrize("traced", (False, True))
def test_last_line_keys_and_types(traced):
    cell = "trot_fleet_b32768"
    out = _cpu.run(cell, traced=traced)
    line = json.loads(json.dumps(harness.result_line(out, traced, "NVIDIA H100 80GB HBM3", 1)))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[:5] == keys and list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool) and isinstance(line["attempted"], int)
    assert isinstance(line["failed"], int) and line["attempted"] > 0
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert isinstance(dev["memory_peak_bytes"], int)
    listed = harness.load_cell(cell)
    want = listed.per_layer if traced else listed.end_to_end
    for m in want:
        if m["source"] != "device_trace":       # the CPU has no device trace
            v = line["metrics"][m["name"]]
            assert isinstance(v["value"], float) and v["unit"] == m["unit"]
    if traced:
        assert {"busy_s", "window_s"} <= set(dev) and set(line["breakdown"]) == {
            "device_ops", "idle_gaps"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and isinstance(c["value"], float)


def test_run_without_a_card_exits_non_zero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "trot_fleet_b32768", "--seed",
         str(_cpu.SEED), "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0 and "correct" not in proc.stdout


def test_a_new_cell_config_and_metric_are_found_by_name(tmp_path):
    """A copy of the benchmark with a cell, a configuration and a per-layer
    metric added as files and entries only: the harness runs the new cell
    and reads the new metric."""
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((ROOT / "port_bench/configs/a1_srb_loop_h10.json").read_text())
    cfg.update(name="a1_srb_loop_h12", horizon=12, mpc=dict(cfg["mpc"], horizon=12))
    (tmp_path / "port_bench/configs/a1_srb_loop_h12.json").write_text(json.dumps(cfg))
    wl = json.loads((ROOT / "port_bench/workloads/trot_fleet_b32768.json").read_text())
    wl.update(name="trot_fleet_h12", config="a1_srb_loop_h12", traffic="trot_h12")
    (tmp_path / "port_bench/workloads/trot_fleet_h12.json").write_text(json.dumps(wl))
    (tmp_path / "port_bench/metrics/units_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.profiled_units)\n")
    bench["configs"].append({"name": "a1_srb_loop_h12", "source": "x",
                             "file": "port_bench/configs/a1_srb_loop_h12.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "trot_fleet_h12", "config": "a1_srb_loop_h12",
                               "traffic": "trot_h12", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "mpc_solves_per_s":
            m["workloads"].append("trot_fleet_h12")
    bench["per_layer"].append({"name": "units_traced", "unit": "units", "better": "higher",
                               "source": "host_clock", "layer": "loop and graphs",
                               "moves": "mpc_solves_per_s", "workloads": ["trot_fleet_h12"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys, json, time, torch\n"
        "from port_bench.lib import harness\n"
        "torch.set_num_threads(1)\n"
        "out = harness.run_cell('trot_fleet_h12', 5, 0.2, True, torch.device('cpu'),"
        " time.perf_counter(), instances=2, log=lambda s: None)\n"
        "print(json.dumps([out['metrics'], out['checks']]))\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    metrics, checks = json.loads(proc.stdout.strip().splitlines()[-1])
    assert metrics["units_traced"] == {"value": float(wl["profile_units"]), "unit": "units"}
    assert checks["forces_N"]["value"] == 0.0


@pytest.mark.parametrize("cell", sorted(_cpu.TINY))
def test_the_seeds_draws_repeat_and_keep_every_shape(cell):
    c = harness.load_cell(cell, listed=False)
    draw = lambda seed: c.stack.draw_inputs(c.cfg, c.wl, seed, torch.device("cpu"))
    a, b, other = draw(_cpu.SEED), draw(_cpu.SEED), draw(_cpu.SEED + 1)
    assert a.keys() == b.keys() == other.keys()
    differs = False
    for k in a:
        for x, y, z in zip(*(v if isinstance(v, tuple) else (v,) for v in (a[k], b[k], other[k]))):
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y) and x.shape == z.shape and x.dtype == z.dtype
                differs |= not torch.equal(x, z)
            else:
                assert x == y and type(x) is type(z)
                differs |= x != z
    assert differs
