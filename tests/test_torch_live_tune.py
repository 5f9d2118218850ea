"""The port's live retune and telemetry stream (utils/live_tune.py and
``cli live``) against the JAX package's.

A retune writes the tune file's values into the tensors the running loop
already holds (``.copy_()``): no tensor moves between chunks.  The ``live``
run here is in-process on the CPU (the kernels' plain versions), its rows
held to JAX's ``loop.rollout`` on the stagewise XLA path run in the same
chunks with the same tunables, float32 on both sides.
"""

import contextlib
import io
import json
import os
import socket

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from quad_periodic_mpc_tpu import config as jc
from quad_periodic_mpc_tpu.control import loop as j_loop
from quad_periodic_mpc_tpu.control import mpc as j_mpc
from quad_periodic_mpc_tpu.ops import gait as j_gait
from quad_periodic_mpc_tpu.sim import srb_sim as j_sim
from quad_periodic_mpc_tpu.utils import live_tune as j_lt
from quad_periodic_mpc_tpu_torch import cli as t_cli
from quad_periodic_mpc_tpu_torch.config import TunableParams
from quad_periodic_mpc_tpu_torch.control import loop as t_loop
from quad_periodic_mpc_tpu_torch.utils import live_tune as LT

CPU = torch.device("cpu")
F32 = jnp.float32
# float32 on both sides, stagewise ADMM-10 (the port's plain version of
# fused_stagewise_solve against JAX's scan path: the same solve summed in
# another order), 4 periods: the state fields of a row
LIVE_TOL = 1e-4          # measured 4.5e-7
STATE_FIELDS = ("t_sim", "vx", "vx_mean_chunk", "height", "roll", "pitch", "est_freq",
                "est_amp")


def test_file_tuner_poll(tmp_path):
    """tests/test_utils_cli.py::test_file_tuner_poll on the port, and the
    new leaves' device and dtype."""
    base = TunableParams.from_config(device=CPU)
    path = tmp_path / "tune.json"
    tuner = LT.FileTuner(str(path), base)
    assert tuner.poll() is None                    # no file yet

    path.write_text(json.dumps({"alpha": 3e-5, "bogus": 1.0}))
    tp = tuner.poll()
    assert tp is not None
    assert abs(float(tp.alpha) - 3e-5) < 1e-12
    assert tuner.unknown_keys == ["bogus"]
    assert float(tp.swing_height) == float(base.swing_height)  # default kept
    assert tp.swing_height is base.swing_height
    assert tp.alpha.dtype == base.alpha.dtype and tp.alpha.device == base.alpha.device
    assert tuner.poll() is None                    # unchanged -> None

    path.write_text("{not json")                   # partial write
    os.utime(path, (1e9, 1e9))                     # force an mtime change
    assert tuner.poll() is None                    # retried, not fatal


def test_file_tuner_matches_jax_and_takes_a_dtype(tmp_path):
    """The same values as JAX's tuner for the same file; an explicit dtype
    applies to the new leaves."""
    path = tmp_path / "tune.json"
    values = {"alpha": 2.5e-5, "weights": list(np.linspace(0.1, 1.2, 12)), "mu": 0.6}
    path.write_text(json.dumps(values))
    port = LT.FileTuner(str(path), TunableParams.from_config(device=CPU)).poll()
    ref = j_lt.FileTuner(str(path), jc.TunableParams.from_config(dtype=F32), F32).poll()
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)))
    f64 = LT.FileTuner(str(path), TunableParams.from_config(device=CPU), torch.float64).poll()
    assert f64.weights.dtype == torch.float64 and f64.ema_smooth.dtype == torch.float32


def test_retune_by_copy_keeps_the_tensors(tmp_path):
    """The loop's retune: the tuner's values written into the held tensors;
    the pointers stay, and a later file without a field returns that field
    to the tuner's base."""
    held = TunableParams.from_config(device=CPU)
    base = TunableParams(*(t.clone() for t in held))
    ptrs = [t.data_ptr() for t in held]
    path = tmp_path / "tune.json"
    tuner = LT.FileTuner(str(path), base)
    path.write_text(json.dumps({"alpha": 2e-5, "swing_height": 0.12}))
    for h, v in zip(held, tuner.poll()):
        h.copy_(v)
    assert [t.data_ptr() for t in held] == ptrs
    assert float(held.alpha) == np.float32(2e-5) and float(held.swing_height) == np.float32(0.12)
    path.write_text(json.dumps({"alpha": 1e-5}))
    os.utime(path, (2e9, 2e9))
    for h, v in zip(held, tuner.poll()):
        h.copy_(v)
    assert float(held.swing_height) == float(base.swing_height)


def test_udp_telemetry_and_parse_hostport():
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(5.0)
    try:
        udp = LT.UdpTelemetry(*LT.parse_hostport(f"127.0.0.1:{rx.getsockname()[1]}"))
        sample = {"vx": 0.25, "tune_seq": 3, "nan": float("nan")}
        udp.send(sample)
        udp.close()
        got = json.loads(rx.recv(65536))
        assert got["vx"] == 0.25 and got["tune_seq"] == 3 and np.isnan(got["nan"])
    finally:
        rx.close()
    for spec in ("example:1234", ":99", "host", ""):
        assert LT.parse_hostport(spec) == j_lt.parse_hostport(spec)


class RetuneAfterRow(io.StringIO):
    """stdout for ``cli live``: after the first complete row it rewrites
    the tune file (with a distinct mtime), which the loop polls before the
    next chunk."""

    def __init__(self, path, values):
        super().__init__()
        self.path, self.values, self.done = path, values, False

    def write(self, s):
        n = super().write(s)
        if not self.done and self.getvalue().count("\n") >= 1:
            self.path.write_text(json.dumps(self.values))
            os.utime(self.path, (3e9, 3e9))
            self.done = True
        return n


def _jax_chunks(alphas, swing_heights, chunk=2, iters=10):
    """JAX's loop.rollout on the stagewise XLA path in chunks, each with
    its own tunables; the rows' state fields."""
    mpc_cfg, loop_cfg, est_cfg = jc.MPCConfig(horizon=10), jc.LoopConfig(), jc.EstimatorConfig()
    solver = jc.ADMMConfig(iterations=iters, backend="xla", formulation="stagewise")
    plant = j_sim.init_plant((), body_height=0.29, dtype=F32)
    ctrl = j_mpc.init_state((), j_sim.observe(plant), dtype=F32, horizon=10,
                            formulation="stagewise")
    f = lambda v: jnp.asarray(v, F32)
    cmd = j_mpc.Command(vx=f(0.3), vy=f(0.0), yaw_rate=f(0.0), body_height=f(0.29))
    gait, dist = j_gait.preset("trotting"), j_sim.DisturbanceParams.zero((), F32)
    run = jax.jit(lambda plant, ctrl, tun: j_loop.rollout(
        chunk, plant, ctrl, cmd, gait, dist, mpc_cfg, loop_cfg, est_cfg, solver, tunable=tun))
    base = jc.TunableParams.from_config(mpc_cfg, loop_cfg, est_cfg, jc.SwingConfig(), dtype=F32)
    rows = []
    for alpha, swing in zip(alphas, swing_heights):
        tun = base._replace(alpha=f(alpha), swing_height=f(swing))
        carry, tr = run(plant, ctrl, tun)
        plant, ctrl = carry.plant, carry.ctrl
        x = np.asarray(tr.x)
        rows.append({"t_sim": float(plant.t), "vx": float(x[-1, 9]),
                     "vx_mean_chunk": float(x[:, 9].mean()), "height": float(x[-1, 5]),
                     "roll": float(x[-1, 0]), "pitch": float(x[-1, 1]),
                     "est_freq": float(ctrl.est.est_freq), "est_amp": float(ctrl.est.est_amp)})
    return rows


def test_cli_live_retunes_between_chunks_and_matches_jax(tmp_path, monkeypatch):
    """``cli live --steps 4 --chunk 2 --solver-iters 10`` in-process on the
    CPU, the tune file rewritten after the first row: two rows, tune_seq 1
    then 2, alpha and swing_height echo the file, the rollout is handed
    the same tensors in both chunks, and each row's state fields lie within
    LIVE_TOL of JAX's rollout run in the same chunks with the same
    tunables."""
    tune = tmp_path / "tune.json"
    tune.write_text(json.dumps({"alpha": 2e-5}))
    seen = []
    real = t_loop.rollout

    def recording(*args, tunable=None, **kw):
        seen.append([t.data_ptr() for t in tunable])
        return real(*args, tunable=tunable, **kw)

    monkeypatch.setattr(t_loop, "rollout", recording)
    out = RetuneAfterRow(tune, {"alpha": 3e-5, "swing_height": 0.12})
    with contextlib.redirect_stdout(out):
        t_cli.main(["live", "--steps", "4", "--chunk", "2", "--solver-iters", "10",
                    "--tune-file", str(tune), "--device", "cpu"])
    rows = [json.loads(line) for line in out.getvalue().splitlines()]
    assert len(rows) == 2 and len(seen) == 2
    assert seen[0] == seen[1]
    assert [r["tune_seq"] for r in rows] == [1, 2]
    assert [r["mpc_steps"] for r in rows] == [2, 4]
    assert abs(rows[0]["alpha"] - 2e-5) < 1e-10 and abs(rows[1]["alpha"] - 3e-5) < 1e-10
    assert rows[0]["swing_height"] == pytest.approx(0.09) and \
        rows[1]["swing_height"] == pytest.approx(0.12)
    ref = _jax_chunks([2e-5, 3e-5], [0.09, 0.12])
    for row, jrow in zip(rows, ref):
        for k in STATE_FIELDS:
            np.testing.assert_allclose(row[k], jrow[k], atol=LIVE_TOL, err_msg=k)
