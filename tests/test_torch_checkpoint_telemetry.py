"""The port's checkpoints and telemetry (utils/checkpoint.py,
utils/telemetry.py) against the JAX package's.

A checkpoint is the layout of the JAX package's npz fallback (``leaf_{i}``
in flattening order, ``{n_leaves, step}`` beside it), so one package reads
the other's.  The JAX package writes that layout when orbax is not
importable; where orbax is installed it writes an orbax directory instead,
which needs JAX to read, so the crossing test hides orbax from JAX's
``save`` (as on a machine without it).
"""

import json
import sys

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

import jax.numpy as jnp

from quad_periodic_mpc_tpu.control import mpc as j_mpc
from quad_periodic_mpc_tpu.ops import estimator as j_est
from quad_periodic_mpc_tpu.sim import srb_sim as j_sim
from quad_periodic_mpc_tpu.utils import checkpoint as j_ckpt
from quad_periodic_mpc_tpu.utils import telemetry as j_tel
from quad_periodic_mpc_tpu_torch import convert
from quad_periodic_mpc_tpu_torch.ops import estimator as t_est
from quad_periodic_mpc_tpu_torch.utils import checkpoint as t_ckpt
from quad_periodic_mpc_tpu_torch.utils import telemetry as t_tel

CPU = torch.device("cpu")


def _assert_trees_equal(port, ref):
    """Leaf for leaf (the JAX tree's leaves in its flattening order)."""
    import jax

    ref_leaves = jax.tree.leaves(ref)
    port_leaves = t_tel.leaves(port)
    assert len(port_leaves) == len(ref_leaves)
    for a, b in zip(port_leaves, ref_leaves):
        np.testing.assert_array_equal(t_tel.to_numpy(a), np.asarray(b))


def _controller_state(batch=(3,)):
    """JAX's controller state (a nested NamedTuple: the estimator's state
    inside) with seeded values in some leaves."""
    plant = j_sim.init_plant(batch, body_height=0.29, dtype=jnp.float32)
    ctrl = j_mpc.init_state(batch, j_sim.observe(plant), window=16, dtype=jnp.float32)
    rng = np.random.default_rng(2)
    return ctrl._replace(
        fr_des=jnp.asarray(rng.uniform(-50, 50, batch + (4, 3)), jnp.float32),
        iteration=jnp.asarray(rng.integers(0, 200, batch), jnp.int32),
        est=ctrl.est._replace(est_freq=jnp.asarray(rng.uniform(0, 1, batch), jnp.float32)))


def test_checkpoint_roundtrip(tmp_path):
    """tests/test_utils_cli.py::test_checkpoint_roundtrip on the port."""
    state = t_est.init((3,), 16, torch.float64, CPU)
    state = state._replace(est_freq=torch.tensor([0.1, 0.2, 0.3], dtype=torch.float64))
    t_ckpt.save(tmp_path / "ck", state, step=7)
    template = t_est.init((3,), 16, torch.float64, CPU)
    restored = t_ckpt.restore(tmp_path / "ck", template)
    np.testing.assert_allclose(restored.est_freq.numpy(), [0.1, 0.2, 0.3])
    assert restored.times.shape == state.times.shape
    assert json.loads((tmp_path / "ck.json").read_text()) == {
        "n_leaves": len(t_tel.leaves(state)), "step": 7}
    # each leaf on the template's device and in its dtype
    template32 = t_est.init((3,), 16, torch.float32, CPU)
    restored32 = t_ckpt.restore(tmp_path / "ck", template32)
    assert all(a.dtype == b.dtype and a.device == b.device
               for a, b in zip(t_tel.leaves(restored32), t_tel.leaves(template32)))


def test_checkpoint_crosses_packages(tmp_path, monkeypatch):
    """A JAX checkpoint (npz layout) restored by the port and the port's
    restored by JAX, equal leaf for leaf, on a nested controller state."""
    ref = _controller_state()
    port_template = convert.controller_state(_controller_state(), CPU)._replace(
        fr_des=torch.zeros(3, 4, 3))
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)   # JAX's npz fallback
    j_ckpt.save(tmp_path / "from_jax", ref, step=3)
    assert (tmp_path / "from_jax.npz").exists()
    restored = t_ckpt.restore(tmp_path / "from_jax", port_template)
    assert type(restored) is type(port_template)
    _assert_trees_equal(restored, ref)

    port_state = convert.controller_state(ref, CPU)
    t_ckpt.save(tmp_path / "from_port", port_state, step=3)
    assert (json.loads((tmp_path / "from_port.json").read_text())
            == json.loads((tmp_path / "from_jax.json").read_text()))
    back = j_ckpt.restore(tmp_path / "from_port", _controller_state())
    _assert_trees_equal(port_state, back)


def test_restore_refuses_a_missing_or_mismatched_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError):
        t_ckpt.restore(tmp_path / "none", t_est.init((2,), 8, torch.float32, CPU))
    t_ckpt.save(tmp_path / "small", {"a": torch.zeros(2)})
    with pytest.raises(ValueError):
        t_ckpt.restore(tmp_path / "small", t_est.init((2,), 8, torch.float32, CPU))


def test_timers_and_sync():
    """tests/test_utils_cli.py::test_timers_and_sync on the port, and sync's
    value: the host float of the first leaf's sum, as JAX's."""
    t = t_tel.Timers()
    t.time("add", lambda: torch.arange(10.0) + 1.0, reps=3)
    s = t.summary()
    assert "add" in s and s["add"]["n"] == 1
    assert s["add"]["p50_ms"] >= 0
    tree = {"b": np.arange(4.0), "a": torch.arange(3.0)}
    assert t_tel.sync(tree) == j_tel.sync({"b": jnp.arange(4.0), "a": jnp.arange(3.0)}) == 3.0


def _records(n=3):
    rng = np.random.default_rng(4)
    shapes = dict(t=(), pos=(3,), rpy=(3,), vel=(3,), omega=(3,), pos_des=(3,),
                  vel_des=(3,), foot_forces=(4, 3), foot_pos=(4, 3), contact=(4,),
                  f_est=(6,), est_freq=(), est_amp=())
    return {k: rng.uniform(-1, 1, (n,) + s).astype(np.float32) for k, s in shapes.items()}


def test_jsonl_dump_lines_equal_jax(tmp_path):
    """The same lines as JAX's for the same float32 numbers, for a
    Telemetry record and for a dict (keys sorted, as JAX writes them)."""
    rec = _records()
    port = t_tel.Telemetry(**{k: torch.from_numpy(v) for k, v in rec.items()})
    ref = j_tel.Telemetry(**{k: jnp.asarray(v) for k, v in rec.items()})
    assert t_tel.jsonl_dump(tmp_path / "port.jsonl", port) == 3
    assert j_tel.jsonl_dump(tmp_path / "jax.jsonl", ref) == 3
    lines = (tmp_path / "port.jsonl").read_text()
    assert lines == (tmp_path / "jax.jsonl").read_text()
    assert json.loads(lines.splitlines()[1])["t"] == float(rec["t"][1])

    d = {"z": torch.arange(2.0), "a": torch.ones(2, 3, dtype=torch.float64)}
    t_tel.jsonl_dump(tmp_path / "dport.jsonl", d)
    j_tel.jsonl_dump(tmp_path / "djax.jsonl", {"z": jnp.arange(2.0), "a": jnp.ones((2, 3))})
    assert (tmp_path / "dport.jsonl").read_text() == (tmp_path / "djax.jsonl").read_text()
