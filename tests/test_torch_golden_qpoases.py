"""The port's solvers against the reference's own compiled qpOASES
(testing/golden.py), mirroring tests/test_golden_qpoases.py, and the port's
fixtures and golden wrapper against the JAX package's.

The solves are skipped, as the JAX file's are, where the golden library is
not available.
Float64 on the CPU; the gates are the JAX file's.
"""

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

import jax.numpy as jnp

from quad_periodic_mpc_tpu.ops import constraints as j_con
from quad_periodic_mpc_tpu.ops import gait as j_gait
from quad_periodic_mpc_tpu.testing import golden as j_golden
from quad_periodic_mpc_tpu.testing.fixtures import make_mpc_qp as j_make_mpc_qp
from quad_periodic_mpc_tpu_torch.config import ADMMConfig, PDIPConfig
from quad_periodic_mpc_tpu_torch.ops import qp_admm, qp_pdip, qp_stagewise
from quad_periodic_mpc_tpu_torch.testing import golden
from quad_periodic_mpc_tpu_torch.testing.fixtures import (
    GOLDEN_SCENES, golden_scene, golden_stagewise_scene, make_mpc_qp,
)

needs_golden = pytest.mark.skipif(
    not golden.available(), reason="golden qpOASES library not available")

CPU = torch.device("cpu")
F64 = torch.float64
SCENES = list(GOLDEN_SCENES)
IDS = [f"h{s['horizon']}-seed{s['seed']}" for s in SCENES]


def _scene(horizon, seed, segment):
    return golden_scene(horizon, seed, segment, dtype=F64, device=CPU)


def _solve_golden(qp, horizon, reduced=False):
    A = golden.dense_constraint_matrix(qp.F, horizon)
    x, status, aux = golden.solve(qp.P, qp.q, A, qp.l, qp.u, reduced=reduced)
    assert status == 0, f"qpOASES status {status}"
    return x, aux


@pytest.mark.parametrize("scene", SCENES, ids=IDS)
def test_fixture_equals_jax(scene):
    """make_mpc_qp equals JAX's field by field.  Under the tests' 64-bit
    mode JAX builds l and u in float32 (its bounds take the float32 result
    type of the int32 gait table), the port in the problem's float64: equal
    once rounded to JAX's dtype."""
    h, seed = scene["horizon"], scene["seed"]
    qp, cfg, table = make_mpc_qp(horizon=h, seed=seed, dtype=F64, device=CPU)
    jqp, jcfg, jtable = j_make_mpc_qp(horizon=h, seed=seed)
    assert cfg == type(cfg)(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    np.testing.assert_array_equal(table, np.asarray(jtable))
    for name in ("P", "q"):
        ref = np.asarray(getattr(jqp, name))
        np.testing.assert_allclose(getattr(qp, name).numpy(), ref, rtol=1e-13,
                                   atol=1e-13 * np.abs(ref).max(), err_msg=name)
    for name in ("F", "l", "u"):
        ref = np.asarray(getattr(jqp, name))
        np.testing.assert_array_equal(getattr(qp, name).numpy().astype(ref.dtype), ref,
                                      err_msg=name)


@needs_golden
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("scene", SCENES, ids=IDS)
def test_golden_solve_equals_jax(scene, reduced):
    """The port's ctypes wrapper gives JAX's answer bit for bit on the same
    QP (the JAX file's scene, its bounds in JAX's float32)."""
    h = scene["horizon"]
    jqp, jcfg, _ = j_make_mpc_qp(horizon=h, seed=scene["seed"])
    table = j_gait.mpc_table(j_gait.preset("trotting"), jnp.asarray(scene["segment"], jnp.int32), h)
    l, u = j_con.bounds(jnp.asarray(table), jcfg.f_max, jcfg.big_number)
    args = (np.asarray(jqp.P), np.asarray(jqp.q),
            j_golden.dense_constraint_matrix(np.asarray(jqp.F), h),
            np.asarray(l).reshape(-1), np.asarray(u).reshape(-1))
    np.testing.assert_array_equal(
        golden.dense_constraint_matrix(torch.from_numpy(np.array(jqp.F)), h), args[2])
    x, status, aux = golden.solve(*(torch.from_numpy(np.array(a)) for a in args),
                                  reduced=reduced)
    jx, jstatus, jaux = j_golden.solve(*args, reduced=reduced)
    assert (status, aux) == (jstatus, jaux) and status == 0
    np.testing.assert_array_equal(x, jx)


@needs_golden
@pytest.mark.parametrize("scene", SCENES, ids=IDS)
def test_swing_leg_elimination_equivalence(scene):
    """The reference's reduced solve equals its full-size solve with zero
    bounds, through the port's wrapper."""
    qp, cfg, table = _scene(**scene)
    n_swing = int(np.sum(table < 0.5))
    x_full, _ = _solve_golden(qp, scene["horizon"], reduced=False)
    x_red, n_red = _solve_golden(qp, scene["horizon"], reduced=True)
    assert n_red == 12 * scene["horizon"] - 3 * n_swing
    np.testing.assert_allclose(x_red, x_full, atol=1e-6)
    swing_mask = np.repeat((table.reshape(-1) < 0.5), 3)
    assert np.all(x_red[swing_mask] == 0.0)


@needs_golden
@pytest.mark.parametrize("scene", SCENES, ids=IDS)
def test_admm_matches_reference_qpoases(scene):
    qp, _, _ = _scene(**scene)
    x_gold, _ = _solve_golden(qp, scene["horizon"], reduced=True)
    x, _ = qp_admm.solve(qp, ADMMConfig(iterations=400))
    np.testing.assert_allclose(x.numpy(), x_gold, atol=2e-3, rtol=1e-3)


@needs_golden
@pytest.mark.parametrize("scene", SCENES, ids=IDS)
def test_pdip_matches_reference_qpoases(scene):
    qp, _, _ = _scene(**scene)
    x_gold, _ = _solve_golden(qp, scene["horizon"], reduced=True)
    x, _ = qp_pdip.solve(qp, PDIPConfig(iterations=40))
    np.testing.assert_allclose(x.numpy(), x_gold, atol=2e-3, rtol=1e-3)


@needs_golden
def test_production_warm_admm_converges_to_reference():
    """Warm-carried ADMM-30 (the production setting), six solves of the
    same QP, meets the reference solver's answer."""
    scene = SCENES[1]
    qp, _, _ = _scene(**scene)
    x_gold, _ = _solve_golden(qp, scene["horizon"], reduced=True)
    warm = None
    for _ in range(6):
        x, warm = qp_admm.solve(qp, ADMMConfig(iterations=30), warm=warm)
    np.testing.assert_allclose(x.numpy(), x_gold, atol=2e-3, rtol=1e-3)


@needs_golden
def test_stagewise_matches_reference_qpoases():
    """The stagewise Riccati-ADMM path against the reference solver at
    h = 16 on the same problem (the JAX file's 3e-3 gate)."""
    qp, _, _ = _scene(horizon=16, seed=5, segment=5)
    x_gold, _ = _solve_golden(qp, 16, reduced=True)
    sw = golden_stagewise_scene(16, 5, 5, dtype=F64, device=CPU)
    U, _ = qp_stagewise.solve(sw, ADMMConfig(iterations=400))
    np.testing.assert_allclose(U.numpy().reshape(-1), x_gold, atol=3e-3, rtol=1e-3)


def test_without_the_library_available_is_false_and_load_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(golden, "_lib", None)
    monkeypatch.setattr(golden, "DEFAULT_LIB", str(tmp_path / "missing.so"))
    assert golden.available() is False
    with pytest.raises(OSError, match="build.sh"):
        golden.load()
