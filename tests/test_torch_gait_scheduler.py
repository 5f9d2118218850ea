"""The port's gait scheduler (ops/gait_scheduler) and cmpc_variant's
adaptive gait update against the JAX package: the ten tests of
tests/test_gait_scheduler_full.py, the three scheduler tests of
tests/test_terrain.py, tests/test_cmpc_variant.py's adaptive-gait test, and
seeded mixed fleets.  Each runs the JAX function (jitted: its XLA path) on
the same inputs.  Gait ids, contact, touchdown and liftoff are held equal
exactly, in float32 and float64; phases and times to 1e-6 in float32 and
1e-12 in float64 (the port keeps each expression's order of operations, so
they come out equal in practice)."""

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from quad_periodic_mpc_tpu.control import cmpc_variant as j_cv
from quad_periodic_mpc_tpu.ops import gait as j_gait
from quad_periodic_mpc_tpu.ops import gait_scheduler as j_gs
from quad_periodic_mpc_tpu_torch import convert
from quad_periodic_mpc_tpu_torch.control import cmpc_variant as cv
from quad_periodic_mpc_tpu_torch.ops import gait as gait_ops
from quad_periodic_mpc_tpu_torch.ops import gait_scheduler as gs

CPU = "cpu"
ATOL = {np.dtype(np.float32): 1e-6, np.dtype(np.float64): 1e-12}
EXACT = ("current_gait", "next_gait", "contact", "contact_prev", "touchdown", "liftoff",
         "enabled", "overrideable")
DT = 0.002


def same(t, j, name=""):
    """Equal dtypes and shapes; integer, bool and contact leaves equal, the
    rest within ATOL."""
    t, j = convert.to_numpy(t), np.asarray(j)
    assert t.dtype == j.dtype and t.shape == j.shape, (name, t.dtype, j.dtype, t.shape, j.shape)
    if name in EXACT or t.dtype.kind in "biu":
        np.testing.assert_array_equal(t, j, err_msg=name)
    else:
        np.testing.assert_allclose(t, j, rtol=0, atol=ATOL[t.dtype], err_msg=name)


def same_tuple(t, j):
    for name, tl, jl in zip(type(t)._fields, t, j):
        same(tl, jl, name)


def j_dtype(dtype):
    return jnp.float32 if dtype == torch.float32 else jnp.float64


# jitted JAX steps, one program per (dt, argument structure)
_j_step_full = jax.jit(j_gs.step_full, static_argnums=(1,))
_j_step = jax.jit(j_gs.step, static_argnums=(2,))


def both_init(batch=(), gait="stand", dtype=torch.float32):
    t = gs.gait_data_init(batch, gait=gait, dtype=dtype, device=CPU)
    j = j_gs.gait_data_init(batch, gait=gait, dtype=j_dtype(dtype))
    same_tuple(t, j)
    return t, j


def both_step(t, j, dt=DT, **kw):
    """step_full in both packages; keyword values as numpy, given to each."""
    t_kw = {k: (torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}
    j_kw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    t, t_out = gs.step_full(t, dt, **t_kw)
    j, j_out = _j_step_full(j, dt, **j_kw)
    same_tuple(t, j)
    same_tuple(t_out, j_out)
    return t, j, t_out


def numpy_reference_step(state, dt):
    """Direct NumPy transcription of GaitScheduler::step
    (GaitScheduler.cpp:95-205), as in tests/test_gait_scheduler_full.py."""
    if state["current"] != gs.STAND:
        state["initial_phase"] = np.fmod(state["initial_phase"] + dt / state["period"], 1.0)
    contact = np.zeros(4)
    for foot in range(4):
        state["contact_prev"][foot] = state["contact_sched"][foot]
        if state["enabled"][foot] == 1:
            dphase = 0.0 if state["current"] == gs.STAND else (
                state["scale"][foot] * (dt / state["period"]))
            state["phase"][foot] = np.fmod(state["phase"][foot] + dphase, 1.0)
            state["contact_sched"][foot] = 1 if state["phase"][foot] <= state["switching"] else 0
        else:
            state["phase"][foot] = 0.0
            state["contact_sched"][foot] = 0
        contact[foot] = state["contact_sched"][foot]
    return contact


def test_tables_equal_reference():
    assert gs.GAIT_TABLE == j_gs.GAIT_TABLE
    assert gs.GAIT_IDS == j_gs.GAIT_IDS
    assert gs._OVERRIDEABLE == j_gs._OVERRIDEABLE
    assert (gs.STAND, gs.CUSTOM, gs.TRANSITION_TO_STAND) == (
        j_gs.STAND, j_gs.CUSTOM, j_gs.TRANSITION_TO_STAND)
    for t, j in zip(gs._stacked_table(torch.float64, CPU), j_gs._stacked_table(jnp.float64)):
        same(t, j)


def test_15_types_enumerated():
    assert len(gs.GAIT_IDS) == 15
    assert gs.GAIT_IDS["stand"] == 0
    assert gs.GAIT_IDS["three_foot"] == 12
    assert gs.GAIT_IDS["custom"] == 13
    assert gs.GAIT_IDS["transition_to_stand"] == 14
    for name in gs.GAIT_IDS:
        both_init((2,), gait=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_trot_matches_numpy_recurrence(dtype):
    t, j = both_init(gait="trot", dtype=dtype)
    p, sw, off, sc, en, _ip = gs.GAIT_TABLE["trot"]
    ref = {"current": gs.GAIT_IDS["trot"], "period": p, "switching": sw,
           "phase": np.array(off, float), "scale": np.array(sc, float),
           "enabled": np.array(en, float), "initial_phase": 0.0,
           "contact_sched": np.zeros(4), "contact_prev": np.zeros(4)}
    for i in range(400):
        t, j, out = both_step(t, j)
        c_ref = numpy_reference_step(ref, DT)
        np.testing.assert_allclose(t.phase.numpy(), ref["phase"], atol=1e-5,
                                   err_msg=f"tick {i}")
        np.testing.assert_allclose(out.contact.numpy(), c_ref)
    np.testing.assert_allclose(float(t.initial_phase), ref["initial_phase"], atol=1e-5)


def test_stand_freezes_phases():
    t, j = both_init(gait="stand")
    p0 = t.phase.numpy().copy()
    for _ in range(50):
        t, j, out = both_step(t, j)
    np.testing.assert_allclose(t.phase.numpy(), p0)
    assert float(t.initial_phase) == 0.0
    np.testing.assert_allclose(out.contact.numpy(), 1.0)


def test_three_foot_disabled_leg():
    t, j = both_init(gait="three_foot")
    for _ in range(100):
        t, j, out = both_step(t, j)
    assert float(t.phase[0]) == 0.0
    assert float(out.contact[0]) == 0.0


def test_transition_to_stand_preserves_time_to_cycle_end():
    t, j = both_init(gait="trot")
    for _ in range(137):
        t, j, _ = both_step(t, j, override_mode=0)
    p_old, sw_old = float(t.period_nominal), float(t.switching_nominal)
    phase_old = t.phase.numpy().copy()
    t2, _, _ = both_step(t, j, override_mode=1, user_gait=gs.TRANSITION_TO_STAND)
    p_new = float(t2.period_nominal)
    assert abs(p_new - 3.0 * p_old) < 1e-6
    sw_new = float(t2.switching_nominal)
    np.testing.assert_allclose(p_new * (1 - sw_new), p_old * (1 - sw_old), atol=1e-5)
    np.testing.assert_allclose(p_new * (1 - t2.phase_offset.numpy()),
                               p_old * (1 - phase_old), atol=1e-5)
    assert int(t2.current_gait) == gs.TRANSITION_TO_STAND
    assert float(t2.overrideable) == 0.0


def test_mode2_override_gated_by_overrideable():
    t, j = both_init(gait="trot")
    for _ in range(40):
        t, j, _ = both_step(t, j)
    t2, _, _ = both_step(t, j, override_mode=2, user_gait=gs.GAIT_IDS["trot"],
                         user_period=0.8, user_switching=0.6)
    assert abs(float(t2.period_nominal) - 0.8) < 1e-6
    assert abs(float(t2.switching_nominal) - 0.6) < 1e-6
    t, j = both_init(gait="stand")
    t3, _, _ = both_step(t, j, override_mode=2, user_gait=gs.STAND, user_period=0.8,
                         user_switching=0.6)
    assert abs(float(t3.period_nominal) - 10.0) < 1e-6
    assert abs(float(t3.switching_nominal) - 1.0) < 1e-6


def test_mode4_restores_naturals():
    t, j = both_init(gait="trot")
    t = t._replace(period_nominal=torch.tensor(0.9, dtype=t.period_nominal.dtype))
    j = j._replace(period_nominal=jnp.asarray(0.9, j.period_nominal.dtype))
    t2, _, _ = both_step(t, j, override_mode=4)
    assert abs(float(t2.period_nominal) - 0.5) < 1e-6


def test_custom_keeps_running_parameters():
    t, j = both_init(gait="bound")
    p = float(t.period_nominal)
    t2, _, _ = both_step(t, j, override_mode=1, user_gait=gs.CUSTOM)
    assert int(t2.current_gait) == gs.CUSTOM
    assert abs(float(t2.period_nominal) - p) < 1e-6
    np.testing.assert_allclose(t2.phase_offset.numpy(), np.asarray(gs.GAIT_TABLE["bound"][2]))


def test_batched_mixed_modes_lockstep():
    t, j = both_init((3,), gait="trot")
    modes = np.array([0, 1, 2], np.int32)
    gaits = np.array([gs.GAIT_IDS["trot"], gs.GAIT_IDS["bound"], gs.GAIT_IDS["pace"]], np.int32)
    for _ in range(30):
        t, j, out = both_step(t, j, override_mode=modes, user_gait=gaits, user_period=0.7,
                              user_switching=0.55)
    assert t.current_gait.tolist() == [gs.GAIT_IDS["trot"], gs.GAIT_IDS["bound"],
                                       gs.GAIT_IDS["pace"]]
    assert abs(float(t.period_nominal[2]) - 0.7) < 1e-6
    assert abs(float(t.period_nominal[1]) - 0.4) < 1e-6
    assert out.contact.shape == (3, 4)


def test_pace_initial_phase_quarter_period():
    t, j = both_init(gait="pace")
    p, sw, off, sc, en, ip = gs.GAIT_TABLE["pace"]
    assert ip == 0.25
    np.testing.assert_allclose(t.phase.numpy(), (np.array(off) + 0.25) * np.array(en), atol=1e-6)
    ref = {"current": gs.GAIT_IDS["pace"], "period": p, "switching": sw,
           "phase": (np.array(off, float) + ip) * np.array(en, float),
           "scale": np.array(sc, float), "enabled": np.array(en, float), "initial_phase": ip,
           "contact_sched": np.zeros(4), "contact_prev": np.zeros(4)}
    for i in range(200):
        t, j, out = both_step(t, j)
        c_ref = numpy_reference_step(ref, DT)
        np.testing.assert_allclose(t.phase.numpy(), ref["phase"], atol=1e-5, err_msg=f"tick {i}")
        np.testing.assert_allclose(out.contact.numpy(), c_ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_seeded_fleet_equal_reference(dtype):
    """256 schedulers through step_full for 500 ticks with seeded gait types
    (all 15), override modes 0/1/2/3/4 and user periods, the requests
    changing every 1-80 ticks: every leaf equal to JAX's tick by tick."""
    rng = np.random.default_rng(8)
    B, ticks = 256, 500
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    t, j = both_init((B,), gait="trot", dtype=dtype)
    mode = rng.choice(np.array([0, 1, 2, 3, 4], np.int32), B)
    gait = rng.integers(0, 15, B).astype(np.int32)
    period = rng.uniform(0.3, 0.9, B).astype(np_dt)
    switching = rng.uniform(0.3, 0.8, B).astype(np_dt)
    change = rng.integers(1, 80, B)
    for k in range(ticks):
        moved = (k % change) == 0
        gait = np.where(moved, rng.integers(0, 15, B), gait).astype(np.int32)
        period = np.where(moved, rng.uniform(0.3, 0.9, B), period).astype(np_dt)
        t, j, _ = both_step(t, j, override_mode=mode, user_gait=gait, user_period=period,
                            user_switching=switching)
    assert len(set(t.current_gait.tolist())) >= 12


def test_gait_scheduler_trot_timing():
    prm = gs.params("trot", torch.float64, CPU)
    j_prm = j_gs.params("trot", jnp.float64)
    same_tuple(prm, j_prm)
    st, j_st = gs.init(prm), j_gs.init(j_prm)
    same_tuple(st, j_st)
    contacts, tds = [], np.zeros(4)
    for _ in range(int(0.5 / DT)):
        st, out = gs.step(st, prm, DT)
        j_st, j_out = _j_step(j_st, j_prm, DT)
        same_tuple(st, j_st)
        same_tuple(out, j_out)
        contacts.append(out.contact.numpy())
        tds += out.touchdown.numpy()
    contacts = np.stack(contacts)
    np.testing.assert_allclose(contacts.mean(axis=0), 0.5, atol=0.02)
    np.testing.assert_allclose(contacts[:, 0], contacts[:, 3])
    np.testing.assert_allclose(contacts[:, 1], contacts[:, 2])
    assert (contacts[:, 0] + contacts[:, 1] == 1).all()
    np.testing.assert_allclose(tds, 1.0)


def test_gait_scheduler_three_foot():
    prm = gs.params("three_foot", torch.float64, CPU)
    j_prm = j_gs.params("three_foot", jnp.float64)
    st, j_st = gs.init(prm), j_gs.init(j_prm)
    for _ in range(100):
        st, out = gs.step(st, prm, DT)
        j_st, j_out = _j_step(j_st, j_prm, DT)
        same_tuple(out, j_out)
        assert float(out.contact[0]) == 0.0


def test_early_contact_handle():
    off = np.array([0.0, 0.5, 0.5, 0.0])
    dur = np.array([0.5, 0.5, 0.5, 0.5])
    swing = np.array([0.9, 0.2, 0.0, 0.0])
    sensor = np.array([1.0, 1.0, 0.0, 0.0])
    args = (off, dur, swing, np.array(0.9), sensor, np.array(16))
    off2, dur2 = gs.early_contact_handle(*(torch.from_numpy(a) for a in args))
    j_off2, j_dur2 = jax.jit(j_gs.early_contact_handle)(*(jnp.asarray(a) for a in args))
    same(off2, j_off2)
    same(dur2, j_dur2)
    assert abs(float(off2[0]) - (0.0 - 0.1 * 1.0001)) < 1e-6
    assert abs(float(dur2[0]) - 0.6) < 1e-6
    assert float(off2[1]) == 0.5 and float(dur2[1]) == 0.5


def test_adaptive_gait_update():
    g = gait_ops.preset("trotting", device=CPU)
    j_g = j_gait.preset("trotting")
    swing, sensor = np.array([0.9, 0.0, 0.0, 0.0]), np.array([1.0, 0.0, 0.0, 0.0])
    g2 = cv.adaptive_gait_update(g, torch.from_numpy(swing), torch.tensor(0.45),
                                 torch.from_numpy(sensor))
    j_g2 = jax.jit(j_cv.adaptive_gait_update)(j_g, jnp.asarray(swing), jnp.asarray(0.45),
                                              jnp.asarray(sensor))
    same_tuple(g2, j_g2)
    assert int(g2.durations[0]) > int(g.durations[0])
    assert int(g2.durations[1]) == int(g.durations[1])


def test_adaptive_gait_update_seeded_equal_reference():
    """Seeded swing states, phases and sensors over a mixed batch of preset
    gaits (negative offsets after the pull-in included): integer offsets
    and durations equal, truncation toward zero in both."""
    rng = np.random.default_rng(21)
    B = 512
    names = ["trotting", "bounding", "pronking", "pacing", "galloping", "walking"]
    g = gait_ops.stacked_presets(names, device=CPU)
    j_g = j_gait.stacked_presets(names)
    idx = rng.integers(0, len(names), B)
    g = type(g)(*(leaf[torch.from_numpy(idx)] for leaf in g))
    j_g = type(j_g)(*(leaf[jnp.asarray(idx)] for leaf in j_g))
    swing = rng.uniform(0.0, 1.0, (B, 4)).astype(np.float32)
    phase = rng.uniform(0.0, 1.0, B).astype(np.float32)
    sensor = (rng.uniform(size=(B, 4)) > 0.4).astype(np.float32)
    g2 = cv.adaptive_gait_update(g, *map(torch.from_numpy, (swing, phase, sensor)))
    j_g2 = jax.jit(j_cv.adaptive_gait_update)(j_g, *map(jnp.asarray, (swing, phase, sensor)))
    same_tuple(g2, j_g2)
    assert (g2.offsets.numpy() < 0).any()
    assert (g2.durations != g.durations).any()
