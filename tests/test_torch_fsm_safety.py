"""The port's FSM and safety checks against the JAX package: the five tests
of tests/test_fsm_safety.py, each run in both packages on the same inputs,
and seeded fleets.  Integer states, modes and counters and the bool masks
are held equal exactly; the clamped float32 values too (a clamp moves no
bits but to its bound, and the bound is the same float32 product)."""

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from quad_periodic_mpc_tpu.control import fsm as j_fsm
from quad_periodic_mpc_tpu.control import safety as j_safety
from quad_periodic_mpc_tpu.models.a1 import A1 as J_A1
from quad_periodic_mpc_tpu_torch import convert
from quad_periodic_mpc_tpu_torch.control import fsm, safety
from quad_periodic_mpc_tpu_torch.models.a1 import A1

CPU = "cpu"


def equal(t, j):
    t, j = convert.to_numpy(t), np.asarray(j)
    assert t.dtype == j.dtype and t.shape == j.shape, (t.dtype, j.dtype, t.shape, j.shape)
    np.testing.assert_array_equal(t, j)


def equal_fsm(t: fsm.FSMState, j):
    for name, tl, jl in zip(fsm.FSMState._fields, t, j):
        equal(tl, jl)


class Both:
    """One FSM in each package, stepped with the same inputs."""

    def __init__(self, batch=()):
        self.t = fsm.init(batch, device=CPU)
        self.j = j_fsm.init(batch)
        self.batch = batch

    def step(self, req, safe=True, loco_safe=True):
        req, safe, loco = (np.broadcast_to(np.asarray(v, d), self.batch)
                           for v, d in ((req, np.int32), (safe, bool), (loco_safe, bool)))
        self.t = fsm.step(self.t, torch.from_numpy(req.copy()), torch.from_numpy(safe.copy()),
                          torch.from_numpy(loco.copy()))
        self.j = j_fsm.step(self.j, jnp.asarray(req), jnp.asarray(safe), jnp.asarray(loco))
        equal_fsm(self.t, self.j)
        return self.t


def test_constants_equal_reference():
    for name in ("PASSIVE", "STAND_UP", "BALANCE_STAND", "LOCOMOTION", "RECOVERY_STAND",
                 "LAY_DOWN", "VISION", "BACKFLIP", "TESTING", "TESTING_CV", "NORMAL",
                 "TRANSITIONING", "ESTOP", "EDAMP", "EDAMP_ITERATIONS"):
        assert getattr(fsm, name) == getattr(j_fsm, name), name
    equal_fsm(fsm.init((3,), device=CPU), j_fsm.init((3,)))


def test_passive_to_locomotion_via_standup():
    b = Both()
    # passive -> locomotion directly is illegal
    assert int(b.step(fsm.LOCOMOTION).state) == fsm.PASSIVE
    # passive -> standup -> locomotion works
    assert int(b.step(fsm.STAND_UP).state) == fsm.STAND_UP
    assert int(b.step(fsm.LOCOMOTION).state) == fsm.LOCOMOTION


def test_unsafe_orientation_edamp_then_estop():
    b = Both()
    b.step(fsm.STAND_UP)
    b.step(fsm.LOCOMOTION)
    assert int(b.step(fsm.LOCOMOTION, safe=False).mode) == fsm.EDAMP
    for _ in range(fsm.EDAMP_ITERATIONS + 1):
        f = b.step(fsm.LOCOMOTION, safe=False)
    assert int(f.mode) == fsm.ESTOP
    assert int(f.state) == fsm.PASSIVE


def test_unsafe_locomotion_forces_recovery():
    b = Both()
    b.step(fsm.STAND_UP)
    b.step(fsm.LOCOMOTION)
    assert int(b.step(fsm.LOCOMOTION, loco_safe=False).state) == fsm.RECOVERY_STAND


def test_batched_mixed_states():
    b = Both((3,))
    f = b.step([fsm.STAND_UP, fsm.PASSIVE, fsm.STAND_UP])
    assert f.state.tolist() == [fsm.STAND_UP, fsm.PASSIVE, fsm.STAND_UP]
    f = b.step([fsm.LOCOMOTION, fsm.LOCOMOTION, fsm.BALANCE_STAND])
    # instance 1 still passive (illegal), others transition
    assert f.state.tolist() == [fsm.LOCOMOTION, fsm.PASSIVE, fsm.BALANCE_STAND]


def test_every_pair_and_unknown_state_equal_reference():
    """Every (current, requested) pair over the state numbering and two
    numbers outside it, from NORMAL: the legality table is the reference's
    pairwise comparison."""
    states = np.arange(-1, 17, dtype=np.int32)
    cur, req = (a.ravel() for a in np.meshgrid(states, states, indexing="ij"))
    n = cur.size
    t0 = fsm.init((n,), device=CPU)._replace(state=torch.from_numpy(cur.copy()))
    j0 = j_fsm.init((n,))._replace(state=jnp.asarray(cur))
    ones = np.ones(n, bool)
    t1 = fsm.step(t0, torch.from_numpy(req.copy()), torch.from_numpy(ones),
                  torch.from_numpy(ones))
    j1 = j_fsm.step(j0, jnp.asarray(req), jnp.asarray(ones), jnp.asarray(ones))
    equal_fsm(t1, j1)
    # a legal request completes in its tick (transition_complete defaults
    # to true): the state moves for exactly the legal pairs
    moved = t1.state.numpy() != cur
    assert moved.sum() == len(fsm._ALLOWED)
    assert (t1.state.numpy()[moved] == req[moved]).all()


def test_safety_clamps():
    p_des = np.array([[[0.5, -0.5, -0.05]] * 4], np.float32)
    force = np.array([[[400.0, -400.0, 100.0]] * 4], np.float32)
    rpy = np.array([[0.2, -0.3, 1.5]], np.float32)
    res = safety.run_checks(torch.from_numpy(rpy), torch.from_numpy(p_des),
                            torch.from_numpy(force), A1)
    ref = j_safety.run_checks(jnp.asarray(rpy), jnp.asarray(p_des), jnp.asarray(force), J_A1)
    for tl, jl in zip(res, ref):
        equal(tl, jl)
    assert bool(res.safe_orientation[0])
    assert not bool(res.safe_p_des[0])
    assert not bool(res.safe_force[0])
    max_pdes = A1.leg.max_leg_length * np.sin(1.0472)
    np.testing.assert_allclose(res.p_des[0, 0].numpy(),
                               [max_pdes, -max_pdes, -A1.leg.max_leg_length / 4], atol=1e-6)
    np.testing.assert_allclose(res.force_ff[0, 0].numpy(), [350.0, -350.0, 100.0])
    # bad orientation detected
    assert not bool(safety.check_safe_orientation(torch.tensor([[1.2, 0.0, 0.0]]))[0])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_seeded_checks_equal_reference(dtype):
    """run_checks and check_locomotion_safe on 512 seeded instances, half of
    them outside each bound, equal in both packages; NaN targets (a pose
    command's unused half) are unsafe in both."""
    rng = np.random.default_rng(12)
    B = 512
    rpy = rng.uniform(-1.3, 1.3, (B, 3)).astype(dtype)
    p_des = rng.uniform(-0.45, 0.1, (B, 4, 3)).astype(dtype)
    p_des[::7, 1, 2] = np.nan
    force = rng.uniform(-420.0, 420.0, (B, 4, 3)).astype(dtype)
    force[::3] *= 0.5
    v_leg = rng.uniform(-6.0, 6.0, (B, 4, 3)).astype(dtype)
    res = safety.run_checks(*map(torch.from_numpy, (rpy, p_des, force)), A1)
    ref = j_safety.run_checks(*map(jnp.asarray, (rpy, p_des, force)), J_A1)
    for tl, jl in zip(res, ref):
        equal(tl, jl)
    loco = safety.check_locomotion_safe(*map(torch.from_numpy, (rpy, p_des, v_leg)))
    j_loco = j_safety.check_locomotion_safe(*map(jnp.asarray, (rpy, p_des, v_leg)))
    equal(loco, j_loco)
    for m in (res.safe_orientation, res.safe_p_des, res.safe_force, loco):
        assert 0 < int(m.sum()) < B
    assert not res.safe_p_des[::7].any()


def test_seeded_fleet_equal_reference():
    """256 FSMs for 1,100 ticks under seeded requests and safety masks
    (orientation faults held for long runs, so that EDAMP reaches ESTOP at
    1,000 ticks), the port's trace equal to JAX's (jitted) tick by tick."""
    rng = np.random.default_rng(5)
    B, ticks = 256, 1100
    states = np.array([fsm.PASSIVE, fsm.STAND_UP, fsm.BALANCE_STAND, fsm.LOCOMOTION,
                       fsm.RECOVERY_STAND, fsm.LAY_DOWN, fsm.VISION, fsm.BACKFLIP,
                       fsm.TESTING, fsm.TESTING_CV], np.int32)
    req = states[rng.integers(0, len(states), (ticks, B))]
    # requests held for 1-50 ticks at a time
    hold = rng.integers(1, 50, (ticks, B))
    for k in range(1, ticks):
        keep = (k % hold[k]) != 0
        req[k] = np.where(keep, req[k - 1], req[k])
    req[:20, : B // 4] = fsm.STAND_UP
    safe = np.ones((ticks, B), bool)
    safe[30:, : B // 4] = False                   # long fault: EDAMP then ESTOP
    safe[:, B // 4:] = rng.uniform(size=(ticks, B - B // 4)) > 0.01
    loco = rng.uniform(size=(ticks, B)) > 0.02
    done = rng.uniform(size=(ticks, B)) > 0.3

    j_step = jax.jit(j_fsm.step)
    t, j = fsm.init((B,), device=CPU), j_fsm.init((B,))
    for k in range(ticks):
        t = fsm.step(t, torch.from_numpy(req[k].copy()), torch.from_numpy(safe[k].copy()),
                     torch.from_numpy(loco[k].copy()), torch.from_numpy(done[k].copy()))
        j = j_step(j, jnp.asarray(req[k]), jnp.asarray(safe[k]), jnp.asarray(loco[k]),
                   jnp.asarray(done[k]))
        if k % 100 == 0 or k == ticks - 1:
            equal_fsm(t, j)
    equal_fsm(t, j)
    assert int((t.mode[: B // 4] == fsm.ESTOP).sum()) >= B // 8
    assert len(set(t.state.tolist())) > 3
