"""The port's closed-loop coverage on the SRB plant against the JAX package:
the mixed-frequency gaits (tests/test_mixed_gait.py's gates), stacked
presets, the GO1 constants, the 6-wrench disturbance, and short rollouts of
the two estimator arms that the port gained ("faithful" with the
reference's residual; "ls6" under a WrenchDisturbance), each long enough
for its fit, freeze and release to happen (window = ls_release = 32,
freeze_after = 40, 50 periods).  The rollouts run float64 PDIP-25 on both
sides (the reference's closed-loop solver), JAX jitted.
"""

import dataclasses

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
from quad_periodic_mpc_tpu.models import a1 as j_a1
from quad_periodic_mpc_tpu.ops import gait as j_gait
from quad_periodic_mpc_tpu.sim import srb_sim as j_sim
from quad_periodic_mpc_tpu_torch import config as tc
from quad_periodic_mpc_tpu_torch import convert
from quad_periodic_mpc_tpu_torch.control import loop as t_loop
from quad_periodic_mpc_tpu_torch.models import a1 as t_a1
from quad_periodic_mpc_tpu_torch.ops import gait as G
from quad_periodic_mpc_tpu_torch.sim import srb_sim as t_sim

F64 = jnp.float64
CPU = "cpu"


def test_phase_per_leg_periods():
    g = G.mixed(periods=(8, 10, 12, 16), duty_cycle=0.5, device=CPU)
    it = 3 * 13 * 8 + 5
    ph = G.mixed_phase(g, torch.tensor(it), 13).numpy()
    for j, T in enumerate([8, 10, 12, 16]):
        assert abs(ph[j] - (it % (13 * T)) / (13 * T)) < 1e-6
    assert np.all((ph >= 0) & (ph < 1))


def test_contact_swing_partition():
    g = G.mixed(periods=(8, 10, 12, 16), duty_cycle=0.4, device=CPU)
    for it in [0, 7, 55, 123, 1000]:
        ph = G.mixed_phase(g, torch.tensor(it), 13)
        c = G.mixed_contact_state(g, ph).numpy()
        s = G.mixed_swing_state(g, ph).numpy()
        assert np.all((c > 0) ^ (s > 0) | (ph.numpy() == 0.0))
        assert np.all((c >= 0) & (c <= 1) & (s >= 0) & (s <= 1))


def test_mpc_table_duty_fraction():
    g = G.mixed(periods=(4, 5, 8, 10), duty_cycle=0.5, device=CPU)
    tab = G.mixed_mpc_table(g, torch.tensor(0), 13, horizon=40).numpy()
    assert tab.shape == (40, 4) and tab.dtype == np.int32
    expect = [np.sum(np.arange(T) < T * 0.5) / T for T in [4, 5, 8, 10]]
    assert np.allclose(tab.mean(0), expect)
    for j, T in enumerate([4, 5, 8, 10]):
        assert np.array_equal(tab[:40 - T, j], tab[T:, j])


def test_times_scale_with_period():
    g = G.mixed(periods=(8, 10, 12, 16), duty_cycle=0.4, device=CPU)
    sw = G.mixed_swing_time(g, 0.026).numpy()
    st = G.mixed_stance_time(g, 0.026).numpy()
    T = np.array([8, 10, 12, 16])
    assert np.allclose(sw, 0.026 * 0.6 * T)
    assert np.allclose(st, 0.026 * 0.4 * T)
    assert np.allclose(sw + st, 0.026 * T)


def test_batched():
    g = G.MixedGaitParams(
        periods=torch.tensor([[8, 8, 8, 8], [6, 8, 10, 12]], dtype=torch.int32),
        duty_cycle=torch.tensor([0.5, 0.4]), n_segments=torch.tensor([10, 10], dtype=torch.int32))
    it = torch.tensor([100, 100])
    assert G.mixed_phase(g, it, 13).shape == (2, 4)
    assert G.mixed_mpc_table(g, it, 13, horizon=10).shape == (2, 10, 4)


def test_mixed_family_matches_jax():
    """Every mixed-gait function on a batch of gaits and unwrapped
    iteration counts, against JAX's: tables and states exactly (the same
    integer and f32 operations), times to 1e-7."""
    rng = np.random.default_rng(8)
    periods = rng.integers(3, 17, (6, 4)).astype(np.int32)
    duty = rng.uniform(0.3, 0.7, 6).astype(np.float32)
    jg = j_gait.MixedGaitParams(jnp.asarray(periods), jnp.asarray(duty),
                                jnp.full((6,), 10, jnp.int32))
    tg = convert.mixed_gait_params(jg, CPU)
    it = rng.integers(0, 5000, 6).astype(np.int32)
    jph = j_gait.mixed_phase(jg, jnp.asarray(it), 13)
    tph = G.mixed_phase(tg, torch.from_numpy(it), 13)
    np.testing.assert_array_equal(tph.numpy(), np.asarray(jph))
    np.testing.assert_array_equal(G.mixed_contact_state(tg, tph).numpy(),
                                  np.asarray(j_gait.mixed_contact_state(jg, jph)))
    np.testing.assert_array_equal(G.mixed_swing_state(tg, tph).numpy(),
                                  np.asarray(j_gait.mixed_swing_state(jg, jph)))
    np.testing.assert_array_equal(
        G.mixed_mpc_table(tg, torch.from_numpy(it), 13, 12).numpy(),
        np.asarray(j_gait.mixed_mpc_table(jg, jnp.asarray(it), 13, 12)))
    for fn in ("mixed_swing_time", "mixed_stance_time"):
        np.testing.assert_allclose(getattr(G, fn)(tg, 0.026).numpy(),
                                   np.asarray(getattr(j_gait, fn)(jg, 0.026)), rtol=1e-7)
    d = j_gait.mixed()
    p = G.mixed(device=CPU)
    for a, b in zip(p, d):
        assert a.dtype == convert.tensor(b, CPU).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("names", [None, ["trotting", "pacing", "trot_long"]])
def test_stacked_presets_match_jax(names):
    """Presets on a leading gait axis, the default list (every preset) and a
    subset, at the default period and at 20, equal to JAX's."""
    for period in (G.DEFAULT_PERIOD, 20):
        t = G.stacked_presets(names, period=period, device=CPU)
        j = j_gait.stacked_presets(names, period=period)
        for a, b in zip(t, j):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert t.offsets.shape == (len(names or j_gait.PRESET_GAITS), 4)


def test_go1_constants_equal_reference():
    """GO1 field by field, its hips and side signs, and get_model."""
    assert dataclasses.asdict(t_a1.GO1) == dataclasses.asdict(j_a1.GO1)
    np.testing.assert_array_equal(t_a1.GO1.hip_locations(), j_a1.GO1.hip_locations())
    np.testing.assert_array_equal(t_a1.GO1.side_signs(), j_a1.GO1.side_signs())
    assert t_a1.get_model("go1") is t_a1.GO1 and t_a1.get_model("a1") is t_a1.A1
    with pytest.raises(KeyError):
        t_a1.get_model("b1")


def _wrench(batch):
    """WrenchDisturbance.zero with component 4 static -0.6, amp 1.0, freq
    0.4 (the reference's lateral test) and seeded others on component 1."""
    d = j_sim.WrenchDisturbance.zero(batch, F64)
    return d._replace(static=d.static.at[..., 4].set(-0.6).at[..., 1].set(0.2),
                      amp=d.amp.at[..., 4].set(1.0).at[..., 1].set(0.3),
                      freq=d.freq.at[..., 4].set(0.4),
                      phase=d.phase.at[..., 1].set(0.5))


def test_disturbance_wrench_matches_jax():
    """The 6-wrench of a WrenchDisturbance (acceleration space, no mass
    division) and of DisturbanceParams (F_x / m), zero() defaults included,
    at seeded times: 1e-12 in float64."""
    t = np.random.default_rng(2).uniform(0, 30, (3,))
    jw = _wrench((3,))
    tw = convert.wrench_disturbance(jw, CPU)
    np.testing.assert_allclose(
        t_sim.disturbance_wrench(tw, torch.from_numpy(t), 12.0).numpy(),
        np.asarray(j_sim.disturbance_wrench(jw, jnp.asarray(t), 12.0, F64)), atol=1e-12)
    for name in ("reference", "zero"):
        jd = getattr(j_sim.DisturbanceParams, name)((3,), F64)
        td = getattr(t_sim.DisturbanceParams, name)((3,), torch.float64, CPU)
        for a, b in zip(td, jd):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_allclose(
            t_sim.disturbance_wrench(td, torch.from_numpy(t), 12.0).numpy(),
            np.asarray(j_sim.disturbance_wrench(jd, jnp.asarray(t), 12.0, F64)), atol=1e-12)
    for a, b in zip(t_sim.WrenchDisturbance.zero((3,), torch.float64, CPU),
                    j_sim.WrenchDisturbance.zero((3,), F64)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _rollout_setup(batch, window=400):
    plant = j_sim.init_plant(batch, body_height=0.29, dtype=F64)
    ctrl = j_mpc.init_state(batch, j_sim.observe(plant), window=window, dtype=F64)
    n = int(np.prod(batch))
    ctrl = ctrl._replace(iteration=((jnp.arange(n, dtype=jnp.int32) * 7) % 208).reshape(batch))
    full = lambda v: jnp.full(batch, v, F64)
    cmd = j_mpc.Command(vx=full(0.3), vy=full(0.0), yaw_rate=full(0.0), body_height=full(0.29))
    return plant, ctrl, cmd


# float64 on both sides.  The PDIP-25 answers differ by ~1e-12 in the first
# period (Cholesky and sums in another order), and the closed loop carries
# that to 4e-7 on the state (m, rad, m/s) and 4e-6 N on the forces by period
# 50, with no estimator at all (mode "off" measures the same); the released
# estimate moves by up to 7e-6 with them.  The tolerances are ~10x those
# measurements; the fitted frequency (an FFT bin, or the LS grid's pick)
# must be the same, to the last ulp of k / (n dt).
ROLL_TOL = {"x": 2e-6, "forces": 5e-5, "f_est": 5e-5, "est_freq": 1e-12, "est_amp": 2e-6}


@pytest.mark.parametrize("arm", ["faithful", "ls6"])
def test_estimator_arm_rollout_matches_jax(arm):
    """50 periods of the trot (vx = 0.3, two gait phases): "faithful" with
    the reference residual under the paper's F_x disturbance, "ls6" with the
    discrete residual under the lateral WrenchDisturbance, against JAX's
    rollout; the fit is active, then frozen (faithful) and released."""
    batch, n = (2,), 50
    est_kw = dict(window=32, ls_release=32, freeze_after=40)
    if arm == "faithful":
        est_kw.update(mode="faithful", residual="reference")
        jd = j_sim.DisturbanceParams.reference(batch, F64)
        td = convert.disturbance(jd, CPU)
    else:
        est_kw.update(mode="ls6", residual="discrete")
        jd = _wrench(batch)
        td = convert.wrench_disturbance(jd, CPU)
    plant, ctrl, cmd = _rollout_setup(batch, window=32)
    j_cfg = (jc.MPCConfig(horizon=10), jc.LoopConfig(), jc.EstimatorConfig(**est_kw),
             jc.PDIPConfig(iterations=25))
    t_cfg = (tc.MPCConfig(horizon=10), tc.LoopConfig(), tc.EstimatorConfig(**est_kw),
             tc.PDIPConfig(iterations=25))
    j_run = jax.jit(lambda p, c: j_loop.rollout(n, p, c, cmd, j_gait.preset("trotting"), jd,
                                                *j_cfg))
    carry_j, tr_j = j_run(plant, ctrl)
    carry_t, tr_t = t_loop.rollout(
        n, convert.plant_state(plant, CPU), convert.controller_state(ctrl, CPU),
        convert.command(cmd, CPU), G.preset("trotting", device=CPU), td, *t_cfg)
    for f, tol in ROLL_TOL.items():
        np.testing.assert_allclose(getattr(tr_t, f).numpy(), np.asarray(getattr(tr_j, f)),
                                   atol=tol, rtol=0, err_msg=f)
    for f in ("est6_freq", "est6_stat", "est6_sin", "est6_cos", "f_est_static", "count"):
        np.testing.assert_allclose(getattr(carry_t.ctrl.est, f).numpy(),
                                   np.asarray(getattr(carry_j.ctrl.est, f)),
                                   atol=ROLL_TOL["f_est"], err_msg=f)
    # the arm's lifecycle happened: fitted from period 32, released
    f_est = tr_t.f_est.numpy()
    assert np.all(f_est[:, :31] == 0.0)
    comp = 4 if arm == "ls6" else 3
    assert np.all(np.abs(f_est[:, 45:, comp]) > 0)
    if arm == "faithful":
        amp = tr_t.est_amp.numpy()
        assert np.all(amp[:, 40:] == amp[:, 39:40])      # frozen after 40
    assert np.isfinite(tr_t.x.numpy()).all()


def test_go1_rollout_matches_jax():
    """The GO1 constants drive the loop: 12 periods at vx = 0.2 (the
    reference's GO1 test, cut), against JAX's, and the GO1's foot targets
    differ from the A1's."""
    batch, n = (2,), 12
    plant, ctrl, cmd = _rollout_setup(batch)
    cmd = cmd._replace(vx=jnp.full(batch, 0.2, F64))
    jd = j_sim.DisturbanceParams.zero(batch, F64)
    cfgs = lambda m: (m.MPCConfig(horizon=10), m.LoopConfig(), m.EstimatorConfig(),
                      m.PDIPConfig(iterations=25))
    carry_j, tr_j = jax.jit(lambda p, c: j_loop.rollout(
        n, p, c, cmd, j_gait.preset("trotting"), jd, *cfgs(jc), model=j_a1.GO1))(plant, ctrl)
    args = (convert.plant_state(plant, CPU), convert.controller_state(ctrl, CPU),
            convert.command(cmd, CPU), G.preset("trotting", device=CPU),
            convert.disturbance(jd, CPU), *cfgs(tc))
    carry_t, tr_t = t_loop.rollout(n, *args, model=t_a1.GO1)
    np.testing.assert_allclose(tr_t.x.numpy(), np.asarray(tr_j.x), atol=ROLL_TOL["x"])
    np.testing.assert_allclose(carry_t.ctrl.swing_pf.numpy(),
                               np.asarray(carry_j.ctrl.swing_pf), atol=ROLL_TOL["x"])
    x = tr_t.x.numpy()
    assert np.isfinite(x).all() and np.all(np.abs(x[:, -1, 5] - 0.29) < 0.05)
    carry_a1, _ = t_loop.rollout(n, *args)
    assert not torch.allclose(carry_a1.ctrl.swing_pf, carry_t.ctrl.swing_pf)
