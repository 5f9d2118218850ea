"""The port's small modules against the JAX package, and its hygiene.

Inputs are made with numpy from a seed and handed to both packages.  Each
tolerance is stated with its reason; "exact" means the two compute the same
f32 operations in the same order.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

import jax.numpy as jnp

from quad_periodic_mpc_tpu import config as j_config
from quad_periodic_mpc_tpu.models import a1 as j_a1
from quad_periodic_mpc_tpu.models import srb as j_srb
from quad_periodic_mpc_tpu.ops import condense as j_condense
from quad_periodic_mpc_tpu.ops import constraints as j_con
from quad_periodic_mpc_tpu.ops import discretize as j_disc
from quad_periodic_mpc_tpu.ops import estimator as j_est
from quad_periodic_mpc_tpu.ops import gait as j_gait
from quad_periodic_mpc_tpu.ops import linalg as j_linalg
from quad_periodic_mpc_tpu.ops import rotations as j_rot
from quad_periodic_mpc_tpu.ops import swing as j_swing
from quad_periodic_mpc_tpu_torch import config as t_config
from quad_periodic_mpc_tpu_torch import convert
from quad_periodic_mpc_tpu_torch.models import a1 as t_a1
from quad_periodic_mpc_tpu_torch.models import srb as t_srb
from quad_periodic_mpc_tpu_torch.ops import condense as t_condense
from quad_periodic_mpc_tpu_torch.ops import constraints as t_con
from quad_periodic_mpc_tpu_torch.ops import discretize as t_disc
from quad_periodic_mpc_tpu_torch.ops import estimator as t_est
from quad_periodic_mpc_tpu_torch.ops import gait as t_gait
from quad_periodic_mpc_tpu_torch.ops import linalg as t_linalg
from quad_periodic_mpc_tpu_torch.ops import rotations as t_rot
from quad_periodic_mpc_tpu_torch.ops import swing as t_swing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 elementwise math with transcendental functions: libm (XLA) and
# torch's vectorized sin/cos/atan2 differ by a few ulp
TRIG_ATOL = 2e-6


def j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(tt, jj, atol, rtol=0.0):
    np.testing.assert_allclose(
        tt.detach().numpy(), np.asarray(jj), atol=atol, rtol=rtol)


def test_import_leaves_jax_out():
    """Importing every module of the port loads neither JAX nor the JAX
    package (a fresh interpreter: this one has imported both)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import quad_periodic_mpc_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'quad_periodic_mpc_tpu'"
        " or m.startswith('quad_periodic_mpc_tpu.')]\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n"
        "assert not bad, bad\n"
        "terrain = ['heightmap', 'scenario', 'sensor', 'input_sources', 'postprocess',"
        " 'footstep_planner']\n"
        "missing = [m for m in terrain if p.__name__ + '.terrain.' + m not in sys.modules]\n"
        "assert not missing and p.__name__ + '.control.cmpc_variant' in sys.modules, missing\n"
        "slice8 = ['control.fsm', 'control.safety', 'control.poses', 'control.playback',"
        " 'control.balance', 'control.balance_vbl', 'control.wbc_tasks',"
        " 'control.force_stand', 'ops.gait_scheduler', 'utils.filters']\n"
        "missing = [m for m in slice8 if p.__name__ + '.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
        "slice9 = ['__main__', 'cli', 'runtime', 'runtime.native_bridge', 'utils.telemetry',"
        " 'utils.viz', 'utils.checkpoint', 'utils.live_tune', 'testing.fixtures',"
        " 'testing.golden']\n"
        "missing = [m for m in slice9 if p.__name__ + '.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
        "slice10 = ['runtime.graphs', 'utils.consts']\n"
        "missing = [m for m in slice10 if p.__name__ + '.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
        "assert p.__name__ + '.parallel.batch_group' in sys.modules\n"
        "slice12 = ['tools', 'tools.parity_table', 'tools.estimator_ab']\n"
        "missing = [m for m in slice12 if p.__name__ + '.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    # every module was imported, slice 2's (articulated model, WBC, plant,
    # full stack, the three kernel wrappers), slice 6's (the terrain tier,
    # cmpc_variant), slice 8's (the FSM and its controllers, the gait
    # scheduler, utils.filters) and slice 9's (the CLI and __main__, whose
    # import runs nothing, the runtime bridge, the utilities, the fixtures
    # and the golden solves), slice 10's (the CUDA graphs, the constant
    # cache), slice 11's (the batch group) and slice 12's (the evidence
    # tools) included
    assert int(out.stdout.strip()) >= 88


@pytest.mark.parametrize("name", [
    "MPCConfig", "ADMMConfig", "PDIPConfig", "EstimatorConfig",
    "SwingConfig", "LoopConfig", "GaitConfig"])
def test_config_defaults_equal_reference(name):
    ref = dataclasses.asdict(getattr(j_config, name)())
    port = dataclasses.asdict(getattr(t_config, name)())
    assert port == ref
    assert t_config.LoopConfig().dt_mpc == j_config.LoopConfig().dt_mpc


@pytest.mark.parametrize("module,name", [
    ("models.floating_base", "A1ModelParams"), ("sim.articulated_sim", "ContactParams"),
    ("control.wbc", "WBCGains"), ("estimation.kf", "KFParams")])
def test_slice2_defaults_equal_reference(module, name):
    """The copied dataclasses of the torque tick and of the Kalman filter,
    field by field (the PDIPConfig the WBC and the full stack use is checked
    above)."""
    import importlib

    ref = getattr(importlib.import_module(f"quad_periodic_mpc_tpu.{module}"), name)()
    port = getattr(importlib.import_module(f"quad_periodic_mpc_tpu_torch.{module}"), name)()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_tunable_defaults_equal_reference():
    """TunableParams.from_config on both packages, leaf by leaf, with
    non-default configs too; leaves on the requested device and dtype."""
    for kw in ({}, dict(mpc=dict(alpha=1e-4, f_max=90.0, x_drag_gain=2.0),
                        loop=dict(swing_height=0.12), swing=dict(bonus_swing=0.1))):
        jt = j_config.TunableParams.from_config(
            j_config.MPCConfig(**kw.get("mpc", {})), j_config.LoopConfig(**kw.get("loop", {})),
            j_config.EstimatorConfig(), j_config.SwingConfig(**kw.get("swing", {})))
        tt = t_config.TunableParams.from_config(
            t_config.MPCConfig(**kw.get("mpc", {})), t_config.LoopConfig(**kw.get("loop", {})),
            t_config.EstimatorConfig(), t_config.SwingConfig(**kw.get("swing", {})), device="cpu")
        assert tt._fields == jt._fields
        for a, b in zip(tt, jt):
            assert a.dtype == torch.float32 and a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        conv = convert.tunable_params(jt, "cpu")
        for a, b in zip(conv, tt):
            assert torch.equal(a, b)
    t64 = t_config.TunableParams.from_config(dtype=torch.float64, device="cpu")
    assert all(v.dtype == torch.float64 for v in t64)


def test_a1_constants_equal_reference():
    jm, tm = j_a1.A1, t_a1.A1
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    np.testing.assert_array_equal(tm.hip_locations(), jm.hip_locations())
    np.testing.assert_array_equal(tm.side_signs(), jm.side_signs())


def test_rotations_match():
    rng = np.random.default_rng(0)
    rpy = rng.uniform(-1.0, 1.0, (16, 3))
    q = rng.normal(size=(16, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.normal(size=(16, 3))
    close(t_rot.quat_to_rpy(t(q)), j_rot.quat_to_rpy(j(q)), TRIG_ATOL)
    close(t_rot.quat_to_rotmat(t(q)), j_rot.quat_to_rotmat(j(q)), TRIG_ATOL)
    close(t_rot.rpy_to_rotmat(t(rpy)), j_rot.rpy_to_rotmat(j(rpy)), TRIG_ATOL)
    close(t_rot.rpy_to_quat(t(rpy)), j_rot.rpy_to_quat(j(rpy)), TRIG_ATOL)
    close(t_rot.skew(t(v)), j_rot.skew(j(v)), 0.0)


def _srb_inputs(seed=1, B=6):
    rng = np.random.default_rng(seed)
    rpy = rng.uniform(-0.3, 0.3, (B, 3))
    R = np.asarray(j_rot.rpy_to_rotmat(j(rpy)))
    r_feet = rng.uniform(-0.3, 0.3, (B, 4, 3))
    x_drag = rng.uniform(-0.5, 0.5, B)
    return R, r_feet, x_drag


def test_srb_ct_dynamics_and_pack_state_match():
    """1e-6: the 3x3 inverse-inertia products sum in another order."""
    R, r_feet, x_drag = _srb_inputs()
    I = (0.07, 0.26, 0.242)
    A_t, B_t, Q_t = t_srb.ct_dynamics(t(R), t(r_feet), 12.0, I, t(x_drag))
    A_j, B_j, Q_j = j_srb.ct_dynamics(j(R), j(r_feet), 12.0, j(I), j(x_drag))
    close(A_t, A_j, 0.0)
    close(B_t, B_j, 1e-6, 1e-6)
    close(Q_t, Q_j, 0.0)
    rng = np.random.default_rng(2)
    parts = [rng.normal(size=(5, 3)) for _ in range(4)]
    close(t_srb.pack_state(*map(t, parts), 9.8),
          j_srb.pack_state(*map(j, parts), 9.8), 0.0)


def test_nilpotent_zoh_matches_reference_and_matrix_exp():
    """Against the JAX closed form (1e-6, reordered f32 sums) and against
    torch.linalg.matrix_exp of the augmented 31x31 block in float64 (the
    reference's c2qp construction): 1e-6 is f32 roundoff on O(dt) entries."""
    R, r_feet, x_drag = _srb_inputs(seed=3)
    I = (0.07, 0.26, 0.242)
    dt = 0.026
    A, B, Qc = t_srb.ct_dynamics(t(R), t(r_feet), 12.0, I, t(x_drag))
    Ad, Bd, Qd = t_disc.nilpotent_zoh(A, B, Qc, dt)
    Aj, Bj, Qj = j_srb.ct_dynamics(j(R), j(r_feet), 12.0, j(I), j(x_drag))
    for got, want in zip((Ad, Bd, Qd), j_disc.nilpotent_zoh(Aj, Bj, Qj, dt)):
        close(got, want, 1e-6)
    n, m, w = 13, 12, 6
    aug = torch.zeros(A.shape[0], n + m + w, n + m + w, dtype=torch.float64)
    aug[:, :n, :n] = A.double()
    aug[:, :n, n:n + m] = B.double()
    aug[:, :n, n + m:] = Qc.double()
    e = torch.linalg.matrix_exp(dt * aug)
    close(Ad.double(), e[:, :n, :n], 1e-6)
    close(Bd.double(), e[:, :n, n:n + m], 1e-6)
    close(Qd.double(), e[:, :n, n + m:], 1e-6)


def test_constraints_and_weights_match():
    rng = np.random.default_rng(4)
    table = rng.integers(0, 2, (3, 10, 4)).astype(np.int32)
    close(t_con.pyramid_block(0.4, device="cpu"), j_con.pyramid_block(0.4), 0.0)
    l_t, u_t = t_con.bounds(torch.from_numpy(table), 120.0, 5e10)
    l_j, u_j = j_con.bounds(jnp.asarray(table), 120.0, 5e10)
    close(l_t, l_j, 0.0)
    close(u_t, u_j.astype(jnp.float32), 0.0)
    w = rng.uniform(0, 10, 12)
    close(t_condense.full_weight(t(w)), j_condense.full_weight(j(w)), 0.0)


@pytest.mark.parametrize("name", ["trotting", "walking", "pacing", "two_leg_balance"])
def test_gait_tables_match_exactly(name):
    jg = j_gait.preset(name)
    tg = t_gait.preset(name, device="cpu")
    for f in jg._fields:
        np.testing.assert_array_equal(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)))
    it = np.arange(0, 520, 7, dtype=np.int32)
    ti, ji = torch.from_numpy(it), jnp.asarray(it)
    ph_t, ph_j = t_gait.phase(tg, ti, 13), j_gait.phase(jg, ji, 13)
    close(ph_t, ph_j, 0.0)
    close(t_gait.contact_state(tg, ph_t), j_gait.contact_state(jg, ph_j), 0.0)
    close(t_gait.swing_state(tg, ph_t), j_gait.swing_state(jg, ph_j), 0.0)
    seg_t, seg_j = t_gait.segment_index(tg, ti, 13), j_gait.segment_index(jg, ji, 13)
    np.testing.assert_array_equal(seg_t.numpy(), np.asarray(seg_j))
    np.testing.assert_array_equal(
        t_gait.mpc_table(tg, seg_t, 10).numpy(), np.asarray(j_gait.mpc_table(jg, seg_j, 10)))
    close(t_gait.swing_time(tg, 0.026), j_gait.swing_time(jg, 0.026), 0.0)
    close(t_gait.stance_time(tg, 0.026), j_gait.stance_time(jg, 0.026), 0.0)


@pytest.mark.parametrize("n", [6, 12])
def test_spd_inverse_matches(n):
    """Same Schur recursion and split: rtol 1e-5 allows reordered sums in
    the small products on a condition-~100 matrix."""
    rng = np.random.default_rng(n)
    A = rng.normal(size=(4, n, n))
    M = A @ np.swapaxes(A, -1, -2) + n * np.eye(n)
    close(t_linalg.spd_inverse(t(M)), j_linalg.spd_inverse(j(M)), 1e-7, 1e-5)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 12, 28])
def test_spd_inverse_sym_matches(n):
    """The upper-triangle form of the same recursion: the reference's
    spd_inverse to rtol 1e-5 on a condition-~100 matrix (reordered sums),
    symmetric to rounding, over any leading dims."""
    rng = np.random.default_rng(40 + n)
    A = rng.normal(size=(2, 3, n, n))
    M = A @ np.swapaxes(A, -1, -2) + n * np.eye(n)
    got = t_linalg.spd_inverse_sym(t(M))
    close(got, j_linalg.spd_inverse(j(M)), 1e-7, 1e-5)
    close(got, got.transpose(-1, -2), 1e-7, 1e-5)


def test_spd_solve_and_block_diag_match():
    """spd_solve through the same Schur inverse (rtol 1e-5, as above);
    add_block_diag exact (one f32 add per entry)."""
    rng = np.random.default_rng(8)
    A = rng.normal(size=(3, 12, 12))
    M = A @ np.swapaxes(A, -1, -2) + 12 * np.eye(12)
    rhs, rhs2 = rng.normal(size=(3, 12)), rng.normal(size=(3, 12, 2))
    close(t_linalg.spd_solve(t(M), t(rhs)), j_linalg.spd_solve(j(M), j(rhs)), 1e-6, 1e-5)
    close(t_linalg.spd_solve(t(M), t(rhs2)), j_linalg.spd_solve(j(M), j(rhs2)), 1e-6, 1e-5)
    G = rng.normal(size=(3, 4, 3, 3))
    close(t_linalg.add_block_diag(t(M), t(G)), j_linalg.add_block_diag(j(M), j(G)), 0.0)
    chol = t_linalg.cholesky_factor(t(M))
    close(t_linalg.cho_solve(chol, t(rhs)),
          j_linalg.cho_solve(j_linalg.cholesky_factor(j(M)), j(rhs)), 1e-6, 1e-5)


def test_cone_apply_and_quat_product_match():
    """blockdiag(F) products on the 5x3 pyramid and the 6x3 WBIC cone, and
    the Hamilton product: 1e-6 (three-term f32 sums)."""
    from quad_periodic_mpc_tpu.estimation import orientation as j_ori
    from quad_periodic_mpc_tpu_torch.control.wbc import cone_block
    from quad_periodic_mpc_tpu_torch.estimation import orientation as t_ori

    rng = np.random.default_rng(10)
    for F in (t_con.pyramid_block(0.4, device="cpu"), cone_block(0.4, device="cpu")):
        c = F.shape[0]
        x, y = rng.normal(size=(5, 12)), rng.normal(size=(5, 4 * c))
        close(t_con.apply(F, t(x)), j_con.apply(j(F), j(x)), 1e-6)
        close(t_con.apply_T(F, t(y)), j_con.apply_T(j(F), j(y)), 1e-6)
    a, b = rng.normal(size=(6, 4)), rng.normal(size=(6, 4))
    close(t_ori.quat_product(t(a), t(b)), j_ori.quat_product(j(a), j(b)), 1e-6)


def _residual_inputs(seed=5, B=6):
    rng = np.random.default_rng(seed)
    R, r_feet, x_drag = _srb_inputs(seed, B)
    x_k = rng.normal(size=(B, 13))
    x_prev = rng.normal(size=(B, 13))
    forces = rng.uniform(-20, 60, (B, 4, 3))
    return x_k, x_prev, forces, R, r_feet, x_drag


def test_residuals_match():
    """Disturbance residuals: 1e-4 absolute on O(10) accelerations (the
    discrete one divides by dt-scaled normal equations, ~1e-5 relative)."""
    x_k, x_prev, forces, R, r_feet, x_drag = _residual_inputs()
    I = (0.07, 0.26, 0.242)
    got = t_est.residual_discrete(
        t(x_k), t(x_prev), t(forces), t(R), t(r_feet), 12.0, I, t(x_drag), 0.026)
    want = j_est.residual_discrete(
        j(x_k), j(x_prev), j(forces), j(R), j(r_feet), 12.0, j(I), j(x_drag), 0.026)
    close(got, want, 1e-4, 1e-5)
    got = t_est.residual_f_ext(
        t(x_k), t(x_prev), t(forces), t(R), t(r_feet), 12.0, I, t(x_drag))
    want = j_est.residual_f_ext(
        j(x_k), j(x_prev), j(forces), j(R), j(r_feet), 12.0, j(I), j(x_drag))
    close(got, want, 1e-5, 1e-6)


def _prefilled_estimator(count, B=3, window=400, seed=6):
    """A window filled with a clear sinusoid (0.3-0.5 Hz, amplitude 4-6,
    offset, small noise) at the MPC cadence, so the FFT peak bin is
    unambiguous and the ls fit actually runs at count >= window."""
    rng = np.random.default_rng(seed)
    dt = 0.026
    t0 = 3.0
    times = t0 + dt * np.arange(window)[None, :] + np.zeros((B, 1))
    freq = rng.uniform(0.3, 0.5, (B, 1))
    amp = rng.uniform(4.0, 6.0, (B, 1))
    diffs = -2.0 + amp * np.sin(2 * np.pi * freq * times + 0.4) \
        + 0.05 * rng.normal(size=(B, window))
    hist = np.zeros((B, window, 6))
    hist[..., 3] = diffs
    st = j_est.init((B,), window, jnp.float32)
    st = st._replace(
        times=j(times), diffs=j(diffs), wrench_hist=j(hist),
        count=jnp.full((B,), count, jnp.int32),
        f_est_static=j(rng.normal(size=(B, 6))),
        f_est_smoothed=j(rng.normal(size=(B, 6))),
    )
    sim_time = times[:, -1] + dt
    f_ext = rng.normal(size=(B, 6))
    return st, sim_time, f_ext


@pytest.mark.parametrize("mode,count", [
    ("ls", 399), ("ls", 450), ("ls", 100), ("static", 399), ("off", 399)])
def test_estimator_update_matches(mode, count):
    """One update on a prefilled window.  count 399 -> 400 is the first
    fit and release; 100 keeps the fit off.  Frequencies to 1e-5 Hz (the
    grid picks the same candidate; bin/64 ~ 1.5e-3 Hz apart), fitted
    coefficients to 2e-3 (f32 sums over 400 samples in another order),
    the released wrench to 5e-3 N/kg."""
    st_j, sim_time, f_ext = _prefilled_estimator(count)
    cfg_j = j_config.EstimatorConfig(mode=mode)
    cfg_t = t_config.EstimatorConfig(mode=mode)
    new_j, f_j = j_est.update(st_j, j(sim_time), j(f_ext), cfg_j)
    st_t = convert.estimator_state(st_j, "cpu")
    new_t, f_t = t_est.update(st_t, t(sim_time), t(f_ext), cfg_t)
    close(f_t, f_j, 5e-3)
    for name in ("times", "diffs", "wrench_hist", "f_est_static"):
        close(getattr(new_t, name), getattr(new_j, name), 1e-6)
    np.testing.assert_array_equal(new_t.count.numpy(), np.asarray(new_j.count))
    close(new_t.est_freq, new_j.est_freq, 1e-5)
    for name in ("est_stat", "est_sin", "est_cos", "est_amp", "f_est",
                 "f_est_smoothed"):
        close(getattr(new_t, name), getattr(new_j, name), 2e-3)
    if mode == "ls" and count >= 399:
        assert float(f_t.abs().max()) > 0.5          # the fit was released


def test_swing_curves_and_foothold_match():
    rng = np.random.default_rng(7)
    B = 5
    p0 = rng.uniform(-0.3, 0.3, (B, 4, 3))
    pf = rng.uniform(-0.3, 0.3, (B, 4, 3))
    ph = rng.uniform(0, 1, (B, 4))
    st = rng.uniform(0.1, 0.3, (B, 4))
    ev_t = t_swing.evaluate(t(p0), t(pf), 0.09, t(ph), t(st))
    ev_j = j_swing.evaluate(j(p0), j(pf), 0.09, j(ph), j(st))
    for a, b in zip(ev_t, ev_j):
        close(a, b, 1e-5, 1e-6)
    rpy = rng.uniform(-0.2, 0.2, (B, 3))
    Rb = np.swapaxes(np.asarray(j_rot.rpy_to_rotmat(j(rpy))), -1, -2)
    hips = np.broadcast_to(t_a1.A1.hip_locations(), (B, 4, 3))
    kw_common = dict(abad_link_length=0.0838, interleave_gain=-0.2,
                     bonus_swing=0.0, p_rel_max=0.3, dt_mpc=0.026)
    arrays = dict(
        p_body=rng.normal(size=(B, 3)), v_world=rng.normal(size=(B, 3)),
        v_des_world=rng.normal(size=(B, 3)), v_des_robot=rng.normal(size=(B, 3)),
        R_body=Rb, hip_location=hips, side_sign=np.array([-1.0, 1, -1, 1]),
        yaw_turn_rate=rng.normal(size=(B, 1)),
        stance_time=np.full(4, 0.208), swing_time_remaining=rng.uniform(0, 0.2, (B, 4)),
        body_height_z=rng.uniform(0.2, 0.3, B),
        interleave_y=np.array([-0.08, 0.08, 0.02, -0.02]))
    got = t_swing.raibert_foothold(**{k: t(v) for k, v in arrays.items()}, **kw_common)
    want = j_swing.raibert_foothold(**{k: j(v) for k, v in arrays.items()}, **kw_common)
    close(got, want, TRIG_ATOL)


def test_convert_round_trip():
    """convert builds the port's state from the reference's, leaf by leaf,
    keeping dtypes; to_numpy gives the arrays back unchanged."""
    from quad_periodic_mpc_tpu.control import mpc as j_mpc
    from quad_periodic_mpc_tpu.sim import srb_sim as j_sim

    plant = j_sim.init_plant((3,), dtype=jnp.float32)
    obs = j_sim.observe(plant)
    ctrl = j_mpc.init_state((3,), obs, dtype=jnp.float32, horizon=10,
                            formulation="stagewise")
    ctrl_t = convert.controller_state(ctrl, "cpu")
    assert ctrl_t.iteration.dtype == torch.int32
    assert ctrl_t.first_swing.dtype == torch.bool
    back = convert.to_numpy(ctrl_t)
    for f in ctrl._fields:
        if f == "est":
            continue
        np.testing.assert_array_equal(getattr(back, f), np.asarray(getattr(ctrl, f)))
    plant_t = convert.plant_state(plant, "cpu")
    np.testing.assert_array_equal(plant_t.x.numpy(), np.asarray(plant.x))
    g = convert.gait_params(j_gait.preset("trotting"), "cpu")
    assert g.offsets.dtype == torch.int32


@pytest.mark.parametrize("module,name", [
    ("control.balance", "BalanceSettings"), ("control.balance_vbl", "VBLSettings")])
def test_slice8_settings_equal_reference(module, name):
    """The balance controllers' settings, field by field."""
    import importlib

    ref = getattr(importlib.import_module(f"quad_periodic_mpc_tpu.{module}"), name)()
    port = getattr(importlib.import_module(f"quad_periodic_mpc_tpu_torch.{module}"), name)()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("module,names", [
    ("ops.gait_scheduler", ("GAIT_TABLE", "GAIT_IDS", "_OVERRIDEABLE", "STAND", "CUSTOM",
                            "TRANSITION_TO_STAND")),
    ("control.fsm", ("_ALLOWED", "EDAMP_ITERATIONS", "PASSIVE", "STAND_UP", "BALANCE_STAND",
                     "LOCOMOTION", "RECOVERY_STAND", "LAY_DOWN", "VISION", "BACKFLIP",
                     "TESTING", "TESTING_CV", "NORMAL", "TRANSITIONING", "ESTOP", "EDAMP")),
    ("control.poses", ("FOLD_JPOS", "STAND_JPOS", "ROLL_JPOS")),
    ("control.playback", ("PLAN_COLS", "TAU_OFFSET"))])
def test_slice8_tables_equal_reference(module, names):
    """The copied constant tables, entry by entry (each a plain Python
    value in both packages)."""
    import importlib

    ref = importlib.import_module(f"quad_periodic_mpc_tpu.{module}")
    port = importlib.import_module(f"quad_periodic_mpc_tpu_torch.{module}")
    for name in names:
        assert getattr(port, name) == getattr(ref, name), name


def test_convert_round_trip_slice8():
    """The slice-8 converters keep every leaf's dtype (int32 FSM states and
    gait ids, bool transition flags) and values."""
    from quad_periodic_mpc_tpu.control import balance as j_balance
    from quad_periodic_mpc_tpu.control import fsm as j_fsm
    from quad_periodic_mpc_tpu.control import poses as j_poses
    from quad_periodic_mpc_tpu.ops import gait_scheduler as j_gs
    from quad_periodic_mpc_tpu.utils import filters as j_filters

    rng = np.random.default_rng(0)
    f32 = lambda *s: jnp.asarray(rng.normal(size=s).astype(np.float32))
    prm = j_gs.params("bound")
    biquad_init, _ = j_filters.make_digital_lp(40.0, 0.002)
    cases = [
        (convert.fsm_state, j_fsm.init((5,))._replace(
            state=jnp.asarray([0, 1, 3, 4, 6], jnp.int32))),
        (convert.scheduler_params, prm),
        (convert.scheduler_state, j_gs.init(prm)),
        (convert.gait_data, j_gs.gait_data_init((3,), gait="pace", dtype=jnp.float32)),
        (convert.balance_command, j_balance.BalanceCommand(f32(2, 3), f32(2, 3), f32(2, 3),
                                                           f32(2, 3, 3), f32(2, 3))),
        (convert.pose_command, j_poses.joint_ramp(jnp.asarray([0.2, 0.7], jnp.float32),
                                                  f32(2, 4, 3), "fold", 1.0)),
        (convert.low_pass_state, j_filters.LowPassState(f32(4))),
        (convert.biquad_state, biquad_init((4,), jnp.float32)),
        (convert.moving_average_state, j_filters.moving_average_init(5, (4,))),
    ]
    for fn, src in cases:
        got = fn(src, "cpu")
        assert type(got).__name__ == type(src).__name__
        back = convert.to_numpy(got)
        for name, b, a in zip(src._fields, back, src):
            a = np.asarray(a)
            assert b.dtype == a.dtype and b.shape == a.shape, (fn.__name__, name)
            np.testing.assert_array_equal(b, a)
    fs = convert.fsm_state(j_fsm.init((2,)), "cpu")
    assert fs.state.dtype == torch.int32 and fs.transition_done.dtype == torch.bool
    gd = convert.gait_data(j_gs.gait_data_init((2,)), "cpu")
    assert gd.current_gait.dtype == torch.int32
