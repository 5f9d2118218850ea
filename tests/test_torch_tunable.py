"""The port's live-tunable parameters (config.TunableParams) against the JAX
package, and the gates of tests/test_tunable.py on the port.

The reference's tunables are traced pytree leaves: a retune reuses the
compiled program.  The port's are tensors read only on the device: a retune
writes new values into the same tensors (``.copy_()``) and the next call
answers differently, with no host read of a tunable on the way
(``_no_host_read`` makes any such read fail).  The JAX side is jitted and
runs its XLA paths; float32 on both sides.
"""

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from quad_periodic_mpc_tpu import config as jc
from quad_periodic_mpc_tpu.control import mpc as j_mpc
from quad_periodic_mpc_tpu.models.a1 import A1 as J_A1
from quad_periodic_mpc_tpu.ops import gait as j_gait
from quad_periodic_mpc_tpu.ops import problem as j_problem
from quad_periodic_mpc_tpu.sim import srb_sim as j_sim
from quad_periodic_mpc_tpu_torch import config as tc
from quad_periodic_mpc_tpu_torch import convert
from quad_periodic_mpc_tpu_torch.control import mpc as t_mpc
from quad_periodic_mpc_tpu_torch.models.a1 import A1 as T_A1
from quad_periodic_mpc_tpu_torch.ops import problem as t_problem
from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel
from quad_periodic_mpc_tpu_torch.sim import srb_sim as t_sim

H, B = 5, 4
F32 = jnp.float32
# condensed ADMM-60 (the reference test's solver), f32 on both sides: the
# K^-1 build and 60 iterations sum in another order (forces ~40-120 N; the
# condensed period's gate in test_torch_mpc_condensed.py)
FORCE_TOL = 5e-3
# the untuned fused-build period against the tuned caller-built one: the
# same problem built two ways (entries equal to ~1e-6, the dump audit's
# gate) and 30 sweeps summed in another order; the kernel-vs-plain gate
# (testing/kernel_cases.STAGEWISE_TOL["U"]); the two plain versions measure
# ~2e-4 apart
FUSED_VS_BUILT_TOL = 2e-3

_HOST_READS = {torch.Tensor.item, torch.Tensor.__float__, torch.Tensor.__int__,
               torch.Tensor.__bool__, torch.Tensor.__index__, torch.Tensor.tolist,
               torch.Tensor.numpy}


class _NoHostRead(torch.Tensor):
    """A tunable leaf that fails on any read into a Python value; every
    operation on it gives a plain tensor."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func in _HOST_READS:
            raise AssertionError(f"host read of a tunable ({func.__name__})")
        with torch._C.DisableTorchFunctionSubclass():
            return func(*args, **(kwargs or {}))


def _no_host_read(tun: tc.TunableParams) -> tc.TunableParams:
    return tc.TunableParams(*(t.clone().as_subclass(_NoHostRead) for t in tun))


def _setup(batch=(B,), formulation="condensed", perturb=True):
    """The bench trot (vx = 0.3, gait phases spread over the batch) in the
    JAX package, and the same state carried into the port."""
    plant = j_sim.init_plant(batch, body_height=0.29, dtype=F32)
    if perturb:
        rng = np.random.default_rng(21)
        x = np.asarray(plant.x).copy()
        x[..., 0:3] += rng.uniform(-0.03, 0.03, batch + (3,))
        x[..., 9:12] += rng.uniform(-0.1, 0.1, batch + (3,))
        plant = plant._replace(x=jnp.asarray(x, F32))
    ctrl = j_mpc.init_state(batch, j_sim.observe(plant), dtype=F32, horizon=H,
                            formulation=formulation)
    n = int(np.prod(batch))
    ctrl = ctrl._replace(
        iteration=((jnp.arange(n, dtype=jnp.int32) * 7) % 208).reshape(batch),
        x_vel_des=jnp.full(batch, 0.3, F32))
    cmd = j_mpc.Command(vx=jnp.full(batch, 0.3, F32), vy=jnp.zeros(batch, F32),
                        yaw_rate=jnp.zeros(batch, F32), body_height=jnp.full(batch, 0.29, F32))
    j = (plant, ctrl, cmd, j_gait.preset("trotting"))
    t = (convert.plant_state(plant, "cpu"), convert.controller_state(ctrl, "cpu"),
         convert.command(cmd, "cpu"), convert.gait_params(j[3], "cpu"))
    return j, t


def _cfgs(mod, **solver):
    return (mod.MPCConfig(horizon=H), mod.LoopConfig(), mod.EstimatorConfig(),
            mod.SwingConfig(), mod.ADMMConfig(**(solver or dict(iterations=60))))


def _jtun(t: tc.TunableParams) -> jc.TunableParams:
    return jc.TunableParams(*(jnp.asarray(v.detach().numpy()) for v in t))


def _j_solve(solver_kw):
    mpc, loop, est, _, solver = _cfgs(jc, **solver_kw)

    @jax.jit
    def solve(tun, plant, ctrl, cmd, gait):
        _, f = j_mpc.mpc_step(ctrl, j_sim.observe(plant), cmd, gait, plant.t, mpc, loop, est,
                              solver, tunable=tun)
        return f

    return solve


def _t_solve(solver_kw, tun, state):
    mpc, loop, est, _, solver = _cfgs(tc, **solver_kw)
    plant, ctrl, cmd, gait = state
    return t_mpc.mpc_step(ctrl, t_sim.observe(plant), cmd, gait, plant.t, mpc, loop, est,
                          solver, tunable=tun)[1]


def _retune(tun: tc.TunableParams) -> None:
    """z-height weight x10, alpha 4e-4, f_max 60, written into the same
    tensors."""
    w = tun.weights.clone()
    w[..., 5] = 500.0
    tun.weights.copy_(w)
    tun.alpha.copy_(torch.full_like(tun.alpha, 4e-4))
    tun.f_max.copy_(torch.full_like(tun.f_max, 60.0))


@pytest.mark.parametrize("formulation", ["condensed", "stagewise"])
def test_retune_mpc_weights_by_copy(formulation):
    """The reference's first gate: the retuned solve differs and the new
    f_max binds.  Both solves against JAX given the same values; the retune
    is a copy into the same tensors, read on the device only."""
    kw = dict(iterations=60) if formulation == "condensed" else dict(
        iterations=60, formulation="stagewise")
    j, t = _setup(batch=(), formulation=formulation, perturb=False)
    mpc, loop, est, swing, _ = _cfgs(tc)
    tun = _no_host_read(tc.TunableParams.from_config(mpc, loop, est, swing, device="cpu"))
    ptrs = [v.data_ptr() for v in tun]
    f0 = _t_solve(kw, tun, t)
    j_solve = _j_solve(kw)
    np.testing.assert_allclose(f0.numpy(), np.asarray(j_solve(_jtun(tun), *j)),
                               atol=FORCE_TOL)
    _retune(tun)
    assert [v.data_ptr() for v in tun] == ptrs
    f1 = _t_solve(kw, tun, t)
    np.testing.assert_allclose(f1.numpy(), np.asarray(j_solve(_jtun(tun), *j)),
                               atol=FORCE_TOL)
    assert j_solve._cache_size() == 1
    assert not torch.allclose(f0, f1, atol=1e-6)
    assert float(f1[..., 2].max()) <= 60.0 + 1e-3


@pytest.mark.parametrize("solver", ["condensed", "stagewise_xla", "stagewise_pallas"])
def test_default_tunable_matches_static_config(solver):
    """TunableParams.from_config reproduces the static-config path (the
    reference's gate, 1e-5) where both take the same solve; on the
    stagewise "pallas" backend the untuned period takes the fused build and
    the tuned one the caller-built solve, held to FUSED_VS_BUILT_TOL."""
    kw = {"condensed": dict(iterations=60),
          "stagewise_xla": dict(iterations=30, formulation="stagewise"),
          "stagewise_pallas": dict(iterations=30, formulation="stagewise",
                                   backend="pallas")}[solver]
    _, (plant, ctrl, cmd, gait) = _setup(
        formulation="condensed" if solver == "condensed" else "stagewise")
    mpc, loop, est, swing, sol = _cfgs(tc, **kw)
    obs = t_sim.observe(plant)
    _, f_static = t_mpc.mpc_step(ctrl, obs, cmd, gait, plant.t, mpc, loop, est, sol)
    _, f_tun = t_mpc.mpc_step(
        ctrl, obs, cmd, gait, plant.t, mpc, loop, est, sol,
        tunable=tc.TunableParams.from_config(mpc, loop, est, swing, device="cpu"))
    tol = FUSED_VS_BUILT_TOL if solver == "stagewise_pallas" else 1e-5
    np.testing.assert_allclose(f_static.numpy(), f_tun.numpy(), atol=tol)


def test_retune_swing_height_by_copy():
    """The reference's third gate (a higher apex for the swinging leg after
    swing_height 0.09 -> 0.18), and swing_update with the tunable (a
    nonzero bonus_swing and a tight p_rel_max as well) against JAX's:
    foot targets to 1e-6 m (the same f32 operations)."""
    j, t = _setup(batch=())
    j_ctrl = j[1]._replace(iteration=jnp.asarray(65, jnp.int32))
    t_ctrl = t[1]._replace(iteration=torch.tensor(65, dtype=torch.int32))
    mpc, loop, est, swing, _ = _cfgs(tc)
    jm, jl, je, js, _ = _cfgs(jc)
    tun = _no_host_read(tc.TunableParams.from_config(mpc, loop, est, swing, device="cpu"))

    @jax.jit
    def j_tick(tn, ctrl):
        _, out = j_mpc.swing_update(ctrl, j_sim.observe(j[0]), j[2], j[3], J_A1, js, jm, jl,
                                    jl.swing_height, tunable=tn)
        return out.p_foot_des, out.swing_state

    def t_tick():
        return t_mpc.swing_update(t_ctrl, t_sim.observe(t[0]), t[2], t[3], T_A1, swing, mpc,
                                  loop, loop.swing_height, tunable=tun)

    _, out0 = t_tick()
    assert float(out0.swing_state.max()) > 0, "scene must have a swinging leg"
    tun.swing_height.copy_(torch.tensor(0.18))
    state1, out1 = t_tick()
    dz = (out1.p_foot_des - out0.p_foot_des)[..., 2]
    assert float(dz.max()) > 0.01
    tun.bonus_swing.copy_(torch.tensor(0.2))
    tun.p_rel_max.copy_(torch.tensor(0.005))
    state2, out2 = t_tick()
    p_j, sw_j = j_tick(_jtun(tun), j_ctrl)
    np.testing.assert_allclose(out2.p_foot_des.numpy(), np.asarray(p_j), atol=1e-6)
    np.testing.assert_array_equal(out2.swing_state.numpy(), np.asarray(sw_j))
    assert not torch.allclose(state2.swing_pf, state1.swing_pf)


def test_per_instance_weight_sweep_axis():
    """The reference's fourth gate: per-instance weights on the condensed
    formulation, each instance under its own z-weight, against JAX."""
    j, t = _setup()
    mpc, loop, est, swing, _ = _cfgs(tc)
    base = tc.TunableParams.from_config(mpc, loop, est, swing, device="cpu")
    w = base.weights.expand(B, 12).clone()
    w[:, 5] = torch.tensor([5.0, 50.0, 500.0, 5000.0])
    tun = base._replace(weights=w, alpha=torch.full((B,), 4e-5), f_max=torch.full((B,), 120.0))
    f = _t_solve(dict(iterations=60), tun, t)
    assert f.shape[0] == B
    assert not torch.allclose(f[0], f[3], atol=1e-6)
    np.testing.assert_allclose(f.numpy(), np.asarray(_j_solve(dict(iterations=60))(
        _jtun(tun), *j)), atol=FORCE_TOL)


def _problem_inputs(seed):
    """A perturbed batched observation, reference and contact table."""
    rng = np.random.default_rng(seed)
    rpy = rng.uniform(-0.1, 0.1, (B, 3))
    q = np.stack([np.cos(rpy[:, 0] / 2), np.sin(rpy[:, 0] / 2), np.zeros(B), np.zeros(B)], -1)
    obs = dict(p=rng.normal(0, 0.05, (B, 3)) + [0, 0, 0.29], v=rng.normal(0, 0.2, (B, 3)),
               quat=q, omega=rng.normal(0, 0.2, (B, 3)),
               r_feet=np.asarray(T_A1.hip_locations()) - [0, 0, 0.29]
               + rng.normal(0, 0.02, (B, 4, 3)))
    obs = {k: np.asarray(v, np.float32) for k, v in obs.items()}
    xref = np.zeros((B, H, 13), np.float32)
    xref[..., 5] = 0.29
    xref[..., 9] = 0.3
    table = rng.integers(0, 2, (B, H, 4)).astype(np.int32)
    return obs, xref, table, rng.normal(0, 1, (B, 6)).astype(np.float32)


def _tunables(per_instance):
    base = tc.TunableParams.from_config(tc.MPCConfig(horizon=H), device="cpu")
    if not per_instance:
        return base._replace(weights=base.weights * 1.5, alpha=torch.tensor(2e-4),
                             mu=torch.tensor(0.6), f_max=torch.tensor(80.0))
    w = base.weights.expand(B, 12).clone()
    w[:, 5] = torch.tensor([5.0, 50.0, 500.0, 5000.0])
    return base._replace(weights=w, alpha=torch.tensor([4e-5, 1e-4, 4e-4, 1e-3]),
                         mu=torch.tensor([0.3, 0.4, 0.5, 0.6]),
                         f_max=torch.tensor([60.0, 80.0, 100.0, 120.0]))


@pytest.mark.parametrize("per_instance", [False, True])
def test_build_qp_tunable_matches_jax(per_instance):
    """build_qp with shared and per-instance tunables: P (entries up to
    ~1e4) to 2e-3 relative and q to 2e-2 (test_torch_condensed.py's f32
    tolerances), F, l, u to 1e-7 relative; the tunable moves every one."""
    obs, xref, table, f_est = _problem_inputs(11)
    tun = _tunables(per_instance)
    qj, _, _ = j_problem.build_qp(j_problem.RobotObs(**{k: jnp.asarray(v) for k, v in obs.items()}),
                                  jnp.asarray(xref), jnp.asarray(table), jc.MPCConfig(horizon=H),
                                  f_est=jnp.asarray(f_est), tunable=_jtun(tun))
    robs = t_problem.RobotObs(**{k: torch.from_numpy(v) for k, v in obs.items()})
    args = (robs, torch.from_numpy(xref), torch.from_numpy(table), tc.MPCConfig(horizon=H))
    qt, _, _ = t_problem.build_qp(*args, f_est=torch.from_numpy(f_est), tunable=tun)
    q0, _, _ = t_problem.build_qp(*args, f_est=torch.from_numpy(f_est))
    for f, rtol in (("P", 2e-3), ("q", 2e-2), ("F", 1e-7), ("l", 1e-7), ("u", 1e-7)):
        ref = np.asarray(getattr(qj, f))
        np.testing.assert_allclose(getattr(qt, f).numpy(), ref,
                                   atol=rtol * max(1.0, np.abs(ref).max()) if rtol > 1e-6 else 0,
                                   rtol=rtol, err_msg=f)
    for f in ("P", "q", "F", "u"):
        assert not torch.equal(getattr(qt, f), getattr(q0, f)), f


def test_build_stagewise_tunable_matches_jax():
    """build_stagewise with a shared tunable: Q, R, F, l, u from it, to 1e-7
    relative (the same f32 products); Ad, Bd, c to 1e-6 as in
    test_torch_qp_stagewise.py."""
    obs, xref, table, f_est = _problem_inputs(12)
    tun = _tunables(False)
    sj, _, _ = j_problem.build_stagewise(
        j_problem.RobotObs(**{k: jnp.asarray(v) for k, v in obs.items()}), jnp.asarray(xref),
        jnp.asarray(table), jc.MPCConfig(horizon=H), f_est=jnp.asarray(f_est),
        tunable=_jtun(tun))
    st, _ = t_problem.build_stagewise(
        t_problem.RobotObs(**{k: torch.from_numpy(v) for k, v in obs.items()}),
        torch.from_numpy(xref), torch.from_numpy(table), tc.MPCConfig(horizon=H),
        f_est=torch.from_numpy(f_est), tunable=tun)
    for f in ("Q", "R", "F", "l", "u"):
        np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(sj, f)),
                                   rtol=1e-7, atol=0, err_msg=f)
    for f in ("Ad", "Bd", "c"):
        np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(sj, f)),
                                   atol=1e-6, err_msg=f)
    assert float(st.R[0]) == pytest.approx(2 * 2e-4, rel=1e-6)
    assert float(st.u[..., 4::5].max()) == 80.0


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_per_instance_tunable_on_stagewise_raises_type_error(backend):
    """Per-instance alpha on the stagewise formulation: JAX's stage cost
    2 alpha 1_12 does not broadcast, and neither does the port's, with the
    same TypeError, from build_stagewise and from mpc_step."""
    obs, xref, table, f_est = _problem_inputs(13)
    tun = _tunables(True)
    with pytest.raises(TypeError):
        j_problem.build_stagewise(
            j_problem.RobotObs(**{k: jnp.asarray(v) for k, v in obs.items()}),
            jnp.asarray(xref), jnp.asarray(table), jc.MPCConfig(horizon=H), tunable=_jtun(tun))
    with pytest.raises(TypeError):
        t_problem.build_stagewise(
            t_problem.RobotObs(**{k: torch.from_numpy(v) for k, v in obs.items()}),
            torch.from_numpy(xref), torch.from_numpy(table), tc.MPCConfig(horizon=H),
            tunable=tun)
    j, t = _setup(formulation="stagewise")
    kw = dict(iterations=30, formulation="stagewise", backend=backend)
    with pytest.raises(TypeError):
        _j_solve(kw)(_jtun(tun), *j)
    with pytest.raises(TypeError):
        _t_solve(kw, tun, t)


def test_tunable_period_dispatches_to_the_caller_built_kernel(monkeypatch):
    """On the stagewise "pallas" backend a tunable period calls
    fused_stagewise_solve once and the fused-build kernel never, as JAX
    dispatches it (control/mpc.py:349); an untuned period the reverse."""
    calls = {"fused_stagewise_solve": 0, "fused_stagewise_solve_srb": 0}
    for name in calls:
        fn = getattr(stagewise_kernel, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(stagewise_kernel, name, counted)
    _, t = _setup(formulation="stagewise")
    kw = dict(iterations=30, formulation="stagewise", backend="pallas")
    _t_solve(kw, None, t)
    assert calls == {"fused_stagewise_solve": 0, "fused_stagewise_solve_srb": 1}
    _t_solve(kw, _no_host_read(tc.TunableParams.from_config(device="cpu")), t)
    assert calls == {"fused_stagewise_solve": 1, "fused_stagewise_solve_srb": 1}
