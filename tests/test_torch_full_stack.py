"""The slice as a whole: one MPC period of the port's full torque stack
(MPC + WBC + joint torques on the articulated plant) against the JAX
package's, from the same starting state.

B = 2, substeps = 5, the SRB-matched MPCConfig and stagewise ADMM-30 in the
fused MPC kernel on both sides (JAX in interpret mode, the port its plain
version).  JAX runs its XLA kinematics/WBC/plant path (the path its own
test_fused_tick_configuration_matches_xla ties to the fused kernels); the
port runs once with kin/wbc backends "pallas" (the fused kernels' plain
versions on the CPU) and once with "xla".  Tolerances are those of that
JAX test: pos 2e-3 m, v_body 2e-2, q 5e-3 rad after 13 ticks and 65
substeps of f32 arithmetic in another order.  From the state that period
ends in, one controller tick is compared with and without the WBC (the
leg-controller branch).
"""

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from quad_periodic_mpc_tpu import config as jc
from quad_periodic_mpc_tpu.control import full_stack as j_fs
from quad_periodic_mpc_tpu.control import mpc as j_mpc
from quad_periodic_mpc_tpu.models import floating_base as j_fb
from quad_periodic_mpc_tpu.ops import gait as j_gait
from quad_periodic_mpc_tpu.sim import articulated_sim as j_art
from quad_periodic_mpc_tpu_torch import config as tc
from quad_periodic_mpc_tpu_torch import convert
from quad_periodic_mpc_tpu_torch.control import full_stack as t_fs
from quad_periodic_mpc_tpu_torch.models import floating_base as t_fb

B, SUBSTEPS, ITERS = 2, 5, 30
TOL = {"pos": 2e-3, "v_body": 2e-2, "q": 5e-3}
_P = j_fb.A1ModelParams()
M_TOT = float(_P.body_mass + 4 * (_P.abad_mass + _P.hip_mass + _P.knee_mass
                                  + 3 * _P.rotor_mass))
INERTIA = (0.12, 0.45, 0.42)


@pytest.fixture(scope="module")
def start_and_reference():
    """The JAX starting state and its one-period rollout (computed once)."""
    f32 = jnp.float32
    mc = j_fb.build_a1_constants("float32")
    plant = j_art.init_on_ground((B,), penetration=3.8e-3, dtype=f32)
    obs0, _, _ = j_fs.observe_plant(plant, mc)
    ctrl = j_mpc.init_state((B,), obs0, dtype=f32, formulation="stagewise")
    cmd = j_mpc.Command(vx=jnp.full((B,), 0.15, f32), vy=jnp.zeros((B,), f32),
                        yaw_rate=jnp.zeros((B,), f32), body_height=plant.fb.pos[..., 2])
    gait = j_gait.preset("trotting")
    solver = jc.ADMMConfig(iterations=ITERS, formulation="stagewise", backend="pallas")
    cfg = jc.MPCConfig(horizon=10, mass=M_TOT, inertia_body=INERTIA)
    carry, trace = jax.jit(lambda: j_fs.rollout_articulated(
        1, plant, ctrl, cmd, gait, mc, mpc_cfg=cfg, solver=solver, substeps=SUBSTEPS,
        wbc_backend="xla", kin_backend="xla"))()
    return (plant, ctrl, cmd, gait), carry, trace


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_full_stack_period_matches_reference(start_and_reference, backend):
    (plant, ctrl, cmd, gait), ref, ref_trace = start_and_reference
    mc = t_fb.build_a1_constants("float32", "cpu")
    carry, trace = t_fs.rollout_articulated(
        1, convert.art_state(plant, "cpu"), convert.controller_state(ctrl, "cpu"),
        convert.command(cmd, "cpu"), convert.gait_params(gait, "cpu"), mc,
        mpc_cfg=tc.MPCConfig(horizon=10, mass=M_TOT, inertia_body=INERTIA),
        solver=tc.ADMMConfig(iterations=ITERS, formulation="stagewise", backend="pallas"),
        substeps=SUBSTEPS, wbc_backend=backend, kin_backend=backend)
    for f, tol in TOL.items():
        np.testing.assert_allclose(getattr(carry.plant.fb, f).numpy(),
                                   np.asarray(getattr(ref.plant.fb, f)), atol=tol, rtol=0,
                                   err_msg=f)
    np.testing.assert_allclose(trace["pos"].numpy(), np.asarray(ref_trace["pos"]),
                               atol=TOL["pos"], rtol=0)
    np.testing.assert_allclose(carry.plant.t.numpy(), np.asarray(ref.plant.t), atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(carry.ctrl.iteration.numpy(), np.asarray(ref.ctrl.iteration))
    # the MPC's forces (the WBC's fr_des) agree at the ADMM gate's scale
    np.testing.assert_allclose(carry.ctrl.fr_des.numpy(), np.asarray(ref.ctrl.fr_des),
                               atol=0.5, rtol=0)


@pytest.mark.parametrize("use_wbc", [True, False])
def test_controller_tick_matches_reference(start_and_reference, use_wbc):
    """One non-MPC controller tick from the reference's state after the
    period (mid-gait, MPC forces set), XLA backends on both sides.  Joint
    torques: with the WBC 0.15 N m (tau_ff 1e-1, plus kp 3 x q_des 1.5e-3
    and kd 1 x qd_des 1e-2, the WBC tests' tolerances); through the leg
    controller 1e-3 N m (FK, Jacobian and clamp on f32 inputs)."""
    (_, _, cmd, gait), ref, _ = start_and_reference
    mc_j = j_fb.build_a1_constants("float32")
    cfg_j = jc.MPCConfig(horizon=10, mass=M_TOT, inertia_body=INERTIA)
    ctrl_j, tau_j, _ = jax.jit(lambda p, c: j_fs.controller_tick(
        p, c, cmd, gait, mc_j, False, mpc_cfg=cfg_j, use_wbc=use_wbc))(ref.plant, ref.ctrl)
    ctrl_t, tau_t, _ = t_fs.controller_tick(
        convert.art_state(ref.plant, "cpu"), convert.controller_state(ref.ctrl, "cpu"),
        convert.command(cmd, "cpu"), convert.gait_params(gait, "cpu"),
        t_fb.build_a1_constants("float32", "cpu"), False,
        mpc_cfg=tc.MPCConfig(horizon=10, mass=M_TOT, inertia_body=INERTIA),
        use_wbc=use_wbc)
    np.testing.assert_allclose(tau_t.numpy(), np.asarray(tau_j),
                               atol=0.15 if use_wbc else 1e-3, rtol=0)
    np.testing.assert_array_equal(ctrl_t.iteration.numpy(), np.asarray(ctrl_j.iteration))
    np.testing.assert_allclose(ctrl_t.swing_pf.numpy(), np.asarray(ctrl_j.swing_pf),
                               atol=1e-5, rtol=0)
