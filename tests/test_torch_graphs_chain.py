"""The single robot's graphed tick pair against the JAX package's jitted
chain on the CPU, where the pair runs its steps eagerly: the steps, not
the replay, are what a graph can get wrong against the reference (the
replay is held to the eager run bit for bit on the card by chip_smoke.py's
phase 19).  Kept apart from tests/test_torch_graphs.py for its JAX
compile (~40 s).

``full_stack.capture_ticks`` for two periods (26 ticks) at B = 1 against
``jax.jit`` of bench.py's ``fs_b1_chain`` configuration (bench.py:770-797:
the SRB-matched MPCConfig, stagewise ADMM-30, ten substeps, the WBC), the
MPC in JAX's fused-build Pallas kernel in interpret mode.  JAX's torque
tick runs its XLA kinematics / WBC / plant path, which its own
test_fused_tick_configuration_matches_xla ties to the fused kernels: in
interpret mode those three take ~2 min to compile on the CPU against ~40 s
for this program.  The port runs every kernel's plain version.  The
tolerances are tests/test_torch_full_stack.py's (pos 2e-3 m, v_body 2e-2,
q 5e-3 rad: f32 arithmetic in another order through the ticks and
substeps; the MPC forces 0.5 N, the ADMM gate's scale).
"""

import numpy as np
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

F32 = jnp.float32
H, ITERS = 10, 30
FS_TOL = {"pos": 2e-3, "v_body": 2e-2, "q": 5e-3}
FS_FORCE_TOL = 0.5
_P = j_fb.A1ModelParams()
M_TOT = float(_P.body_mass + 4 * (_P.abad_mass + _P.hip_mass + _P.knee_mass
                                  + 3 * _P.rotor_mass))
INERTIA = (0.12, 0.45, 0.42)


def test_b1_tick_pair_matches_jax_chain():
    mc = j_fb.build_a1_constants("float32")
    plant = j_art.init_on_ground((1,), penetration=3.8e-3, dtype=F32)
    obs0, _, _ = j_fs.observe_plant(plant, mc)
    ctrl = j_mpc.init_state((1,), obs0, dtype=F32, formulation="stagewise")
    cmd = j_mpc.Command(vx=jnp.full((1,), 0.15, F32), vy=jnp.zeros((1,), F32),
                        yaw_rate=jnp.zeros((1,), F32), body_height=plant.fb.pos[..., 2])
    gait = j_gait.preset("trotting")

    def fs_b1_chain(plant, ctrl):
        carry, _ = j_fs.rollout_articulated(
            2, plant, ctrl, cmd, gait, mc,
            mpc_cfg=jc.MPCConfig(horizon=H, mass=M_TOT, inertia_body=INERTIA),
            solver=jc.ADMMConfig(iterations=ITERS, formulation="stagewise", backend="pallas"),
            use_wbc=True, substeps=10, wbc_backend="xla", kin_backend="xla")
        return carry.plant, carry.ctrl

    plant_j, ctrl_j = jax.jit(fs_b1_chain)(plant, ctrl)

    mpc_tick, plain_tick = t_fs.capture_ticks(
        convert.art_state(plant, "cpu"), convert.controller_state(ctrl, "cpu"),
        convert.command(cmd, "cpu"), convert.gait_params(gait, "cpu"),
        t_fb.build_a1_constants("float32", "cpu"),
        mpc_cfg=tc.MPCConfig(horizon=H, mass=M_TOT, inertia_body=INERTIA),
        solver=tc.ADMMConfig(iterations=ITERS, formulation="stagewise", backend="pallas"),
        substeps=10, wbc_backend="pallas", kin_backend="pallas")
    carry = t_fs.FullStackCarry(convert.art_state(plant, "cpu"),
                                convert.controller_state(ctrl, "cpu"))
    for i in range(26):
        carry, = (mpc_tick if i % 13 == 0 else plain_tick)(carry)

    for f, tol in FS_TOL.items():
        np.testing.assert_allclose(getattr(carry.plant.fb, f).numpy(),
                                   np.asarray(getattr(plant_j.fb, f)), atol=tol, rtol=0,
                                   err_msg=f)
    np.testing.assert_allclose(carry.plant.t.numpy(), np.asarray(plant_j.t), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(carry.ctrl.iteration.numpy(), np.asarray(ctrl_j.iteration))
    np.testing.assert_allclose(carry.ctrl.fr_des.numpy(), np.asarray(ctrl_j.fr_des),
                               atol=FS_FORCE_TOL, rtol=0)
