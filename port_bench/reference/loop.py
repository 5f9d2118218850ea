"""Closed-loop period: controller + SRB plant.

The 500 Hz process loop against the analytic plant: one MPC period is an
MPC tick and iterations_between_mpc - 1 plain ticks
(FSM_State_Locomotion.cpp:13), each a swing update and a plant step.
Batched: a leading batch axis runs many scenarios in lockstep.
"""

from __future__ import annotations

from typing import NamedTuple

from port_bench.reference import mpc as mpc_ctrl
from port_bench.reference import srb_sim
from port_bench.reference.a1 import A1, RobotModel
from port_bench.reference.config import (
    ADMMConfig,
    EstimatorConfig,
    LoopConfig,
    MPCConfig,
    SwingConfig,
)


class RolloutCarry(NamedTuple):
    plant: srb_sim.PlantState
    ctrl: mpc_ctrl.ControllerState


def period_step(
    cmd: mpc_ctrl.Command,
    gait,
    dist: srb_sim.DisturbanceParams,
    mpc_cfg: MPCConfig,
    loop_cfg: LoopConfig,
    est_cfg: EstimatorConfig,
    solver: ADMMConfig,
    model: RobotModel = A1,
    swing_cfg: SwingConfig = SwingConfig(),
):
    """One MPC period with everything but the carry closed over:
    ``step(carry) -> (carry',)``."""

    def control_tick(carry: RolloutCarry, do_mpc: bool) -> RolloutCarry:
        plant, ctrl = carry
        obs = srb_sim.observe(plant)
        ctrl = mpc_ctrl.setup_command(ctrl, cmd, loop_cfg)
        if do_mpc:
            ctrl, _ = mpc_ctrl.mpc_step(
                ctrl, obs, cmd, gait, plant.t, mpc_cfg, loop_cfg, est_cfg, solver)
        ctrl, out = mpc_ctrl.swing_update(
            ctrl, obs, cmd, gait, model, swing_cfg, mpc_cfg, loop_cfg,
            loop_cfg.swing_height)
        stance = (out.swing_state <= 0).to(plant.x.dtype)
        plant = srb_sim.step(
            plant, out.fr_des, out.p_foot_des, stance, dist, mpc_cfg, loop_cfg.dt)
        return RolloutCarry(plant, ctrl)

    def step(carry: RolloutCarry) -> tuple[RolloutCarry]:
        carry = control_tick(carry, do_mpc=True)
        for _ in range(loop_cfg.iterations_between_mpc - 1):
            carry = control_tick(carry, do_mpc=False)
        return (carry,)

    return step
