"""The full torque stack (``control/full_stack``) of configuration
``a1_full_stack_h10``: the program's timed units, the reference's, and
what the comparison reads.

Entry: ``tick_pair``, the MPC tick and the plain tick replayed from
``full_stack.capture_ticks``, an MPC tick every 13th."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from port_bench.lib import tree
from port_bench.stacks import draws
from port_bench.stacks.srb_loop import build_configs

SOURCES = ("stagewise_srb.cu", "kinematics.cu", "wbc.cu", "plant.cu")
FALL_HEIGHT = 0.15                  # m: a base below it has fallen


def draw_inputs(cfg: dict, wl: dict, seed: int, device, instances=None) -> dict:
    p = wl["params"]
    g = draws.generator(seed, device)
    samples = draws.window_samples(g, wl["samples"], device)
    B = int(p["instances"] if instances is None else instances)
    return {"kind": "robots", "samples": samples, "B": B, "gait": p["gait"],
            "vx": draws.uniform(g, B, *p["vx"], device).float()}


def _kw(cfg: dict, C, wbc_mod, art):
    mpc_cfg, loop_cfg, est_cfg, solver, swing_cfg = build_configs(cfg, C)
    gains = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["wbc_gains"].items()}
    return dict(mpc_cfg=mpc_cfg, loop_cfg=loop_cfg, est_cfg=est_cfg, solver=solver,
                swing_cfg=swing_cfg, wbc_gains=wbc_mod.WBCGains(**gains),
                wbc_pdip=C.PDIPConfig(**cfg["wbc_pdip"]),
                contact=art.ContactParams(**cfg["contact"]), substeps=int(cfg["substeps"]))


def _start(mods, cfg: dict, inp: dict, device, observe):
    """(carry, cmd, gait): the robots standing on the ground, built with
    ``mods`` (the program's or the reference's modules)."""
    B = inp["B"]
    f32 = dict(dtype=torch.float32, device=device)
    plant = mods.art.init_on_ground((B,), penetration=float(cfg["start_penetration"]),
                                    device=device)
    obs0 = observe(plant)
    est_window = int(cfg["estimator"]["window"])
    ctrl = mods.mpc.init_state((B,), obs0, window=est_window, horizon=int(cfg["horizon"]),
                               formulation="stagewise")
    cmd = mods.mpc.Command(vx=inp["vx"].clone(), vy=torch.zeros(B, **f32),
                           yaw_rate=torch.zeros(B, **f32),
                           body_height=plant.fb.pos[..., 2].clone())
    gait = mods.gait.preset(inp["gait"], device=device)
    return mods.fs.FullStackCarry(plant, ctrl), cmd, gait


def program(cfg: dict, wl: dict, inp: dict, device):
    from quad_periodic_mpc_tpu_torch import config as C
    from quad_periodic_mpc_tpu_torch.control import full_stack as FS
    from quad_periodic_mpc_tpu_torch.control import mpc as M
    from quad_periodic_mpc_tpu_torch.control import wbc as W
    from quad_periodic_mpc_tpu_torch.models import floating_base as fb
    from quad_periodic_mpc_tpu_torch.ops import gait as G
    from quad_periodic_mpc_tpu_torch.sim import articulated_sim as art

    mc = fb.build_a1_constants("float32", str(device))
    kw = dict(_kw(cfg, C, W, art), wbc_backend="pallas", kin_backend="pallas")
    mods = SimpleNamespace(art=art, mpc=M, gait=G, fs=FS)
    start, cmd, gait = _start(mods, cfg, inp, device,
                              lambda plant: FS.observe_plant(plant, mc, kin_backend="pallas")[0])
    if wl["entry"] != "tick_pair":
        raise ValueError(f"the full stack has no entry {wl['entry']!r}")
    every = kw["loop_cfg"].iterations_between_mpc
    mpc_tick, plain_tick = FS.capture_ticks(start.plant, start.ctrl, cmd, gait, mc, **kw)
    units = {"mpc": lambda carry: mpc_tick(carry)[0],
             "plain": lambda carry: plain_tick(carry)[0]}
    schedule = lambda i: "mpc" if i % every == 0 else "plain"
    return SimpleNamespace(start=start, units=units, schedule=schedule, instances=inp["B"],
                           ticks_per_unit=1)


def reference(cfg: dict, wl: dict, inp: dict, device):
    from port_bench.reference import articulated_sim as art
    from port_bench.reference import config as C
    from port_bench.reference import floating_base as fb
    from port_bench.reference import full_stack as FS
    from port_bench.reference import gait as G
    from port_bench.reference import mpc as M
    from port_bench.reference import wbc as W

    mc = fb.build_a1_constants("float32", str(device))
    kw = _kw(cfg, C, W, art)
    mods = SimpleNamespace(art=art, mpc=M, gait=G, fs=FS)
    start, cmd, gait = _start(mods, cfg, inp, device,
                              lambda plant: FS.observe_plant(plant, mc)[0])
    mpc_tick = FS.tick_step(cmd, gait, mc, True, **kw)
    plain_tick = FS.tick_step(cmd, gait, mc, False, **kw)
    units = {"mpc": lambda c: mpc_tick(c)[0], "plain": lambda c: plain_tick(c)[0]}
    return SimpleNamespace(start=start, units=units)


def compare(got, want) -> dict:
    """The gaps of the program's carry after a unit to the reference's
    from the same state, each the largest over the robots: the first-step
    forces (solved at an MPC tick), the swing targets, the base and the
    joints (their velocities answer the tick's WBC torques)."""
    g, w = got.ctrl, want.ctrl
    gp, wp = got.plant.fb, want.plant.fb
    return {
        "forces_N": tree.max_gap(g.fr_des, w.fr_des),
        "swing_m": tree.max_gap((g.swing_p0, g.swing_pf), (w.swing_p0, w.swing_pf)),
        "base": tree.max_gap((gp.pos, gp.quat, gp.v_body), (wp.pos, wp.quat, wp.v_body)),
        "joints": tree.max_gap((gp.q, gp.qd), (wp.q, wp.qd)),
    }


def failed(carry) -> torch.Tensor:
    """(B,) bool on the device: the robot's plant state or forces are not
    finite, or its base has fallen."""
    B = carry.plant.fb.pos.shape[0]
    ok = tree.per_instance_finite((carry.plant, carry.ctrl.fr_des), B)
    return ~(ok & (carry.plant.fb.pos[:, 2] > FALL_HEIGHT))
