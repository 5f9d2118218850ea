"""The SRB walking loop (``control/loop.period_step``) of configuration
``a1_srb_loop_h10``: the program's timed unit, the reference's, and what
the comparison reads.

Entry: ``period_replay``, the period captured once and replayed
(``runtime/graphs.capture`` of ``loop.period_step``, as
``loop.rollout_graphed`` runs it)."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from port_bench.lib import tree
from port_bench.stacks import draws

SOURCES = ("stagewise_srb.cu",)
FALL_HEIGHT = 0.15                  # m: a body below it has fallen


def build_configs(cfg: dict, mod):
    """(mpc, loop, est, solver, swing) configs of ``mod`` (the program's or
    the reference's ``config`` module) from the configuration's file."""
    mpc = dict(cfg["mpc"], inertia_body=tuple(cfg["mpc"]["inertia_body"]),
               weights=tuple(cfg["mpc"]["weights"]))
    swing = dict(cfg["swing"], interleave_y=tuple(cfg["swing"]["interleave_y"]))
    return (mod.MPCConfig(**mpc), mod.LoopConfig(**cfg["loop"]),
            mod.EstimatorConfig(**cfg["estimator"]), mod.ADMMConfig(**cfg["solver"]),
            mod.SwingConfig(**swing))


def draw_inputs(cfg: dict, wl: dict, seed: int, device, instances=None) -> dict:
    """The cell's inputs from the seed: plain tensors and numbers that both
    sides build their own objects from."""
    p = wl["params"]
    g = draws.generator(seed, device)
    samples = draws.window_samples(g, wl["samples"], device)
    f32 = dict(dtype=torch.float32, device=device)
    B = int(p["instances"] if instances is None else instances)
    return {
        "samples": samples, "B": B, "gait": p["gait"],
        "vx": float(p["vx"]), "body_height": float(cfg["body_height"]),
        "iteration": draws.integers(g, B, int(p["gait_cycle_ticks"]), device).to(torch.int32),
        "dist": (torch.full((B,), float(p["dist_static"]), **f32),
                 draws.uniform(g, B, *p["dist_amp"], device).float(),
                 draws.uniform(g, B, *p["dist_freq"], device).float(),
                 draws.uniform(g, B, *p["dist_phase"], device).float()),
    }


def _fleet_start(mods, inp: dict, device):
    """The fleet's (carry, cmd, gait, dist) built with ``mods`` (the
    program's or the reference's modules)."""
    B = inp["B"]
    f32 = dict(dtype=torch.float32, device=device)
    plant = mods.srb_sim.init_plant((B,), body_height=inp["body_height"], device=device)
    obs = mods.srb_sim.observe(plant)
    ctrl = mods.mpc.init_state((B,), obs, horizon=mods.cfgs[0].horizon,
                               window=mods.cfgs[2].window, formulation="stagewise")
    ctrl = ctrl._replace(iteration=inp["iteration"].clone(),
                         x_vel_des=torch.full((B,), inp["vx"], **f32))
    cmd = mods.mpc.Command(vx=torch.full((B,), inp["vx"], **f32), vy=torch.zeros(B, **f32),
                           yaw_rate=torch.zeros(B, **f32),
                           body_height=torch.full((B,), inp["body_height"], **f32))
    gait = mods.gait.preset(inp["gait"], device=device)
    dist = mods.srb_sim.DisturbanceParams(*(t.clone() for t in inp["dist"]))
    return mods.loop.RolloutCarry(plant, ctrl), cmd, gait, dist


def program(cfg: dict, wl: dict, inp: dict, device):
    """The program's side: ``start`` (the initial carry), ``units`` {kind:
    fn(carry) -> carry} and ``schedule(i)`` -> the kind of unit i."""
    from quad_periodic_mpc_tpu_torch import config as C
    from quad_periodic_mpc_tpu_torch.control import loop as L
    from quad_periodic_mpc_tpu_torch.control import mpc as M
    from quad_periodic_mpc_tpu_torch.ops import gait as G
    from quad_periodic_mpc_tpu_torch.sim import srb_sim as S

    from quad_periodic_mpc_tpu_torch.runtime import graphs

    if wl["entry"] != "period_replay":
        raise ValueError(f"the SRB loop has no entry {wl['entry']!r}")
    cfgs = build_configs(cfg, C)
    mpc_cfg, loop_cfg, est_cfg, solver, swing_cfg = cfgs
    mods = SimpleNamespace(srb_sim=S, mpc=M, gait=G, loop=L, cfgs=cfgs)
    start, cmd, gait, dist = _fleet_start(mods, inp, device)
    step = L.period_step(cmd, gait, dist, mpc_cfg, loop_cfg, est_cfg, solver,
                         swing_cfg=swing_cfg)
    graphed = graphs.capture(step, start)
    unit = lambda carry: graphed(carry)[0]
    return SimpleNamespace(start=start, units={"period": unit}, schedule=lambda i: "period",
                           instances=inp["B"],
                           ticks_per_unit=loop_cfg.iterations_between_mpc)


def reference(cfg: dict, wl: dict, inp: dict, device):
    """The reference's side: ``start`` (its own initial carry from the
    inputs) and ``units`` {kind: fn(carry) -> carry} on carries of its own
    layout."""
    from port_bench.reference import config as C
    from port_bench.reference import gait as G
    from port_bench.reference import loop as L
    from port_bench.reference import mpc as M
    from port_bench.reference import srb_sim as S

    cfgs = build_configs(cfg, C)
    mpc_cfg, loop_cfg, est_cfg, solver, swing_cfg = cfgs
    mods = SimpleNamespace(srb_sim=S, mpc=M, gait=G, loop=L, cfgs=cfgs)
    start, cmd, gait, dist = _fleet_start(mods, inp, device)
    step = L.period_step(cmd, gait, dist, mpc_cfg, loop_cfg, est_cfg, solver,
                         swing_cfg=swing_cfg)
    return SimpleNamespace(start=start, units={"period": lambda carry: step(carry)[0]})


def compare(got, want) -> dict:
    """The gaps of the program's carry after a unit to the reference's
    from the same state: first-step forces, the estimate, the swing
    targets, the plant."""
    g, w = got.ctrl, want.ctrl
    return {
        "forces_N": tree.max_gap(g.fr_des, w.fr_des),
        "f_est_N": tree.max_gap(g.est.f_est, w.est.f_est),
        "swing_m": tree.max_gap((g.swing_p0, g.swing_pf), (w.swing_p0, w.swing_pf)),
        "plant": tree.max_gap((got.plant.x[..., :12], got.plant.p_feet),
                              (want.plant.x[..., :12], want.plant.p_feet)),
    }


def failed(carry) -> torch.Tensor:
    """(B,) bool on the device: the instance's plant state or forces are not
    finite, or its body has fallen."""
    B = carry.plant.x.shape[0]
    ok = tree.per_instance_finite((carry.plant, carry.ctrl.fr_des), B)
    return ~(ok & (carry.plant.x[:, 5] > FALL_HEIGHT))
