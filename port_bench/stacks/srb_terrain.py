"""The terrain-aware walking loop (``control/loop.period_step`` with a
heightmap and a ground) of configuration ``a1_terrain_loop_h10``: the
program's timed unit, the reference's, and the decision-aware comparison.

Entry: ``period_replay``, the period captured once and replayed
(``runtime/graphs.capture`` of ``loop.period_step``, as
``loop.rollout_graphed`` runs it), over each scenario's own map and step.

The comparison.  Every map lookup is a decision on a rounded coordinate,
and the two sides' coordinates differ by the rounding of their forces
and plant step.  A leg's decisions are its cells and its step: the
foothold cell of its swing target, the cell of its swing start and the
step under its foot, each read from the two sides' states after the
period with the reference's lookups.  A leg *differs* where one of those
differs, or where its swing target or foot lies farther from the
reference's than the cell's limit.  A leg that differs is a *flip* where
the reference's own period took one of its decisions within rounding of
the other answer (``terrain_loop``'s ``near``: a point within
``rounding_window_m`` of a cell boundary or a riser's x, a traversability
within ``rounding_window_trav`` of the threshold), and *unexplained*
otherwise.  ``swing_m`` and ``plant`` are held on the instances with no
flip; ``forces_N`` and ``f_est_N`` on all (the MPC tick decides from the
state before the period, the same on both sides).  ``terrain_flips``
counts the instances with a flip, ``terrain_flips_unexplained`` those with
a leg that differs outside the window: each unit's count, the largest over
the kept units."""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import torch

from port_bench.lib import tree
from port_bench.stacks import draws, srb_loop
from port_bench.stacks.srb_loop import build_configs, failed  # noqa: F401  (failed: the harness's)

SOURCES = ("stagewise_srb.cu", "srb_plant.cu")


class Judged(NamedTuple):
    """The reference's answer with what the comparison reads beside it."""

    carry: object
    near: torch.Tensor        # (B, 4) bool
    hm: object                # the reference's maps
    stairs: object            # the reference's ground
    leg_limits: tuple         # (swing m, plant m) past which a leg differs


def draw_inputs(cfg: dict, wl: dict, seed: int, device, instances=None) -> dict:
    """The cell's inputs from the seed: plain tensors and numbers that both
    sides build their own objects from."""
    p = wl["params"]
    g = draws.generator(seed, device)
    samples = draws.window_samples(g, wl["samples"], device)
    f32 = dict(dtype=torch.float32, device=device)
    B = int(p["instances"] if instances is None else instances)
    pick = lambda values: torch.tensor(values, **f32)[
        draws.integers(g, B, len(values), device)]
    return {
        "samples": samples, "B": B, "gait": p["gait"],
        "vx": float(p["vx"]), "body_height": float(cfg["body_height"]),
        "iteration": draws.integers(g, B, int(p["gait_cycle_ticks"]), device).to(torch.int32),
        "dist": (torch.full((B,), float(p["dist_static"]), **f32),
                 draws.uniform(g, B, *p["dist_amp"], device).float(),
                 draws.uniform(g, B, *p["dist_freq"], device).float(),
                 draws.uniform(g, B, *p["dist_phase"], device).float()),
        "riser": pick(p["risers"]), "edge_x": pick(p["edges"]),
    }


def _fleet_start(mods, inp: dict, device):
    """The trot cell's (carry, cmd, gait, dist) built with ``mods``, the
    command filter from 0: every robot starts from rest at the origin (the
    doorstep experiment's start)."""
    carry, cmd, gait, dist = srb_loop._fleet_start(mods, inp, device)
    ctrl = carry.ctrl._replace(x_vel_des=torch.zeros_like(carry.ctrl.x_vel_des))
    return carry._replace(ctrl=ctrl), cmd, gait, dist


def program(cfg: dict, wl: dict, inp: dict, device):
    """The program's side: ``start``, ``units`` {kind: fn(carry) -> carry},
    ``schedule(i)``, and the scenarios' ``terrain`` and ``heightmap`` the
    captured period reads."""
    from quad_periodic_mpc_tpu_torch import config as C
    from quad_periodic_mpc_tpu_torch.control import loop as L
    from quad_periodic_mpc_tpu_torch.control import mpc as M
    from quad_periodic_mpc_tpu_torch.ops import gait as G
    from quad_periodic_mpc_tpu_torch.runtime import graphs
    from quad_periodic_mpc_tpu_torch.sim import srb_sim as S
    from quad_periodic_mpc_tpu_torch.terrain import scenario as SC

    if wl["entry"] != "period_replay":
        raise ValueError(f"the terrain loop has no entry {wl['entry']!r}")
    cfgs = build_configs(cfg, C)
    mpc_cfg, loop_cfg, est_cfg, solver, swing_cfg = cfgs
    mods = SimpleNamespace(srb_sim=S, mpc=M, gait=G, loop=L, cfgs=cfgs)
    start, cmd, gait, dist = _fleet_start(mods, inp, device)
    terrain = SC.StairsTerrain(edge_x=inp["edge_x"].clone(), riser=inp["riser"].clone(),
                               tread=float(cfg["ground"]["tread"]),
                               n_steps=int(cfg["ground"]["n_steps"]))
    hm = SC.build_map(terrain, size=int(cfg["map"]["size"]),
                      resolution=float(cfg["map"]["resolution"]))
    step = L.period_step(cmd, gait, dist, mpc_cfg, loop_cfg, est_cfg, solver,
                         swing_cfg=swing_cfg, heightmap=hm,
                         ground_fn=lambda xy: SC.ground_z(terrain, xy),
                         terrain_cfg=L.TerrainLoopConfig(**cfg["terrain"]))
    graphed = graphs.capture(step, start)
    unit = lambda carry: graphed(carry)[0]
    return SimpleNamespace(start=start, units={"period": unit}, schedule=lambda i: "period",
                           instances=inp["B"], ticks_per_unit=loop_cfg.iterations_between_mpc,
                           terrain=terrain, heightmap=hm)


def reference(cfg: dict, wl: dict, inp: dict, device):
    """The reference's side: ``start`` and ``units`` {kind: fn(carry) ->
    Judged}."""
    from port_bench.reference import config as C
    from port_bench.reference import gait as G
    from port_bench.reference import loop as L
    from port_bench.reference import mpc as M
    from port_bench.reference import srb_sim as S
    from port_bench.reference import terrain as T
    from port_bench.reference import terrain_loop as TL

    cfgs = build_configs(cfg, C)
    mpc_cfg, loop_cfg, est_cfg, solver, swing_cfg = cfgs
    mods = SimpleNamespace(srb_sim=S, mpc=M, gait=G, loop=L, cfgs=cfgs)
    start, cmd, gait, dist = _fleet_start(mods, inp, device)
    stairs = T.Stairs(inp["edge_x"].clone(), inp["riser"].clone(),
                      float(cfg["ground"]["tread"]), int(cfg["ground"]["n_steps"]))
    hm = T.build_map(stairs, int(cfg["map"]["size"]), float(cfg["map"]["resolution"]))
    p, lim = wl["params"], wl["limits"]
    step = TL.period_step(cmd, gait, dist, mpc_cfg, loop_cfg, est_cfg, solver, hm, stairs,
                          T.TerrainConfig(**cfg["terrain"]), float(p["rounding_window_m"]),
                          float(p["rounding_window_trav"]), swing_cfg=swing_cfg)

    def unit(carry):
        out = step(carry)
        return Judged(out.carry, out.near, hm, stairs, (lim["swing_m"], lim["plant"]))

    return SimpleNamespace(start=start, units={"period": unit})


def _per(a: torch.Tensor, b: torch.Tensor, dims: int) -> torch.Tensor:
    """|a - b| in float64, its largest over the last ``dims`` axes; inf
    where either side is not finite."""
    d = (a.double() - b.double()).abs()
    d = torch.where(torch.isfinite(a) & torch.isfinite(b), d, torch.full_like(d, float("inf")))
    return d.flatten(-dims).amax(-1)


def decisions(carry, hm, stairs) -> tuple:
    """A carry's decisions, read with the reference's lookups: each leg's
    foothold cell (its swing target), swing-start cell and step, (B, 4)
    int64 each."""
    from port_bench.reference import terrain as T

    leg_hm = hm._replace(center=hm.center[..., None, :])
    cell = lambda xy: (lambda i: i[..., 0] * hm.elevation.shape[-1] + i[..., 1])(
        T.world_to_index(leg_hm, xy))
    c = carry.ctrl
    return (cell(c.swing_pf[..., 0:2]), cell(c.swing_p0[..., 0:2]),
            T.step_index(stairs, carry.plant.p_feet[..., 0]).long())


def compare(got, want: Judged) -> dict:
    """The gaps of the program's carry after a unit (or of a reference's in
    its place) to the reference's from the same state, held as the module's
    note says, and the unit's flips."""
    g = getattr(got, "carry", got)
    w = want.carry
    swing_lim, plant_lim = want.leg_limits
    swing = torch.maximum(_per(g.ctrl.swing_p0, w.ctrl.swing_p0, 1),
                          _per(g.ctrl.swing_pf, w.ctrl.swing_pf, 1))        # (B, 4)
    feet = _per(g.plant.p_feet, w.plant.p_feet, 1)                            # (B, 4)
    body = _per(g.plant.x[..., :12], w.plant.x[..., :12], 1)                  # (B,)
    cells = [a != b for a, b in zip(decisions(g, want.hm, want.stairs),
                                    decisions(w, want.hm, want.stairs))]
    differs = cells[0] | cells[1] | cells[2] | (swing > swing_lim) | (feet > plant_lim)
    finite = torch.isfinite(torch.cat([swing, feet, body[:, None]], -1)).all(-1)
    flipped = (differs & want.near).any(-1) & finite
    unexplained = (differs & ~want.near).any(-1)
    kept = ~flipped
    held = lambda t: float(t[kept].max()) if bool(kept.any()) else 0.0
    return {
        "forces_N": tree.max_gap(g.ctrl.fr_des, w.ctrl.fr_des),
        "f_est_N": tree.max_gap(g.ctrl.est.f_est, w.ctrl.est.f_est),
        "swing_m": held(swing.amax(-1)),
        "plant": held(torch.maximum(body, feet.amax(-1))),
        "terrain_flips": float(flipped.sum()),
        "terrain_flips_unexplained": float(unexplained.sum()),
        "terrain_near_legs": float(want.near.sum()),
    }
