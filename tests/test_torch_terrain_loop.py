"""Terrain in the loop on the port, against the JAX package: the map's
ground truth, the staircase, _updateFoothold's relative z and clamp, the
spiral search off low-traversability cells and the frozen map (the five
fast tests of tests/test_terrain_loop.py), the plant's ground clamp, and
both arms of the doorstep experiment (map-aware and terrain-blind) rolled
out against JAX's loop.rollout period by period.

The rollouts run float64 PDIP-25 on both sides (the reference's
closed-loop solver), JAX jitted with the map closed over.  The terrain
adds discrete choices (cells, the spiral's pick) to the loop; the feet
stay clear of cell edges by far more than the loop's 1e-12-level drift,
so every choice is the same and the states stay as close as the flat
rollouts of tests/test_torch_closed_loop.py.  test_terrain_rollout_beats_flat
(110 periods, slow in JAX) has its counterpart on the card, chip_smoke.py
phase 14.
"""

import numpy as np
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from quad_periodic_mpc_tpu import config as jc
from quad_periodic_mpc_tpu.control import loop as j_loop
from quad_periodic_mpc_tpu.control import mpc as j_mpc
from quad_periodic_mpc_tpu.ops import gait as j_gait
from quad_periodic_mpc_tpu.sim import srb_sim as j_sim
from quad_periodic_mpc_tpu.terrain import heightmap as j_hm
from quad_periodic_mpc_tpu.terrain import scenario as j_scn
from quad_periodic_mpc_tpu_torch import config as tc
from quad_periodic_mpc_tpu_torch import convert
from quad_periodic_mpc_tpu_torch.control import cmpc_variant as cv
from quad_periodic_mpc_tpu_torch.control import loop as t_loop
from quad_periodic_mpc_tpu_torch.ops import gait as G
from quad_periodic_mpc_tpu_torch.sim import srb_sim as t_sim
from quad_periodic_mpc_tpu_torch.terrain import heightmap as hmap
from quad_periodic_mpc_tpu_torch.terrain import scenario

CPU = "cpu"
F64 = jnp.float64


# ---- the five fast tests of tests/test_terrain_loop.py, on the port -------

def test_build_map_matches_ground_truth():
    terr = scenario.StairsTerrain.single_step(edge_x=0.30, height=0.08, device=CPU)
    hm = scenario.build_map(terr, size=64, resolution=0.03)
    for x, y in [(-0.5, 0.0), (0.0, 0.2), (0.29, -0.3), (0.35, 0.1), (0.8, 0.0)]:
        xy = torch.tensor([x, y])
        z_map = float(hmap.sample(hm.elevation, hmap.world_to_index(hm, xy)[None, :])[0])
        assert abs(z_map - float(scenario.ground_z(terr, xy))) < 1e-6, (x, y)


def test_stairs_ground_z_batched():
    terr = scenario.StairsTerrain(edge_x=torch.tensor([0.3, 0.5]), riser=torch.tensor([0.05, 0.10]),
                                  tread=0.25, n_steps=3)
    np.testing.assert_allclose(scenario.ground_z(terr, torch.zeros(2, 2)).numpy(), 0.0)
    xy = torch.tensor([[0.31, 0.0], [0.51, 0.0]])
    np.testing.assert_allclose(scenario.ground_z(terr, xy).numpy(), [0.05, 0.10])
    xy = torch.tensor([[5.0, 0.0], [5.0, 0.0]])
    np.testing.assert_allclose(scenario.ground_z(terr, xy).numpy(), [0.15, 0.30], rtol=1e-6)
    assert scenario.ground_z(terr, xy[:, None, :].expand(2, 4, 2)).shape == (2, 4)


def test_foothold_update_relative_z_and_clamp():
    terr = scenario.StairsTerrain.single_step(edge_x=0.0, height=0.30, device=CPU)
    hm = scenario.build_map(terr, size=64, resolution=0.03)
    hm = hm._replace(traversability=torch.ones_like(hm.traversability))
    p0 = torch.tensor([[-0.20, 0.0, 0.0]] * 4)
    pf = torch.tensor([[0.20, 0.0, 0.0]] * 4)
    out = cv.foothold_update(hm, pf, p0, max_step_height=0.17)
    np.testing.assert_allclose(out[:, 2].numpy(), 0.17, atol=1e-6)
    p0_top, pf_top = p0.clone(), pf.clone()
    pf_top[:, 2] = 0.30
    out2 = cv.foothold_update(hm, p0_top, pf_top, max_step_height=0.17)   # a drop-off
    np.testing.assert_allclose(out2[:, 2].numpy(), 0.0, atol=1e-6)


def test_foothold_update_avoids_low_traversability():
    terr = scenario.StairsTerrain.single_step(edge_x=0.30, height=0.10, device=CPU)
    hm = scenario.build_map(terr, size=64, resolution=0.03)
    assert bool((hm.traversability < 0.8).any()), "riser must create non-traversable cells"
    pf = torch.tensor([[0.30, 0.0, 0.0]] * 4)
    out = cv.foothold_update(hm, pf, torch.tensor([[0.10, 0.0, 0.0]] * 4))
    trav = hmap.sample(hm.traversability, hmap.world_to_index(hm, out[..., 0:2]))
    assert bool((trav > 0.8).all()), trav
    assert float(torch.abs(out[0, 0] - 0.30)) > 1e-3


def test_frozen_map_same_world_answers():
    terr = scenario.StairsTerrain.single_step(edge_x=0.30, height=0.08, device=CPU)
    hm = scenario.build_map(terr, size=96, resolution=0.03)
    pf = torch.tensor([[0.25, 0.05, 0.0]] * 4)
    p0a = torch.tensor([[0.05, 0.05, 0.0]] * 4)
    out_a = cv.foothold_update(hm, pf, p0a)
    assert torch.equal(out_a, cv.foothold_update(hm, pf, p0a))
    out_c = cv.foothold_update(hmap.move(hm, torch.tensor([0.30, 0.0])), pf, p0a)
    np.testing.assert_allclose(out_a.numpy(), out_c.numpy(), atol=1e-6)


def test_foothold_counters_hold_a_direct_count():
    """FOOTHOLD_MOVED and FOOTHOLD_SEARCHED after one foothold_update on
    three flat maps against a direct count: one target snapped off its own
    cell (made untraversable), the four targets of a map with no
    traversable cell, none of the other seven; twelve searched."""
    terr = scenario.StairsTerrain.flat((3,), device=CPU)
    hm = scenario.build_map(terr, size=48, resolution=0.03)
    pf = torch.tensor([[0.18, -0.13, 0.0], [0.18, 0.13, 0.0], [-0.18, -0.13, 0.0],
                       [-0.18, 0.13, 0.0]]).expand(3, 4, 3).clone()
    pf[1] += torch.tensor([0.011, -0.004, 0.0])
    own = hmap.world_to_index(hm._replace(center=hm.center[:, None, :]), pf[..., 0:2])
    trav = hm.traversability.clone()
    trav[1, own[1, 2, 0], own[1, 2, 1]] = 0.0                # the forced snap
    trav[2] = 0.0                                            # no valid cell anywhere
    hm = hm._replace(traversability=trav)
    direct = hmap.sample(trav, own) <= 0.8
    assert direct.sum() == 5
    before = cv.foothold_counts()
    out = cv.foothold_update(hm, pf, pf.clone())
    moved, searched = (b - a for a, b in zip(before, cv.foothold_counts()))
    assert (moved, searched) == (int(direct.sum()), 12)
    shifted = (out[..., 0:2] != pf[..., 0:2]).any(-1)
    assert shifted.tolist() == [[False] * 4, [False, False, True, False], [False] * 4]


# ---- the loop's terrain hooks against JAX ---------------------------------

def test_plant_ground_clamp_and_terrain_command_match_jax():
    """srb_sim.step with a ground function (feet below the stairs lifted onto
    them) and the map body-height command (the mean map elevation under the
    feet added to the command), in float64 against JAX."""
    jt = j_scn.StairsTerrain(edge_x=jnp.asarray([0.1, 0.2], F64),
                             riser=jnp.asarray([0.05, 0.09], F64), tread=0.2, n_steps=3)
    tt = convert.stairs_terrain(jt, CPU)
    jm = j_scn.build_map(jt, size=48, resolution=0.03, dtype=F64)
    tm = convert.heightmap(jm, CPU)
    rng = np.random.default_rng(30)
    plant = j_sim.init_plant((2,), body_height=0.29, dtype=F64)
    feet = np.asarray(plant.p_feet) + rng.normal(0, 0.1, (2, 4, 3))
    plant = plant._replace(p_feet=jnp.asarray(feet))
    forces = jnp.asarray(rng.normal(0, 20, (2, 4, 3)) + [0.0, 0.0, 30.0])
    p_des = jnp.asarray(feet + rng.normal(0, 0.05, (2, 4, 3)))
    stance = jnp.asarray([[1.0, 0.0, 0.0, 1.0], [0.0, 1.0, 1.0, 0.0]], F64)
    dist = j_sim.DisturbanceParams.zero((2,), F64)
    cfg_j, cfg_t = jc.MPCConfig(), tc.MPCConfig()
    out_j = j_sim.step(plant, forces, p_des, stance, dist, cfg_j, 0.002,
                       ground_fn=lambda xy: j_scn.ground_z(jt, xy))
    out_t = t_sim.step(convert.plant_state(plant, CPU), *(convert.tensor(a, CPU) for a in (
        forces, p_des, stance)), convert.disturbance(dist, CPU), cfg_t, 0.002,
        ground_fn=lambda xy: scenario.ground_z(tt, xy))
    np.testing.assert_allclose(out_t.p_feet.numpy(), np.asarray(out_j.p_feet), atol=1e-15)
    lifted = np.asarray(out_j.p_feet)[..., 2] > np.where(np.asarray(stance) > 0.5, feet[..., 2],
                                                           np.asarray(p_des)[..., 2])
    assert lifted.any()
    cmd = j_mpc.Command(vx=jnp.zeros(2, F64), vy=jnp.zeros(2, F64), yaw_rate=jnp.zeros(2, F64),
                        body_height=jnp.full(2, 0.29, F64))
    obs = j_sim.observe(out_j)
    hm_feet = jm._replace(center=jm.center[..., None, :])
    z_ref = jnp.mean(j_hm.sample(jm.elevation, j_hm.world_to_index(hm_feet, obs.p_feet[..., :2])),
                     axis=-1)
    got = t_loop.terrain_command(tm, convert.command(cmd, CPU), t_sim.observe(out_t))
    np.testing.assert_allclose(got.body_height.numpy(), 0.29 + np.asarray(z_ref), atol=1e-15)
    assert t_loop.terrain_command(None, cmd, obs) is cmd
    off = t_loop.TerrainLoopConfig(body_height_from_map=False)
    assert t_loop.terrain_command(tm, cmd, obs, off) is cmd
    assert t_loop.TerrainLoopConfig()._asdict() == j_loop.TerrainLoopConfig()._asdict()


# float64 both sides: the flat rollouts of tests/test_torch_closed_loop.py
# drift to 4e-7 on the state by period 50; the terrain adds no continuous
# term of its own, so the same tolerances hold here over 30 periods
ROLL_TOL = {"x": 2e-6, "forces": 5e-5}
EDGE, RISER, PERIODS = 0.28, 0.06, 30


def test_doorstep_rollout_both_arms_match_jax():
    """B = 2: instance 0 walks (vx = 0.25, gait phase 0) over a 6 cm riser at
    0.28 m, close enough that its front feet step onto it within the 30
    periods; instance 1 (gait phase 7) walks on flat ground.  The map-aware
    arm (96 x 96 map at 0.03 m, foothold_update every tick, the map's
    body-height command) and the terrain-blind arm on the same plant and
    surface, each against JAX's rollout period by period."""
    batch = (2,)
    jt = j_scn.StairsTerrain(edge_x=jnp.asarray([EDGE, 1e6], F64),
                             riser=jnp.asarray([RISER, 0.0], F64), tread=10.0, n_steps=1)
    tt = convert.stairs_terrain(jt, CPU)
    jm = j_scn.build_map(jt, size=96, resolution=0.03, dtype=F64)
    tm = convert.heightmap(jm, CPU)
    plant = j_sim.init_plant(batch, body_height=0.29, dtype=F64)
    ctrl = j_mpc.init_state(batch, j_sim.observe(plant), dtype=F64, horizon=10)
    ctrl = ctrl._replace(iteration=jnp.asarray([0, 7], jnp.int32))
    full = lambda v: jnp.full(batch, v, F64)
    cmd = j_mpc.Command(vx=full(0.25), vy=full(0.0), yaw_rate=full(0.0), body_height=full(0.29))
    jd = j_sim.DisturbanceParams.zero(batch, F64)
    est = dict(mode="ls", residual="discrete")
    j_cfg = (jc.MPCConfig(horizon=10), jc.LoopConfig(), jc.EstimatorConfig(**est),
             jc.PDIPConfig(iterations=25))
    t_cfg = (tc.MPCConfig(horizon=10), tc.LoopConfig(), tc.EstimatorConfig(**est),
             tc.PDIPConfig(iterations=25))
    t_args = (convert.plant_state(plant, CPU), convert.controller_state(ctrl, CPU),
              convert.command(cmd, CPU), G.preset("trotting", device=CPU),
              convert.disturbance(jd, CPU), *t_cfg)
    traces = {}
    for arm, use_map in (("map", True), ("blind", False)):
        carry_j, tr_j = jax.jit(lambda p, c: j_loop.rollout(
            PERIODS, p, c, cmd, j_gait.preset("trotting"), jd, *j_cfg,
            heightmap=jm if use_map else None,
            ground_fn=lambda xy: j_scn.ground_z(jt, xy)))(plant, ctrl)
        carry_t, tr_t = t_loop.rollout(PERIODS, *t_args, heightmap=tm if use_map else None,
                                       ground_fn=lambda xy: scenario.ground_z(tt, xy))
        for f, tol in ROLL_TOL.items():
            np.testing.assert_allclose(getattr(tr_t, f).numpy(), np.asarray(getattr(tr_j, f)),
                                       atol=tol, rtol=0, err_msg=f"{arm} {f}")
        np.testing.assert_allclose(carry_t.ctrl.swing_pf.numpy(),
                                   np.asarray(carry_j.ctrl.swing_pf), atol=ROLL_TOL["x"])
        np.testing.assert_allclose(carry_t.plant.p_feet.numpy(),
                                   np.asarray(carry_j.plant.p_feet), atol=ROLL_TOL["x"])
        traces[arm] = (tr_t.x.numpy(), carry_t)
    # the run crossed the riser: instance 0's front feet are over it in both
    # arms, on it or above it, and the map-aware arm's body rose with it
    for arm in ("map", "blind"):
        feet = traces[arm][1].plant.p_feet.numpy()[0]
        on_step = feet[:, 0] > EDGE + 0.01
        assert on_step.any() and (feet[on_step, 2] >= RISER - 1e-9).all(), (arm, feet)
    x_map, x_blind = traces["map"][0], traces["blind"][0]
    assert np.isfinite(x_map).all() and np.isfinite(x_blind).all()
    assert x_map[0, -1, 5] > x_blind[0, -1, 5]
    # flat ground: the map changes nothing but the cell-centred footholds
    np.testing.assert_allclose(x_map[1, :, 5], x_blind[1, :, 5], atol=2e-3)
