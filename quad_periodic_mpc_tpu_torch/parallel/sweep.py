"""Monte-Carlo sweep runner
(counterpart of ``quad_periodic_mpc_tpu/parallel/sweep.py``).

The BASELINE.json scaling configs as harnesses:
- config 3: gait sweep (trot/bound/pace/gallop x phase offsets), 1k+ QPs
  batched per card;
- config 4: disturbance-hypothesis x terrain sweep, 10k scenarios, each
  with its own heightmap;
- config 5: the gait x disturbance Monte-Carlo split over many devices
  (``mesh``) or ranks (``dist_check``).

A sweep = (scenario axes -> batched closed-loop rollout of each chunk on
its device, the chunks in lockstep -> per-instance metrics -> gathered in
global order -> mean and argmin over the whole batch).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import torch

from quad_periodic_mpc_tpu_torch.config import (
    ADMMConfig, EstimatorConfig, LoopConfig, MPCConfig,
)
from quad_periodic_mpc_tpu_torch.control import loop as loop_mod
from quad_periodic_mpc_tpu_torch.control import mpc as mpc_mod
from quad_periodic_mpc_tpu_torch.ops import gait as gait_ops
from quad_periodic_mpc_tpu_torch.parallel import mesh as mesh_lib
from quad_periodic_mpc_tpu_torch.sim import srb_sim
from quad_periodic_mpc_tpu_torch.terrain import heightmap as hmap
from quad_periodic_mpc_tpu_torch.terrain import scenario as terrain_scn


class SweepSpec(NamedTuple):
    """Cartesian scenario axes; total batch = product of axis lengths.

    The terrain axes realize BASELINE config 4: each (riser, edge_x) pair
    gets its own heightmap instance, and the rollout runs the map-aware
    foothold / body-height tier per scenario.  Empty terrain_risers = flat
    ground, no map (configs 3/5)."""

    gait_names: tuple = ("trotting", "bounding", "pacing", "galloping")
    phase_offsets: int = 4            # initial gait-phase shifts
    dist_static: tuple = (-10.0,)     # N
    dist_amp: tuple = (15.0,)         # N
    dist_freq: tuple = (0.33,)        # Hz
    dist_phase: tuple = (0.0,)        # rad
    terrain_risers: tuple = ()        # m; () = flat, no heightmap
    terrain_edge_x: tuple = (0.30,)   # m, first riser position
    terrain_tread: float = 10.0       # m (single long step by default)
    terrain_n_steps: int = 1
    map_size: int = 48                # heightmap cells per side
    map_resolution: float = 0.04      # m / cell
    vx: float = 0.3

    @property
    def size(self) -> int:
        n_terrain = (
            len(self.terrain_risers) * len(self.terrain_edge_x)
            if self.terrain_risers else 1
        )
        return (
            len(self.gait_names) * self.phase_offsets * len(self.dist_static)
            * len(self.dist_amp) * len(self.dist_freq) * len(self.dist_phase)
            * n_terrain
        )


class SweepResult(NamedTuple):
    vx_rms: torch.Tensor          # (B,) per-instance tracking error
    height_rms: torch.Tensor      # (B,)
    mean_vx_rms: torch.Tensor     # () mean over the whole batch
    best_instance: torch.Tensor   # () argmin of vx_rms, a global index
    batch: int


def build_scenarios(spec: SweepSpec, dtype=torch.float32, device="cuda"):
    """Expand the spec into batched (gait, phase-iteration, disturbance,
    terrain), terrain innermost.  terrain is None when the spec has no
    terrain axis."""
    terrain_axis = (
        list(itertools.product(spec.terrain_risers, spec.terrain_edge_x))
        if spec.terrain_risers else [None]
    )
    gaits, iters = [], []
    dist_s, dist_a, dist_f, dist_p = [], [], [], []
    risers, edges = [], []
    period_iters = 13 * gait_ops.DEFAULT_PERIOD
    for name, ph, ds, da, df, dp, terr in itertools.product(
        spec.gait_names, range(spec.phase_offsets), spec.dist_static,
        spec.dist_amp, spec.dist_freq, spec.dist_phase, terrain_axis,
    ):
        gaits.append(gait_ops.PRESET_GAITS[name])
        iters.append((ph * period_iters) // spec.phase_offsets)
        dist_s.append(ds); dist_a.append(da); dist_f.append(df); dist_p.append(dp)
        if terr is not None:
            risers.append(terr[0]); edges.append(terr[1])

    i32 = dict(dtype=torch.int32, device=device)
    f = lambda v: torch.tensor(v, dtype=dtype, device=device)
    gait = gait_ops.GaitParams(
        offsets=torch.tensor([g[0] for g in gaits], **i32),
        durations=torch.tensor([g[1] for g in gaits], **i32),
        n_segments=torch.full((len(gaits),), gait_ops.DEFAULT_PERIOD, **i32),
    )
    dist = srb_sim.DisturbanceParams(
        static=f(dist_s), amp=f(dist_a), freq=f(dist_f), phase=f(dist_p))
    terrain = None
    if spec.terrain_risers:
        terrain = terrain_scn.StairsTerrain(
            edge_x=f(edges), riser=f(risers),
            tread=float(spec.terrain_tread), n_steps=int(spec.terrain_n_steps))
    return gait, torch.tensor(iters, **i32), dist, terrain


def tracking_metrics(trace: loop_mod.RolloutTrace, cmd: mpc_mod.Command, terrain=None):
    """(vx_rms, height_rms) per instance over the second half of the trace
    (its steps axis follows the batch axis); the height error is measured
    above the local ground when there is terrain."""
    vx = trace.x[..., 9]
    half = vx.shape[-1] // 2
    vx_rms = torch.sqrt(torch.mean((vx[..., half:] - cmd.vx[..., None]) ** 2, -1))
    z = trace.x[..., 5]
    z_ref = cmd.body_height[..., None].expand(z.shape)
    if terrain is not None:
        z_ref = z_ref + terrain_scn.ground_z(terrain, trace.x[..., 3:5])
    height_rms = torch.sqrt(torch.mean((z[..., half:] - z_ref[..., half:]) ** 2, -1))
    return vx_rms, height_rms


DEFAULT_MPC = MPCConfig(horizon=10)
DEFAULT_EST = EstimatorConfig(mode="ls", residual="discrete")


class SweepChunk(NamedTuple):
    """One mesh entry's share of a sweep: its rollout's inputs on its
    device (terrain and heightmap None on flat ground)."""

    plant: srb_sim.PlantState
    ctrl: mpc_mod.ControllerState
    cmd: mpc_mod.Command
    gait: gait_ops.GaitParams
    dist: srb_sim.DisturbanceParams
    terrain: terrain_scn.StairsTerrain | None
    heightmap: hmap.HeightMap | None


def build_chunks(spec: SweepSpec, mesh: mesh_lib.Mesh, mpc_cfg: MPCConfig,
                 est_cfg: EstimatorConfig, solver, dtype) -> list[SweepChunk]:
    """The sweep's set-up: the plant, controller, command, disturbance and
    (with a terrain axis) the (B, map_size, map_size) maps of every
    scenario, built on the mesh's first device and split over the mesh."""
    device = mesh.devices[0]
    gait, iters, dist, terrain = build_scenarios(spec, dtype, device)
    B = spec.size
    batch = (B,)

    plant = srb_sim.init_plant(batch, body_height=0.29, dtype=dtype, device=device)
    obs = srb_sim.observe(plant)
    ctrl = mpc_mod.init_state(
        batch, obs, window=est_cfg.window, dtype=dtype, horizon=mpc_cfg.horizon,
        formulation=getattr(solver, "formulation", "condensed"))
    ctrl = ctrl._replace(iteration=iters)
    f = lambda v: torch.full(batch, v, dtype=dtype, device=device)
    cmd = mpc_mod.Command(vx=f(spec.vx), vy=f(0.0), yaw_rate=f(0.0), body_height=f(0.29))
    hm = None
    if terrain is not None:
        hm = terrain_scn.build_map(
            terrain, size=spec.map_size, resolution=spec.map_resolution, dtype=dtype)

    chunks = []
    for c in mesh_lib.shard_batch((plant, ctrl, cmd, gait, dist, terrain, hm), mesh, B):
        c = SweepChunk(*c)
        # the map's resolution and the staircase's tread and step count stay
        # Python numbers from the spec (heightmap.div builds its divisor
        # from them on the chunk's device)
        if c.heightmap is not None:
            c = c._replace(heightmap=c.heightmap._replace(
                resolution=float(spec.map_resolution)))
        if c.terrain is not None:
            c = c._replace(terrain=c.terrain._replace(
                tread=float(spec.terrain_tread), n_steps=int(spec.terrain_n_steps)))
        chunks.append(c)
    return chunks


def rollout_chunk(n_mpc_steps: int, chunk: SweepChunk, mpc_cfg: MPCConfig,
                  loop_cfg: LoopConfig, est_cfg: EstimatorConfig, solver):
    """loop.rollout of one chunk: map-aware footholds on its maps and the
    plant on its staircase when it has terrain.  Returns (carry, trace)."""
    terrain = chunk.terrain
    return loop_mod.rollout(
        n_mpc_steps, chunk.plant, chunk.ctrl, chunk.cmd, chunk.gait, chunk.dist, mpc_cfg,
        loop_cfg, est_cfg, solver, heightmap=chunk.heightmap,
        ground_fn=None if terrain is None else lambda xy: terrain_scn.ground_z(terrain, xy))


def run_sweep(
    spec: SweepSpec,
    n_mpc_steps: int = 100,
    mesh: mesh_lib.Mesh | None = None,
    mpc_cfg: MPCConfig = DEFAULT_MPC,
    loop_cfg: LoopConfig = LoopConfig(),
    est_cfg: EstimatorConfig = DEFAULT_EST,
    solver=ADMMConfig(iterations=100),
    dtype=torch.float32,
    device="cuda",
) -> SweepResult:
    """Roll out every scenario in lockstep.  With a mesh the batch is split
    over its entries, the chunks rolled out at once (``mesh.run_lockstep``:
    a thread per entry on its entry's device, the batch-global decisions
    taken over every chunk), and the metrics gathered on the first entry's
    device; mesh=None is one chunk on ``device``.  A split run is the
    unsplit program: on the CPU it gives the unsplit run's bits."""
    if mesh is None:
        mesh = mesh_lib.make_mesh(devices=[device])

    def metrics(chunk: SweepChunk):
        _, trace = rollout_chunk(n_mpc_steps, chunk, mpc_cfg, loop_cfg, est_cfg, solver)
        return tracking_metrics(trace, chunk.cmd, chunk.terrain)

    chunks = build_chunks(spec, mesh, mpc_cfg, est_cfg, solver, dtype)
    vx_rms, height_rms = mesh_lib.gather(mesh_lib.run_lockstep(metrics, chunks, mesh),
                                         mesh.devices[0])
    return SweepResult(
        vx_rms=vx_rms, height_rms=height_rms, mean_vx_rms=torch.mean(vx_rms),
        best_instance=torch.argmin(vx_rms), batch=spec.size)


def argmin_agrees(ref_values, ref_index: int, index: int, atol: float, rtol: float) -> bool:
    """The tie rule for comparing an argmin with a reference's: the indices
    are equal, or the reference's two smallest values lie within the
    comparison's tolerance (atol + rtol |min|) of each other and the
    reference's value at ``index`` lies within it of the reference's
    minimum."""
    ref = (ref_values.detach().cpu() if isinstance(ref_values, torch.Tensor)
           else torch.tensor(ref_values)).to(torch.float64).flatten()
    if int(index) == int(ref_index):
        return True
    lo = float(ref[int(ref_index)])
    tol = atol + rtol * abs(lo)
    two = torch.topk(ref, min(2, ref.numel()), largest=False).values
    near_tie = ref.numel() > 1 and float(two[1] - two[0]) < tol
    return near_tie and abs(float(ref[int(index)]) - lo) <= tol
