"""The reference figures behind chip_smoke.py's phase-14 gates, on the CPU.

    python tools/slice6_reference.py [--batch 8] [--periods 110] [--package jax|torch|both]
        [--solver admm|pdip]

Runs phase 14's terrain experiment at a small batch in the JAX package
(float32, XLA path) and in the port (float32, the CUDA kernels' plain
versions on the CPU): the bench trot's gait phases ((7 i) mod 208) at vx =
0.25, h = 10, estimator "ls" on the discrete residual, no disturbance,
through loop.rollout with a per-instance 96 x 96 map at 0.03 m from
scenario.build_map and the true surface as the plant's ground function.
Instance 0 is tests/test_terrain_loop.py's robot (a 6 cm riser at edge
0.35 m, gait phase 0); instances 1.. cycle through the 20 (riser, edge)
pairs of tests/test_sweep_terrain.py:106-107.  Two arms, map-aware and
terrain-blind, on the same plant and surface.  The solver is stagewise
ADMM-30 (the card's path; "pallas" in the port, "xla" in JAX), or with
--solver pdip the reference test's PDIP-25.

Prints, per arm and package, instance 0's four gate figures of
tests/test_terrain_loop.py::test_terrain_rollout_beats_flat (final x, and
the rms of the height-above-terrain error z - ground - 0.29 over the last
25 periods) and their median over the instances with a riser.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VX, H, ITERS, MAP_SIZE, MAP_RES = 0.25, 10, 30, 96, 0.03
RISERS, EDGES = (0.0, 0.03, 0.06, 0.09), (0.20, 0.25, 0.30, 0.35, 0.40)
TAIL = 25


def scenarios(B: int) -> tuple[np.ndarray, np.ndarray]:
    """(riser, edge_x) per instance: instance 0 the reference test's robot,
    then the 20 pairs, risers cycling fastest (the sweep's innermost
    axis)."""
    pairs = [(r, e) for e in EDGES for r in RISERS]
    riser = np.array([0.06] + [pairs[(i - 1) % 20][0] for i in range(1, B)], np.float32)
    edge = np.array([0.35] + [pairs[(i - 1) % 20][1] for i in range(1, B)], np.float32)
    return riser, edge


class Package:
    """The scenario's calls in one package, on numpy at the edges."""

    def __init__(self, name: str):
        self.name = name
        if name == "jax":
            import jax

            jax.config.update("jax_platforms", "cpu")
            import jax.numpy as jnp

            from quad_periodic_mpc_tpu import config
            from quad_periodic_mpc_tpu.control import loop, mpc
            from quad_periodic_mpc_tpu.ops import gait
            from quad_periodic_mpc_tpu.sim import srb_sim
            from quad_periodic_mpc_tpu.terrain import scenario

            self.backend = "xla"
            self.arr = lambda a, dtype=np.float32: jnp.asarray(np.asarray(a, dtype))
            self.kw, self.gait_kw = dict(dtype=jnp.float32), {}
        else:
            import torch

            from quad_periodic_mpc_tpu_torch import config
            from quad_periodic_mpc_tpu_torch.control import loop, mpc
            from quad_periodic_mpc_tpu_torch.ops import gait
            from quad_periodic_mpc_tpu_torch.sim import srb_sim
            from quad_periodic_mpc_tpu_torch.terrain import scenario

            self.backend = "pallas"
            self.arr = lambda a, dtype=np.float32: torch.from_numpy(np.array(a, dtype))
            self.kw, self.gait_kw = dict(device="cpu"), dict(device="cpu")
        self.config, self.loop, self.mpc = config, loop, mpc
        self.gait, self.sim, self.scenario = gait, srb_sim, scenario

    def np(self, a) -> np.ndarray:
        return np.asarray(a) if self.name == "jax" else a.detach().cpu().numpy()

    def run(self, B: int, periods: int, use_map: bool, solver_name: str):
        """loop.rollout of one arm; returns (x (B, periods), err (B, periods))."""
        C, S, M = self.config, self.sim, self.mpc
        riser, edge = scenarios(B)
        terr = self.scenario.StairsTerrain(edge_x=self.arr(edge), riser=self.arr(riser),
                                           tread=10.0, n_steps=1)
        hm = self.scenario.build_map(terr, size=MAP_SIZE, resolution=MAP_RES)
        plant = S.init_plant((B,), body_height=0.29, **self.kw)
        init_kw = {"dtype": self.kw["dtype"]} if self.name == "jax" else {}
        ctrl = M.init_state((B,), S.observe(plant), horizon=H, formulation="stagewise",
                            **init_kw)
        ctrl = ctrl._replace(iteration=self.arr((np.arange(B) * 7) % 208, np.int32))
        full = lambda v: self.arr(np.full(B, v))
        cmd = M.Command(vx=full(VX), vy=full(0.0), yaw_rate=full(0.0), body_height=full(0.29))
        solver = (C.ADMMConfig(iterations=ITERS, backend=self.backend, formulation="stagewise")
                  if solver_name == "admm" else C.PDIPConfig(iterations=25))
        _, tr = self.loop.rollout(
            periods, plant, ctrl, cmd, self.gait.preset("trotting", **self.gait_kw),
            S.DisturbanceParams.zero((B,), **self.kw), C.MPCConfig(horizon=H), C.LoopConfig(),
            C.EstimatorConfig(mode="ls", residual="discrete"), solver,
            heightmap=hm if use_map else None,
            ground_fn=lambda xy: self.scenario.ground_z(terr, xy))
        x = self.np(tr.x)
        zg = self.np(self.scenario.ground_z(terr, tr.x[..., 3:5]))
        return x[..., 3], x[..., 5] - zg - 0.29, np.isfinite(x).all()


def figures(pk: Package, B: int, periods: int, solver: str) -> dict:
    riser, _ = scenarios(B)
    out = {}
    for arm, use_map in (("map", True), ("flat", False)):
        t0 = time.time()
        x, err, finite = pk.run(B, periods, use_map, solver)
        rms = np.sqrt((err[:, -TAIL:] ** 2).mean(-1))
        out[arm] = (x[:, -1], rms)
        print(f"[{pk.name}] {arm}: {periods} periods in {time.time() - t0:.1f} s, finite "
              f"{finite}; final x {np.array2string(x[:, -1], precision=4)}; rms over the "
              f"last {TAIL} {np.array2string(rms, precision=5)}", flush=True)
    (xm, rm), (xf, rf) = out["map"], out["flat"]
    sel = riser > 0
    for tag, pick in (("instance 0", lambda a: a[0]),
                      ("median over riser > 0", lambda a: float(np.median(a[sel])))):
        print(f"[{pk.name}] {tag}: x_map {pick(xm):.4f}, x_flat {pick(xf):.4f} (gates > 0.55); "
              f"rms_map {pick(rm):.5f} (< 0.012), rms_flat {pick(rf):.5f} (> 0.04), "
              f"rms_map / rms_flat {pick(rm / rf):.4f} (< 0.3)")
    flat_inst = riser == 0
    if flat_inst.any():
        print(f"[{pk.name}] riser-0 instances: largest |rms_map - rms_flat| "
              f"{np.abs(rm - rf)[flat_inst].max():.3g}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=["jax", "torch", "both"], default="both")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--periods", type=int, default=110)
    ap.add_argument("--solver", choices=["admm", "pdip"], default="admm")
    a = ap.parse_args()
    names = ["jax", "torch"] if a.package == "both" else [a.package]
    print(f"terrain experiment, B={a.batch}, {a.periods} periods, solver {a.solver}, on the CPU")
    for name in names:
        figures(Package(name), a.batch, a.periods, a.solver)
    return 0


if __name__ == "__main__":
    sys.exit(main())
