"""The reference figures behind chip_smoke.py's phase-16 gates, on the CPU.

    python tools/slice7_reference.py [--package jax|torch|both] [--n-devices 8]
        [--tier2-backend pallas|xla]

Runs the unsplit oracle of each tier of the multi-device dry run
(``__graft_entry__.dryrun_multichip``; the port's ``parallel/dryrun.py``)
at the tier sizes of an n-device mesh, in float32, and prints:

- tier 1 (16 n instances, condensed ADMM-30 "xla", h = 10, terrain, 16
  periods): the mean vx_rms, the best instance, the two smallest vx_rms
  values and their indices (the tie rule's inputs);
- tier 1b (n instances, 48 periods): each estimator arm's mean vx_rms and
  the argmin arm;
- tier 2 (2 n instances, h = 32 stagewise ADMM-30 through the fused-build
  kernel, 8 periods): the mean vx_rms (--tier2-backend xla takes JAX's XLA
  path instead of its interpret-mode kernel);
- tier 3 (2 n instances, the full stack, 2 periods, 5 substeps): the mean
  final body height;
- the small sweep of the port's CPU tests (2 gaits x 2 phases x 2
  frequencies x 1 terrain pair, h = 5, 8 periods, condensed ADMM-30) in
  float64 and float32: vx_rms per instance and the best instance.

Nothing here splits a batch: an oracle is one device's program, so no
8-device interpret program runs in-process.  JAX runs on the CPU, the
dry-run figures with 64-bit mode off (as the reference's own record) and
the float64 small-sweep figures with it on.  ~3 min for JAX at n = 8.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from quad_periodic_mpc_tpu_torch.parallel.dryrun import (  # noqa: E402
    ARMS, arm_estimator, tier_specs,
)

SMALL = dict(gait_names=("trotting", "bounding"), phase_offsets=2, dist_freq=(0.33, 0.5),
             terrain_risers=(0.05,), terrain_edge_x=(0.30,))


class Package:
    """The dry run's oracle calls in one package, numpy at the edges."""

    def __init__(self, name: str):
        self.name = name
        if name == "jax":
            import jax

            jax.config.update("jax_platforms", "cpu")
            from quad_periodic_mpc_tpu import config
            from quad_periodic_mpc_tpu.parallel import sweep

            self.kw = {}
        else:
            import torch

            torch.set_num_threads(os.cpu_count() or 1)
            from quad_periodic_mpc_tpu_torch import config
            from quad_periodic_mpc_tpu_torch.parallel import sweep

            self.kw = {"device": "cpu"}
        self.config, self.sweep = config, sweep

    def dtype(self, bits: int):
        if self.name == "jax":
            import jax.numpy as jnp

            return jnp.float64 if bits == 64 else jnp.float32
        import torch

        return torch.float64 if bits == 64 else torch.float32

    def run_sweep(self, spec: dict, steps: int, bits: int = 32, **kw):
        c = self.config
        kw.setdefault("solver", c.ADMMConfig(iterations=30))
        res = self.sweep.run_sweep(self.sweep.SweepSpec(**spec), n_mpc_steps=steps,
                                   dtype=self.dtype(bits), **kw, **self.kw)
        return (np.asarray(res.vx_rms, np.float64), int(res.best_instance),
                np.asarray(res.height_rms, np.float64))

    def tier3_pos(self, n: int) -> np.ndarray:
        """Tier 3's unsplit final body positions, (2 n, 3)."""
        if self.name == "torch":
            import torch

            from quad_periodic_mpc_tpu_torch.parallel import dryrun

            mesh = [torch.device("cpu")]
            return dryrun.tier3(n, dryrun.mesh_lib.make_mesh(devices=mesh * n), "xla")[
                "oracle_pos"].numpy()
        import jax
        import jax.numpy as jnp

        from quad_periodic_mpc_tpu.control import full_stack as FS
        from quad_periodic_mpc_tpu.control import mpc as M
        from quad_periodic_mpc_tpu.models import floating_base as fb
        from quad_periodic_mpc_tpu.ops import gait as G
        from quad_periodic_mpc_tpu.sim import articulated_sim as art

        c, dtype, fsb = self.config, jnp.float32, 2 * n
        MC = fb.build_a1_constants("float32")
        P = fb.A1ModelParams()
        m_tot = P.body_mass + 4 * (P.abad_mass + P.hip_mass + P.knee_mass + 3 * P.rotor_mass)
        fs_cfg = c.MPCConfig(horizon=10, mass=float(m_tot), inertia_body=(0.12, 0.45, 0.42))
        plant = art.init_on_ground((fsb,), penetration=3.8e-3, dtype=dtype)
        obs0, _, _ = FS.observe_plant(plant, MC)
        ctrl = M.init_state((fsb,), obs0, dtype=dtype)
        cmd = M.Command(vx=jnp.full((fsb,), 0.15, dtype), vy=jnp.zeros((fsb,), dtype),
                        yaw_rate=jnp.zeros((fsb,), dtype), body_height=plant.fb.pos[..., 2])

        def go(plant, ctrl, cmd):
            carry, _ = FS.rollout_articulated(
                2, plant, ctrl, cmd, G.preset("trotting"), MC, mpc_cfg=fs_cfg,
                solver=c.ADMMConfig(iterations=30), use_wbc=True, substeps=5)
            return carry.plant.fb.pos

        return np.asarray(jax.jit(go)(plant, ctrl, cmd))


def dryrun_figures(p: Package, n: int, tier2_backend: str) -> None:
    c, specs = p.config, tier_specs(n)
    t0 = time.perf_counter()
    vx, best, _ = p.run_sweep(specs["1"], 16)
    order = np.argsort(vx, kind="stable")[:2]
    print(f"[{p.name}] tier 1 (B={vx.size}): mean vx_rms {vx.mean():.8f}, best instance "
          f"{best}, smallest {vx[order[0]]:.8f} at {order[0]}, next {vx[order[1]]:.8f} at "
          f"{order[1]} (gap {vx[order[1]] - vx[order[0]]:.3g})  [{time.perf_counter() - t0:.0f} s]")
    means = {}
    for arm in ARMS:
        e = c.EstimatorConfig(**arm_estimator(arm))
        means[arm] = float(p.run_sweep(specs["1b"], 48, est_cfg=e)[0].mean())
    print(f"[{p.name}] tier 1b (B={n}): " + ", ".join(f"{a} {v:.8f}" for a, v in means.items())
          + f"; argmin arm {min(means, key=means.get)!r}  [{time.perf_counter() - t0:.0f} s]")
    solver32 = c.ADMMConfig(iterations=30, formulation="stagewise", backend=tier2_backend)
    vx32, _, _ = p.run_sweep(specs["2"], 8, solver=solver32, mpc_cfg=c.MPCConfig(horizon=32))
    print(f"[{p.name}] tier 2 (B={vx32.size}, {tier2_backend}): mean vx_rms {vx32.mean():.8f}"
          f"  [{time.perf_counter() - t0:.0f} s]")
    print(f"[{p.name}] tier 3 (B={2 * n}): mean final z {p.tier3_pos(n)[..., 2].mean():.8f}"
          f"  [{time.perf_counter() - t0:.0f} s]")


def small_sweep_figures(p: Package) -> None:
    c = p.config
    if p.name == "jax":
        import jax

        jax.config.update("jax_enable_x64", True)
    for bits in (64, 32):
        vx, best, _ = p.run_sweep(SMALL, 8, bits=bits, mpc_cfg=c.MPCConfig(horizon=5))
        print(f"[{p.name}] small sweep float{bits}: vx_rms "
              + " ".join(f"{v:.9f}" for v in vx) + f"; best instance {best}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "torch", "both"), default="jax")
    ap.add_argument("--n-devices", type=int, default=8)
    ap.add_argument("--tier2-backend", choices=("pallas", "xla"), default="pallas")
    args = ap.parse_args()
    for name in (("jax", "torch") if args.package == "both" else (args.package,)):
        p = Package(name)
        dryrun_figures(p, args.n_devices, args.tier2_backend)
        small_sweep_figures(p)


if __name__ == "__main__":
    main()
