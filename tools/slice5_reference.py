"""The reference figures behind chip_smoke.py's slice-5 gates, on the CPU.

    python tools/slice5_reference.py experiment [--batch 8] [--periods 800] [--package jax|torch]
    python tools/slice5_reference.py lateral [--batch 8] [--periods 700] [--package jax|torch]
    python tools/slice5_reference.py sweep [--batch 832] [--periods 20] [--package jax|torch]
    python tools/slice5_reference.py tune [--batch 64] [--warm 10] [--package jax|torch]
    python tools/slice5_reference.py kkt [--batch 208] [--first 395] [--periods 420]

Each runs one scenario of chip_smoke.py's phases 11-13 at a small batch in
the JAX package (float32, XLA path) or in the port (float32, the CUDA
kernels' plain versions on the CPU), and prints the quantity its gate
reads:

- experiment: the paper's adaptive-vs-baseline run (the bench trot, gait
  phases (7 i) mod 208, F_x = -10 + 15 sin(2 pi 0.33 t) N, stagewise
  ADMM-30, h = 10; "ls"/discrete against "faithful"/reference never
  released): the vx-rms ratio over periods 500 on per instance, and
  instance 0's fitted frequency and amplitude;
- lateral: ls6/discrete against the frozen baseline under the lateral
  wrench (component 4: -0.6 + sin(2 pi 0.4 t)): the vy-rms ratio over
  periods 450 on;
- sweep: the condensed ADMM-30 with z weights 5 / 50 / 500 / 5000 over the
  batch's quarters (alpha 4e-5, f_max 120 per instance), bench.py's
  period (feet glide toward a Raibert touchdown): the KKT residuals of
  every period by quarter;
- tune: after `warm` untuned periods the z weight x10, alpha 4e-4 and
  f_max 60, stagewise ADMM-30: the largest f_z of the next periods.
- kkt: the condensed ADMMConfig(iterations=30) period (XLA path in JAX, the
  "xla" loop in the port) in both packages side by side from the same
  start, through the estimator's release at period 400 (B = 208 holds every
  gait phase of the trot once): the KKT residuals of each period from
  `first` to `periods` in both, and every period where the port misses the
  6e-3 / 1e-3 gates while JAX meets them.

JAX runs on the CPU (jax_platforms is set here); the port's tensors are
CPU tensors.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VX, H, ITERS = 0.3, 10, 30
EXP_FROM, LAT_FROM = 500, 450


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
            from quad_periodic_mpc_tpu.models import a1
            from quad_periodic_mpc_tpu.ops import gait, qp_admm
            from quad_periodic_mpc_tpu.ops.rotations import quat_to_rotmat
            from quad_periodic_mpc_tpu.sim import srb_sim

            self.xp, self.backend = jnp, "xla"
            self.arr = lambda a, dtype=np.float32: jnp.asarray(np.asarray(a, dtype))
            self.kw = dict(dtype=jnp.float32)
        else:
            import torch

            from quad_periodic_mpc_tpu_torch import config
            from quad_periodic_mpc_tpu_torch.control import loop, mpc
            from quad_periodic_mpc_tpu_torch.models import a1
            from quad_periodic_mpc_tpu_torch.ops import gait, qp_admm
            from quad_periodic_mpc_tpu_torch.ops.rotations import quat_to_rotmat
            from quad_periodic_mpc_tpu_torch.sim import srb_sim

            self.xp, self.backend = torch, "pallas"
            self.arr = lambda a, dtype=np.float32: torch.from_numpy(np.array(a, dtype))
            self.kw = dict(device="cpu")
        self.config, self.loop, self.mpc, self.a1 = config, loop, mpc, a1
        self.gait, self.qp_admm, self.sim, self.rotmat = gait, qp_admm, srb_sim, quat_to_rotmat

    def np(self, a) -> np.ndarray:
        return np.asarray(a) if self.name == "jax" else a.detach().cpu().numpy()

    def inputs(self, B: int, formulation: str = "stagewise", vx: float = VX):
        """The bench trot (bench.py make_inputs): (plant, ctrl, cmd, gait)."""
        S, M = self.sim, self.mpc
        plant = S.init_plant((B,), body_height=0.29, **self.kw)
        init_kw = {"dtype": self.kw["dtype"]} if self.name == "jax" else {}
        ctrl = M.init_state((B,), S.observe(plant), horizon=H, formulation=formulation, **init_kw)
        ctrl = ctrl._replace(iteration=self.arr((np.arange(B) * 7) % 208, np.int32),
                             x_vel_des=self.arr(np.full(B, vx)))
        full = lambda v: self.arr(np.full(B, v))
        cmd = M.Command(vx=full(vx), vy=full(0.0), yaw_rate=full(0.0), body_height=full(0.29))
        gait = self.gait.preset("trotting") if self.name == "jax" else self.gait.preset(
            "trotting", device="cpu")
        return plant, ctrl, cmd, gait

    def solver(self, formulation: str = "stagewise"):
        return self.config.ADMMConfig(iterations=ITERS, backend=self.backend,
                                      formulation=formulation)

    def rollout(self, B, periods, est_cfg, dist):
        plant, ctrl, cmd, gait = self.inputs(B)
        C = self.config
        return self.loop.rollout(periods, plant, ctrl, cmd, gait, dist, C.MPCConfig(horizon=H),
                                 C.LoopConfig(), est_cfg, self.solver())

    def period_fn(self, solver, est_cfg, tunable=None):
        """bench.py's period (chip_smoke.make_period): solve, hold the
        first-step forces, swing feet glide toward a half-stance Raibert
        touchdown.  Returns (ctrl, plant, forces, qp)."""
        C, S, M, G, xp = self.config, self.sim, self.mpc, self.gait, self.xp
        mpc_cfg, loop_cfg = C.MPCConfig(horizon=H), C.LoopConfig()
        dt_mpc = loop_cfg.dt * loop_cfg.iterations_between_mpc
        hips = self.arr(self.a1.A1.hip_locations())

        def period(ctrl, plant, cmd, gait, dist):
            obs = S.observe(plant)
            ctrl = M.setup_command(ctrl, cmd, loop_cfg)
            ctrl, forces, qp = M.mpc_step(ctrl, obs, cmd, gait, plant.t, mpc_cfg, loop_cfg,
                                          est_cfg, solver, tunable=tunable, return_qp=True)
            seg = G.segment_index(gait, ctrl.iteration, loop_cfg.iterations_between_mpc)
            stance = G.mpc_table(gait, seg, 1)[..., 0, :]
            stance = stance.astype(np.float32) if self.name == "jax" else stance.float()
            R = self.rotmat(obs.quat)
            hip_w = obs.p[..., None, :] + xp.einsum("...ij,...kj->...ki", R,
                                                    xp.broadcast_to(hips, obs.p_feet.shape))
            p_touch = hip_w + 0.5 * 10 * dt_mpc * obs.v[..., None, :]
            p_touch = xp.concatenate([p_touch[..., :2], 0.0 * p_touch[..., 2:]], -1) \
                if self.name == "jax" else xp.cat([p_touch[..., :2], 0.0 * p_touch[..., 2:]], -1)
            d = xp.clip(p_touch - plant.p_feet, -0.04, 0.04)
            p_feet = xp.where(stance[..., None] > 0.5, plant.p_feet, plant.p_feet + d)
            plant = S.step(plant, forces[..., 0, :, :], p_feet, stance, dist, mpc_cfg, dt_mpc)
            ctrl = ctrl._replace(iteration=ctrl.iteration + loop_cfg.iterations_between_mpc)
            return ctrl, plant, forces, qp

        if self.name == "jax":
            import jax

            return jax.jit(period)
        return period


def _quantiles(tag: str, ratio: np.ndarray) -> None:
    p5, p50, p95 = np.percentile(ratio, [5, 50, 95])
    print(f"{tag}: ratio per instance {np.array2string(ratio, precision=4)}; p5 {p5:.4f}, "
          f"p50 {p50:.4f}, p95 {p95:.4f}, instance 0 {ratio[0]:.4f}")


def experiment(pk: Package, B: int, periods: int) -> None:
    C = pk.config
    dist = pk.sim.DisturbanceParams.reference((B,), **pk.kw)
    rms, carries = {}, {}
    for arm, est in (("adaptive", C.EstimatorConfig(mode="ls", residual="discrete")),
                     ("baseline", C.EstimatorConfig(mode="faithful", residual="reference",
                                                    freeze_after=10 ** 9))):
        t0 = time.time()
        carries[arm], tr = pk.rollout(B, periods, est, dist)
        x = pk.np(tr.x)
        rms[arm] = np.sqrt(((x[:, EXP_FROM:, 9] - VX) ** 2).mean(-1))
        print(f"{arm}: {periods} periods in {time.time() - t0:.1f} s, vx rms "
              f"{np.array2string(rms[arm], precision=5)}, finite {np.isfinite(x).all()}")
    _quantiles("adaptive/baseline", rms["adaptive"] / rms["baseline"])
    est = carries["adaptive"].ctrl.est
    print(f"instance 0: f_hat {float(pk.np(est.est_freq)[0]):.5f} Hz, amp_hat "
          f"{float(pk.np(est.est_amp)[0]):.4f}")


def lateral(pk: Package, B: int, periods: int) -> None:
    C = pk.config
    z = np.zeros((B, 6), np.float32)
    static, amp, freq = z.copy(), z.copy(), np.full((B, 6), 0.33, np.float32)
    static[:, 4], amp[:, 4], freq[:, 4] = -0.6, 1.0, 0.4
    dist = pk.sim.WrenchDisturbance(pk.arr(static), pk.arr(amp), pk.arr(freq), pk.arr(z))
    rms = {}
    for arm, est in (("ls6", C.EstimatorConfig(mode="ls6", residual="discrete")),
                     ("baseline", C.EstimatorConfig(mode="faithful", residual="reference",
                                                    freeze_after=10 ** 9))):
        t0 = time.time()
        _, tr = pk.rollout(B, periods, est, dist)
        x = pk.np(tr.x)
        rms[arm] = np.sqrt((x[:, LAT_FROM:, 10] ** 2).mean(-1))
        print(f"{arm}: {periods} periods in {time.time() - t0:.1f} s, vy rms "
              f"{np.array2string(rms[arm], precision=5)}, finite {np.isfinite(x).all()}")
    _quantiles("ls6/baseline", rms["ls6"] / rms["baseline"])


def sweep(pk: Package, B: int, periods: int) -> None:
    C = pk.config
    q = B // 4
    base = C.TunableParams.from_config(C.MPCConfig(horizon=H), C.LoopConfig(),
                                       C.EstimatorConfig(), C.SwingConfig(), **(
                                           {} if pk.name == "jax" else {"device": "cpu"}))
    w = np.broadcast_to(pk.np(base.weights), (B, 12)).copy()
    w[:, 5] = np.repeat([5.0, 50.0, 500.0, 5000.0], q)
    tun = base._replace(weights=pk.arr(w), alpha=pk.arr(np.full(B, 4e-5)),
                        f_max=pk.arr(np.full(B, 120.0)))
    period = pk.period_fn(pk.solver("condensed"), C.EstimatorConfig(), tunable=tun)
    plant, ctrl, cmd, gait = pk.inputs(B, formulation="condensed")
    dist = pk.sim.DisturbanceParams.reference((B,), **pk.kw)
    worst = np.zeros(4)
    for p in range(periods):
        ctrl, plant, _, qp = period(ctrl, plant, cmd, gait, dist)
        res = pk.qp_admm.kkt_residuals(qp, ctrl.warm_x, ctrl.warm_z, ctrl.warm_y)
        primal = pk.np(res["primal"]).reshape(4, q).max(1)
        worst = np.maximum(worst, primal)
        print(f"period {p + 1}: primal max by quarter (z weight 5/50/500/5000) "
              f"{np.array2string(primal, precision=5)}, dual max {pk.np(res['dual']).max():.3g}")
    print(f"largest primal by quarter over periods 1-{periods}: "
          f"{np.array2string(worst, precision=5)}")


def tune(pk: Package, B: int, warm: int) -> None:
    C = pk.config
    mpc_cfg, loop_cfg, est = C.MPCConfig(horizon=H), C.LoopConfig(), C.EstimatorConfig()
    solver = pk.solver()
    untuned = pk.period_fn(solver, est)
    plant, ctrl, cmd, gait = pk.inputs(B)
    dist = pk.sim.DisturbanceParams.reference((B,), **pk.kw)
    for _ in range(warm):
        ctrl, plant, _, _ = untuned(ctrl, plant, cmd, gait, dist)
    base = C.TunableParams.from_config(mpc_cfg, loop_cfg, est, C.SwingConfig(), **(
        {} if pk.name == "jax" else {"device": "cpu"}))
    w = pk.np(base.weights).copy()
    w[5] *= 10.0
    tun = base._replace(weights=pk.arr(w), alpha=pk.arr(4e-4), f_max=pk.arr(60.0))
    tuned = pk.period_fn(solver, est, tunable=tun)
    for p in range(3):
        ctrl, plant, forces, _ = tuned(ctrl, plant, cmd, gait, dist)
        print(f"retuned period {p + 1} after {warm} warm: largest f_z "
              f"{pk.np(forces)[..., 2].max():.5f} N")


def kkt(B: int, first: int, periods: int) -> int:
    """Returns the number of periods where the port misses a gate that JAX
    meets."""
    pks = [Package("jax"), Package("torch")]
    for pk in pks:
        pk.backend = "xla"
    state = []
    for pk in pks:
        C = pk.config
        state.append([pk.period_fn(pk.solver("condensed"), C.EstimatorConfig()),
                      *pk.inputs(B, formulation="condensed"),
                      pk.sim.DisturbanceParams.reference((B,), **pk.kw)])
    faults = 0
    t0 = time.time()
    for p in range(1, periods + 1):
        res = []
        for pk, st in zip(pks, state):
            period, plant, ctrl, cmd, gait, dist = st
            ctrl, plant, forces, qp = period(ctrl, plant, cmd, gait, dist)
            st[1], st[2] = plant, ctrl
            if p >= first:
                r = pk.qp_admm.kkt_residuals(qp, ctrl.warm_x, ctrl.warm_z, ctrl.warm_y)
                res.append((pk.np(r["primal"]), pk.np(r["dual"]), pk.np(forces)))
        if p < first:
            continue
        (pj, dj, fj), (pt, dt, ft) = res
        miss = (pt.max() >= 6e-3 or dt.max() >= 1e-3) and (pj.max() < 6e-3 and dj.max() < 1e-3)
        faults += int(miss)
        print(f"period {p}: primal max JAX {pj.max():.4g} / port {pt.max():.4g} (over 6e-3: "
              f"{(pj >= 6e-3).sum()} / {(pt >= 6e-3).sum()} instances, JAX's at "
              f"{np.flatnonzero(pj >= 6e-3)[:6].tolist()}); dual max {dj.max():.3g} / "
              f"{dt.max():.3g}; max|dforces| {np.abs(fj - ft).max():.3g} N"
              f"{'  <- the port misses where JAX holds' if miss else ''}", flush=True)
    print(f"{periods} periods in {time.time() - t0:.0f} s; periods where the port misses a gate "
          f"that JAX meets: {faults}")
    return faults


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scenario", choices=["experiment", "lateral", "sweep", "tune", "kkt"])
    ap.add_argument("--package", choices=["jax", "torch"], default="jax")
    ap.add_argument("--batch", type=int)
    ap.add_argument("--periods", type=int)
    ap.add_argument("--warm", type=int, default=10)
    ap.add_argument("--first", type=int, default=395)
    a = ap.parse_args()
    defaults = {"experiment": (8, 800), "lateral": (8, 700), "sweep": (832, 20),
                "tune": (64, 3), "kkt": (208, 420)}[a.scenario]
    B, periods = a.batch or defaults[0], a.periods or defaults[1]
    if a.scenario == "kkt":
        print(f"kkt in both packages, B={B}, on the CPU")
        kkt(B, a.first, periods)
        return 0
    pk = Package(a.package)
    print(f"{a.scenario} in the {a.package} package, B={B}, on the CPU")
    if a.scenario == "experiment":
        experiment(pk, B, periods)
    elif a.scenario == "lateral":
        lateral(pk, B, periods)
    elif a.scenario == "sweep":
        sweep(pk, B, periods)
    else:
        tune(pk, B, a.warm)
    return 0


if __name__ == "__main__":
    sys.exit(main())
