#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card, the CUDA
toolkit (nvcc) and PyTorch built for CUDA.  Imports nothing of JAX or of
the JAX package.  Phases, each of which fails the run (non-zero exit, no
result line) when it fails:

1. build every hand-written kernel from ``quad_periodic_mpc_tpu_torch/csrc``
   (one nvcc per source, all started together);
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at a ragged batch and a long horizon, with the
   tolerances stated below, and time both;
3. drive the main path: the walking trot of bench.py (vx = 0.3, gait
   phases spread over the batch, reference disturbance) at batch 2048,
   h = 10, ADMM-30 in the fused stagewise kernel, as MPC periods of
   setup_command -> mpc_step -> swing-foot glide -> srb_sim.step, then
   through control/loop.rollout; the launch counts must show one kernel
   launch per MPC period, every force must be finite, and the KKT audit
   of one return_qp step must meet primal 6e-3 / dual 1e-3.

The last lines are the card's name and power limit (nvidia-smi), one JSON
object per kernel with its times and bound, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
BATCH, HORIZON, ADMM_ITERS, VX = 2048, 10, 30, 0.3
WARM_PERIODS, TIMED_PERIODS, ROLLOUT_PERIODS = 3, 10, 3
# kernel vs plain version: (B, h); the first is the main path's shape
KERNEL_CASES = ((BATCH, HORIZON), (1000, HORIZON), (256, 48))
# U and z are forces (~100 N): FMA contraction and summation order differ
# between the kernel and the plain version's batched products, amplified
# through 30 ADMM sweeps (this is the gate the JAX kernel is held to
# against its XLA path).  y is rho-scaled (rho = 3e-4).
TOL = {"U": 2e-3, "z": 2e-3, "y": 1e-5}
KKT_PRIMAL, KKT_DUAL = 6e-3, 1e-3
# H100 SXM: HBM3 rate and float32 (non-tensor-core) peak, NVIDIA data sheet
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# work counts for the bound (operations counted from the kernel's loops)
# ---------------------------------------------------------------------------

def solve_flops(B: int, h: int, iters: int, ns_it: int, ns_warm: int,
                rescued: int) -> int:
    """Floating-point operations of one fused solve (multiply and add each
    count one), from the loops of csrc/stagewise_srb.cu.  ``rescued`` is
    the number of (instance, stage) warm inverses that failed the gate and
    restarted cold in this run's data (the plain version counts them)."""
    mm12 = 144 * 23                    # one 12x12x12 product
    ns_round = 2 * mm12 + 144
    norm = 3 * 144
    assemble = 54 + 4 * 110 + 12 + 31
    riccati_stage = 3588 + 3456 + 2184 + 3588 + 325 + 2366 + 2366 + 3887 + 676
    warm_inverse = 3 * mm12 + 2 * norm + 3 * 144 + 2 + (ns_warm - 1) * ns_round
    cold_inverse = norm + ns_it * ns_round
    admm_stage = 956 + 1731
    per_instance = (
        assemble + h * riccati_stage + cold_inverse + (h - 1) * warm_inverse
        + h * iters * admm_stage)
    return B * per_instance + rescued * (cold_inverse + 144)


def solve_bytes(B: int, h: int) -> int:
    """Each input read once, each output written once (float32)."""
    per_instance = (9 + 12 + 1 + 6 + 13) + h * (13 + 20 + 20 + 12 + 20 + 20)
    shared = 13 + 144 + 15
    outputs = h * (12 + 20 + 20)
    return 4 * (B * (per_instance + outputs) + shared)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def build_kernels():
    from quad_periodic_mpc_tpu_torch.ops.cuda import build

    sources = sorted(p.name for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        paths = list(pool.map(build.build, sources))
    for src in sources:
        build.load(src)
        for line in build.BUILD_LOGS.get(src, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")
    print(f"[build] {len(paths)} kernel source(s) in "
          f"{time.perf_counter() - t0:.1f} s")


def kernel_inputs(B: int, h: int, seed: int, device):
    """Well-posed fused-solve inputs from numpy (the recipe of the JAX
    package's test_fused_srb_build_matches_xla_build), via the port's own
    problem build."""
    import numpy as np
    import torch

    from quad_periodic_mpc_tpu_torch.config import ADMMConfig, MPCConfig
    from quad_periodic_mpc_tpu_torch.ops import gait, problem
    from quad_periodic_mpc_tpu_torch.ops.rotations import quat_to_rotmat, rpy_to_quat

    rng = np.random.default_rng(seed)
    cfg = MPCConfig(horizon=h)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    hips = np.array([[0.18, -0.13, -0.27], [0.18, 0.13, -0.27],
                     [-0.18, -0.13, -0.27], [-0.18, 0.13, -0.27]])
    quat = rpy_to_quat(t(rng.uniform(-0.15, 0.15, (B, 3))))
    obs = problem.RobotObs(
        p=t(np.tile([0.0, 0.0, 0.27], (B, 1))),
        v=t(rng.uniform(-0.3, 0.3, (B, 3))), quat=quat,
        omega=t(rng.uniform(-0.2, 0.2, (B, 3))),
        r_feet=t(hips + rng.uniform(-0.03, 0.03, (B, 4, 3))))
    xref = np.zeros((B, h, 13), np.float32)
    xref[..., 5] = 0.27
    g = gait.preset("trotting", device=device)
    seg = torch.as_tensor(rng.integers(0, 16, B), dtype=torch.int32, device=device)
    table = gait.mpc_table(g, seg, h)
    f_est, x_drag = t(rng.uniform(-3, 3, (B, 6))), t(rng.uniform(-0.5, 0.5, B))
    sw, x0 = problem.build_stagewise(obs, t(xref), table, cfg, f_est=f_est,
                                     x_drag=x_drag)
    rho = ADMMConfig().rho
    R_eff = torch.diag(sw.R) + rho * torch.kron(
        torch.eye(4, device=device), sw.F.T @ sw.F)
    z = lambda r: torch.zeros(B, h, r, device=device)
    args = [quat_to_rotmat(quat), obs.r_feet, x_drag, f_est, x0, sw.x_ref,
            sw.Q, R_eff, sw.F, sw.l, sw.u, z(12), z(20), z(20)]
    return [a.contiguous() for a in args], rho


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_kernels(device, card: str) -> dict:
    import torch

    from quad_periodic_mpc_tpu_torch.ops import qp_stagewise
    from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel as SK

    record = None
    for i, (B, h) in enumerate(KERNEL_CASES):
        args, rho = kernel_inputs(B, h, seed=100 + i, device=device)
        kw = dict(iters=ADMM_ITERS, rho=rho, ns_it=qp_stagewise.ns_combine_iters(h))
        got = SK.fused_stagewise_solve_srb(*args, **kw)
        torch.cuda.synchronize()
        stats = {}
        want = SK.fused_stagewise_solve_srb_reference(*args, **kw, stats=stats)
        errs = {n: float((g - w).abs().max()) for n, g, w in zip("Uzy", got, want)}
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        print(f"[kernel] stagewise_srb B={B} h={h}: max|dU|={errs['U']:.3g} "
              f"(tol {TOL['U']}), max|dz|={errs['z']:.3g} (tol {TOL['z']}), "
              f"max|dy|={errs['y']:.3g} (tol {TOL['y']}), rescued stages "
              f"{stats['rescued']}")
        check(finite, f"kernel output not finite at B={B} h={h}")
        for n in "Uzy":
            check(errs[n] <= TOL[n], f"kernel disagrees with plain version: "
                  f"max|d{n}|={errs[n]} > {TOL[n]} at B={B} h={h}")
        if (B, h) == (BATCH, HORIZON):
            ms = time_ms(lambda: SK.fused_stagewise_solve_srb(*args, **kw), 20)
            plain_ms = time_ms(
                lambda: SK.fused_stagewise_solve_srb_reference(*args, **kw), 2)
            flops = solve_flops(B, h, ADMM_ITERS, kw["ns_it"],
                                SK.ns_warm_rounds(kw["ns_it"]), stats["rescued"])
            nbytes = solve_bytes(B, h)
            t_ops = 1e3 * flops / FP32_FLOPS_PER_S
            t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
            record = {
                "name": "fused_stagewise_solve_srb", "route": "cuda",
                "source": "quad_periodic_mpc_tpu_torch/csrc/stagewise_srb.cu",
                "replaces": "quad_periodic_mpc_tpu/ops/pallas/stagewise_kernel.py:753",
                "launches": 0, "max_abs_err": max(errs.values()),
                "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": None,
            }
            print(f"[kernel] B={B} h={h}: kernel {ms:.3f} ms, plain version "
                  f"{plain_ms:.1f} ms, bound {record['bound_ms']:.4f} ms "
                  f"({flops:.3e} flop, {nbytes} B) on {card}")
    return record


def trot_inputs(device):
    """The bench's walking trot (bench.py make_inputs) on the port."""
    import torch

    from quad_periodic_mpc_tpu_torch.control import mpc as M
    from quad_periodic_mpc_tpu_torch.ops import gait as G
    from quad_periodic_mpc_tpu_torch.sim import srb_sim as S

    f32 = dict(dtype=torch.float32, device=device)
    plant = S.init_plant((BATCH,), body_height=0.29, device=device)
    obs = S.observe(plant)
    ctrl = M.init_state((BATCH,), obs, horizon=HORIZON, formulation="stagewise")
    ctrl = ctrl._replace(
        iteration=(torch.arange(BATCH, dtype=torch.int32, device=device) * 7) % 208,
        x_vel_des=torch.full((BATCH,), VX, **f32))
    cmd = M.Command(vx=torch.full((BATCH,), VX, **f32),
                    vy=torch.zeros(BATCH, **f32), yaw_rate=torch.zeros(BATCH, **f32),
                    body_height=torch.full((BATCH,), 0.29, **f32))
    gait = G.preset("trotting", device=device)
    dist = S.DisturbanceParams.reference((BATCH,), device=device)
    return ctrl, plant, cmd, gait, dist


def profile_periods(step, ctrl, plant, n: int = 3) -> None:
    """Where a main-path period's time goes: device time by kernel name
    over n periods (torch.profiler), and the device's busy share of the
    wall time.  Runs after the counted window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            ctrl, plant = step(ctrl, plant)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device-side events only: a CPU op's row repeats its kernels' time
    rows = [(e.self_device_time_total / 1e3 / n, e.count // n, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(r[0] for r in rows)
    if not rows:
        print("[profile] the profiler recorded no device time: not measured")
        return
    print(f"[profile] per period: device busy {busy:.2f} ms of {wall_ms / n:.2f} ms "
          f"wall ({100 * busy * n / wall_ms:.1f}% busy), "
          f"{sum(r[1] for r in rows)} kernel launches")
    for ms, count, key in sorted(rows, reverse=True)[:8]:
        print(f"[profile]   {ms:8.3f} ms  x{count:<4d} {key[:90]}")


def main_path(device, card: str) -> int:
    import torch

    from quad_periodic_mpc_tpu_torch.config import (
        ADMMConfig, EstimatorConfig, LoopConfig, MPCConfig)
    from quad_periodic_mpc_tpu_torch.control import loop as L
    from quad_periodic_mpc_tpu_torch.control import mpc as M
    from quad_periodic_mpc_tpu_torch.models.a1 import A1
    from quad_periodic_mpc_tpu_torch.ops import gait as G
    from quad_periodic_mpc_tpu_torch.ops import qp_stagewise
    from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel as SK
    from quad_periodic_mpc_tpu_torch.ops.rotations import quat_to_rotmat
    from quad_periodic_mpc_tpu_torch.sim import srb_sim as S

    mpc_cfg, loop_cfg, est_cfg = MPCConfig(horizon=HORIZON), LoopConfig(), EstimatorConfig()
    solver = ADMMConfig(iterations=ADMM_ITERS, backend="pallas", formulation="stagewise")
    dt_mpc = loop_cfg.dt * loop_cfg.iterations_between_mpc
    hips = torch.as_tensor(A1.hip_locations(), dtype=torch.float32, device=device)
    t_stance = 10 * dt_mpc

    def period(ctrl, plant, cmd, gait, dist, return_qp=False):
        """bench.py's step: solve, hold the first-step forces over the
        period, swing feet glide toward a half-stance Raibert touchdown."""
        obs = S.observe(plant)
        ctrl = M.setup_command(ctrl, cmd, loop_cfg)
        out = M.mpc_step(ctrl, obs, cmd, gait, plant.t, mpc_cfg, loop_cfg,
                         est_cfg, solver, return_qp=return_qp)
        ctrl, forces = out[0], out[1]
        seg = G.segment_index(gait, ctrl.iteration, loop_cfg.iterations_between_mpc)
        stance = G.mpc_table(gait, seg, 1)[..., 0, :].float()
        R = quat_to_rotmat(obs.quat)
        hip_w = obs.p[..., None, :] + torch.einsum(
            "...ij,...kj->...ki", R, hips.expand(obs.p_feet.shape))
        p_touch = hip_w + 0.5 * t_stance * obs.v[..., None, :]
        p_touch = torch.cat([p_touch[..., :2], torch.zeros_like(p_touch[..., 2:])], -1)
        d = torch.clamp(p_touch - plant.p_feet, -0.04, 0.04)
        p_feet = torch.where(stance[..., None] > 0.5, plant.p_feet, plant.p_feet + d)
        plant = S.step(plant, forces[..., 0, :, :], p_feet, stance, dist,
                       mpc_cfg, dt_mpc)
        ctrl = ctrl._replace(iteration=ctrl.iteration + loop_cfg.iterations_between_mpc)
        return ctrl, plant, forces, (out[2] if return_qp else None)

    ctrl, plant, cmd, gait, dist = trot_inputs(device)
    for _ in range(WARM_PERIODS):
        ctrl, plant, forces, _ = period(ctrl, plant, cmd, gait, dist)
    torch.cuda.synchronize()

    SK.LAUNCHES = 0
    times = []
    all_finite = True
    for _ in range(TIMED_PERIODS):
        t0 = time.perf_counter()
        ctrl, plant, forces, _ = period(ctrl, plant, cmd, gait, dist)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        all_finite &= bool(torch.isfinite(forces).all())
    launches = SK.LAUNCHES
    print(f"[main path] bench trot B={BATCH} h={HORIZON} ADMM-{ADMM_ITERS}: "
          f"{TIMED_PERIODS} periods, median {statistics.median(times):.2f} ms/period "
          f"(min {min(times):.2f}, max {max(times):.2f}), kernel launches {launches} "
          f"on {card}")
    check(launches == TIMED_PERIODS,
          f"expected {TIMED_PERIODS} kernel launches, counted {launches}")
    check(all_finite, "non-finite forces on the main path")
    check(bool(torch.isfinite(plant.x).all()), "non-finite plant state")

    profile_periods(lambda c, p: period(c, p, cmd, gait, dist)[:2], ctrl, plant)

    # KKT audit of the production warm solve against the independent build
    ctrl, plant, forces, qp = period(ctrl, plant, cmd, gait, dist, return_qp=True)
    res = qp_stagewise.kkt_residuals(
        qp, forces.reshape(BATCH, HORIZON, 12),
        ctrl.warm_z.reshape(BATCH, HORIZON, 20), ctrl.warm_y.reshape(BATCH, HORIZON, 20))
    primal, dual = float(res["primal"].max()), float(res["dual"].max())
    print(f"[main path] KKT audit: primal max {primal:.3g} (gate {KKT_PRIMAL}), "
          f"dual max {dual:.3g} (gate {KKT_DUAL})")
    check(primal < KKT_PRIMAL and dual < KKT_DUAL, "KKT gate failed")

    # the product entry point: loop.rollout (13 control ticks per period)
    ctrl, plant, cmd, gait, dist = trot_inputs(device)
    torch.cuda.synchronize()
    SK.LAUNCHES = 0
    t0 = time.perf_counter()
    carry, trace = L.rollout(ROLLOUT_PERIODS, plant, ctrl, cmd, gait, dist,
                             mpc_cfg, loop_cfg, est_cfg, solver)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / ROLLOUT_PERIODS
    rollout_launches = SK.LAUNCHES
    print(f"[main path] loop.rollout B={BATCH}: {ROLLOUT_PERIODS} periods, "
          f"{ms:.1f} ms/period (13 control ticks each), kernel launches "
          f"{rollout_launches} on {card}")
    check(rollout_launches == ROLLOUT_PERIODS,
          f"expected {ROLLOUT_PERIODS} rollout launches, counted {rollout_launches}")
    check(bool(torch.isfinite(trace.forces).all())
          and bool(torch.isfinite(carry.plant.x).all()), "non-finite rollout")
    height = float(carry.plant.x[:, 5].mean())
    check(0.2 < height < 0.4, f"rollout body height {height} left [0.2, 0.4]")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    if not (REPO / "quad_periodic_mpc_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: quad_periodic_mpc_tpu_torch/ not found next to "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import quad_periodic_mpc_tpu_torch  # noqa: F401  (sets the f32 policy)

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    try:
        build_kernels()
        record = compare_kernels(device, card)
        record["launches"] = main_path(device, card)
        if "jax" in sys.modules or "quad_periodic_mpc_tpu" in sys.modules:
            raise SmokeFailure("JAX or the JAX package was imported")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
