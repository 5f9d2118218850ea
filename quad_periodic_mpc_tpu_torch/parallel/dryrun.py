"""Multi-device dry run (counterpart of ``__graft_entry__.dryrun_multichip``).

Runs the product split over an n-entry mesh, tier by tier, each against the
unsplit run on the mesh's first device (the oracle), with the reference's
specs, steps, solvers and tolerances.  The split's chunks roll out in
lockstep (``mesh.run_lockstep``), so they take the oracle's batch-global
decisions:

1. ``run_sweep``: gait x phase x disturbance frequency x terrain (16 n
   instances), 16 periods of condensed ADMM-30 at h = 10 with map-aware
   footholds and the ground clamp;
1b. the estimator-arm axis: "ls" / "static" / "off" sweeps under the
   reference disturbance, the arm with the least mean tracking error the
   same split and unsplit;
2. the h = 32 stagewise sweep through the fused-build kernel
   (``backend="pallas"``);
3. two MPC periods of the full torque stack (MPC + KinWBC/WBIC + joint
   torques on the articulated plant, 5 substeps).

``backend="pallas"`` runs tier 1's ADMM and tier 3's MPC, model evaluation,
WBC and plant in their kernels (on CPU tensors their plain versions).  An
argmin is held to the oracle's under the tie rule of
``sweep.argmin_agrees``.  Returns each tier's figures and per-instance
results (on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from quad_periodic_mpc_tpu_torch.config import ADMMConfig, EstimatorConfig, MPCConfig
from quad_periodic_mpc_tpu_torch.parallel import mesh as mesh_lib
from quad_periodic_mpc_tpu_torch.parallel import sweep as sweep_lib

TIERS = ("1", "1b", "2", "3")
ARMS = ("ls", "static", "off")
ATOL, RTOL = 5e-4, 1e-3          # split vs oracle, the reference's
FS_ATOL = 1e-4                   # tier 3's positions


def tier_specs(n: int) -> dict:
    """The sweep tiers' ``SweepSpec`` fields at an n-entry mesh."""
    return {
        "1": dict(gait_names=("trotting", "bounding"), phase_offsets=4 * n,
                  dist_freq=(0.33, 0.5), terrain_risers=(0.05,), terrain_edge_x=(0.30,)),
        "1b": dict(gait_names=("trotting",), phase_offsets=n, dist_freq=(0.33,)),
        "2": dict(gait_names=("trotting",), phase_offsets=2 * n, dist_freq=(0.33,)),
    }


def arm_estimator(arm: str) -> dict:
    """Tier 1b's ``EstimatorConfig`` fields for an arm: released inside the
    run (window 16) so that the arms differ."""
    return dict(mode=arm, residual="discrete" if arm == "ls" else "reference", window=16,
                ls_release=16, freeze_after=20)


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _sweep_pair(spec, n_steps, mesh, **kw):
    """(split, oracle) results of one sweep, checked against each other."""
    split = sweep_lib.run_sweep(spec, n_mpc_steps=n_steps, mesh=mesh, **kw)
    oracle = sweep_lib.run_sweep(spec, n_mpc_steps=n_steps, device=mesh.devices[0], **kw)
    _require(bool(torch.isfinite(split.vx_rms).all()), "non-finite sweep metric (split)")
    for f in ("vx_rms", "height_rms"):
        np.testing.assert_allclose(_np(getattr(split, f)), _np(getattr(oracle, f)),
                                   atol=ATOL, rtol=RTOL)
    return split, oracle


def _record(split, oracle) -> dict:
    return {
        "batch": split.batch, "mean": float(split.mean_vx_rms),
        "oracle_mean": float(oracle.mean_vx_rms), "best": int(split.best_instance),
        "oracle_best": int(oracle.best_instance),
        "max_gap": float((split.vx_rms - oracle.vx_rms).abs().max()),
        "vx_rms": split.vx_rms.cpu(), "oracle_vx_rms": oracle.vx_rms.cpu(),
        "height_rms": split.height_rms.cpu(), "oracle_height_rms": oracle.height_rms.cpu(),
    }


def tier1(n: int, mesh, backend: str) -> dict:
    spec = sweep_lib.SweepSpec(**tier_specs(n)["1"])
    split, oracle = _sweep_pair(spec, 16, mesh,
                                solver=ADMMConfig(iterations=30, backend=backend))
    _require(sweep_lib.argmin_agrees(oracle.vx_rms, oracle.best_instance,
                                     split.best_instance, ATOL, RTOL),
             f"best instance {int(split.best_instance)} != oracle "
             f"{int(oracle.best_instance)}")
    r = _record(split, oracle)
    print(f"tier 1 ok: {mesh.size} devices, sweep batch {r['batch']} (gait x phase x freq "
          f"x terrain), 16 MPC periods @ h=10, ADMM {backend}; mean vx_rms = "
          f"{r['mean']:.4f} (oracle {r['oracle_mean']:.4f}), best instance = {r['best']} "
          f"(oracle {r['oracle_best']}), per-instance max gap = {r['max_gap']:.2e}")
    return r


def tier1b(n: int, mesh, arms=ARMS) -> dict:
    spec = sweep_lib.SweepSpec(**tier_specs(n)["1b"])
    out = {}
    for arm in arms:
        split, oracle = _sweep_pair(spec, 48, mesh, solver=ADMMConfig(iterations=30),
                                    est_cfg=EstimatorConfig(**arm_estimator(arm)))
        out[arm] = _record(split, oracle)
    means = [out[a]["oracle_mean"] for a in arms]
    best_or = int(np.argmin(means))
    best_sh = int(np.argmin([out[a]["mean"] for a in arms]))
    _require(sweep_lib.argmin_agrees(means, best_or, best_sh, ATOL, RTOL),
             f"argmin arm {arms[best_sh]!r} != oracle {arms[best_or]!r}: {means}")
    print("tier 1b ok: estimator arms split == oracle; per-arm mean vx_rms: "
          + ", ".join(f"{a}={out[a]['mean']:.4f}" for a in arms)
          + f"; argmin arm = {arms[best_sh]!r} (oracle {arms[best_or]!r})")
    return {"arms": out, "argmin": arms[best_sh], "oracle_argmin": arms[best_or]}


def tier2(n: int, mesh) -> dict:
    spec = sweep_lib.SweepSpec(**tier_specs(n)["2"])
    solver = ADMMConfig(iterations=30, formulation="stagewise", backend="pallas")
    split, oracle = _sweep_pair(spec, 8, mesh, solver=solver, mpc_cfg=MPCConfig(horizon=32))
    r = _record(split, oracle)
    print(f"tier 2 ok: h=32 stagewise sweep batch {r['batch']} split, mean vx_rms = "
          f"{r['mean']:.4f} (oracle {r['oracle_mean']:.4f}), max gap = {r['max_gap']:.2e}")
    return r


def tier3(n: int, mesh, backend: str) -> dict:
    from quad_periodic_mpc_tpu_torch.control import full_stack as FS
    from quad_periodic_mpc_tpu_torch.control import mpc as M
    from quad_periodic_mpc_tpu_torch.models import floating_base as fb
    from quad_periodic_mpc_tpu_torch.ops import gait as G
    from quad_periodic_mpc_tpu_torch.sim import articulated_sim as art

    dtype, device, fsb = torch.float32, mesh.devices[0], 2 * n
    P = fb.A1ModelParams()
    m_tot = P.body_mass + 4 * (P.abad_mass + P.hip_mass + P.knee_mass + 3 * P.rotor_mass)
    fs_cfg = MPCConfig(horizon=10, mass=float(m_tot), inertia_body=(0.12, 0.45, 0.42))
    solver = ADMMConfig(iterations=30, backend=backend)
    kin = "pallas" if backend == "pallas" else "xla"
    mc = fb.build_a1_constants("float32", device)
    plant = art.init_on_ground((fsb,), penetration=3.8e-3, dtype=dtype, device=device)
    ctrl = M.init_state((fsb,), FS.observe_plant(plant, mc, kin_backend=kin)[0], dtype=dtype)
    f = lambda v: torch.full((fsb,), v, dtype=dtype, device=device)
    cmd = M.Command(vx=f(0.15), vy=f(0.0), yaw_rate=f(0.0),
                    body_height=plant.fb.pos[..., 2].clone())

    def go(plant, ctrl, cmd, gait):
        d = plant.fb.pos.device
        carry, _ = FS.rollout_articulated(
            2, plant, ctrl, cmd, gait, fb.build_a1_constants("float32", d), mpc_cfg=fs_cfg,
            solver=solver, use_wbc=True, substeps=5, wbc_backend=backend, kin_backend=kin)
        return carry.plant.fb.pos

    pos_o = go(plant, ctrl, cmd, G.preset("trotting", device=device))
    chunks = mesh_lib.shard_batch((plant, ctrl, cmd), mesh, fsb)
    gaits = mesh_lib.replicated(G.preset("trotting", device=device), mesh)
    pos_s = mesh_lib.gather(mesh_lib.run_lockstep(
        lambda c: go(*c[0], c[1]), list(zip(chunks, gaits)), mesh), device)
    _require(bool(torch.isfinite(pos_s).all()), "non-finite full stack (split)")
    np.testing.assert_allclose(_np(pos_s), _np(pos_o), atol=FS_ATOL, rtol=RTOL)
    r = {"batch": fsb, "zmean": float(pos_s[..., 2].mean()),
         "oracle_zmean": float(pos_o[..., 2].mean()),
         "max_gap": float((pos_s - pos_o).abs().max()),
         "pos": pos_s.cpu(), "oracle_pos": pos_o.cpu()}
    print(f"tier 3 ok: full stack (MPC+WBC+torques, {backend}) batch {fsb} split, 2 MPC "
          f"periods on the articulated plant; mean z = {r['zmean']:.4f}, max pos gap vs "
          f"oracle = {r['max_gap']:.2e}")
    return r


def dryrun_multichip(n_devices: int, devices=None, tiers=TIERS, arms=ARMS,
                     backend: str = "xla") -> dict:
    """Run ``tiers`` of the dry run on a mesh of the first n_devices of
    ``devices`` (default: the CUDA devices; the same device may repeat),
    each against its oracle.  Returns {tier: figures}."""
    mesh = mesh_lib.make_mesh(n_devices, devices)
    n = mesh.size
    out = {}
    for t in tiers:
        if t == "1":
            out[t] = tier1(n, mesh, backend)
        elif t == "1b":
            out[t] = tier1b(n, mesh, arms)
        elif t == "2":
            out[t] = tier2(n, mesh)
        elif t == "3":
            out[t] = tier3(n, mesh, backend)
        else:
            raise ValueError(f"unknown tier {t!r}; tiers are {TIERS}")
    print(f"dryrun_multichip ok: {n} devices, tiers {', '.join(tiers)} asserted")
    return out
