"""Command-line interface: rollout / sweep / live / parity (counterpart of
``quad_periodic_mpc_tpu/cli.py``, the same flags, defaults and JSON keys).

  python -m quad_periodic_mpc_tpu_torch rollout --steps 200 --gait trotting
  python -m quad_periodic_mpc_tpu_torch sweep --mpc-steps 100
  python -m quad_periodic_mpc_tpu_torch parity --horizon 10
  python -m quad_periodic_mpc_tpu_torch live --tune-file /tmp/tune.json \\
      --telemetry-udp 127.0.0.1:9870      (dynamic_reconfigure analog)

Every subcommand takes ``--device`` (default ``cuda``), the port's
counterpart of ``JAX_PLATFORMS``.  ``--device cuda`` without a CUDA card
exits non-zero; nothing falls back to the CPU.  ``--backend pallas`` names
the hand-written CUDA kernels (their plain PyTorch versions with ``--device
cpu``).  The benchmark is not a subcommand.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"quad_periodic_mpc_tpu_torch: --device {name} asked for a CUDA card and "
            "none is available; pass --device cpu to run the plain PyTorch versions")
    return device


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def cmd_rollout(args) -> None:
    from quad_periodic_mpc_tpu_torch.config import (
        ADMMConfig, EstimatorConfig, LoopConfig, MPCConfig, PDIPConfig,
    )
    from quad_periodic_mpc_tpu_torch.control import loop as L
    from quad_periodic_mpc_tpu_torch.control import mpc as M
    from quad_periodic_mpc_tpu_torch.ops import gait as G
    from quad_periodic_mpc_tpu_torch.sim import srb_sim as S

    device = _device(args.device)
    dtype = torch.float64 if args.f64 else torch.float32
    mpc_cfg = MPCConfig(horizon=args.horizon)
    loop_cfg = LoopConfig()
    est_cfg = EstimatorConfig(
        mode=args.estimator, residual="discrete" if args.estimator == "ls" else "reference")
    solver = (
        PDIPConfig(iterations=25) if args.solver == "pdip"
        else ADMMConfig(iterations=args.solver_iters, backend=args.backend,
                        formulation=args.formulation)
    )
    s = lambda v: torch.tensor(v, dtype=dtype, device=device)

    plant = S.init_plant((), body_height=0.29, dtype=dtype, device=device)
    ctrl = M.init_state(
        (), S.observe(plant), dtype=dtype, horizon=args.horizon,
        formulation=getattr(solver, "formulation", "condensed"))
    cmd = M.Command(vx=s(args.vx), vy=s(0.0), yaw_rate=s(args.yaw_rate), body_height=s(0.29))
    gait = G.preset(args.gait, device=device)
    dist = (S.DisturbanceParams.reference((), dtype, device) if args.disturbance
            else S.DisturbanceParams.zero((), dtype, device))
    hm = ground_fn = terr = None
    if args.terrain_step > 0:
        from quad_periodic_mpc_tpu_torch.terrain import scenario as TS

        terr = TS.StairsTerrain.single_step(
            edge_x=args.terrain_edge, height=args.terrain_step, dtype=dtype, device=device)
        hm = TS.build_map(terr, size=96, resolution=0.03, dtype=dtype)
        ground_fn = lambda xy: TS.ground_z(terr, xy)
    # on a card the float32 stagewise period in the CUDA kernels (on flat
    # ground or over the terrain) replays from a CUDA graph; the condensed
    # and PDIP periods are not captured yet and run eagerly
    captured = (not args.f64 and args.solver == "admm"
                and args.formulation == "stagewise" and args.backend == "pallas")
    run = L.rollout_graphed if captured else L.rollout
    carry, tr = run(
        args.steps, plant, ctrl, cmd, gait, dist, mpc_cfg, loop_cfg, est_cfg, solver,
        heightmap=hm, ground_fn=ground_fn)
    x = _host(tr.x)
    vx = x[:, 9]
    out = {
        "steps": args.steps,
        "gait": args.gait,
        "final_pos": x[-1, 3:6].tolist(),
        "vx_mean": float(vx[args.steps // 3:].mean()),
        "vx_rms_err": float(np.sqrt(((vx[args.steps // 3:] - args.vx) ** 2).mean())),
        "height_final": float(x[-1, 5]),
        "est_freq": float(carry.ctrl.est.est_freq),
        "est_amp": float(carry.ctrl.est.est_amp),
    }
    if args.terrain_step > 0:
        zg = float(TS.ground_z(terr, torch.as_tensor(x[-1, 3:5], device=device)))
        out["terrain_step"] = args.terrain_step
        out["ground_final"] = zg
        out["height_above_terrain_final"] = float(x[-1, 5]) - zg
    if args.viz_svg:
        from quad_periodic_mpc_tpu_torch.utils import viz

        markers = viz.scene(
            p_body=x[-1, 3:6],
            p_feet=carry.plant.p_feet,
            contact_state=(carry.ctrl.swing_time_remaining <= 0).to(torch.float64),
            swing_pf=carry.ctrl.swing_pf,
            forces=carry.ctrl.fr_des,
            x_ref_positions=x[:, 3:6],
        )
        viz.render_svg(markers, args.viz_svg, view="xz")
        out["viz_svg"] = args.viz_svg
    print(json.dumps(out, indent=2))


def cmd_sweep(args) -> None:
    from quad_periodic_mpc_tpu_torch.config import ADMMConfig, EstimatorConfig
    from quad_periodic_mpc_tpu_torch.parallel import mesh as mesh_lib
    from quad_periodic_mpc_tpu_torch.parallel.sweep import SweepSpec, run_sweep

    device = _device(args.device)
    terrain = {}
    if args.terrain_risers:
        terrain = dict(
            terrain_risers=tuple(float(v) for v in args.terrain_risers.split(",")),
            terrain_edge_x=tuple(float(v) for v in args.terrain_edges.split(",")),
        )
    spec = SweepSpec(phase_offsets=args.phase_offsets, **terrain)
    # --shard: every CUDA card, as the JAX CLI's mesh takes every device
    mesh = (mesh_lib.make_mesh(devices=None if device.type == "cuda" else [device])
            if args.shard else None)
    est_cfg = EstimatorConfig(
        mode=args.estimator,
        residual="discrete" if args.estimator in ("ls", "ls6") else "reference",
        window=args.est_window, ls_release=args.est_window,
    )
    solver = ADMMConfig(
        iterations=args.solver_iters, formulation=args.formulation, backend=args.backend)
    res = run_sweep(spec, n_mpc_steps=args.mpc_steps, mesh=mesh, est_cfg=est_cfg,
                    solver=solver, device=device)
    vx_rms = _host(res.vx_rms)
    print(json.dumps({
        "instances": res.batch,
        "mean_vx_rms": float(res.mean_vx_rms),
        "best_instance": int(res.best_instance),
        "vx_rms_p50": float(np.percentile(vx_rms, 50)),
        "vx_rms_p95": float(np.percentile(vx_rms, 95)),
    }, indent=2))


def cmd_live(args) -> None:
    """Live-retunable chunked rollout with telemetry streaming.

    The dynamic_reconfigure + PlotJuggler operator surface
    (ros_dynamic_params.cfg via be2r_cmpc_unitree.cpp:733-739;
    config/plotjuggler/): the rollout runs in chunks of --chunk MPC
    periods; between chunks the tune file is polled, and changed
    TunableParams values are written into the tensors the rollout already
    holds (``.copy_()``), so the next chunk runs with them and no tensor
    moves.  Telemetry goes to stdout as JSON lines and optionally to
    PlotJuggler as JSON over UDP (--telemetry-udp host:port, "UDP Server"
    source).

    Retune example while it runs:
        echo '{"alpha": 2e-5, "swing_height": 0.12}' > /tmp/tune.json
    """
    from quad_periodic_mpc_tpu_torch.config import (
        ADMMConfig, EstimatorConfig, LoopConfig, MPCConfig, SwingConfig, TunableParams,
    )
    from quad_periodic_mpc_tpu_torch.control import loop as L
    from quad_periodic_mpc_tpu_torch.control import mpc as M
    from quad_periodic_mpc_tpu_torch.ops import gait as G
    from quad_periodic_mpc_tpu_torch.sim import srb_sim as S
    from quad_periodic_mpc_tpu_torch.utils import live_tune as LT

    device = _device(args.device)
    dtype = torch.float32
    mpc_cfg = MPCConfig(horizon=args.horizon)
    loop_cfg = LoopConfig()
    est_cfg = EstimatorConfig()
    solver = ADMMConfig(
        iterations=args.solver_iters, backend=args.backend, formulation=args.formulation)
    s = lambda v: torch.tensor(v, dtype=dtype, device=device)
    plant = S.init_plant((), body_height=0.29, dtype=dtype, device=device)
    ctrl = M.init_state(
        (), S.observe(plant), dtype=dtype, horizon=args.horizon,
        formulation=solver.formulation)
    cmd = M.Command(vx=s(args.vx), vy=s(0.0), yaw_rate=s(0.0), body_height=s(0.29))
    gait = G.preset(args.gait, device=device)
    dist = (S.DisturbanceParams.reference((), dtype, device) if args.disturbance
            else S.DisturbanceParams.zero((), dtype, device))
    tunable = TunableParams.from_config(
        mpc_cfg, loop_cfg, est_cfg, SwingConfig(), dtype=dtype, device=device)
    # the tuner's base keeps the defaults: fields absent from the file
    # return to them, whatever an earlier retune wrote into ``tunable``
    tuner = LT.FileTuner(args.tune_file, TunableParams(*(t.clone() for t in tunable)))
    udp = None
    if args.telemetry_udp:
        udp = LT.UdpTelemetry(*LT.parse_hostport(args.telemetry_udp))

    carry = L.RolloutCarry(plant, ctrl)
    tune_seq = 0
    done = 0
    try:
        while done < args.steps:
            new = tuner.poll()
            if new is not None:
                for held, value in zip(tunable, new):
                    held.copy_(value)
                tune_seq += 1
                if tuner.unknown_keys:
                    print(json.dumps({"warn": "unknown tune keys", "keys": tuner.unknown_keys}),
                          file=sys.stderr, flush=True)
            t0 = time.perf_counter()
            carry, tr = L.rollout(
                args.chunk, carry.plant, carry.ctrl, cmd, gait, dist, mpc_cfg, loop_cfg,
                est_cfg, solver, tunable=tunable)
            x = _host(tr.x)
            wall = time.perf_counter() - t0
            done += args.chunk
            sample = {
                "t_sim": float(carry.plant.t),
                "mpc_steps": done,
                "vx": float(x[-1, 9]),
                "vx_mean_chunk": float(x[:, 9].mean()),
                "height": float(x[-1, 5]),
                "roll": float(x[-1, 0]),
                "pitch": float(x[-1, 1]),
                "est_freq": float(carry.ctrl.est.est_freq),
                "est_amp": float(carry.ctrl.est.est_amp),
                "alpha": float(tunable.alpha),
                "swing_height": float(tunable.swing_height),
                "tune_seq": tune_seq,
                "chunk_wall_ms": round(wall * 1e3, 2),
            }
            print(json.dumps(sample), flush=True)
            if udp is not None:
                udp.send(sample)
    finally:
        if udp is not None:
            udp.close()


def parity_report(horizon: int, problems: int, admm_iters: int, device,
                  dtype=torch.float32) -> dict:
    """The parity subcommand's report: for seeds 0..problems-1, the
    fixture QP solved by PDIP-40 and by condensed ADMM, the largest force
    gap and the ADMM answer's KKT residuals."""
    from quad_periodic_mpc_tpu_torch.config import ADMMConfig, PDIPConfig
    from quad_periodic_mpc_tpu_torch.ops import qp_admm, qp_pdip
    from quad_periodic_mpc_tpu_torch.testing.fixtures import make_mpc_qp

    rows = []
    for seed in range(problems):
        qp, _, _ = make_mpc_qp(horizon=horizon, seed=seed, dtype=dtype, device=device)
        x_ref, _ = qp_pdip.solve(qp, PDIPConfig(iterations=40))
        x_admm, st = qp_admm.solve(qp, ADMMConfig(iterations=admm_iters))
        res = qp_admm.kkt_residuals(qp, x_admm, st.z, st.y)
        rows.append({
            "seed": seed,
            "admm_vs_pdip_max": float(torch.max(torch.abs(x_admm - x_ref))),
            "primal": float(res["primal"]),
            "dual": float(res["dual"]),
        })
    worst = max(r["admm_vs_pdip_max"] for r in rows)
    return {"horizon": horizon, "worst_force_diff_N": worst, "rows": rows}


def cmd_parity(args) -> None:
    """Cross-solver parity report on a standard problem set, in float32
    (the JAX CLI runs without 64-bit mode)."""
    device = _device(args.device)
    print(json.dumps(parity_report(args.horizon, args.problems, args.admm_iters, device),
                     indent=2))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="quad_periodic_mpc_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def device_flag(p):
        p.add_argument("--device", default="cuda",
                       help="torch device to run on (default cuda; cpu runs the "
                            "kernels' plain PyTorch versions)")

    r = sub.add_parser("rollout", help="closed-loop SRB rollout")
    r.add_argument("--steps", type=int, default=200)
    r.add_argument("--gait", default="trotting")
    r.add_argument("--vx", type=float, default=0.3)
    r.add_argument("--yaw-rate", type=float, default=0.0)
    r.add_argument("--horizon", type=int, default=10)
    r.add_argument("--disturbance", action="store_true")
    r.add_argument("--estimator", choices=["faithful", "ls"], default="ls")
    r.add_argument("--solver", choices=["admm", "pdip"], default="pdip")
    r.add_argument("--solver-iters", type=int, default=200)
    # the production setting is --solver admm --formulation stagewise
    # --backend pallas (ops/cuda/stagewise_kernel.py)
    r.add_argument("--formulation", choices=["condensed", "stagewise"],
                   default="condensed")
    r.add_argument("--backend", choices=["xla", "pallas"], default="xla",
                   help="ADMM iteration-loop backend (pallas = the CUDA kernel)")
    r.add_argument("--f64", action="store_true")
    r.add_argument("--terrain-step", type=float, default=0.0,
                   help="doorstep height (m); 0 disables the terrain tier")
    r.add_argument("--terrain-edge", type=float, default=0.35,
                   help="world x of the doorstep edge")
    r.add_argument("--viz-svg", default="",
                   help="write the final-state marker scene (RViz analog) to this SVG")
    device_flag(r)
    r.set_defaults(fn=cmd_rollout)

    s = sub.add_parser("sweep", help="gait x disturbance Monte-Carlo sweep")
    s.add_argument("--mpc-steps", type=int, default=100)
    s.add_argument("--phase-offsets", type=int, default=4)
    s.add_argument("--shard", action="store_true")
    s.add_argument("--terrain-risers", default="",
                   help="comma list of doorstep heights (m): the terrain axis")
    s.add_argument("--terrain-edges", default="0.30",
                   help="comma list of doorstep edge positions (m)")
    # estimator A/B axis (the paper's experiment arms): adaptive
    # ("ls"/"ls6"/"faithful") vs "static" (EMA residual only) vs "off"
    s.add_argument("--estimator", choices=["ls", "ls6", "faithful", "static", "off"],
                   default="ls")
    s.add_argument("--est-window", type=int, default=400,
                   help="estimator window / release sample count")
    s.add_argument("--solver-iters", type=int, default=100)
    s.add_argument("--formulation", choices=["condensed", "stagewise"],
                   default="condensed")
    s.add_argument("--backend", choices=["xla", "pallas"], default="xla")
    device_flag(s)
    s.set_defaults(fn=cmd_sweep)

    lv = sub.add_parser(
        "live",
        help="live-retunable rollout with telemetry streaming "
             "(dynamic_reconfigure + PlotJuggler analog)")
    lv.add_argument("--steps", type=int, default=400, help="total MPC periods to run")
    lv.add_argument("--chunk", type=int, default=10,
                    help="MPC periods per chunk (tune-poll granularity)")
    lv.add_argument("--gait", default="trotting")
    lv.add_argument("--vx", type=float, default=0.3)
    lv.add_argument("--horizon", type=int, default=10)
    lv.add_argument("--disturbance", action="store_true")
    lv.add_argument("--solver-iters", type=int, default=30)
    lv.add_argument("--formulation", choices=["condensed", "stagewise"],
                    default="stagewise")
    lv.add_argument("--backend", choices=["xla", "pallas"], default="pallas")
    lv.add_argument("--tune-file", default="/tmp/qpm_tune.json",
                    help="JSON file of TunableParams overrides, polled each chunk; "
                         "writing it is the reconfigure call")
    lv.add_argument("--telemetry-udp", default="",
                    help="host:port for PlotJuggler JSON-over-UDP streaming "
                         "(UDP Server source)")
    device_flag(lv)
    lv.set_defaults(fn=cmd_live)

    p = sub.add_parser("parity", help="cross-solver parity report")
    p.add_argument("--horizon", type=int, default=10)
    p.add_argument("--problems", type=int, default=5)
    p.add_argument("--admm-iters", type=int, default=200)
    device_flag(p)
    p.set_defaults(fn=cmd_parity)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
