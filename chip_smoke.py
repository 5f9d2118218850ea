#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card, the CUDA
toolkit (nvcc) and PyTorch built for CUDA.  Imports nothing of JAX or of
the JAX package.  Phases, each of which fails the run (non-zero exit, no
result line) when it fails:

1. build every hand-written kernel from ``quad_periodic_mpc_tpu_torch/csrc``
   (one nvcc per source, all started together), printing ptxas' registers
   and spills;
2. the kernel table (kernel_table, one row a hand-written kernel: PERF.md
   section 6's rows 1-13): each kernel run on testing/kernel_cases' seeded
   inputs at the shapes its driven paths launch it at (KC.PATH_CASES), held
   to its plain PyTorch version there by its KC comparison (the card tests
   hold it on these cases and more), and timed (device ms a launch from the
   profiler, which must see the kernel's symbol; ms a call between CUDA
   events) beside its plain version at the first shape and its bound: the
   fused-build stagewise solve at every (B, h, ADMM iterations) of the
   paths that launch it; the torque tick's model evaluation, WBC and plant
   substeps at B = 256 (the full stack's batch) and 1 (the single robot),
   the contact kinematics at 256; the caller-built solve at the predictive
   path's shape, the streamed one at h = 128, the dump at 2048; the KF at
   2048 and 1, beside the "xla" backend's dense chain; the ADMM at B = 2048,
   h = 10 in float32 and with bf16 storage; the SRB plant step
   (srb_sim.step's kernel) at B = 32,768 (the trot cell's) and 2048 with
   the x-force and the six-component disturbance; the swing update at
   32,768, 2048 and 1; the foothold update at 32,768 (the terrain cell's),
   2048 (the terrain experiment's) and 1 (a shape only).  The SRB plant's
   launches are read on each srb-loop path run in this process (exactly one
   a period on the main path's timed periods; on the graphs path the eager
   warm-ups, as it counts no capture or replay), none of which may be 0;
   the foothold update's on phase 14's map arm and config 4's sweep, none
   of which may be 0, and on the main path, which must be 0;
3. drive the slice-1 main path: the walking trot of bench.py (vx = 0.3,
   gait phases spread over the batch, reference disturbance) at batch
   2048, h = 10, ADMM-30 in the fused stagewise kernel, as MPC periods of
   setup_command -> mpc_step -> swing-foot glide -> srb_sim.step, then
   through control/loop.rollout; the launch counts must show one kernel
   launch per MPC period, every force must be finite, and the KKT audit
   of one return_qp step must meet primal 6e-3 / dual 1e-3;
4. drive the slice-2 path, the composed 500 Hz torque tick
   (control/full_stack.rollout_articulated: MPC + WBC + joint torques on
   the articulated plant) with every kernel on, at bench.py's full-stack
   batch 256: 45 MPC periods of a trot at vx = 0.15 from the ground
   stance, the first 3 warm, the next 10 timed; every period must launch
   model evaluation, WBC and substeps 13 times and the stagewise solve
   once, the start-up observation the contact kinematics once, every
   state must stay finite, and the robot must walk (the gates of the
   reference's test_full_stack_trot_walks);
5. time the single robot (B = 1): the composed tick and the controller
   tick alone, over two-period chains (bench.py's b=1 lines);
6. (the caller-built stagewise kernels: timed in phase 2, held to their
   plain versions by the card tests);
7. drive the slice-3 paths through mpc_step and srb_sim.step, the same
   bench trot: (a) the predictive disturbance horizon at B = 2048, h = 10,
   ADMM-30, run past the estimator's release (400 samples) so that the
   per-step c varies, one fused_stagewise_solve launch per period and none
   of the fused-build kernel; (b) bench.py's h = 128 line (B = 128,
   ADMM-50), one fused_stagewise_solve_stream launch per period; (c) its
   h = 16 / 32 / 64 lines, which take the fused-build kernel.  Every line
   ends in the warm KKT audit (return_qp; 6e-3 / 1e-3), and the fused-build
   lines also dump the kernel's own build (srb_build_dump) beside the
   audited problem;
8. (the slice-4 kernels, fused_kf_innovate and fused_admm_iterations:
   timed in phase 2, held to their plain versions by the card tests);
9. drive the state-estimation tick (estimation/container.update with
   kf_backend="pallas") at B = 2048 for 500 ticks: a standing A1, the IMU
   yaw spread over +-pi, the scheduled contact phases those of the trot
   advancing tick by tick; one fused_kf_innovate launch per tick and no
   other kernel; yaw zeroed, |v| < 5e-3, body height above the feet within
   0.02 of the leg kinematics; then 300 ticks of the dense chain ("xla" backend)
   from a cold start of its own: finite, |v| < 5e-3, velocity and position
   from the feet within 2e-3 of the kernel's path;
10. drive the condensed walking period (bench.py's "condensed pallas-f32"
   line: B = 2048, h = 10, ADMM-30, backend="pallas") through setup_command
   -> mpc_step -> srb_sim.step: one fused_admm_iterations launch per period
   and no stagewise launch, the warm KKT audit with qp_admm.kkt_residuals
   (6e-3 / 1e-3), then the same line with pallas_bf16_kinv=True, audited
   and printed beside it (not gated);
11. the paper's experiment on the main path (tests/test_closed_loop.py:69-92):
   loop.rollout of the bench trot at B = 2048 through the fused-build kernel
   for 800 periods per arm under the reference disturbance, the adaptive arm
   ("ls" on the discrete residual) against the baseline ("faithful" on the
   reference residual, never released): one fused_stagewise_solve_srb launch
   per period; instance 0 (gait phase 0) meets the reference test's gates
   (vx-rms ratio over periods 500 on under 0.65, fitted frequency within
   0.02 of 0.33 Hz, amplitude 0.8-1.8), the batch's median ratio is under
   0.65, and p5/p50/p95 of the ratio are printed;
12. ls6 under a lateral wrench (tests/test_estimator.py:233-268): the same
   at B = 256 for 700 periods per arm under WrenchDisturbance component 4
   = -0.6 + sin(2 pi 0.4 t), ls6 against the frozen faithful baseline; the
   median vy-rms ratio over periods 450 on is under 0.7;
13. (a) the live-tunable parameters at B = 2048: TunableParams.from_config
   against the untuned fused-build period, then z weight x10, alpha 4e-4
   and f_max 60 written into the same tensors (the forces change, every f_z
   within 60 + 1e-3, one fused_stagewise_solve launch per period and no
   fused-build launch), then swing_height 0.09 -> 0.18 (the swing apex rises
   by more than 0.01 m); (b) the condensed line at B = 2048 with per-instance
   z weights 5 / 50 / 500 / 5000 by quarter (one fused_admm_iterations launch
   per period, forces that differ between the quarters, the KKT audit,
   the z-weight-5000 quarter's primal residual to SWEEP_W5000_PRIMAL);
   (c) the GO1 constants through loop.rollout, 40 periods at B = 256 (body
   height within 0.05 of 0.29, every state finite).  The four arms of 11
   and 12 run side by side, each in a process of its own (spawned, and
   joined before 13), since every period is host-bound.  11-13 print their
   wall seconds, their periods' ms and the device's busy share.
14. terrain in the loop (tests/test_terrain_loop.py:126-178's doorstep
   experiment) on the main path: loop.rollout with each instance's 96 x 96
   map at 0.03 m (scenario.build_map) and the true surface as the plant's
   ground, B = 2048 (the bench trot's gait phases at vx = 0.25 from rest,
   estimator "ls", no disturbance), 110 periods an arm, the map-aware arm
   (foothold_update every tick, the map's body-height command) against the
   terrain-blind one, side by side in two spawned processes; instance 0 is
   the reference test's robot (a 6 cm riser at 0.35 m) and the others cycle
   through the 20 (riser, edge) pairs of tests/test_sweep_terrain.py; one
   fused_stagewise_solve_srb launch a period and no other, one
   foothold_update launch a control tick on the map; instance 0 and
   the median over the instances with a riser meet
   test_terrain_rollout_beats_flat's gates (final x > 0.55 in both arms; rms
   of the height-above-terrain error over the last 25 periods under 0.012
   with the map, over 0.04 without, and their ratio under 0.3); one warm
   period of the map-aware arm passes the KKT audit with the fused build
   dumped (one srb_build_dump launch);
15. the elevation-mapping tick of 256 robots, each walking onto its own
   step with a 16,384-point stereo scan a tick (a 128 x 128 subsample of a
   480 x 640 depth image, noise-free, depth cutoff 0.2-3 m): predict ->
   motion_update -> InputSource.process (multi-height gate) ->
   visibility_cleanup (12 ray samples) -> move -> fuse_area -> postprocess
   -> compute_traversability, 20 ticks, then one footstep_planner.plan and
   extract_path; ticks 0 and 19 and the first 16 robots' plan are held stage
   by stage to the CPU port run on the same inputs copied to the CPU
   (MAPPING_TOL: 0 for the elementwise stages, the gathers, the scatter-min
   and the planner; 2e-5 relative for the summing ones), and the Kalman map
   converges to the true step (within 1e-3 on every observed cell clear of
   the riser).  14-15 print their ms per period or tick, launches and busy
   share.
16. the sweeps (quad_periodic_mpc_tpu_torch/parallel): (a) the multi-device
   dry run (parallel/dryrun.dryrun_multichip, the counterpart of
   __graft_entry__.dryrun_multichip) on a mesh of eight entries that are all
   this card, so that the batch split, copy and gather run on it: tier 1
   (128 instances, condensed ADMM-30 "xla", terrain, 16 periods), tier 1b's
   three estimator arms (8 instances, 48 periods), tier 2 (16 instances, h =
   32 through the fused-build kernel) and tier 3 (16 instances, the full
   stack), each split against its unsplit oracle with the reference's
   tolerances, side by side in spawned processes; the oracles' figures held
   to JAX's (DRYRUN_REF) and the best instance and the argmin arm under the
   tie rule; tier 1 again with the ADMM in fused_admm_iterations and tier 3
   with every torque-tick kernel, each held to its "xla" twin; (b)
   BASELINE.json config 3, the gait sweep: four gaits x 256 phases = 1,024
   instances under the reference disturbance, stagewise ADMM-30 at h = 10 in
   the fused-build kernel, 40 periods, one launch a period and no other,
   every metric finite, p5/p50/p95 of vx_rms per gait, then the same split
   over four entries of the card and held to the first (atol 5e-4, rtol
   1e-3, the tie rule); (c) config 4, the 10,000 terrain scenarios of
   tests/test_sweep_terrain.py (a 32 x 32 map each): the reference test's 2
   periods at h = 4 with condensed ADMM-20 and its assertions, then 20
   periods of the production setting (h = 10, stagewise ADMM-30 in the
   fused-build kernel, map-aware footholds), every metric finite, one launch
   a period; each of (b) and (c) then builds its batch once more, runs a
   warm period and times 10 periods of the rollout without the set-up,
   profiling two more; (d) parallel/dist_check as one torch.distributed
   rank (NCCL, world size 1; its two all_gathers go through the group)
   against one process without a group: equal JSON on every key.  16
   prints its wall seconds, ms per period, busy share, launches and peak
   device memory, and the sweeps' figures as one "[sweep figures]" line
   after every phase has passed.
17. the FSM and its controllers (slice 8): (a) the torque-level force stand
   (control/force_stand.py: the reference's capstone,
   tests/test_articulated_sim.py:57-125, with the safety post-check's
   clamps and the FSM fed each tick) at B = 2,048 for 1,500 ticks, each
   instance holding its own seeded target height: the balance QP (PDIP-25)
   -> safety.run_checks -> the stance LegController -> fused_substeps, on
   fused_model_eval's terms, exactly these two kernel launches a tick; every
   instance meets the capstone's gates (|z - target| < 0.03, |quat[0]| >
   0.99, max |v_body| < 0.6), every safety mask holds on every tick, every
   FSM ends in BALANCE_STAND / NORMAL, instances 0-7 lie within 1e-4 of
   JAX's figures (STAND_REF), the FSM trace replayed by the CPU port from the
   copied masks is equal, and both kernels are held to their plain versions
   on the first and last ticks' states; 17a runs in a spawned process, and
   its loop is timed for a few ticks in this process before the spawn and
   again after 17a's profiler session; (b) balance_vbl.solve at B = 2,048
   on those stances (a seeded quarter on three legs), at the target and
   displaced, the card against the CPU port (F and the CARE's P) and
   tests/test_balance_vbl.py's equilibrium and restoring gates; (c) fleets
   on the card and again on the CPU port: 2,048 FSMs for 1,200 ticks (EDAMP
   reaching ESTOP), 2,048 gait schedulers through step_full for 1,000 ticks,
   adaptive_gait_update, the poses, playback through a saved plan, the
   filters, and the six wbc_tasks builders through wbic / kin_wbc, in
   float64 and in float32 (WBC_LISTS).  17 prints ms per tick, the busy
   share, launches and peak memory.

18. the command-line interface and the operator surfaces (slice 9), each
   CLI run in this process through ``cli.main`` with its output captured:
   (a) ``rollout --steps 200 --solver admm --formulation stagewise --backend
   pallas --solver-iters 30``: exactly 200 fused_stagewise_solve_srb
   launches, height_final within 0.03 of 0.29 and vx_mean within 0.03 of 0.3;
   (b) ``python -m quad_periodic_mpc_tpu_torch rollout`` with those flags,
   ``--disturbance`` and 20 steps, a subprocess with no ``--device``: exit 0
   and JSON equal to the same run in this process, whose every numeric field
   lies within 1e-3 of the CPU port's (``--device cpu``); (c) ``live --steps
   40 --chunk 10`` with the tune file rewritten after the second row and
   telemetry to a UDP socket bound on port 0: 4 rows, tune_seq 1, 1, 2, 2,
   alpha and swing_height echo the file, the rollout handed the same tensors
   in every chunk, one datagram per row equal to it, 40 fused_stagewise_solve
   launches; (d) ``sweep --mpc-steps 20 --phase-offsets 4 --backend pallas``
   on the card and on the CPU port: 20 fused_admm_iterations launches, the
   same instances, best_instance under the tie rule, the mean and p50 / p95
   within atol 5e-4, rtol 1e-3; (e) ``parity --horizon 10 --problems 5``
   in float32, each row printed beside JAX's (PARITY_REF), the worst force
   gap within 1e-2 N of JAX's; (f) tests/test_golden_qpoases.py's three
   scenes in float32 on the card through fused_admm_iterations (ADMM-400),
   fused_stagewise_solve (ADMM-400) and the PDIP-40, each against the
   committed qpOASES library (tools/golden/libqpoases_golden.so) at that
   test's gates, or where float32 misses one, no farther than 4/3 of JAX's
   own float32 gap (GOLDEN_XLA_GAP); (g) the native runtime built with g++
   into build/native/: the ring, UDP on ports from a bind-to-0 probe, the
   four safety functions, and the 500 Hz periodic loop for 0.25 s (its
   iterations and jitter, host figures).  18 prints each part's seconds.
19. the CUDA graphs (runtime/graphs.py, slice 10): (e) first, one eager run
   of every step the phase captures under torch.cuda.set_sync_debug_mode(
   "error"); (a) the bench trot at B = 2048 through loop.rollout and
   loop.rollout_graphed from one start for 20 periods: every tensor of the
   carry and the trace equal bit for bit, one fused-build launch a period,
   then the period timed eagerly and replayed (a synchronize after each) and
   three replayed periods profiled; (b) the tunable trot (one
   fused_stagewise_solve a period): 3 periods, a retune by copy_ into the
   TunableParams, 3 more, replayed equal to eager bit for bit and the
   forces moved by the retune; (c) the full stack at B = 256: 10 periods of
   rollout_articulated_graphed equal to rollout_articulated bit for bit,
   then 45 periods through one capture, (13, 13, 13, 1, 0) launches each,
   the trot-walks gates, timed and profiled; (d) B = 1: the tick pair
   (full_stack.capture_ticks) and the controller tick alone (the plant
   held) for 20 chains of 26 ticks, a synchronize after every tick, p50 /
   p99 / max ms a tick beside the eager ticks and the 2 ms budget (printed,
   not gated), the first 4 periods equal to rollout_articulated bit for
   bit.  A graph's first two calls run eagerly (its warm-up; they launch
   and count), the third captures.
20. the evidence tools (quad_periodic_mpc_tpu_torch/tools, slice 12): (a)
   parity_table on the card: 15 scenes (h = 10 / 16 / 19; trot, bound, pace,
   gallop; two with a disturbance estimate; six plant-stepped B = 1 walking
   sequences of 12 condensed mpc_steps through fused_admm_iterations with
   the "faithful" estimator) x 6 float32 solver settings (ADMM-400 cold and
   ADMM-30 warm x6 on the "xla" loop, the production setting warm x6 through
   fused_admm_iterations, PDIP-40, PDIP-40 spd, the stagewise ADMM-400 on its
   scan path) against qpOASES in float64 on the host: each cell under the
   golden gate or within 4/3 of JAX's float32 gap (EVIDENCE_GAPS; on the
   three cells of EVIDENCE_SPREAD, of the largest of its gap and its
   rounding draws), JAX's own misses (>= 1 N) missed too by PDIP and within
   2 % of JAX's by ADMM (the walking tails), the walking scenes' applied
   first step within 2 % of JAX's; exactly
   9 x 6 + 6 x 12 = 126 fused_admm_iterations launches and no other; the
   table and the walking split printed; (b) estimator_ab at the JAX tool's
   grid (72 instances) and window AB_WINDOW (2 x AB_WINDOW periods an arm,
   run_sweep's condensed ADMM-100 on the "xla" loop), its four arms side by
   side in spawned processes: the arms' order in mean vx RMS JAX's on the
   CPU (EVIDENCE_AB), "ls" against "off" under AB_RATIO, each arm's mean
   within AB_REL of JAX's; ms a period for each arm, and the busy share and
   launches of a profiled period; (c) the "xla" ADMM loop and the stagewise
   scan path alone: ms and launches an iteration.  20 prints its seconds.

The last lines are the card's name and power limit (nvidia-smi), one JSON
object per kernel with its times and bound, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple

# the counts the benchmark's roofline shares use; port_bench/tests reads
# pdip_row_flops and the peaks from here too
from port_bench.counts import (
    CROSS3, FORCE_CROSS, FP32_FLOPS_PER_S, HBM_BYTES_PER_S, MM3, MV3, MV6, TICK_FLOATS, XAPPLY,
    XT_FORCE, bound, gemm_flops, pdip_row_flops, solve_bytes, solve_flops, spd_inv_flops,
    wbc_flops,
)
from quad_periodic_mpc_tpu_torch.testing import kernel_cases as KC
from quad_periodic_mpc_tpu_torch.tools.parity_table import (
    EVIDENCE_ATOL, EVIDENCE_JAX_MISS, EVIDENCE_MISS, EVIDENCE_REL, EVIDENCE_SPREAD, GOLDEN_ATOL,
    GOLDEN_RTOL, evidence_cell,
)

REPO = Path(__file__).resolve().parent
BATCH, HORIZON, ADMM_ITERS, VX = 2048, 10, 30, 0.3
WARM_PERIODS, TIMED_PERIODS, ROLLOUT_PERIODS = 3, 10, 3
# the fused-build kernel's shapes (KC.PATH_CASES) that phase 16 launches it
# at (their launches are checked there)
SWEEP_SHAPES = ("config 3 sweep", "config 4 sweep", "dry run tier 2", "dry run tier 2 chunk")
KKT_PRIMAL, KKT_DUAL = 6e-3, 1e-3
# slice 3: (label, B, h, ADMM iterations, warm periods, timed periods, kernel)
# The predictive line is audited at period 415, 15 periods after the
# estimator's release.  From about period 402 on the primal residual of the
# ADMM-30 warm solve spikes above the gate in some periods for the instances
# of one gait phase, with or without the predictive horizon and in the fused
# build as well: PREDICTIVE_LATER more periods are audited and printed, not
# gated, so that the record shows it.
PREDICTIVE_WARM, LINE_TIMED, PREDICTIVE_LATER = 405, 10, 20
STREAM_ITERS = 50
LONG_LINES = (
    ("h=128 streamed", 128, 128, STREAM_ITERS, 4, 8, "fused_stagewise_solve_stream"),
    ("h=16", 1024, 16, 40, 6, LINE_TIMED, "fused_stagewise_solve_srb"),
    ("h=32", 512, 32, 50, 6, LINE_TIMED, "fused_stagewise_solve_srb"),
    ("h=64", 256, 64, 50, 4, LINE_TIMED, "fused_stagewise_solve_srb"),
)
# torque tick: bench.py's full-stack batch and the reference's trot-walks
# test (45 periods, vx = 0.15)
FS_BATCH, FS_VX, FS_PERIODS, FS_WARM, FS_TIMED = 256, 0.15, 45, 3, 10
B1_CHAINS, B1_PERIODS = 10, 2
# slice 4: the estimation tick (KFParams.dt = 0.002: 500 ticks are 1 s) and
# the condensed line (bench.py audits its sixth warm step)
EST_TICKS, EST_PROFILE_TICKS, EST_XLA_TICKS = 500, 20, 300
# the dense chain against the kernel's path after EST_XLA_TICKS ticks from a
# cold start: the reference's gate between its two float32 backends.  The
# dense chain refines neither solve, so through the transient it is the
# further of the two from float64, and is held once it settles
EST_XLA_GAP = 2e-3
CONDENSED_WARM, CONDENSED_TIMED = 6, 10
# slice 5: the paper's adaptive-vs-baseline experiment at the bench's batch
# and solver (the reference's gates, tests/test_closed_loop.py:69-92: vx rms
# over periods 500 on), ls6 under the lateral wrench (its gate,
# tests/test_estimator.py:233-268: vy rms over periods 450 on), the
# tunables, the per-instance weight sweep and the GO1 (40 periods, the
# reference's test_go1_model_pipeline)
EXP_PERIODS, EXP_FROM, EXP_RATIO = 800, 500, 0.65
LAT_BATCH, LAT_PERIODS, LAT_FROM, LAT_RATIO = 256, 700, 450, 0.7
TUNE_WARM, TUNE_TIMED, SWEEP_PERIODS = 10, 3, 8
GO1_BATCH, GO1_PERIODS, GO1_VX = 256, 40, 0.2
# the weight sweep's KKT audit: the quarters at z weights 5 / 50 / 500 meet the
# bench's gates; at 5000 the ADMM-30 with the bench's rho misses the primal
# gate in the reference too (tools/slice5_reference.py sweep, JAX's XLA path
# on the CPU, B = 832: 0.0079-0.0148 over periods 1-20), so that quarter is
# held to JAX's worst plus a third
SWEEP_W5000_PRIMAL = 0.02
# the untuned fused-build period against the tuned caller-built one: each
# kernel is held to its plain version at KC.STAGEWISE_TOL["U"], and the two
# plain versions lie ~2e-4 apart (tests/test_torch_tunable.py), allowed 1e-3
TUNE_TOL = 2 * KC.STAGEWISE_TOL["U"] + 1e-3
# slice 6: terrain in the loop, phase 14 (tests/test_terrain_loop.py:126-178's
# doorstep experiment: 110 periods at vx = 0.25, the height-above-terrain rms
# over the last 25, each instance's 96 x 96 map at 0.03 m) on the bench's
# batch and solver, and the elevation-mapping tick, phase 15
TERRAIN_PERIODS, TERRAIN_VX, TERRAIN_TAIL = 110, 0.25, 25
MAP_SIZE, MAP_RES = 96, 0.03
TERRAIN_RISERS, TERRAIN_EDGES = (0.0, 0.03, 0.06, 0.09), (0.20, 0.25, 0.30, 0.35, 0.40)
# test_terrain_rollout_beats_flat's gates.  JAX's XLA path meets every one
# under stagewise ADMM-30 float32 (tools/slice6_reference.py, B = 8: instance
# 0 final x 0.6952 / 0.6990, rms 0.00481 / 0.05671, ratio 0.0848; the median
# over risers 0.7005 / 0.7006, 0.00543 / 0.04952, 0.1848), so they stand
TERRAIN_X_MIN, TERRAIN_RMS_MAP, TERRAIN_RMS_FLAT, TERRAIN_RATIO = 0.55, 0.012, 0.04, 0.3
# phase 15: B robots walk MAPPING_STEP a tick from MAPPING_START before
# their step onto it; a stereo camera (the reference's StereoSensorProcessor
# model, a 128 x 128 subsample of a 480 x 640 image, 90 degrees wide, pitched
# down 0.5 rad, 0.25 m ahead of the base) with a 0.2-3 m depth cutoff
MAPPING_BATCH, MAPPING_TICKS, MAPPING_CHECK_TICKS, MAPPING_PLAN_CHECK = 256, 20, (0, 19), 16
MAPPING_STEP, MAPPING_START, MAPPING_GOAL, MAPPING_PATH_STEPS = 0.05, 0.6, 0.6, 40
MAPPING_PROCESS_VAR, MAPPING_POSE_VAR, MAPPING_MAHALANOBIS = 1e-6, 1e-6, 2.5
MAPPING_RAY_SAMPLES = 12
SCAN_SIDE, CAM_W, CAM_H, CAM_F, CAM_PITCH, CAM_T = 128, 640, 480, 320.0, 0.5, (0.25, 0.0, 0.05)
STEREO = dict(p_1=0.1, p_2=0.002, p_3=0.5, p_4=320.0, p_5=0.001, lateral_factor=0.01,
              depth_to_disparity_factor=100.0, v_center=240.0, cutoff_min_depth=0.2,
              cutoff_max_depth=3.0)
# card vs the CPU port, stage by stage on the same inputs: |card - cpu| over
# max(|cpu|, MAPPING_SCALE m) (variances relative to themselves).  0: equal
# (elementwise operations, gathers, the scatter-min of visibility_cleanup,
# the planner's adds and mins).  The others sum in another order: the
# fusion's scatter-adds are atomics on the card, fuse_area's and inpaint's
# sums and the products of motion_update and the sensor model go through
# other reductions; float32 sums of up to ~100 terms: 2e-5
MAPPING_SCALE = 0.1
MAPPING_TOL = {"predict": 0.0, "motion_update": 2e-5, "process": 2e-5, "points": 2e-5,
               "visibility_cleanup": 0.0, "move": 0.0, "fuse_area": 2e-5, "postprocess": 2e-5,
               "traversability": 0.0, "plan": 0.0}
# test_fuse_convergence's gate, over the cells seen (variance < 1) more than
# two cells from the riser, with at least this many such cells a robot (a
# quarter of them on the step)
MAPPING_CONVERGED, MAPPING_MIN_CELLS = 1e-3, 200
# slice 7: the sweeps, phase 16 (parallel/).  The dry run on a mesh of
# DRYRUN_ENTRIES copies of the one card (the reference's eight devices), its
# oracles held to JAX's: the unsplit oracles of each tier at eight devices
# (python tools/slice7_reference.py: JAX on the CPU, float32; the
# reference's MULTICHIP_r05.json prints the same to four digits).  Tier 1's
# two smallest errors are the tie rule's inputs
DRYRUN_ENTRIES = 8
DRYRUN_REF = {"1": {"mean": 0.27855247, "best": 111, "min": 0.02348637, "next": 0.02824243},
              "1b": {"ls": 0.08487609, "static": 0.11950116, "off": 0.09947275},
              "2": {"mean": 0.15457078}, "3": {"zmean": 0.27343780}}
# BASELINE.json config 3: SweepSpec()'s four gaits x 256 phase offsets = 1,024
# instances, 40 periods, then split over CONFIG3_SPLIT entries of the card;
# config 4: tests/test_sweep_terrain.py's 10,000 terrain scenarios, the
# reference test's (periods, h, ADMM iterations), then 20 periods of the
# production setting
CONFIG3_PHASES, CONFIG3_PERIODS, CONFIG3_SPLIT = 256, 40, 4
CONFIG4 = dict(gait_names=("trotting", "bounding", "pacing", "galloping"), phase_offsets=5,
               dist_static=(-10.0, -5.0, 0.0, 5.0, 10.0), dist_amp=(0.0, 5.0, 10.0, 15.0, 20.0),
               terrain_risers=(0.0, 0.03, 0.06, 0.09),
               terrain_edge_x=(0.20, 0.25, 0.30, 0.35, 0.40), map_size=32, map_resolution=0.05)
CONFIG4_REFERENCE, CONFIG4_PERIODS = (2, 4, 20), 20
# slice 11: a split run takes the Newton-Schulz inverses' batch-global
# decisions over the whole batch (parallel/batch_group.py), so a split is
# the unsplit program; on the card it may still differ from the unsplit run
# in the last bits where cuBLAS picks another GEMM for another batch count.
# SPLIT_GAP is the largest |split - unsplit| of a per-instance metric
# allowed to dry-run tiers 1 and 1b (1.43e-4 at tier 1 on an H100 when each
# chunk decided alone, SPLIT_GAP_BEFORE) and to 16e, config 4's condensed
# sweep (the reference settings' h and ADMM iterations,
# CONFIG4_CONDENSED_PERIODS periods) split CONFIG4_SPLIT ways: the bound
# predicted in PERF.md before the first run on the card
SPLIT_GAP, SPLIT_GAP_BEFORE = 2e-5, 1.43e-4
CONFIG4_SPLIT, CONFIG4_CONDENSED_PERIODS = 4, 10
# the split runs' ms a period (with the set-up) on an H100 when the chunks
# ran one after another: printed beside this run's
SEQUENTIAL_SPLIT_MS = {"config 3": 481.8}
# the bucket's escalated set on the card against the CPU's: seed residuals
# with ties and with a NaN, k = 8 // 2, and lax.top_k's indices for them
# (JAX 0.9.0 on the CPU: the lower index first among equal values, NaN
# first); then SELECTION_B seeded residuals on a 1/64 grid (ties
# everywhere) with NaNs, k = B // 4
SELECTION_CASES = {"tied": ([0.5, 0.7, 0.7, 0.1, 0.7, 0.3, 0.2, 0.7], [1, 2, 4, 7]),
                   "nan": ([0.5, 0.7, 0.7, 0.1, 0.7, float("nan"), 0.2, 0.7], [5, 1, 2, 4])}
SELECTION_B = 10000
# each sweep's periods timed after its set-up and a warm period
SWEEP_TIMED_PERIODS = 10
# slice 8: the FSM and its controllers, phase 17.  17a: the torque-level
# force stand (tests/test_articulated_sim.py:57-125 with the safety
# post-check and the FSM; control/force_stand.py) at STAND_BATCH for
# STAND_TICKS ticks, instance i's target height z0 + the seeded offset of
# stand_offsets (instance 0: z0).  Its gates are the
# capstone's on every instance; instances 0-7 (final z, quat[0], max|v_body|)
# are held to JAX's figures for the same inputs (python
# tools/slice8_reference.py: JAX's XLA path on the CPU, float32, B = 8, one
# model evaluation a tick and ten step_fast substeps; the port on the CPU lies
# within 2.7e-6 of them)
STAND_BATCH, STAND_TICKS, STAND_SEED = 2048, 1500, 1208
# 17a's loop timed from its start for this many ticks in its fresh process,
# again there after its profiler session, and in the smoke run's own process
# after phases 1-16: a torch.profiler session leaves the host's loop slower
# for the rest of the process (PERF.md section 7)
STAND_RETIMED_TICKS = 30
STAND_GATES = {"z": 0.03, "quat0": 0.99, "vmax": 0.6}
STAND_REF = [[0.2811795, 0.9999914, 0.0017293], [0.2897912, 0.9999913, 0.0034784],
             [0.2972397, 0.9999913, 0.0050509], [0.2970431, 0.9999913, 0.0050079],
             [0.2977056, 0.9999913, 0.0051483], [0.2801622, 0.9999914, 0.0015257],
             [0.2712039, 0.9999913, 0.0008054], [0.2750154, 0.9999913, 0.0008011]]
STAND_REF_TOL = 1e-4
# 17b: the card against the CPU port on the same inputs; F relative to the
# instance's largest force (at least 1 N), so the pinned legs' ~0 forces are
# held absolutely (reference_grf's 1e9 penalty makes their last digits
# library-dependent); P of the CARE relative to its largest entry
VBL_TOL = {"F": 1e-3, "P": 1e-4}
# 17c: the fleets, each against the CPU port on the same inputs: integers and
# flags equal, floats within FLEET_TOL (elementwise float32 operations, and
# the poses' 3 x 3 products).  The WBC tasks through wbic, with the
# reference test's list (RyRz, then the joint task) and a list of
# independent rows (RyRz, roll, a foot relative to another): in float64
# both lists' torques within WBC_TASK_TOL of their size (pseudo-inverses and
# the relaxation PDIP summed in another order); in float32 the second
# list's within WBC_TASK_F32_TOL (the CPU port's float32 torques lie 2.2e-4
# of their size from float64 on 17a's final states, as this phase prints;
# two such answers up to twice that apart), and the reference list's finite
# on both: its damped Gram reaches cond ~1e6, and there the CPU port's
# float32 torques lie up to 2.6x their size from float64 (JAX's go further:
# tests/test_torch_wbc_tasks.py::test_wbic_reference_list_float32_finite_like_jax)
FLEET_B, FLEET_FSM_TICKS, FLEET_GAIT_TICKS, FLEET_DT = 2048, 1200, 1000, 0.002
FLEET_TOL, WBC_TASK_TOL, WBC_TASK_F32_TOL = 1e-6, 1e-4, 1e-3
WBC_LISTS = {"reference": ("ryrz", "jpos"), "independent": ("ryrz", "roll", "local_pos")}
# slice 9: the CLI and the operator surfaces, phase 18.  18b: the card's
# rollout against the CPU port's on the same flags, every numeric field;
# 18c: live's rows against the CPU port's, the state fields LIVE_STATE
# (float32; the kernels and the plain versions sum in another order; the
# H100 gave 7.75e-7 on 18b's 20 periods)
CLI_STEPS, CLI_SHORT_STEPS, CLI_CPU_TOL = 200, 20, 1e-5
LIVE_STATE = ("t_sim", "vx", "vx_mean_chunk", "height", "roll", "pitch", "est_freq", "est_amp")
CLI_ROLLOUT_FLAGS = ["--solver", "admm", "--formulation", "stagewise", "--backend", "pallas",
                     "--solver-iters", "30"]
# 18a: the JAX CLI test's gate on the final height, the verify skill's on vx
CLI_HEIGHT, CLI_HEIGHT_TOL, CLI_VX, CLI_VX_TOL = 0.29, 0.03, 0.3, 0.03
# 18e: each seed's ADMM-200-vs-PDIP-40 force gap within PARITY_TOL N of
# JAX's float32 figure (tools/slice9_reference.py, JAX on the CPU, 64-bit
# mode off); on the H100 the rows lay 2.9e-6 to 2.5e-4 N from JAX's (the
# ADMM stops 200 iterations short of its fixed point, so float32 sums in
# another order move it by up to a fifth of the gap itself)
PARITY_TOL = 3e-4
# 18f: parity_table.GOLDEN_ATOL / GOLDEN_RTOL, tests/test_golden_qpoases.py's
# gates; where float32 misses one, the largest gap may be no more than 4/3
# of JAX's own float32 XLA gap on the same QP.  JAX's figures, float32 on
# the CPU (tools/slice9_reference.py): parity's rows for seeds 0-4 (ADMM-200
# against PDIP-40, h = 10), and per golden scene (fixtures.GOLDEN_SCENES)
# the largest |x - x_qpOASES| of ADMM-400, PDIP-40 and the stagewise
# ADMM-400
PARITY_REF = {"worst_force_diff_N": 0.002143383026123047, "rows": [
    {"seed": 0, "admm_vs_pdip_max": 0.00140380859375, "primal": 4.0900813473854214e-05,
     "dual": 1.6391277313232422e-07},
    {"seed": 1, "admm_vs_pdip_max": 0.0010833740234375, "primal": 2.0242499886080623e-05,
     "dual": 1.1920928955078125e-07},
    {"seed": 2, "admm_vs_pdip_max": 0.0007015466690063477, "primal": 1.4821156582911499e-05,
     "dual": 8.568167686462402e-08},
    {"seed": 3, "admm_vs_pdip_max": 0.0011034011840820312, "primal": 4.576464561978355e-05,
     "dual": 2.4959444999694824e-07},
    {"seed": 4, "admm_vs_pdip_max": 0.002143383026123047, "primal": 4.664276639232412e-05,
     "dual": 2.5331974029541016e-07}]}
GOLDEN_XLA_GAP = (
    {"admm": 0.0008169878998245395, "pdip": 0.0002953471564715038,
     "stagewise": 0.00044297882151056456},
    {"admm": 0.0006463931260611844, "pdip": 9.816277617513691e-05,
     "stagewise": 0.00019876828635290167},
    {"admm": 0.003796395411427511, "pdip": 0.0009896547054033533,
     "stagewise": 0.0005499794449406181},
)
# slice 10: the CUDA graphs, phase 19.  (a) the bench trot for GRAPH_PERIODS
# periods; (b) the tunable trot, GRAPH_TUNE_PERIODS periods either side of
# the retune; (c) the full stack's first GRAPH_FS_EQUAL periods held to
# eager, then FS_PERIODS; (d) B = 1, GRAPH_CHAINS chains of
# GRAPH_B1_PERIODS periods, the first GRAPH_B1_EQUAL periods held to eager
# (a graph's first two calls are its eager warm-up, so the first periods
# include replays of the MPC tick only from the third).  Replay runs the
# eager run's kernels on the same inputs: every tensor equal bit for bit
GRAPH_PERIODS, GRAPH_TUNE_PERIODS, GRAPH_FS_EQUAL = 20, 3, 10
GRAPH_B1_PERIODS, GRAPH_CHAINS, GRAPH_B1_EQUAL = 2, 20, 4
TICK_BUDGET_MS = 2.0
QUEUE_SLEEP_CYCLES = 200_000_000     # ~0.1 s at the H100's clock: longer than 21 calls' issue
# slice 12: the evidence tools, phase 20.  20a holds each cell of the gap
# table by parity_table.evidence_cell, and each walking scene's applied
# first step within EVIDENCE_REL of JAX's (the H100 gave both within 0.3 %
# of JAX's).  The wider walking gates (a tail missing by 0.1 N, a first
# step within EVIDENCE_FIRST_STEP x JAX's) are printed too.  The
# production setting's six solves on each of the 9 still scenes and the 12
# walking steps of each of the 6 walking scenes launch the fused ADMM
# kernel, nothing else does
EVIDENCE_FIRST_STEP = 2.0
EVIDENCE_LAUNCHES = 9 * 6 + 6 * 12
# JAX's figures on the CPU, float32 (tools/slice12_reference.py --part parity): per
# scene and setting [its gap, the largest over its 16 rounding draws] (N); the
# walking scenes' production cell and applied first step [its gap]
EVIDENCE_GAPS = {
    "h=10 seed=3 seg=0": {
        "ADMM-400 cold": [0.000801729, 0.00119083], "ADMM-30 warm x6": [0.00269933, 0.00294729],
        "production warm x6": [0.00260492, 0.00293203], "PDIP-40": [0.000295347, 0.000612682],
        "PDIP-40 spd": [35.6603, 86.8514], "stagewise ADMM-400": [0.000496385, 0.000572679],
    },
    "h=10 seed=11 seg=2": {
        "ADMM-400 cold": [0.00068454, 0.000974457], "ADMM-30 warm x6": [0.00148409, 0.00163002],
        "production warm x6": [0.00144547, 0.00154658], "PDIP-40": [9.81628e-05, 0.000319198],
        "PDIP-40 spd": [19.9096, 61.6653], "stagewise ADMM-400": [0.000232354, 0.000409882],
    },
    "h=16 seed=5 seg=5": {
        "ADMM-400 cold": [0.0038498, 0.00569611], "ADMM-30 warm x6": [0.00211805, 0.00380714],
        "production warm x6": [0.0019806, 0.0030269], "PDIP-40": [0.000989655, 0.00178034],
        "PDIP-40 spd": [64.1559, 64.7967], "stagewise ADMM-400": [0.000651542, 0.000679679],
    },
    "h=19 seed=7 seg=3": {
        "ADMM-400 cold": [0.00843941, 0.019256], "ADMM-30 warm x6": [0.00335295, 0.00466129],
        "production warm x6": [0.00350792, 0.00455149], "PDIP-40": [0.00176917, 0.00277597],
        "PDIP-40 spd": [72.0554, 72.276], "stagewise ADMM-400": [0.000723973, 0.000879666],
    },
    "h=16 seed=9 seg=1 bounding": {
        "ADMM-400 cold": [0.00336656, 0.00461317], "ADMM-30 warm x6": [0.00446054, 0.00506421],
        "production warm x6": [0.00457447, 0.005598], "PDIP-40": [0.000554777, 0.00263754],
        "PDIP-40 spd": [78.0625, 74.3394], "stagewise ADMM-400": [0.000613547, 0.000647414],
    },
    "h=10 seed=13 seg=4 pacing": {
        "ADMM-400 cold": [0.000650398, 0.00121193], "ADMM-30 warm x6": [0.00139504, 0.00196152],
        "production warm x6": [0.00152569, 0.00199585], "PDIP-40": [0.000723651, 0.00119896],
        "PDIP-40 spd": [0.0036251, 0.00247841], "stagewise ADMM-400": [0.000372699, 0.000578693],
    },
    "h=10 seed=2 seg=0 galloping": {
        "ADMM-400 cold": [0.000579661, 0.00102203], "ADMM-30 warm x6": [0.00542114, 0.00558755],
        "production warm x6": [0.00531111, 0.00551364], "PDIP-40": [0.000185747, 0.000574492],
        "PDIP-40 spd": [0.000118274, 0.0099638],
        "stagewise ADMM-400": [0.000289609, 0.000388906],
    },
    "h=16 seed=4 seg=2 f_est": {
        "ADMM-400 cold": [0.0158756, 0.0160454], "ADMM-30 warm x6": [1.97898, 1.97908],
        "production warm x6": [1.97897, 1.97922], "PDIP-40": [0.529746, 0.634167],
        "PDIP-40 spd": [0.630301, 1.17456], "stagewise ADMM-400": [0.0158132, 0.0159729],
    },
    "h=10 seed=6 seg=1 f_est": {
        "ADMM-400 cold": [0.00015275, 0.000218554],
        "ADMM-30 warm x6": [5.34169e-05, 0.000104915],
        "production warm x6": [7.34677e-05, 0.000139248], "PDIP-40": [0.0266874, 0.269793],
        "PDIP-40 spd": [0.00496834, 0.0511872], "stagewise ADMM-400": [3.43434e-05, 0.00018964],
    },
    "h=10 walking x12 trott vx=0.3 (prod warm)": {
        "ADMM-400 cold": [0.000621034, 0.000979198],
        "ADMM-30 warm x6": [0.000521435, 0.000685467], "production warm x6": [1.48312],
        "_walk_first_step": [0.189582], "PDIP-40": [5.00116e-05, 0.000196907],
        "PDIP-40 spd": [6.52704e-05, 0.000214228],
    },
    "h=10 walking x12 trott vx=0.8 (prod warm)": {
        "ADMM-400 cold": [0.000605876, 0.000781352], "ADMM-30 warm x6": [0.00151656, 0.0015978],
        "production warm x6": [2.25504], "_walk_first_step": [0.331807],
        "PDIP-40": [4.08598e-05, 0.000199115], "PDIP-40 spd": [3.88944e-05, 0.000227462],
    },
    "h=10 walking x12 bound vx=0.3 (prod warm)": {
        "ADMM-400 cold": [0.000356954, 0.000479822], "ADMM-30 warm x6": [0.00281115, 0.00289508],
        "production warm x6": [2.47919], "_walk_first_step": [0.0157329],
        "PDIP-40": [2.10139e-05, 8.20491e-05], "PDIP-40 spd": [2.83689e-05, 5.54645e-05],
    },
    "h=10 walking x12 bound vx=0.8 (prod warm)": {
        "ADMM-400 cold": [0.000207777, 0.000242454], "ADMM-30 warm x6": [0.00712775, 0.00722967],
        "production warm x6": [1.46606], "_walk_first_step": [0.00571303],
        "PDIP-40": [2.11049e-05, 5.86673e-05], "PDIP-40 spd": [9.77474e-06, 6.64772e-05],
    },
    "h=10 walking x12 pacin vx=0.3 (prod warm)": {
        "ADMM-400 cold": [0.000391748, 0.00049856], "ADMM-30 warm x6": [0.00255449, 0.00256957],
        "production warm x6": [5.86912], "_walk_first_step": [0.0222969],
        "PDIP-40": [2.70911e-05, 0.000106227], "PDIP-40 spd": [2.60902e-05, 0.000113856],
    },
    "h=10 walking x12 pacin vx=0.8 (prod warm)": {
        "ADMM-400 cold": [0.00052893, 0.000567077], "ADMM-30 warm x6": [0.00375424, 0.00377665],
        "production warm x6": [5.7954], "_walk_first_step": [0.00888185],
        "PDIP-40": [1.68352e-05, 0.000110444], "PDIP-40 spd": [1.72581e-05, 0.000118074],
    },
}
# 20b: the A/B's window (2 x AB_WINDOW periods an arm); "ls" against "off"
# in mean vx RMS under AB_RATIO at window 400 (PERF.md section 2's gate for the
# paper's ratio), at another window no more than JAX's ratio + 0.05; each arm's
# mean vx RMS within AB_REL of JAX's (the H100 gave 1e-6; the issue's gate,
# AB_ISSUE_REL, is printed too).  EVIDENCE_AB: JAX's rows on the CPU
# (tools/slice12_reference.py --part ab --est-window 400 128), float32
AB_WINDOW, AB_RATIO, AB_REL, AB_ISSUE_REL = 400, 0.65, 1e-4, 0.05
EVIDENCE_AB = {
    "400": [
        {"arm": "ls", "instances": 72, "vx_rms_mean": 0.06349219381809235,
         "vx_rms_p50": 0.058289505541324615, "vx_rms_p95": 0.12471498548984528,
         "height_rms_mean": 0.0036202864721417427},
        {"arm": "faithful", "instances": 72, "vx_rms_mean": 0.1595727652311325,
         "vx_rms_p50": 0.15102709829807281, "vx_rms_p95": 0.28503233194351196,
         "height_rms_mean": 0.0036296530161052942},
        {"arm": "static", "instances": 72, "vx_rms_mean": 0.10365072637796402,
         "vx_rms_p50": 0.08845657110214233, "vx_rms_p95": 0.22519369423389435,
         "height_rms_mean": 0.0037409563083201647},
        {"arm": "off", "instances": 72, "vx_rms_mean": 0.11531586199998856,
         "vx_rms_p50": 0.113729327917099, "vx_rms_p95": 0.19502952694892883,
         "height_rms_mean": 0.003650940954685211},
    ],
    "128": [
        {"arm": "ls", "instances": 72, "vx_rms_mean": 0.0714588314294815,
         "vx_rms_p50": 0.06217500567436218, "vx_rms_p95": 0.1297520399093628,
         "height_rms_mean": 0.0038833213038742542},
        {"arm": "faithful", "instances": 72, "vx_rms_mean": 0.1088428869843483,
         "vx_rms_p50": 0.1024768203496933, "vx_rms_p95": 0.18088845908641815,
         "height_rms_mean": 0.003860891330987215},
        {"arm": "static", "instances": 72, "vx_rms_mean": 0.1131465807557106,
         "vx_rms_p50": 0.10696625709533691, "vx_rms_p95": 0.22116082906723022,
         "height_rms_mean": 0.004000093322247267},
        {"arm": "off", "instances": 72, "vx_rms_mean": 0.11134503781795502,
         "vx_rms_p50": 0.10578015446662903, "vx_rms_p95": 0.187840536236763,
         "height_rms_mean": 0.0038734774570912123},
    ],
}


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
# work counts for the bound (operations counted from the kernel's loops),
# beside the ones port_bench/counts.py keeps for the benchmark
# ---------------------------------------------------------------------------

def contact_kinematics_flops(rotors: bool) -> int:
    """Per instance: the tree walk, bias accelerations, four foot walks."""
    joint = 15 + 2 + 2 * MM3 + MV3 + 3 + XAPPLY + 1 + 2 * CROSS3
    rotor = 15 + 2 + MM3 + 2 + XAPPLY + 1 + 2 * CROSS3
    bias = XAPPLY + 6
    # per leg: two X v, the cross, Wl, three joints of (3 products + sub), p
    leg = 2 * XAPPLY + CROSS3 + 3 + MM3 + 9 + 3 * (3 * MM3 + 9) + MV3 + 3
    return 30 + 12 * (joint + bias + (rotor + bias if rotors else 0)) + 4 * leg


def model_eval_flops() -> int:
    """Per instance: contact_kinematics_flops(rotors) + CRBA, H, the 18x18
    inverse, gravity and Coriolis."""
    crba = 12 * (2 * 9 * 5 + 2 * gemm_flops(6, 6, 6) + 36 * (2 * 11 + 2))
    h_asm = 12 * (6 + 2 + 2 * XT_FORCE + 6) + 12 * XT_FORCE
    grav = XAPPLY + MV6 + 12 * (2 * XAPPLY + 2 * MV6 + 3)
    cori = 2 * MV6 + FORCE_CROSS + 6 + 12 * (4 * MV6 + 2 * FORCE_CROSS + 12) + 12 * (
        2 * XT_FORCE + 14)
    return (contact_kinematics_flops(True) + crba + h_asm + spd_inv_flops(18) + grav
            + cori)


def substep_flops(substeps: int) -> int:
    """Per instance: Jc qdot, four feet of penalty contact, Jc^T f,
    A^{-1} rhs and the integration, per substep."""
    per = (gemm_flops(12, 18, 1) + 4 * 30 + gemm_flops(18, 12, 1) + 30
           + gemm_flops(18, 18, 1) + 60 + 30 + 21 + 60 + 24)
    return substeps * per


def kf_flops() -> int:
    """Per instance, loop by loop from csrc/kf.cu: the shifted-add predict,
    the row / column combinations, the 28x28 Schur inverse, the two solves
    with their refinement step, P' and the symmetrise / reset."""
    NX, NY = 18, 28
    with_d = lambda r, k, s: gemm_flops(r, k, s) + 2 * r * s     # D + alpha * (A B)
    predict = 12 + 3 * NX * 2 + NX * 3 * 2 + 9 * 2 + NX
    combine = (NY + 12) + 12 * NX + (12 * NY + NY)               # ey, CP, S
    solve_x = gemm_flops(NY, NY, 1) + 2 * with_d(NY, NY, 1) + with_d(NX, NY, 1)
    solve_P = gemm_flops(NY, NY, NX) + 2 * with_d(NY, NY, NX) + with_d(NX, NY, NX)
    return predict + combine + spd_inv_flops(NY) + solve_x + solve_P + 8 * NX * NX


def srb_plant_flops(wrench: bool) -> int:
    """Per instance, from csrc/srb_plant.cu: R from rpy (16), the four feet's
    u, r, force sum and r x u (84), c_omega and c_v (42), the ZOH (57), t'
    (1), and the disturbance: six sinusoids of 5, or the x-force's one with
    its divide, 6; the sines and cosines are not counted."""
    return 200 + (30 if wrench else 6)


def srb_plant_bytes(B: int, wrench: bool) -> int:
    """Read once: x (13), feet, forces, targets (12 each), stance (4), t and
    the disturbance's four parameters (one or six each); written once: x',
    feet' and t'.  336 B an instance with the x-force."""
    return 4 * B * (13 + 36 + 4 + 1 + 4 * (6 if wrench else 1) + 13 + 12 + 1)


def swing_update_bytes(B: int) -> int:
    """Read once: p (3), v's x and y (2), the quaternion (4), the feet (12),
    iteration, the velocity command (2), world_position_desired (3),
    rpy_int (2), first_swing (4 B), the swing timers (4), p0 and pf (12
    each) and the yaw rate, a gait shared by the batch; written once: the
    state's eight fields and the outputs (p, v, a targets, contact and swing
    states).  560 B an instance in float32."""
    return 4 * B * (3 + 2 + 4 + 12 + 1 + 2 + 3 + 2 + 1 + 4 + 24 + 1) + 4 * B * (
        1 + 3 + 2 + 2 + 1 + 4 + 24 + 36 + 4 + 4)


def foothold_bytes(B: int) -> int:
    """Read once: each leg's target and its swing start (3 each: the foot
    where first_swing is set, swing_p0 elsewhere, one of the two a leg), its
    first_swing (1 B) and the map's center (2, shared by the four legs);
    written once: the swing target (3); and a 32-B sector for each of three
    scattered map reads a leg: the taken cell's traversability (the least a
    search reads: more where it moves on) and elevation, and the swing
    start's elevation.  540 B an instance in float32."""
    return B * (4 * (3 * 12 + 1) + 4 * 2) + 4 * B * 3 * 32


def admm_flops(n: int, m: int, iters: int) -> int:
    """Per instance, from csrc/admm.cu's loops: rhs (12 a variable), the
    K^{-1} product (2 n^2), the x update (3 a variable) and the z / y / w row
    work (17 a row) per iteration, and the set-up of 1/rho and w."""
    return iters * (2 * n * n + 15 * n + 17 * m) + 3 * m


def admm_bytes(B: int, n: int, m: int) -> int:
    """K^{-1}, q, x0 and l, u, rho, z0, y0 read once, x, z, y written once."""
    return 4 * (B * (n * n + 2 * n + 5 * m + n + 2 * m) + 15)


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


def time_ms(fn, reps: int) -> float:
    """ms per call between CUDA events around `reps` calls: the device's
    time when it, not the host's issue of the calls, is the limit."""
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


def kernel_ms(fn, reps: int, symbol: str) -> tuple[float, float]:
    """(device ms per launch of the kernel named `symbol`, from the
    profiler's device time over the launches it recorded of `reps` calls; ms
    per call from CUDA events).  A kernel shorter than its wrapper's
    host-side cost leaves the device idle between calls, which the events
    count and the device time does not.  Fails the run where the profiler records no device
    time for `symbol` in three windows (a renamed kernel, or a profiler
    that sees no device), rather than report the events' time as the
    kernel's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    per_call = time_ms(fn, reps)
    # the trace drops some launches of a window (15 to 19 of 20 have been
    # seen, more in the later windows of a process, and once all 20 of a
    # window that a fresh process records in full); the time is per launch
    # that it did record.  A window that recorded none is profiled again,
    # twice at most.  None in three windows, or a launch too many, is a
    # renamed kernel or a profiler that sees no device
    for window in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and symbol in e.key]
        launches = sum(e.count for e in rows)
        if launches:
            break
        print(f"[kernel] the profiler recorded no launch of {symbol} in window {window + 1}")
    check(1 <= launches <= reps, f"the profiler saw {launches} "
          f"device launches of {symbol!r} in {reps} calls, in each of three windows")
    if launches < reps:
        print(f"[kernel] the profiler recorded {launches} of {reps} launches of {symbol}")
    return sum(e.self_device_time_total for e in rows) / 1e3 / launches, per_call


class Row(NamedTuple):
    """One hand-written kernel of the table (PERF.md section 6's row): its
    record's and launch counter's name (its key in KC.PATH_CASES, whose
    cases it is gated and timed at, the first also beside its plain
    version), the device symbol the profiler must see, its source and the
    TPU kernel it replaces.  case(*arguments) builds testing/kernel_cases'
    seeded inputs and returns (kernel call, plain call, gate, flops,
    bytes[, the nearest library call]), gate() the kernel's KC comparison
    on the two calls' outputs.  reps: calls timed of the kernel and of the
    plain version."""
    name: str
    symbol: str
    source: str
    replaces: str | None
    case: Callable
    reps: tuple = (20, 3)


def kernel_rows(device) -> list[Row]:
    """Rows 1-13 of PERF.md section 6, in its order."""
    from quad_periodic_mpc_tpu_torch.config import MPCConfig
    from quad_periodic_mpc_tpu_torch.control import cmpc_variant as CV
    from quad_periodic_mpc_tpu_torch.control import mpc as M
    from quad_periodic_mpc_tpu_torch.control.wbc import WBCGains
    from quad_periodic_mpc_tpu_torch.estimation import kf as KF
    from quad_periodic_mpc_tpu_torch.models import floating_base as fb
    from quad_periodic_mpc_tpu_torch.ops.cuda import admm_kernel as AK
    from quad_periodic_mpc_tpu_torch.ops.cuda import kf_kernel as FK
    from quad_periodic_mpc_tpu_torch.ops.cuda import kinematics_kernel as KK
    from quad_periodic_mpc_tpu_torch.ops.cuda import plant_kernel as PK
    from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel as SK
    from quad_periodic_mpc_tpu_torch.ops.cuda import wbc_kernel as WK
    from quad_periodic_mpc_tpu_torch.sim import srb_sim as S
    from quad_periodic_mpc_tpu_torch.sim.articulated_sim import ContactParams

    mc, gains, params, cfg = (fb.build_a1_constants("float32", str(device)), WBCGains(),
                              ContactParams(), MPCConfig())

    def gated(run, plain, compare):     # compare(kernel's outputs, plain version's)
        return run, plain, lambda: compare(run(), plain())

    def tick(key, B, flops):        # a torque-tick kernel's work at batch B
        per_in, per_out, shared = TICK_FLOATS[key]
        return B * flops, 4 * (B * (per_in + per_out) + shared)

    def srb(B, h, iters, seed):
        args, kw = KC.stagewise_case(B, h, seed=seed, device=device, iters=iters)
        rescued = SK.rescues()
        SK.fused_stagewise_solve_srb(*args, **kw)    # the kernel's own count of cold restarts
        rescued = SK.rescues() - rescued
        ns = kw["ns_it"]
        return (*gated(lambda: SK.fused_stagewise_solve_srb(*args, **kw),
                       lambda: SK.fused_stagewise_solve_srb_reference(*args, **kw),
                       KC.stagewise_mismatches),
                solve_flops(B, h, iters, ns, SK.ns_warm_rounds(ns), rescued), solve_bytes(B, h))

    def built(B, h, per_step_c, dense_ad, seed):
        args, kw = KC.solve_case(B, h, seed=seed, device=device, iters=ADMM_ITERS,
                                 per_step_c=per_step_c, dense_ad=dense_ad)
        kw["srb_ad"] = not dense_ad
        stats = {}
        SK.fused_stagewise_solve_reference(*args, **kw, stats=stats)
        ns = kw["ns_it"]
        return (*gated(lambda: SK.fused_stagewise_solve(*args, **kw),
                       lambda: SK.fused_stagewise_solve_reference(*args, **kw),
                       KC.stagewise_mismatches),
                solve_flops(B, h, ADMM_ITERS, ns, SK.ns_warm_rounds(ns), stats["rescued"],
                            assemble=False),
                solve_bytes(B, h, built=True, per_step_c=per_step_c))

    def stream(B, h, per_step_c, warm, seed):
        args, kw, sw = KC.solve_case(B, h, seed=seed, device=device, iters=STREAM_ITERS,
                                     per_step_c=per_step_c, with_problem=True)
        if warm:
            args[10:] = [w.contiguous() for w in SK.fused_stagewise_solve_stream(
                *args, **dict(kw, iters=5))]
        stats = {}
        SK.fused_stagewise_solve_stream_reference(*args, **kw, stats=stats)
        ns = kw["ns_it"]
        return (*gated(lambda: SK.fused_stagewise_solve_stream(*args, **kw),
                       lambda: SK.fused_stagewise_solve_stream_reference(*args, **kw),
                       lambda got, want: KC.stagewise_mismatches(got, want, KC.STREAM_TOL,
                                                                 None if warm else sw)),
                solve_flops(B, h, STREAM_ITERS, ns, SK.ns_warm_rounds(ns), stats["rescued"],
                            assemble=False, stream=True),
                solve_bytes(B, h, built=True, per_step_c=per_step_c))

    def model(B):
        st = KC.model_states(B, seed=KC.MODEL_SEED, device=device)
        return (*gated(lambda: KK.fused_model_eval(st, mc), lambda: KK.model_eval_reference(st, mc),
                       KC.model_eval_mismatches),
                *tick("model", B, model_eval_flops()))

    def contact(B):
        st = KC.model_states(B, seed=KC.CONTACT_SEED, device=device)
        return (*gated(lambda: KK.fused_contact_kinematics(st, mc),
                       lambda: fb.contact_jacobians(st, mc), KC.contact_mismatches),
                *tick("contact", B, contact_kinematics_flops(False)))

    def wbc(B):
        args = KC.wbc_kernel_args(*KC.wbc_state_and_input(B, device=device))
        return (*gated(lambda: WK.fused_wbc(*args, gains, KC.WBC_PDIP),
                       lambda: WK.fused_wbc_reference(*args, gains, KC.WBC_PDIP),
                       KC.wbc_mismatches),
                *tick("wbc", B, wbc_flops(KC.WBC_PDIP.iterations)))

    def substeps(B):
        p0, tau, cache, Jc, pf = KC.plant_case(B, device=device)
        run = lambda fn: fn(p0, tau, 2e-4, params, cache, Jc, pf, 10)
        return (*gated(lambda: run(PK.fused_substeps), lambda: run(PK.fused_substeps_reference),
                       KC.substeps_mismatches),
                *tick("plant", B, substep_flops(10)))

    def dump(B, seed):
        args, sw = KC.srb_dump_case(B, seed=seed, device=device)
        return (*gated(lambda: SK.srb_build_dump(*args), lambda: SK.srb_assemble(*args),
                       lambda got, want: KC.dump_mismatches(got, want, sw)),
                B * (54 + 4 * 110 + 12 + 31 + 13), 4 * B * (28 + 338))

    def kf(B, seed):
        args = KC.kf_case(B, seed=seed, device=device)
        return (*gated(lambda: FK.fused_kf_innovate(*args, dt=KC.KF_DT),
                       lambda: FK.fused_kf_innovate_reference(*args, dt=KC.KF_DT),
                       functools.partial(KC.kf_mismatches, args)),
                B * kf_flops(), 4 * B * 761,
                # not one library call but the nearest thing: the "xla"
                # backend's dense chain on PyTorch's batched products
                lambda: KF.dense_predict_innovate(*args, KF.KFParams(dt=KC.KF_DT)))

    def admm(B, h, iters, warm, bf16, seed):
        args = KC.admm_case(B, h, seed=seed, device=device, warm=warm)
        kw = dict(iters=iters, kinv_bf16=bf16)
        n, m = 12 * h, 20 * h
        return (*gated(lambda: AK.fused_admm_iterations(*args, **kw),
                       lambda: AK.fused_admm_iterations_reference(*args, **kw),
                       lambda got, want: KC.admm_mismatches(args, got, want, **kw)),
                B * admm_flops(n, m, iters), admm_bytes(B, n, m))

    def plant(B, wrench, seed):
        args = KC.srb_plant_case(B, seed=seed, device=device, wrench=wrench)
        return (*gated(lambda: S.step_kernel(*args, cfg, 0.002),
                       lambda: S.step_dense(*args, cfg, 0.002), KC.srb_plant_mismatches),
                B * srb_plant_flops(wrench), srb_plant_bytes(B, wrench))

    def swing(B, seed):
        args = KC.swing_update_case(B, seed=seed, device=device)
        return (lambda: M.swing_update_kernel(*args), lambda: M.swing_update_plain(*args),
                lambda: KC.swing_update_mismatches(args), 0, swing_update_bytes(B))

    def foothold(B, seed):
        args = KC.foothold_case(B, seed=seed, device=device)
        return (lambda: CV.foothold_update_kernel(*args), lambda: CV.foothold_update_plain(*args),
                lambda: KC.foothold_mismatches(args), 0, foothold_bytes(B))

    tpu = "quad_periodic_mpc_tpu/ops/pallas/"
    return [
        Row("fused_stagewise_solve_srb", "stagewise_srb_kernel", "stagewise_srb.cu",
            tpu + "stagewise_kernel.py:753", srb, (20, 2)),
        Row("fused_model_eval", "model_eval_kernel", "kinematics.cu",
            tpu + "kinematics_kernel.py:727", model),
        Row("fused_wbc", "wbc_kernel", "wbc.cu", tpu + "wbc_kernel.py:493", wbc),
        Row("fused_substeps", "plant_kernel", "plant.cu", tpu + "plant_kernel.py:224", substeps),
        Row("fused_contact_kinematics", "contact_kinematics_kernel", "kinematics.cu",
            tpu + "kinematics_kernel.py:286", contact),
        Row("fused_stagewise_solve", "stagewise_solve_kernel", "stagewise_solve.cu",
            tpu + "stagewise_kernel.py:610", built, (20, 2)),
        Row("fused_stagewise_solve_stream", "stagewise_stream_kernel", "stagewise_stream.cu",
            tpu + "stagewise_kernel.py:1103", stream, (3, 1)),
        Row("srb_build_dump", "srb_build_dump_kernel", "stagewise_srb.cu",
            tpu + "stagewise_kernel.py:1225", dump),
        Row("fused_kf_innovate", "kf_kernel", "kf.cu", tpu + "kf_kernel.py:159", kf),
        Row("fused_admm_iterations", "admm_kernel", "admm.cu", tpu + "admm_kernel.py:138", admm),
        Row("srb_plant_step", "srb_plant_step_kernel", "srb_plant.cu", None, plant, (20, 5)),
        Row("swing_update", "swing_update_kernel", "swing_update.cu", None, swing, (20, 5)),
        Row("foothold_update", "foothold_update_kernel", "foothold.cu", None, foothold, (20, 5)),
    ]


def kernel_table(device, card: str) -> dict:
    """Phase 2: every hand-written kernel of kernel_rows at each of its
    KC.PATH_CASES, held to its plain version by its KC comparison (a
    non-finite output fails it too) and timed (device ms a launch from the
    profiler, ms a call between CUDA events; the plain version at the first
    case) against its bound.  Returns {name: record} in the rows' order,
    with the largest |kernel - plain| of each case and of the row
    ("max_abs_err"), "launches" 0 for the driven paths to fill in."""
    import torch

    from quad_periodic_mpc_tpu_torch.utils.telemetry import leaves

    records = {}
    for row in kernel_rows(device):
        shapes, plain_ms, library_ms = [], None, None
        for path, args in KC.PATH_CASES[row.name].items():
            run, plain, gate, flops, nbytes, *library = row.case(*args)
            what = f"{row.name} {path} {list(args)}"
            bad, gaps = gate()
            print(f"[kernel] {what}: largest |kernel - plain| "
                  + ", ".join(f"{n} {g:.3g}" for n, g in gaps.items()))
            check(not bad, f"{what} disagrees with its plain version in {bad}")
            ms, call_ms = kernel_ms(run, row.reps[0], row.symbol)
            bound_ms, by = bound(flops, nbytes)
            shapes.append({"path": path, "args": list(args), "ms": ms, "call_ms": call_ms,
                           "bound_ms": bound_ms, "bound_by": by,
                           "max_abs_err": max(g for n, g in gaps.items() if " " not in n)})
            line = f"[kernel] {what}: kernel {ms:.5f} ms on the device ({call_ms:.4f} ms per call)"
            if plain_ms is None:
                plain_ms = time_ms(plain, row.reps[1])
                line += f", plain version {plain_ms:.3f} ms"
                if library:
                    check(all(bool(torch.isfinite(t).all()) for t in leaves(library[0]())),
                          f"{what}: the library call's output not finite")
                    library_ms = time_ms(library[0], row.reps[1])
                    line += f", library {library_ms:.3f} ms"
            print(f"{line}, bound {bound_ms:.6f} ms ({by}; {flops:.3e} flop, {nbytes} B) "
                  f"on {card}")
        main = shapes[0]
        records[row.name] = {
            "name": row.name, "route": "cuda",
            "source": "quad_periodic_mpc_tpu_torch/csrc/" + row.source,
            "replaces": row.replaces, "launches": 0,
            "max_abs_err": max(s["max_abs_err"] for s in shapes), "ms": main["ms"],
            "plain_ms": plain_ms, "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": library_ms, "shapes": shapes}
    for i, rec in enumerate(records.values(), 1):
        print(f"[kernel table] {i:2d} {rec['name']}: " + "; ".join(
            f"{s['path']} {s['ms']:.5f} ms (bound {s['bound_ms']:.6f})" for s in rec["shapes"])
            + f"; plain version {rec['plain_ms']:.3f} ms; largest gap {rec['max_abs_err']:.3g} "
            f"on {card}")
    return records


def _maxdiff(a, b) -> float:
    return float((a - b).abs().max())


def take_srb_plant_launches() -> int:
    """The SRB plant kernel's launches since the last call, its count set to
    0.  Graph captures and replays are not counted (it is not one of
    runtime/graphs' counted wrappers), eager calls are."""
    from quad_periodic_mpc_tpu_torch.ops.cuda import srb_plant_kernel as SPK

    n, SPK.LAUNCHES = SPK.LAUNCHES, 0
    return n


def take_swing_launches() -> int:
    """The swing update kernel's launches since the last call, its count
    set to 0.  As the plant's: eager launches count, a graph's capture and
    replays do not."""
    from quad_periodic_mpc_tpu_torch.ops.cuda import swing_update_kernel as SUK

    n, SUK.LAUNCHES = SUK.LAUNCHES, 0
    return n


def take_foothold_launches() -> int:
    """The foothold kernel's launches since the last call, its count set to
    0.  As the plant's: eager launches count, a graph's capture and replays
    do not."""
    from quad_periodic_mpc_tpu_torch.ops.cuda import foothold_kernel as FHK

    n, FHK.LAUNCHES = FHK.LAUNCHES, 0
    return n


def trot_inputs(device, batch: int = BATCH, horizon: int = HORIZON,
                formulation: str = "stagewise"):
    """The bench's walking trot (bench.py make_inputs) on the port."""
    import torch

    from quad_periodic_mpc_tpu_torch.control import mpc as M
    from quad_periodic_mpc_tpu_torch.ops import gait as G
    from quad_periodic_mpc_tpu_torch.sim import srb_sim as S

    f32 = dict(dtype=torch.float32, device=device)
    plant = S.init_plant((batch,), body_height=0.29, device=device)
    obs = S.observe(plant)
    ctrl = M.init_state((batch,), obs, horizon=horizon, formulation=formulation)
    ctrl = ctrl._replace(
        iteration=(torch.arange(batch, dtype=torch.int32, device=device) * 7) % 208,
        x_vel_des=torch.full((batch,), VX, **f32))
    cmd = M.Command(vx=torch.full((batch,), VX, **f32),
                    vy=torch.zeros(batch, **f32), yaw_rate=torch.zeros(batch, **f32),
                    body_height=torch.full((batch,), 0.29, **f32))
    gait = G.preset("trotting", device=device)
    dist = S.DisturbanceParams.reference((batch,), device=device)
    return ctrl, plant, cmd, gait, dist


def make_period(device, mpc_cfg, est_cfg, solver, tunable=None):
    """bench.py's step for one configuration: solve, hold the first-step
    forces over the period, swing feet glide toward a half-stance Raibert
    touchdown.  period(ctrl, plant, cmd, gait, dist, return_qp=False) ->
    (ctrl, plant, forces, qp or None).  tunable: TunableParams for every
    solve."""
    import torch

    from quad_periodic_mpc_tpu_torch.config import LoopConfig
    from quad_periodic_mpc_tpu_torch.control import mpc as M
    from quad_periodic_mpc_tpu_torch.models.a1 import A1
    from quad_periodic_mpc_tpu_torch.ops import gait as G
    from quad_periodic_mpc_tpu_torch.ops.rotations import quat_to_rotmat
    from quad_periodic_mpc_tpu_torch.sim import srb_sim as S

    loop_cfg = LoopConfig()
    dt_mpc = loop_cfg.dt * loop_cfg.iterations_between_mpc
    hips = torch.as_tensor(A1.hip_locations(), dtype=torch.float32, device=device)
    t_stance = 10 * dt_mpc

    def period(ctrl, plant, cmd, gait, dist, return_qp=False):
        obs = S.observe(plant)
        ctrl = M.setup_command(ctrl, cmd, loop_cfg)
        out = M.mpc_step(ctrl, obs, cmd, gait, plant.t, mpc_cfg, loop_cfg,
                         est_cfg, solver, tunable=tunable, return_qp=return_qp)
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

    return period


def reset_stagewise_counts() -> None:
    from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel as SK

    for k in SK.LAUNCHES:
        SK.LAUNCHES[k] = 0


def kkt_audit(tag: str, period, ctrl, plant, cmd, gait, dist, est_cfg, dump: bool):
    """One more period with return_qp: the KKT residuals of the production
    warm solve against the problem it answered (gates 6e-3 / 1e-3).  dump:
    on a fused-build line, also launch srb_build_dump on the step's
    observation and hold the kernel's own Ad, Bd, c to the audited
    problem's.  Returns (ctrl, plant, qp)."""
    import torch

    from quad_periodic_mpc_tpu_torch.ops import qp_stagewise
    from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel as SK

    ctrl, plant, forces, qp = period(ctrl, plant, cmd, gait, dist, return_qp=True)
    B, h = forces.shape[0], forces.shape[1]
    res = qp_stagewise.kkt_residuals(
        qp, forces.reshape(B, h, 12), ctrl.warm_z.reshape(B, h, 20),
        ctrl.warm_y.reshape(B, h, 20))
    primal, dual = float(res["primal"].max()), float(res["dual"].max())
    print(f"[{tag}] KKT audit: primal max {primal:.3g} (gate {KKT_PRIMAL}), "
          f"dual max {dual:.3g} (gate {KKT_DUAL})")
    check(primal < KKT_PRIMAL and dual < KKT_DUAL, f"{tag}: KKT gate failed")
    if dump:
        # what mpc_step gave the fused-build kernel, from the round-trip state
        released = (ctrl.est.count >= est_cfg.ls_release)[..., None]
        f_for_qp = torch.where(released, ctrl.est.f_est, torch.zeros_like(ctrl.est.f_est))
        built = SK.srb_build_dump(
            ctrl.prev_R.contiguous(), ctrl.prev_r_feet.contiguous(),
            ctrl.prev_x_drag.contiguous(), f_for_qp.contiguous())
        bad, gaps = KC.dump_mismatches(built, (qp.Ad, qp.Bd, qp.c))
        print(f"[{tag}] fused build (srb_build_dump) vs audited problem: " + ", ".join(
            f"max|d{n}|={e:.3g}" for n, e in gaps.items()) + f" (tol {KC.DUMP_TOL})")
        check(not bad, f"{tag}: the kernel's build differs from the audit's in {bad}")
    return ctrl, plant, qp


def profile_periods(step, ctrl, plant, n: int = 3, unit: str = "period") -> dict | None:
    """Where a main-path period's time goes: device time by kernel name
    over n periods (torch.profiler), and the device's busy share of the
    wall time.  Runs after the counted window.  Returns the device ms, wall
    ms and launches a period (None when the profiler recorded no device
    time)."""
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
        return None
    launches = sum(r[1] for r in rows)
    print(f"[profile] per {unit}: device busy {busy:.2f} ms of {wall_ms / n:.2f} ms "
          f"wall ({100 * busy * n / wall_ms:.1f}% busy), {launches} kernel launches")
    for ms, count, key in sorted(rows, reverse=True)[:8]:
        print(f"[profile]   {ms:8.3f} ms  x{count:<4d} {key[:90]}")
    return {"device_ms": busy, "wall_ms": wall_ms / n, "launches": launches}


def main_path(device, card: str) -> dict:
    """The slice-1 path.  Returns the stagewise kernels' launch counts of
    its counted windows (the timed periods, and the audit's dump)."""
    import torch

    from quad_periodic_mpc_tpu_torch.config import (
        ADMMConfig, EstimatorConfig, LoopConfig, MPCConfig)
    from quad_periodic_mpc_tpu_torch.control import loop as L
    from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel as SK

    mpc_cfg, loop_cfg, est_cfg = MPCConfig(horizon=HORIZON), LoopConfig(), EstimatorConfig()
    solver = ADMMConfig(iterations=ADMM_ITERS, backend="pallas", formulation="stagewise")
    period = make_period(device, mpc_cfg, est_cfg, solver)

    ctrl, plant, cmd, gait, dist = trot_inputs(device)
    for _ in range(WARM_PERIODS):
        ctrl, plant, forces, _ = period(ctrl, plant, cmd, gait, dist)
    torch.cuda.synchronize()

    reset_stagewise_counts()
    take_srb_plant_launches()
    times = []
    all_finite = True
    for _ in range(TIMED_PERIODS):
        t0 = time.perf_counter()
        ctrl, plant, forces, _ = period(ctrl, plant, cmd, gait, dist)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        all_finite &= bool(torch.isfinite(forces).all())
    counts = dict(SK.LAUNCHES)
    launches = counts["fused_stagewise_solve_srb"]
    plant_steps = take_srb_plant_launches()
    print(f"[main path] bench trot B={BATCH} h={HORIZON} ADMM-{ADMM_ITERS}: "
          f"{TIMED_PERIODS} periods, median {statistics.median(times):.2f} ms/period "
          f"(min {min(times):.2f}, max {max(times):.2f}), kernel launches {launches}, "
          f"srb_plant_step {plant_steps} on {card}")
    check(launches == TIMED_PERIODS and sum(counts.values()) == launches,
          f"expected {TIMED_PERIODS} fused-build launches and no other, counted {counts}")
    check(plant_steps == TIMED_PERIODS, f"expected {TIMED_PERIODS} srb_plant_step launches "
          f"(bench.py's one plant step a period), counted {plant_steps}")
    counts["srb_plant_step"] = plant_steps
    check(all_finite, "non-finite forces on the main path")
    check(bool(torch.isfinite(plant.x).all()), "non-finite plant state")

    profile_periods(lambda c, p: period(c, p, cmd, gait, dist)[:2], ctrl, plant)

    # KKT audit of the production warm solve against the independent build,
    # and the kernel's own build dumped beside it
    reset_stagewise_counts()
    ctrl, plant, _ = kkt_audit("main path", period, ctrl, plant, cmd, gait, dist, est_cfg,
                               dump=True)
    counts["srb_build_dump"] = SK.LAUNCHES["srb_build_dump"]

    # the product entry point: loop.rollout (13 control ticks per period)
    ctrl, plant, cmd, gait, dist = trot_inputs(device)
    torch.cuda.synchronize()
    reset_stagewise_counts()
    take_swing_launches()
    t0 = time.perf_counter()
    carry, trace = L.rollout(ROLLOUT_PERIODS, plant, ctrl, cmd, gait, dist,
                             mpc_cfg, loop_cfg, est_cfg, solver)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / ROLLOUT_PERIODS
    rollout_launches = SK.LAUNCHES["fused_stagewise_solve_srb"]
    swings = take_swing_launches()
    ticks = ROLLOUT_PERIODS * loop_cfg.iterations_between_mpc
    print(f"[main path] loop.rollout B={BATCH}: {ROLLOUT_PERIODS} periods, "
          f"{ms:.1f} ms/period (13 control ticks each), kernel launches "
          f"{rollout_launches}, swing_update {swings} on {card}")
    check(rollout_launches == ROLLOUT_PERIODS,
          f"expected {ROLLOUT_PERIODS} rollout launches, counted {rollout_launches}")
    check(swings == ticks, f"expected {ticks} swing_update launches (one a control tick), "
          f"counted {swings}")
    counts["swing_update"] = swings
    check(bool(torch.isfinite(trace.forces).all())
          and bool(torch.isfinite(carry.plant.x).all()), "non-finite rollout")
    height = float(carry.plant.x[:, 5].mean())
    check(0.2 < height < 0.4, f"rollout body height {height} left [0.2, 0.4]")
    return counts


def walking_line(device, card: str, label: str, B: int, h: int, iters: int, warm: int,
                 timed: int, kernel: str, predictive: bool = False) -> dict:
    """One line of bench.py's walking trot through mpc_step and srb_sim.step
    at (B, h, ADMM-iters): `warm` periods, then `timed` timed ones with the
    stagewise launch counts set to 0 just before and read just after (one
    launch of `kernel` per period and none of the other solves), then the
    warm KKT audit.  predictive: the estimator's per-step horizon; the warm
    periods must carry it past release, and the audited c must vary over
    the horizon.  Returns the counted launches."""
    import torch

    from quad_periodic_mpc_tpu_torch.config import ADMMConfig, EstimatorConfig, MPCConfig
    from quad_periodic_mpc_tpu_torch.ops import qp_stagewise
    from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel as SK

    mpc_cfg, est_cfg = MPCConfig(horizon=h), EstimatorConfig(predictive=predictive)
    solver = ADMMConfig(iterations=iters, backend="pallas", formulation="stagewise")
    period = make_period(device, mpc_cfg, est_cfg, solver)
    tag = f"line {label}"
    ctrl, plant, cmd, gait, dist = trot_inputs(device, B, h)
    t0 = time.perf_counter()
    for _ in range(warm):
        ctrl, plant, forces, _ = period(ctrl, plant, cmd, gait, dist)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    reset_stagewise_counts()
    times, all_finite = [], True
    for _ in range(timed):
        t0 = time.perf_counter()
        ctrl, plant, forces, _ = period(ctrl, plant, cmd, gait, dist)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        all_finite &= bool(torch.isfinite(forces).all())
    counts = dict(SK.LAUNCHES)
    med = statistics.median(times)
    print(f"[{tag}] bench trot B={B} h={h} ADMM-{iters}"
          f"{' predictive' if predictive else ''}: {warm} warm periods ({warm_s:.1f} s), "
          f"{timed} timed, median {med:.2f} ms/period (min {min(times):.2f}, max "
          f"{max(times):.2f}), {B / med * 1e3:.0f} solves/s, launches {counts} on {card}")
    check(counts[kernel] == timed and sum(counts.values()) == timed,
          f"{tag}: expected {timed} launches of {kernel} and no other, counted {counts}")
    check(all_finite and bool(torch.isfinite(plant.x).all()), f"{tag}: non-finite state")
    if predictive:
        check(bool((ctrl.est.count >= est_cfg.ls_release).all()),
              f"{tag}: the estimator has not released after {warm + timed} periods")

    profile_periods(lambda c, p: period(c, p, cmd, gait, dist)[:2], ctrl, plant, n=2)

    reset_stagewise_counts()
    ctrl, plant, qp = kkt_audit(tag, period, ctrl, plant, cmd, gait, dist, est_cfg,
                                dump=kernel == "fused_stagewise_solve_srb")
    counts["srb_build_dump"] = SK.LAUNCHES["srb_build_dump"]
    if predictive:
        spread = float((qp.c.amax(dim=1) - qp.c.amin(dim=1)).abs().max())
        print(f"[{tag}] audited problem: c {tuple(qp.c.shape)}, largest variation of an "
              f"entry over the horizon {spread:.3g}")
        check(qp.c.ndim == 3 and spread > 0.0, f"{tag}: the per-step c does not vary")
        later = []
        for _ in range(PREDICTIVE_LATER):
            ctrl, plant, forces, qp = period(ctrl, plant, cmd, gait, dist, return_qp=True)
            primal = qp_stagewise.kkt_residuals(
                qp, forces.reshape(B, h, 12), ctrl.warm_z.reshape(B, h, 20),
                ctrl.warm_y.reshape(B, h, 20))["primal"]
            later.append((float(primal.max()), float(primal.median()),
                          int((primal > KKT_PRIMAL).sum())))
        print(f"[{tag}] the next {PREDICTIVE_LATER} periods, not gated: primal max per period "
              + " ".join(f"{m:.3g}" for m, _, _ in later) + "; median over the batch "
              f"{min(md for _, md, _ in later):.3g}-{max(md for _, md, _ in later):.3g}; "
              f"instances over the gate per period " + " ".join(str(n) for _, _, n in later))
    return counts


def full_stack_setup(device, B: int):
    """bench.py's full-stack configuration at batch B, every kernel on:
    returns (mc, gait, kw for rollout_articulated / controller_tick, and the
    start: plant on the ground, its kernel observation, controller,
    command).  The controller skips the condensed K^-1 carry."""
    import torch

    from quad_periodic_mpc_tpu_torch.config import ADMMConfig, MPCConfig
    from quad_periodic_mpc_tpu_torch.control import full_stack as FS
    from quad_periodic_mpc_tpu_torch.control import mpc as M
    from quad_periodic_mpc_tpu_torch.models import floating_base as fb
    from quad_periodic_mpc_tpu_torch.ops import gait as G
    from quad_periodic_mpc_tpu_torch.sim import articulated_sim as art

    mc = fb.build_a1_constants("float32", str(device))
    P = fb.A1ModelParams()
    m_tot = P.body_mass + 4 * (P.abad_mass + P.hip_mass + P.knee_mass + 3 * P.rotor_mass)
    kw = dict(
        mpc_cfg=MPCConfig(horizon=HORIZON, mass=float(m_tot), inertia_body=(0.12, 0.45, 0.42)),
        solver=ADMMConfig(iterations=ADMM_ITERS, formulation="stagewise", backend="pallas"),
        wbc_backend="pallas", kin_backend="pallas")
    plant = art.init_on_ground((B,), penetration=3.8e-3, device=device)
    obs0, _, _ = FS.observe_plant(plant, mc, kin_backend="pallas")
    ctrl = M.init_state((B,), obs0, formulation="stagewise")
    f32 = dict(dtype=torch.float32, device=device)
    cmd = M.Command(vx=torch.full((B,), FS_VX, **f32), vy=torch.zeros(B, **f32),
                    yaw_rate=torch.zeros(B, **f32), body_height=plant.fb.pos[..., 2].clone())
    return mc, G.preset("trotting", device=device), kw, plant, ctrl, cmd


def full_stack_path(device, card: str) -> dict:
    """The composed torque tick with every kernel on, at FS_BATCH: launch
    counts per period, finiteness, the trot-walks gates, period times and a
    profile.  Returns the launch counts of the run."""
    import torch

    from quad_periodic_mpc_tpu_torch.control import full_stack as FS

    reset_all_counts()
    mc, gait, kw, plant, ctrl, cmd = full_stack_setup(device, FS_BATCH)

    def periods(plant, ctrl, n):
        carry, trace = FS.rollout_articulated(n, plant, ctrl, cmd, gait, mc, substeps=10,
                                              **kw)
        return carry.plant, carry.ctrl, trace

    z0 = float(plant.fb.pos[0, 2])
    torch.cuda.synchronize()
    traces, times, all_finite = [], [], True
    for i in range(FS_PERIODS):
        before = fs_counts()
        t0 = time.perf_counter()
        plant, ctrl, trace = periods(plant, ctrl, 1)
        torch.cuda.synchronize()
        if FS_WARM <= i < FS_WARM + FS_TIMED:
            times.append(1e3 * (time.perf_counter() - t0))
        per = tuple(a - b for a, b in zip(fs_counts(), before))
        check(per == (13, 13, 13, 1, 0), f"full-stack period {i}: launches (model_eval, "
              f"wbc, substeps, stagewise, contact) = {per}, expected (13, 13, 13, 1, 0)")
        traces.append(trace)
        all_finite &= all(bool(torch.isfinite(t).all()) for t in (*plant.fb, ctrl.fr_des))
    launches = dict(zip(FS_KERNELS, fs_counts()))
    check(launches["fused_contact_kinematics"] == 1,
          f"contact kinematics launched {launches['fused_contact_kinematics']} times, expected 1")
    check(all_finite, "non-finite state on the full-stack path")
    med = statistics.median(times)
    print(f"[full stack] B={FS_BATCH} trot vx={FS_VX}, ADMM-{ADMM_ITERS} h={HORIZON}, "
          f"WBC PDIP-15, 10 substeps: {FS_TIMED} timed periods, median {med:.2f} ms/period "
          f"(min {min(times):.2f}, max {max(times):.2f}), {FS_BATCH / med * 1e3:.1f} "
          f"periods/s, {med / 13:.3f} ms per batched tick; launches {launches} on {card}")

    trot_walks("full stack", traces, plant, z0)
    profile_periods(lambda c, p: periods(p, c, 1)[1::-1], ctrl, plant)
    return launches


def trot_walks(tag: str, traces: list, plant, z0: float) -> None:
    """The reference's test_full_stack_trot_walks gates over FS_PERIODS
    periods' traces (each {"pos", "v_body", ...} of shape (1, B, .)) and
    the final plant."""
    import torch

    pos = torch.cat([t["pos"] for t in traces]).cpu()          # (periods, B, 3)
    vb = torch.cat([t["v_body"] for t in traces]).cpu()
    dist = float(pos[-1, :, 0].min())
    dz = float((pos[10:, :, 2] - z0).abs().max())
    qw = float(plant.fb.quat[:, 0].abs().min())
    vx = vb[15:, :, 3].mean(0)
    print(f"[{tag}] trot walks ({len(traces)} periods): forward {dist:.4f} m (> 0.10), "
          f"max|z - z0| after period 10 {dz:.4f} (< 0.04), min|quat_w| {qw:.5f} (> 0.99), "
          f"mean v_x after period 15 in [{float(vx.min()):.4f}, {float(vx.max()):.4f}] "
          f"(0.05, 0.3)")
    check(dist > 0.10, f"{tag}: the robot did not walk forward: {dist} m")
    check(dz < 0.04, f"{tag}: body height left the band: {dz}")
    check(qw > 0.99, f"{tag}: attitude tumbled: |quat_w| = {qw}")
    check(bool(((vx > 0.05) & (vx < 0.3)).all()), f"{tag}: mean forward speed out of (0.05, 0.3)")


def single_robot(device, card: str) -> None:
    """B = 1: ms per control tick of the composed tick (controller + 10
    plant substeps) and of the controller tick alone (plant held), over
    two-period chains (bench.py's b=1 lines).  Numbers for PERF.md."""
    import torch

    from quad_periodic_mpc_tpu_torch.control import full_stack as FS

    mc, gait, kw, plant, ctrl, cmd = full_stack_setup(device, 1)
    ticks = 13 * B1_PERIODS

    def chain(plant, ctrl):
        carry, _ = FS.rollout_articulated(B1_PERIODS, plant, ctrl, cmd, gait, mc,
                                          substeps=10, **kw)
        return carry.plant, carry.ctrl

    def controller_chain(ctrl):
        for _ in range(B1_PERIODS):
            for k in range(13):
                ctrl, _, _ = FS.controller_tick(plant, ctrl, cmd, gait, mc, k == 0, **kw)
        return (ctrl,)

    def per_tick(fn, *state):
        out = []
        for i in range(2 + B1_CHAINS):
            t0 = time.perf_counter()
            state = fn(*state)
            torch.cuda.synchronize()
            if i >= 2:
                out.append(1e3 * (time.perf_counter() - t0) / ticks)
        return out, state

    tick, (plant_end, _) = per_tick(chain, plant, ctrl)
    check(bool(torch.isfinite(plant_end.fb.pos).all()), "non-finite B=1 plant")
    ctl, _ = per_tick(controller_chain, ctrl)
    print(f"[single robot] B=1: composed tick median {statistics.median(tick):.3f} ms "
          f"(min {min(tick):.3f}, max {max(tick):.3f}); controller tick alone median "
          f"{statistics.median(ctl):.3f} ms (min {min(ctl):.3f}, max {max(ctl):.3f}); "
          f"{B1_CHAINS} chains of {ticks} ticks on {card}")


def all_launch_counts() -> dict:
    """Every kernel's launch count, by record name."""
    from quad_periodic_mpc_tpu_torch.runtime import graphs

    return graphs.launch_counts()


FS_KERNELS = ("fused_model_eval", "fused_wbc", "fused_substeps", "fused_stagewise_solve_srb",
              "fused_contact_kinematics")


def fs_counts() -> tuple:
    """The full stack's kernels' launch counts, in FS_KERNELS' order."""
    counts = all_launch_counts()
    return tuple(counts[k] for k in FS_KERNELS)


def estimation_path(device, card: str) -> int:
    """Path A, the state-estimation tick at B = BATCH through
    container.update(kf_backend="pallas").  Returns the fused_kf_innovate
    launches of the counted run."""
    import math

    import torch

    from quad_periodic_mpc_tpu_torch.control import leg_controller as lc
    from quad_periodic_mpc_tpu_torch.estimation import container
    from quad_periodic_mpc_tpu_torch.models.a1 import A1
    from quad_periodic_mpc_tpu_torch.ops import gait as G
    from quad_periodic_mpc_tpu_torch.ops.cuda import kf_kernel as FK
    from quad_periodic_mpc_tpu_torch.ops.rotations import rpy_to_quat

    B = BATCH
    f32 = dict(dtype=torch.float32, device=device)
    q = torch.tensor([0.0, 0.67, -1.3], **f32).expand(B, 4, 3).contiguous()
    qd, gyro = torch.zeros(B, 4, 3, **f32), torch.zeros(B, 3, **f32)
    accel = torch.tensor([0.0, 0.0, 9.81], **f32).expand(B, 3)      # at rest
    yaw = torch.linspace(-math.pi, math.pi, B, **f32)
    quat_imu = rpy_to_quat(torch.stack([torch.zeros_like(yaw), torch.zeros_like(yaw), yaw], -1))
    gait = G.preset("trotting", device=device)
    start = (torch.arange(B, dtype=torch.int32, device=device) * 7) % 208

    def tick(state, it, backend="pallas"):
        phase = G.contact_state(gait, G.phase(gait, start + it, 13))
        state, est = container.update(state, quat_imu, gyro, accel, q, qd, phase,
                                      kf_backend=backend)
        return state, est

    state = container.init((B,), device=device)
    torch.cuda.synchronize()
    FK.LAUNCHES = 0
    before = all_launch_counts()
    trust_open = trust_shut = False
    t0 = time.perf_counter()
    for it in range(EST_TICKS):
        state, est = tick(state, it)
        if it == EST_XLA_TICKS - 1:
            est_early, feet_early = est, state.kf.xhat[:, 6:]
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / EST_TICKS
    counts = all_launch_counts()
    launches = counts.pop("fused_kf_innovate")
    before.pop("fused_kf_innovate")
    check(launches == EST_TICKS and counts == before,
          f"estimation: expected {EST_TICKS} fused_kf_innovate launches and no other, counted "
          f"{launches} and {counts} (before: {before})")
    phases = torch.stack([G.contact_state(gait, G.phase(gait, start[:1] + it, 13))[0, 0]
                          for it in range(0, EST_TICKS, 13)])
    trust_open, trust_shut = bool((phases > 0.3).any()), bool((phases == 0).any())
    check(trust_open and trust_shut, "estimation: the contact phase did not open and close")

    yaw_out = float(est.rpy[:, 2].abs().max())
    v_max = float(est.v_world.abs().max())
    foot_z = lc.update_data(q, qd, A1).p[..., 2]                    # leg FK, body frame
    z_rel = est.position[:, 2:3] - state.kf.xhat[:, 8::3]           # body above each foot
    dz = float((z_rel + foot_z).abs().max())
    finite = all(bool(torch.isfinite(t).all()) for t in (*est, state.kf.P))
    print(f"[estimation] B={B}, {EST_TICKS} ticks of container.update(kf_backend='pallas'): "
          f"{ms:.3f} ms/tick, {B / ms * 1e3:.0f} instance-ticks/s, fused_kf_innovate launches "
          f"{launches}; max|yaw| {yaw_out:.2g} (< 1e-5), max|v| {v_max:.2g} (< 5e-3), height "
          f"above the feet within {dz:.2g} of the leg kinematics (< 0.02) on {card}")
    check(finite, "estimation: non-finite estimate")
    check(yaw_out < 1e-5, f"estimation: the IMU yaw was not zeroed: {yaw_out}")
    check(v_max < 5e-3, f"estimation: velocity did not settle: {v_max}")
    check(dz < 0.02, f"estimation: body height off the leg kinematics by {dz}")

    it0 = [EST_TICKS]

    def step(state, _):
        state, _est = tick(state, it0[0])
        it0[0] += 1
        return state, None

    profile_periods(step, state, None, n=EST_PROFILE_TICKS, unit="tick")

    # the dense chain ("xla" backend) through the same first ticks from a
    # cold start of its own (P0 = 100 I, the swing legs at trust 0): it
    # stays finite, settles and ends on the kernel's path
    tick(container.init((B,), device=device), 0, "xla")            # warms its operators
    xla_state = container.init((B,), device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for it in range(EST_XLA_TICKS):
        xla_state, est_x = tick(xla_state, it, "xla")
    torch.cuda.synchronize()
    xla_ms = 1e3 * (time.perf_counter() - t0) / EST_XLA_TICKS
    check(all(bool(torch.isfinite(t).all()) for t in (*est_x, xla_state.kf.P)),
          "estimation: the dense chain went non-finite")
    # what the filter observes: the velocity and the body's position from
    # each foot.  The absolute position is not observed (only p - p_foot is
    # measured): the offset it takes in the first ticks stays, and is printed
    from_feet = lambda est, feet: est.position[:, None, :] - feet.reshape(B, 4, 3)
    gap = max(_maxdiff(est_x.v_world, est_early.v_world),
              _maxdiff(from_feet(est_x, xla_state.kf.xhat[:, 6:]),
                       from_feet(est_early, feet_early)))
    v_x = float(est_x.v_world.abs().max())
    print(f"[estimation] the dense chain (kf_backend='xla') from a cold start: "
          f"{xla_ms:.3f} ms/tick over {EST_XLA_TICKS} ticks, finite; max|v| {v_x:.2g} (< 5e-3), "
          f"velocity and position from the feet within {gap:.2g} of the kernel's path at tick "
          f"{EST_XLA_TICKS} (< {EST_XLA_GAP}; the unobserved absolute position "
          f"{_maxdiff(est_x.position, est_early.position):.2g}) on {card}")
    check(v_x < 5e-3, f"estimation: the dense chain's velocity did not settle: {v_x}")
    check(gap < EST_XLA_GAP, f"estimation: the dense chain is {gap} off the kernel's path")
    return launches


def condensed_line(device, card: str, bf16: bool) -> int:
    """Path B, bench.py's condensed walking period at B = BATCH, h = HORIZON,
    ADMM-ADMM_ITERS in the fused ADMM kernel: warm periods, timed periods
    with the launch counts set to 0 just before and read just after, then
    the warm KKT audit (gated in float32; printed for bfloat16 storage).
    Returns the fused_admm_iterations launches of the timed periods."""
    import torch

    from quad_periodic_mpc_tpu_torch.config import ADMMConfig, EstimatorConfig, MPCConfig
    from quad_periodic_mpc_tpu_torch.ops import qp_admm
    from quad_periodic_mpc_tpu_torch.ops.cuda import admm_kernel as AK

    mpc_cfg, est_cfg = MPCConfig(horizon=HORIZON), EstimatorConfig()
    solver = ADMMConfig(iterations=ADMM_ITERS, backend="pallas", pallas_bf16_kinv=bf16)
    period = make_period(device, mpc_cfg, est_cfg, solver)
    tag = f"condensed {'bf16' if bf16 else 'f32'}"
    ctrl, plant, cmd, gait, dist = trot_inputs(device, formulation="condensed")
    for _ in range(CONDENSED_WARM):
        ctrl, plant, forces, _ = period(ctrl, plant, cmd, gait, dist)
    torch.cuda.synchronize()

    AK.LAUNCHES = 0
    before = all_launch_counts()
    times, all_finite = [], True
    for _ in range(CONDENSED_TIMED):
        t0 = time.perf_counter()
        ctrl, plant, forces, _ = period(ctrl, plant, cmd, gait, dist)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        all_finite &= bool(torch.isfinite(forces).all())
    counts = all_launch_counts()
    launches = counts.pop("fused_admm_iterations")
    before.pop("fused_admm_iterations")
    med = statistics.median(times)
    print(f"[{tag}] bench trot B={BATCH} h={HORIZON} ADMM-{ADMM_ITERS} condensed, "
          f"backend='pallas'{', pallas_bf16_kinv' if bf16 else ''}: {CONDENSED_WARM} warm "
          f"periods, {CONDENSED_TIMED} timed, median {med:.2f} ms/period (min {min(times):.2f}, "
          f"max {max(times):.2f}), {BATCH / med * 1e3:.0f} solves/s, fused_admm_iterations "
          f"launches {launches} on {card}")
    check(launches == CONDENSED_TIMED and counts == before,
          f"{tag}: expected {CONDENSED_TIMED} fused_admm_iterations launches and no other, "
          f"counted {launches} and {counts} (before: {before})")
    check(all_finite and bool(torch.isfinite(plant.x).all()), f"{tag}: non-finite state")
    height = float(plant.x[:, 5].mean())
    check(0.2 < height < 0.4, f"{tag}: body height {height} left [0.2, 0.4]")

    profile_periods(lambda c, p: period(c, p, cmd, gait, dist)[:2], ctrl, plant, n=2)

    ctrl, plant, forces, qp = period(ctrl, plant, cmd, gait, dist, return_qp=True)
    res = qp_admm.kkt_residuals(qp, ctrl.warm_x, ctrl.warm_z, ctrl.warm_y)
    primal, dual = float(res["primal"].max()), float(res["dual"].max())
    print(f"[{tag}] KKT audit of warm period {CONDENSED_WARM + CONDENSED_TIMED + 3}: primal max "
          f"{primal:.3g}, dual max {dual:.3g} (gates {KKT_PRIMAL} / {KKT_DUAL}"
          f"{'; reported, not gated' if bf16 else ''}), feasibility max "
          f"{float(res['feas'].max()):.3g}")
    if not bf16:
        check(primal < KKT_PRIMAL and dual < KKT_DUAL, f"{tag}: KKT gate failed")
    return launches


def slice4(device, card: str, records: dict) -> None:
    """Phases 9-10: the KF and ADMM kernels' records get the launches of
    their paths' counted runs."""
    kf, admm = records["fused_kf_innovate"], records["fused_admm_iterations"]
    kf["launches"] = estimation_path(device, card)
    admm["launches"] = condensed_line(device, card, bf16=False)
    admm["bf16_launches"] = condensed_line(device, card, bf16=True)
    for rec in (kf, admm):
        check(rec["launches"] > 0, f"{rec['name']} was launched on no driven path")


# ---------------------------------------------------------------------------
# slice 5: the estimator arms, tunables, GO1
# ---------------------------------------------------------------------------

def _slice5_configs(mode: str = "stagewise"):
    from quad_periodic_mpc_tpu_torch.config import ADMMConfig, LoopConfig, MPCConfig

    return MPCConfig(horizon=HORIZON), LoopConfig(), ADMMConfig(
        iterations=ADMM_ITERS, backend="pallas", formulation=mode)


def rollout_arm(device, card: str, tag: str, B: int, periods: int, est_cfg, dist=None,
                vx: float = VX, model=None, profile: bool = False):
    """loop.rollout of the bench trot at batch B for `periods` MPC periods
    through the fused-build kernel, the stagewise launch counts set to 0
    just before and read just after: one fused_stagewise_solve_srb launch a
    period and no other.  dist replaces the reference disturbance; vx the
    commanded speed; model the robot (A1 by default); profile: then two
    more periods under the profiler.  Returns (carry, trace, launches)."""
    import torch

    from quad_periodic_mpc_tpu_torch.control import loop as L
    from quad_periodic_mpc_tpu_torch.models.a1 import A1
    from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel as SK

    mpc_cfg, loop_cfg, solver = _slice5_configs()
    ctrl, plant, cmd, gait, ref_dist = trot_inputs(device, B)
    if vx != VX:
        ctrl = ctrl._replace(x_vel_des=torch.full_like(ctrl.x_vel_des, vx))
        cmd = cmd._replace(vx=torch.full_like(cmd.vx, vx))
    torch.cuda.synchronize()
    reset_stagewise_counts()
    t0 = time.perf_counter()
    carry, trace = L.rollout(periods, plant, ctrl, cmd, gait,
                             ref_dist if dist is None else dist, mpc_cfg, loop_cfg, est_cfg,
                             solver, model=model or A1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(SK.LAUNCHES)
    launches = counts["fused_stagewise_solve_srb"]
    print(f"[{tag}] loop.rollout B={B} {est_cfg.mode}/{est_cfg.residual}: {periods} periods "
          f"in {secs:.1f} s ({1e3 * secs / periods:.1f} ms/period), fused_stagewise_solve_srb "
          f"launches {launches} on {card}")
    check(launches == periods and sum(counts.values()) == launches,
          f"{tag}: expected {periods} fused-build launches and no other, counted {counts}")
    check(bool(torch.isfinite(trace.x).all()) and bool(torch.isfinite(trace.forces).all()),
          f"{tag}: non-finite rollout")
    if profile:
        def step(c, p):
            out = L.rollout(1, p, c, cmd, gait, ref_dist if dist is None else dist, mpc_cfg,
                            loop_cfg, est_cfg, solver, model=model or A1)[0]
            return out.ctrl, out.plant

        profile_periods(step, carry.ctrl, carry.plant, n=2)
    return carry, trace, launches


def _ratio_line(tag: str, what: str, ratio) -> float:
    import torch

    q = torch.quantile(ratio.double(), torch.tensor([0.05, 0.5, 0.95], dtype=torch.float64,
                                                    device=ratio.device))
    print(f"[{tag}] {what} ratio over the batch: p5 {float(q[0]):.4f}, p50 {float(q[1]):.4f}, "
          f"p95 {float(q[2]):.4f}, max {float(ratio.max()):.4f}")
    return float(q[1])


def lateral_wrench(B: int, device):
    """WrenchDisturbance.zero with component 4 (y acceleration) -0.6 +
    sin(2 pi 0.4 t): tests/test_estimator.py:233-268's disturbance."""
    import torch

    from quad_periodic_mpc_tpu_torch.sim import srb_sim as S

    dist = S.WrenchDisturbance.zero((B,), device=device)
    col = lambda t, v: torch.cat([t[:, :4], torch.full_like(t[:, 4:5], v), t[:, 5:]], dim=1)
    return dist._replace(static=col(dist.static, -0.6), amp=col(dist.amp, 1.0),
                         freq=col(dist.freq, 0.4))


def _arm_job(job: dict) -> dict:
    """One arm of phase 11 or 12 in a process of its own: rollout_arm (its
    launch count read in that process), then what the phase's gates read,
    on the CPU: the vx- and vy-rms over periods job["from"] on, instance
    0's fit."""
    import torch

    sys.path.insert(0, str(REPO))
    import quad_periodic_mpc_tpu_torch  # noqa: F401  (sets the f32 policy)
    from quad_periodic_mpc_tpu_torch.config import EstimatorConfig

    device = torch.device(job["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist = lateral_wrench(job["B"], device) if job["lateral"] else None
    carry, trace, launches = rollout_arm(device, job["card"], job["tag"], job["B"],
                                         job["periods"], EstimatorConfig(**job["est"]), dist,
                                         profile=True)
    x, est = trace.x[:, job["from"]:], carry.ctrl.est
    return {"launches": launches,
            "vx_rms": ((x[..., 9] - VX) ** 2).mean(dim=1).sqrt().cpu(),
            "vy_rms": (x[..., 10] ** 2).mean(dim=1).sqrt().cpu(),
            "f_hat": float(est.est_freq[0]), "amp_hat": float(est.est_amp[0]),
            "f6": float(est.est6_freq[0, 4]), "stat6": float(est.est6_stat[0, 4])}


def estimator_experiments(device, card: str, exp_B: int = BATCH,
                          exp_periods: int = EXP_PERIODS, lat_B: int = LAT_BATCH,
                          lat_periods: int = LAT_PERIODS) -> dict:
    """Phases 11 and 12, their four arms side by side, each in a spawned
    process (every period is host-bound, so one process would run them one
    after another; the card, 6 % busy with one, takes the four).

    Phase 11, the paper's experiment (tests/test_closed_loop.py:69-92) on
    the main path: the bench trot at batch exp_B under F_x = -10 + 15 sin(2
    pi 0.33 t) N, the periodic-adaptive MPC ("ls" on the discrete residual)
    against the non-adaptive baseline ("faithful" on the reference's
    residual, never released).  Instance 0 (gait phase 0, the reference
    test's robot) meets the reference test's gates, and the batch's median
    vx-rms ratio is under EXP_RATIO.

    Phase 12, ls6 under a lateral wrench (tests/test_estimator.py:233-268):
    the bench trot at batch lat_B under lateral_wrench, ls6 on the discrete
    residual against the same baseline; the batch's median vy-rms ratio over
    periods LAT_FROM on is under LAT_RATIO.

    Returns the fused-build launches of each phase's two arms."""
    import multiprocessing

    t0 = time.perf_counter()
    baseline = dict(mode="faithful", residual="reference", freeze_after=10 ** 9)
    arms = {("experiment", "adaptive"): (exp_B, exp_periods, EXP_FROM,
                                         dict(mode="ls", residual="discrete"), False),
            ("experiment", "baseline"): (exp_B, exp_periods, EXP_FROM, baseline, False),
            ("lateral", "ls6"): (lat_B, lat_periods, LAT_FROM,
                                 dict(mode="ls6", residual="discrete"), True),
            ("lateral", "baseline"): (lat_B, lat_periods, LAT_FROM, baseline, True)}
    jobs = [{"device": str(device), "card": card, "tag": f"{phase} {arm}", "B": B,
             "periods": n, "from": frm, "est": est, "lateral": lat}
            for (phase, arm), (B, n, frm, est, lat) in arms.items()]
    with concurrent.futures.ProcessPoolExecutor(
            len(jobs), mp_context=multiprocessing.get_context("spawn")) as pool:
        out = dict(zip(arms, pool.map(_arm_job, jobs)))
    print(f"[experiment] phases 11 and 12, four arms side by side, took "
          f"{time.perf_counter() - t0:.1f} s")

    tag, ad, off = "experiment", out["experiment", "adaptive"], out["experiment", "baseline"]
    ratio = ad["vx_rms"] / off["vx_rms"]
    print(f"[{tag}] instance 0: vx rms over periods {EXP_FROM}-{exp_periods} adaptive "
          f"{float(ad['vx_rms'][0]):.5f}, baseline {float(off['vx_rms'][0]):.5f}, ratio "
          f"{float(ratio[0]):.4f} (gate {EXP_RATIO}); f_hat {ad['f_hat']:.5f} Hz (gate |f - 0.33| "
          f"< 0.02), amp_hat {ad['amp_hat']:.4f} m/s^2 (gate 0.8-1.8)")
    median = _ratio_line(tag, "adaptive/baseline vx-rms", ratio)
    check(float(ratio[0]) < EXP_RATIO, f"{tag}: instance 0's ratio {float(ratio[0])}")
    check(abs(ad["f_hat"] - 0.33) < 0.02, f"{tag}: instance 0's fitted frequency {ad['f_hat']}")
    check(0.8 < ad["amp_hat"] < 1.8, f"{tag}: instance 0's fitted amplitude {ad['amp_hat']}")
    check(median < EXP_RATIO, f"{tag}: the batch's median ratio {median}")

    tag, on, off = "lateral", out["lateral", "ls6"], out["lateral", "baseline"]
    print(f"[{tag}] ls6 fit of instance 0, component 4: f {on['f6']:.4f} Hz (true 0.4), "
          f"offset {on['stat6']:.4f} (true -0.6)")
    median = _ratio_line(tag, "ls6/baseline vy-rms", on["vy_rms"] / off["vy_rms"])
    check(median < LAT_RATIO, f"{tag}: the batch's median ratio {median} (gate {LAT_RATIO})")
    return {phase: out[phase, a]["launches"] + out[phase, "baseline"]["launches"]
            for phase, a in (("experiment", "adaptive"), ("lateral", "ls6"))}


def tunable_period(device, card: str, B: int = BATCH) -> dict:
    """Phase 13a, the live-tunable parameters on the main path's solver:
    the bench trot at batch B after TUNE_WARM untuned periods; from one
    state the untuned period (fused build) against a period with
    TunableParams.from_config (caller-built solve) within TUNE_TOL; then the
    z weight x10, alpha 4e-4 and f_max 60 written into the same tensors
    (the forces change, every stance f_z within 60 + 1e-3) and TUNE_TIMED
    counted periods (one fused_stagewise_solve launch each, no fused-build
    launch); then swing_height 0.09 -> 0.18 written in, the swing apex up by
    more than 0.01 m.  Returns the counted launches."""
    import torch

    from quad_periodic_mpc_tpu_torch.config import EstimatorConfig, SwingConfig, TunableParams
    from quad_periodic_mpc_tpu_torch.control import mpc as M
    from quad_periodic_mpc_tpu_torch.models.a1 import A1
    from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel as SK
    from quad_periodic_mpc_tpu_torch.sim import srb_sim as S

    tag, t0 = "tunable", time.perf_counter()
    mpc_cfg, loop_cfg, solver = _slice5_configs()
    est_cfg, swing_cfg = EstimatorConfig(), SwingConfig()
    tun = TunableParams.from_config(mpc_cfg, loop_cfg, est_cfg, swing_cfg, device=device)
    untuned = make_period(device, mpc_cfg, est_cfg, solver)
    tuned = make_period(device, mpc_cfg, est_cfg, solver, tunable=tun)
    ctrl, plant, cmd, gait, dist = trot_inputs(device, B)
    for _ in range(TUNE_WARM):
        ctrl, plant, _, _ = untuned(ctrl, plant, cmd, gait, dist)
    _, _, f_plain, _ = untuned(ctrl, plant, cmd, gait, dist)
    _, _, f_default, _ = tuned(ctrl, plant, cmd, gait, dist)
    gap = _maxdiff(f_plain, f_default)
    print(f"[{tag}] B={B}: TunableParams.from_config against the untuned fused-build period: "
          f"max|dU| {gap:.3g} N (tol {TUNE_TOL})")
    check(gap <= TUNE_TOL, f"{tag}: the default tunables moved the forces by {gap}")

    w = tun.weights.clone()
    w[5] *= 10.0
    tun.weights.copy_(w)
    tun.alpha.copy_(torch.tensor(4e-4))
    tun.f_max.copy_(torch.tensor(60.0))
    torch.cuda.synchronize()
    reset_stagewise_counts()
    times, fz_max, first = [], 0.0, None
    for _ in range(TUNE_TIMED):
        t1 = time.perf_counter()
        ctrl, plant, forces, _ = tuned(ctrl, plant, cmd, gait, dist)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t1))
        first = forces if first is None else first
        fz_max = max(fz_max, float(forces[..., 2].max()))
    counts = dict(SK.LAUNCHES)
    changed = _maxdiff(first, f_plain)      # the same state as f_plain's
    print(f"[{tag}] retuned (z weight x10, alpha 4e-4, f_max 60 by copy_): {TUNE_TIMED} periods, "
          f"median {statistics.median(times):.2f} ms/period, the first period's forces "
          f"{changed:.3g} N from the untuned solve, largest f_z {fz_max:.5f} N (limit 60 + "
          f"1e-3); launches {counts} on {card}")
    launches = counts["fused_stagewise_solve"]
    check(launches == TUNE_TIMED and sum(counts.values()) == launches,
          f"{tag}: expected {TUNE_TIMED} fused_stagewise_solve launches and no other, "
          f"counted {counts}")
    profile_periods(lambda c, p: tuned(c, p, cmd, gait, dist)[:2], ctrl, plant, n=2)
    check(changed > 1.0, f"{tag}: the retune moved the forces by only {changed}")
    check(fz_max <= 60.0 + 1e-3, f"{tag}: a stance f_z of {fz_max} exceeds the retuned f_max")

    obs = S.observe(plant)
    ctrl_s = M.setup_command(ctrl, cmd, loop_cfg)
    swing = lambda: M.swing_update(ctrl_s, obs, cmd, gait, A1, swing_cfg, mpc_cfg, loop_cfg,
                                   loop_cfg.swing_height, tunable=tun)[1]
    low = swing()
    tun.swing_height.copy_(torch.tensor(0.18))
    high = swing()
    rise = float((high.p_foot_des - low.p_foot_des)[..., 2].max())
    print(f"[{tag}] swing_height 0.09 -> 0.18 by copy_: the swing apex rises by up to "
          f"{rise:.4f} m ({int((low.swing_state > 0).sum())} swinging feet)")
    check(rise > 0.01, f"{tag}: the swing apex rose by only {rise}")
    print(f"[{tag}] phase 13a took {time.perf_counter() - t0:.1f} s")
    return {"fused_stagewise_solve": launches}


def weight_sweep(device, card: str, B: int = BATCH, periods: int = SWEEP_PERIODS) -> int:
    """Phase 13b, per-instance tunables on the condensed line (backend
    "pallas", ADMM-30): z weights 5 / 50 / 500 / 5000 over four quarters of
    the batch, alpha 4e-5 and f_max 120 per instance; `periods` counted
    periods (one fused_admm_iterations launch each), forces that differ
    between the quarters at the same gait phase, and the warm KKT audit
    (6e-3 / 1e-3; the primal residual of the z weight 5000 quarter to
    SWEEP_W5000_PRIMAL).  Returns the counted launches."""
    import torch

    from quad_periodic_mpc_tpu_torch.config import EstimatorConfig, TunableParams
    from quad_periodic_mpc_tpu_torch.ops import qp_admm
    from quad_periodic_mpc_tpu_torch.ops.cuda import admm_kernel as AK

    tag, t0 = "weight sweep", time.perf_counter()
    mpc_cfg, loop_cfg, solver = _slice5_configs("condensed")
    est_cfg = EstimatorConfig()
    base = TunableParams.from_config(mpc_cfg, loop_cfg, est_cfg, device=device)
    q = B // 4
    w = base.weights.expand(B, 12).clone()
    w[:, 5] = torch.tensor([5.0, 50.0, 500.0, 5000.0], device=device).repeat_interleave(q)
    tun = base._replace(weights=w, alpha=torch.full((B,), 4e-5, device=device),
                        f_max=torch.full((B,), 120.0, device=device))
    period = make_period(device, mpc_cfg, est_cfg, solver, tunable=tun)
    ctrl, plant, cmd, gait, dist = trot_inputs(device, B, formulation="condensed")
    torch.cuda.synchronize()
    AK.LAUNCHES = 0
    before = all_launch_counts()
    for _ in range(periods):
        ctrl, plant, forces, _ = period(ctrl, plant, cmd, gait, dist)
    torch.cuda.synchronize()
    counts = all_launch_counts()
    launches = counts.pop("fused_admm_iterations")
    before.pop("fused_admm_iterations")
    check(launches == periods and counts == before,
          f"{tag}: expected {periods} fused_admm_iterations launches and no other, counted "
          f"{launches} and {counts}")
    check(bool(torch.isfinite(forces).all()) and bool(torch.isfinite(plant.x).all()),
          f"{tag}: non-finite state")
    profile_periods(lambda c, p: period(c, p, cmd, gait, dist)[:2], ctrl, plant, n=2)
    # the first instance of each quarter at gait phase 0 (0, 624, 1040, 1664
    # at B = 2048): the same start but for the weights
    same_phase = [g * q + (-(g * q)) % 208 for g in range(4)]
    gaps = [_maxdiff(forces[same_phase[g]], forces[same_phase[g + 1]]) for g in range(3)]
    ctrl, plant, forces, qp = period(ctrl, plant, cmd, gait, dist, return_qp=True)
    res = qp_admm.kkt_residuals(qp, ctrl.warm_x, ctrl.warm_z, ctrl.warm_y)
    primal, dual = float(res["primal"].max()), float(res["dual"].max())
    by_quarter = res["primal"].reshape(4, q).amax(dim=1)
    print(f"[{tag}] condensed B={B} ADMM-{ADMM_ITERS}, z weights 5/50/500/5000 by quarter: "
          f"{launches} fused_admm_iterations launches in {periods} periods; forces of instances "
          f"{same_phase} (gait phase 0) apart by {', '.join(f'{g:.3g}' for g in gaps)} N; KKT "
          f"audit of period {periods + 1}: primal max {primal:.3g} (by quarter "
          f"{', '.join(f'{float(v):.3g}' for v in by_quarter)}), dual max {dual:.3g} (gates "
          f"{KKT_PRIMAL} / {KKT_DUAL}; z weight 5000: {SWEEP_W5000_PRIMAL}) on {card}")
    check(min(gaps) > 1e-2, f"{tag}: the weight groups' forces do not differ: {gaps}")
    check(float(by_quarter[:3].max()) < KKT_PRIMAL and float(by_quarter[3]) < SWEEP_W5000_PRIMAL
          and dual < KKT_DUAL, f"{tag}: KKT gate failed")
    print(f"[{tag}] phase 13b took {time.perf_counter() - t0:.1f} s")
    return launches


def go1_rollout(device, card: str, B: int = GO1_BATCH, periods: int = GO1_PERIODS) -> int:
    """Phase 13c, the GO1 constants through loop.rollout (the reference's
    test_go1_model_pipeline at batch B): the trot at vx = 0.2, no
    disturbance, `periods` periods on the fused-build kernel; every state
    finite, the body height within 0.05 of 0.29.  Returns the launches."""
    import torch

    from quad_periodic_mpc_tpu_torch.config import EstimatorConfig
    from quad_periodic_mpc_tpu_torch.models.a1 import GO1
    from quad_periodic_mpc_tpu_torch.sim import srb_sim as S

    tag, t0 = "go1", time.perf_counter()
    carry, trace, launches = rollout_arm(
        device, card, tag, B, periods, EstimatorConfig(),
        dist=S.DisturbanceParams.zero((B,), device=device), vx=GO1_VX, model=GO1)
    err = float((carry.plant.x[:, 5] - 0.29).abs().max())
    print(f"[{tag}] body height after {periods} periods within {err:.4f} m of 0.29 (gate 0.05)")
    check(err < 0.05, f"{tag}: body height {err} from 0.29")
    print(f"[{tag}] phase 13c took {time.perf_counter() - t0:.1f} s")
    return launches


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def terrain_scenarios(B: int, device):
    """(riser, edge_x) per instance: instance 0 is tests/test_terrain_loop.py's
    robot (a 6 cm riser at 0.35 m), instances 1.. cycle through the 20 pairs of
    tests/test_sweep_terrain.py:106-107, risers fastest."""
    import torch

    pairs = [(r, e) for e in TERRAIN_EDGES for r in TERRAIN_RISERS]
    riser = [0.06] + [pairs[(i - 1) % len(pairs)][0] for i in range(1, B)]
    edge = [0.35] + [pairs[(i - 1) % len(pairs)][1] for i in range(1, B)]
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return f(riser), f(edge)


def terrain_inputs(device, B: int):
    """Phase 14's batch: the bench trot's gait phases ((7 i) mod 208) from
    rest at TERRAIN_VX, no disturbance, each instance's single step and its
    MAP_SIZE x MAP_SIZE map at MAP_RES (scenario.build_map).  Returns
    (terrain, map, plant, ctrl, cmd, gait, dist)."""
    import torch

    from quad_periodic_mpc_tpu_torch.control import mpc as M
    from quad_periodic_mpc_tpu_torch.ops import gait as G
    from quad_periodic_mpc_tpu_torch.sim import srb_sim as S
    from quad_periodic_mpc_tpu_torch.terrain import scenario as SC

    riser, edge = terrain_scenarios(B, device)
    terr = SC.StairsTerrain(edge_x=edge, riser=riser, tread=10.0, n_steps=1)
    hm = SC.build_map(terr, size=MAP_SIZE, resolution=MAP_RES)
    plant = S.init_plant((B,), body_height=0.29, device=device)
    ctrl = M.init_state((B,), S.observe(plant), horizon=HORIZON, formulation="stagewise")
    ctrl = ctrl._replace(
        iteration=(torch.arange(B, dtype=torch.int32, device=device) * 7) % 208)
    f32 = dict(dtype=torch.float32, device=device)
    cmd = M.Command(vx=torch.full((B,), TERRAIN_VX, **f32), vy=torch.zeros(B, **f32),
                    yaw_rate=torch.zeros(B, **f32), body_height=torch.full((B,), 0.29, **f32))
    return (terr, hm, plant, ctrl, cmd, G.preset("trotting", device=device),
            S.DisturbanceParams.zero((B,), device=device))


def terrain_period(hm, mpc_cfg, loop_cfg, est_cfg, solver):
    """The MPC step of one map-aware period, for kkt_audit: the map's
    body-height command, setup_command, mpc_step (the plant is not stepped)."""
    from quad_periodic_mpc_tpu_torch.control import loop as L
    from quad_periodic_mpc_tpu_torch.control import mpc as M
    from quad_periodic_mpc_tpu_torch.sim import srb_sim as S

    def period(ctrl, plant, cmd, gait, dist, return_qp=False):
        obs = S.observe(plant)
        cmd_t = L.terrain_command(hm, cmd, obs)
        ctrl = M.setup_command(ctrl, cmd_t, loop_cfg)
        out = M.mpc_step(ctrl, obs, cmd_t, gait, plant.t, mpc_cfg, loop_cfg, est_cfg, solver,
                         return_qp=return_qp)
        return out[0], plant, out[1], (out[2] if return_qp else None)

    return period


def terrain_arm(job: dict) -> dict:
    """One arm of phase 14 in a process of its own: loop.rollout of the
    terrain batch, map-aware (job["map"]) or terrain-blind, on the true
    surface, the stagewise launch counts set to 0 just before and read just
    after (one fused_stagewise_solve_srb launch a period, no other; one
    foothold_update launch a control tick on the map, none blind); two more
    periods under the profiler; the map-aware arm's warm KKT audit with the
    fused build dumped.  Returns the launches and what the gates read: each
    instance's final x and rms of the height-above-terrain error over the
    last TERRAIN_TAIL periods."""
    import torch

    sys.path.insert(0, str(REPO))
    import quad_periodic_mpc_tpu_torch  # noqa: F401  (sets the f32 policy)
    from quad_periodic_mpc_tpu_torch.config import EstimatorConfig
    from quad_periodic_mpc_tpu_torch.control import loop as L
    from quad_periodic_mpc_tpu_torch.ops.cuda import foothold_kernel as FHK
    from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel as SK
    from quad_periodic_mpc_tpu_torch.terrain import scenario as SC

    device = torch.device(job["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    tag, B, periods = job["tag"], job["B"], job["periods"]
    terr, hm, plant, ctrl, cmd, gait, dist = terrain_inputs(device, B)
    mpc_cfg, loop_cfg, solver = _slice5_configs()
    est_cfg = EstimatorConfig(mode="ls", residual="discrete")

    def run(n, p, c):
        return L.rollout(n, p, c, cmd, gait, dist, mpc_cfg, loop_cfg, est_cfg, solver,
                         heightmap=hm if job["map"] else None,
                         ground_fn=lambda xy: SC.ground_z(terr, xy))

    _sync(device)
    reset_stagewise_counts()
    FHK.LAUNCHES = 0
    t0 = time.perf_counter()
    carry, trace = run(periods, plant, ctrl)
    _sync(device)
    secs = time.perf_counter() - t0
    counts = dict(SK.LAUNCHES)
    launches, footholds = counts["fused_stagewise_solve_srb"], FHK.LAUNCHES
    if device.type == "cuda":      # one foothold update a control tick on the map
        ticks = periods * loop_cfg.iterations_between_mpc if job["map"] else 0
        check(footholds == ticks, f"{tag}: expected {ticks} foothold_update launches, "
              f"counted {footholds}")
    print(f"[{tag}] loop.rollout B={B}: {periods} periods in {secs:.1f} s "
          f"({1e3 * secs / periods:.1f} ms/period), fused_stagewise_solve_srb launches "
          f"{launches} ({launches / periods:g} a period) on {job['card']}")
    if device.type == "cuda":      # the counts count CUDA launches only
        check(launches == periods and sum(counts.values()) == launches,
              f"{tag}: expected {periods} fused-build launches and no other, counted {counts}")
    check(bool(torch.isfinite(trace.x).all()) and bool(torch.isfinite(trace.forces).all())
          and bool(torch.isfinite(carry.plant.p_feet).all()), f"{tag}: non-finite rollout")
    if device.type == "cuda":
        def step(c, p):
            out = run(1, p, c)[0]
            return out.ctrl, out.plant

        profile_periods(step, carry.ctrl, carry.plant, n=2)
    dumps = 0
    if job["map"]:
        reset_stagewise_counts()
        kkt_audit(tag, terrain_period(hm, mpc_cfg, loop_cfg, est_cfg, solver), carry.ctrl,
                  carry.plant, cmd, gait, dist, est_cfg, dump=True)
        audit = dict(SK.LAUNCHES)
        dumps = audit["srb_build_dump"]
        if device.type == "cuda":
            check(audit["fused_stagewise_solve_srb"] == 1 and dumps == 1,
                  f"{tag}: the audit launched {audit}")
    x = trace.x
    err = x[..., 5] - SC.ground_z(terr, x[..., 3:5]) - 0.29
    return {"launches": launches, "dumps": dumps, "footholds": footholds,
            "x_final": x[:, -1, 3].cpu(),
            "rms": err[:, -TERRAIN_TAIL:].pow(2).mean(dim=1).sqrt().cpu()}


def terrain_experiment(device, card: str, B: int = BATCH,
                       periods: int = TERRAIN_PERIODS) -> dict:
    """Phase 14, terrain in the loop (tests/test_terrain_loop.py:126-178's
    doorstep experiment at the bench's batch and solver): the map-aware and
    the terrain-blind arm side by side, a spawned process each.  Instance 0
    and the median over the instances with a riser meet
    test_terrain_rollout_beats_flat's gates.  Returns the launches of the
    kernels of the path, by name."""
    import multiprocessing

    import numpy as np

    t0 = time.perf_counter()
    jobs = [{"device": str(device), "card": card, "tag": f"terrain {arm}", "B": B,
             "periods": periods, "map": arm == "map"} for arm in ("map", "blind")]
    with concurrent.futures.ProcessPoolExecutor(
            len(jobs), mp_context=multiprocessing.get_context("spawn")) as pool:
        m, f = pool.map(terrain_arm, jobs)
    print(f"[terrain] phase 14, two arms side by side, took {time.perf_counter() - t0:.1f} s")
    riser = terrain_scenarios(B, "cpu")[0].numpy()
    xm, xf, rm, rf = (a.numpy() for a in (m["x_final"], f["x_final"], m["rms"], f["rms"]))
    stepped = riser > 0
    for what, pick in (("instance 0", lambda a: float(a[0])),
                       ("median over riser > 0", lambda a: float(np.median(a[stepped])))):
        fig = [pick(a) for a in (xm, xf, rm, rf, rm / rf)]
        print(f"[terrain] {what}: final x map {fig[0]:.4f}, blind {fig[1]:.4f} (gate > "
              f"{TERRAIN_X_MIN}); rms over the last {TERRAIN_TAIL} periods map {fig[2]:.5f} "
              f"(gate < {TERRAIN_RMS_MAP}), blind {fig[3]:.5f} (gate > {TERRAIN_RMS_FLAT}), "
              f"ratio {fig[4]:.4f} (gate < {TERRAIN_RATIO})")
        check(fig[0] > TERRAIN_X_MIN and fig[1] > TERRAIN_X_MIN and fig[2] < TERRAIN_RMS_MAP
              and fig[3] > TERRAIN_RMS_FLAT and fig[4] < TERRAIN_RATIO,
              f"terrain: {what} misses a gate: {fig}")
    flat = ~stepped
    print(f"[terrain] riser-0 instances ({int(flat.sum())}): largest |rms map - rms blind| "
          f"{np.abs(rm - rf)[flat].max():.3g} m, |x map - x blind| {np.abs(xm - xf)[flat].max():.3g} m")
    return {"fused_stagewise_solve_srb": m["launches"] + f["launches"],
            "srb_build_dump": m["dumps"], "foothold_update": m["footholds"]}


def camera(device):
    """The depth camera on each robot: R_base_sensor (optical axis forward,
    pitched down by CAM_PITCH; x right, y down), t_base_sensor, and the
    SCAN_SIDE x SCAN_SIDE subsample of its CAM_H x CAM_W image: pixel
    (row, col) coordinates and rays in the sensor frame (z = 1)."""
    import math

    import torch

    f32 = dict(dtype=torch.float32, device=device)
    c, s = math.cos(CAM_PITCH), math.sin(CAM_PITCH)
    pitch = torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], **f32)
    axes = torch.tensor([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]], **f32)
    k = torch.arange(SCAN_SIDE, **f32) + 0.5
    v, u = torch.meshgrid(k * (CAM_H / SCAN_SIDE), k * (CAM_W / SCAN_SIDE), indexing="ij")
    u, v = u.reshape(-1), v.reshape(-1)
    rays = torch.stack([(u - CAM_W / 2) / CAM_F, (v - CAM_H / 2) / CAM_F, torch.ones_like(u)], -1)
    return pitch @ axes, torch.tensor(CAM_T, **f32), torch.stack([v, u], -1), rays


def depth_scan(terr, p_base, cam):
    """Each robot's noise-free scan of its single step (flat z = 0 before
    edge_x, z = riser from it on), robot yaw 0: the first hit of every ray
    with the floor, the riser's face or its top; a ray that hits nothing gets
    depth 100 m, outside the stereo cutoff.  Returns sensor-frame points
    (B, n, 3)."""
    import torch

    R_bs, t_bs, _, rays = cam
    d = rays @ R_bs.T                                      # (n, 3), world = base frame
    o = p_base + t_bs                                      # (B, 3)
    dx, dz = d[:, 0][None], d[:, 2][None]
    ox, oz = o[:, 0:1], o[:, 2:3]
    e, r = terr.edge_x[:, None], terr.riser[:, None]
    inf = torch.full_like(ox * dx, float("inf"))
    down = dz < 0
    t_floor = torch.where(down, -oz / torch.where(down, dz, -1.0), inf)
    t_floor = torch.where(ox + t_floor * dx < e, t_floor, inf)
    t_top = torch.where(down, (r - oz) / torch.where(down, dz, -1.0), inf)
    t_top = torch.where((ox + t_top * dx >= e) & (t_top > 0), t_top, inf)
    fwd = dx > 0
    t_face = torch.where(fwd, (e - ox) / torch.where(fwd, dx, 1.0), inf)
    z_face = oz + t_face * dz
    t_face = torch.where((t_face > 0) & (z_face >= 0) & (z_face <= r), t_face, inf)
    t = torch.minimum(torch.minimum(t_floor, t_top), t_face)
    depth = torch.where(torch.isfinite(t), t, torch.full_like(t, 100.0))
    return depth[..., None] * rays


def _to_cpu(a):
    import torch

    if isinstance(a, torch.Tensor):
        return a.cpu()
    if isinstance(a, dict):
        return {k: _to_cpu(v) for k, v in a.items()}
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*(_to_cpu(v) for v in a))
    if isinstance(a, (tuple, list)):
        return type(a)(_to_cpu(v) for v in a)
    return a


def _named_leaves(a, name=""):
    """(field name, tensor) of every tensor in a (nested) result."""
    import torch

    if isinstance(a, torch.Tensor):
        return [(name, a)]
    if isinstance(a, dict):
        return [x for k, v in a.items() for x in _named_leaves(v, k)]
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return [x for k, v in zip(a._fields, a) for x in _named_leaves(v, k)]
    if isinstance(a, (tuple, list)):
        return [x for i, v in enumerate(a) for x in _named_leaves(v, f"{name}{i}")]
    return []


def stage_error(out, ref) -> float:
    """The largest error of a stage's card result against the CPU port's:
    |card - cpu| / max(|cpu|, MAPPING_SCALE) over every float field (a
    variance field relative to itself; equal values, infinities too, and NaN
    against NaN count 0), inf where an integer or boolean field differs."""
    import torch

    worst = 0.0
    for (name, a), (_, b) in zip(_named_leaves(out), _named_leaves(ref)):
        a = a.cpu()
        if not a.is_floating_point():
            worst = max(worst, 0.0 if torch.equal(a, b) else float("inf"))
            continue
        floor = 1e-30 if name == "variance" else MAPPING_SCALE
        gap = (a - b).abs() / torch.clamp(b.abs(), min=floor)
        gap = torch.where((a == b) | (a.isnan() & b.isnan()), torch.zeros_like(gap), gap)
        worst = max(worst, float(gap.nan_to_num(float("inf")).max()))
    return worst


def mapping_tick(hm, scan, source, cam, errors=None):
    """One elevation-mapping tick of every robot: predict -> motion_update ->
    InputSource.process (stereo, depth cutoff, multi-height gate) ->
    visibility_cleanup -> move (to the robot) -> fuse_area -> postprocess ->
    compute_traversability.  Returns (the Kalman map carried to the next
    tick, the traversability map the planner reads).  errors: a dict into
    which each stage writes its stage_error against the CPU port run on the
    same inputs copied to the CPU (None: no comparison)."""
    import torch

    from quad_periodic_mpc_tpu_torch.terrain import heightmap as H
    from quad_periodic_mpc_tpu_torch.terrain import postprocess as PP
    from quad_periodic_mpc_tpu_torch.terrain import sensor as SE

    def stage(name, fn, *args):
        out = fn(*args)
        if errors is not None:
            errors[name] = max(errors.get(name, 0.0), stage_error(out, fn(*_to_cpu(args))))
        return out

    pts, p_base = scan
    R_bs, t_bs, pix, _ = cam
    B = p_base.shape[0]

    def frame(p):
        """The poses on p's device: R_map_base (yaw 0), R_base_sensor,
        t_base_sensor, t_map_base, and the pose covariance."""
        eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(B, 3, 3)
        return eye, R_bs.to(p.device), t_bs.to(p.device), p_base.to(p.device), MAPPING_POSE_VAR * eye

    def fuse(m, p):
        R_mb, R_bs_, t_bs_, t_mb, cov = frame(p)
        return source.process(m, p, R_mb, R_bs_, t_bs_, t_mb, cov, pixel_ij=pix.to(p.device),
                              mahalanobis_threshold=MAPPING_MAHALANOBIS)

    def scan_points(p):
        R_mb, R_bs_, t_bs_, t_mb, cov = frame(p)
        p_map, var = SE.process_points(p, source.processor, R_mb, R_bs_, t_bs_, t_mb, cov,
                                       pixel_ij=pix.to(p.device))
        var = torch.where(source.processor.depth_mask(p), torch.clamp(var, min=1e-9),
                          torch.full_like(var, float("inf")))
        return {"points": p_map, "variance": var}

    eye, *_, cov = frame(pts)
    hm = stage("predict", H.predict, hm, MAPPING_PROCESS_VAR)
    hm = stage("motion_update", H.motion_update, hm, cov, eye)
    hm = stage("process", fuse, hm, pts)
    cloud = stage("points", scan_points, pts)
    hm = stage("visibility_cleanup", lambda m, c, s: H.visibility_cleanup(
        m, c["points"], c["variance"], s, MAPPING_RAY_SAMPLES), hm, cloud, p_base + t_bs)
    hm = stage("move", H.move, hm, p_base[:, :2])
    mean = stage("fuse_area", H.fuse_area, hm)[0]
    post = stage("postprocess", PP.postprocess, hm._replace(elevation=mean))
    trav = stage("traversability", H.compute_traversability, post)
    return hm, trav


def elevation_mapping(device, card: str, B: int = MAPPING_BATCH,
                      ticks: int = MAPPING_TICKS, check_ticks=MAPPING_CHECK_TICKS,
                      plan_check: int = MAPPING_PLAN_CHECK) -> None:
    """Phase 15, the elevation-mapping tick of B robots, each walking at
    MAPPING_STEP a tick onto its own single step (risers 3 / 6 / 9 cm, edges
    0.20-0.40 m) with a SCAN_SIDE^2-point stereo scan a tick (noise-free,
    depth_scan) and a MAP_SIZE^2 map at MAP_RES that moves with it; then one
    footstep plan and path on the last traversability map.  The ticks in
    check_ticks are held stage by stage to the CPU port on the same inputs
    (MAPPING_TOL; 0 = equal), and so are the first plan_check robots' plan
    and path; every observed cell of the Kalman map away from the riser
    converges to the true step (tests/test_terrain.py::test_fuse_convergence's
    1e-3)."""
    import torch

    from quad_periodic_mpc_tpu_torch.terrain import footstep_planner as FP
    from quad_periodic_mpc_tpu_torch.terrain import heightmap as H
    from quad_periodic_mpc_tpu_torch.terrain import scenario as SC
    from quad_periodic_mpc_tpu_torch.terrain.input_sources import InputSourceManager

    t_phase = time.perf_counter()
    mgr = InputSourceManager()
    check(mgr.configure({"front_stereo": {
        "type": "pointcloud", "topic": "/front/points", "queue_size": 1,
        "publish_on_update": True, "sensor_processor": {"type": "stereo", **STEREO}}}),
        f"mapping: input sources rejected: {mgr.errors}")
    source = mgr.sources[0]
    pairs = [(r, e) for e in TERRAIN_EDGES for r in TERRAIN_RISERS if r > 0]
    f32 = dict(dtype=torch.float32, device=device)
    terr = SC.StairsTerrain(
        edge_x=torch.tensor([pairs[i % len(pairs)][1] for i in range(B)], **f32),
        riser=torch.tensor([pairs[i % len(pairs)][0] for i in range(B)], **f32),
        tread=10.0, n_steps=1)
    cam = camera(device)

    def robot(k):
        x = terr.edge_x - MAPPING_START + MAPPING_STEP * k
        xy = torch.stack([x, torch.zeros_like(x)], -1)
        return torch.cat([xy, (SC.ground_z(terr, xy) + 0.29)[:, None]], -1)

    hm = H.create(size=MAP_SIZE, resolution=MAP_RES, batch=(B,), device=device)
    hm = hm._replace(center=robot(0)[:, :2].clone())
    times, errors = [], {}
    for k in range(ticks):
        p_base = robot(k)
        scan = (depth_scan(terr, p_base, cam), p_base)
        _sync(device)
        t0 = time.perf_counter()
        hm_next, trav = mapping_tick(hm, scan, source, cam)
        _sync(device)
        times.append(1e3 * (time.perf_counter() - t0))
        if k in check_ticks:
            mapping_tick(hm, scan, source, cam, errors)
        hm = hm_next
    n_pts = scan[0].shape[1]
    valid = float(source.processor.depth_mask(scan[0]).float().mean())
    print(f"[mapping] B={B}, {n_pts} points a robot a tick ({100 * valid:.1f}% inside the depth "
          f"cutoff at the last tick): {ticks} ticks, median {statistics.median(times):.2f} "
          f"ms/tick (min {min(times):.2f}, max {max(times):.2f}) on {card}")
    if device.type == "cuda":
        profile_periods(lambda m, s: (mapping_tick(m, s, source, cam)[0], s), hm, scan, n=2,
                        unit="tick")

    # one plan and path on the last traversability map, from the robot's cell
    # to the cell MAPPING_GOAL ahead
    xy = robot(ticks - 1)[:, :2]
    start = H.world_to_index(trav, xy)
    goal = H.world_to_index(trav, xy + torch.tensor([MAPPING_GOAL, 0.0], **f32))
    _sync(device)
    t0 = time.perf_counter()
    plan = FP.plan(trav, goal)
    path = FP.extract_path(plan, start, MAPPING_PATH_STEPS)
    _sync(device)
    plan_ms = 1e3 * (time.perf_counter() - t0)
    sub = lambda a: _to_cpu(a)[:plan_check]
    cpu_map = H.HeightMap(*(sub(a) for a in trav[:4]), trav.resolution)
    ref_plan = FP.plan(cpu_map, sub(goal))
    ref_path = FP.extract_path(ref_plan, sub(start), MAPPING_PATH_STEPS)
    errors["plan"] = stage_error((plan.value[:plan_check], path[:plan_check]),
                                 (ref_plan.value, ref_path))
    reached = float((path[:, -1] == goal).all(-1).float().mean())
    print(f"[mapping] footstep plan ({MAP_SIZE + MAP_SIZE} sweeps) and a {MAPPING_PATH_STEPS}-step "
          f"path: {plan_ms:.1f} ms; {100 * reached:.1f}% of the paths end at the goal")
    print(f"[mapping] card vs CPU port on the same inputs (ticks {list(check_ticks)}, the plan "
          f"of robots 0-{plan_check - 1}), largest error by stage: "
          + ", ".join(f"{k} {v:.3g} (tol {MAPPING_TOL[k]:g})" for k, v in errors.items()))
    for k, v in errors.items():
        check(v <= MAPPING_TOL[k], f"mapping: stage {k} is {v} from the CPU port")

    # the Kalman map converges to the true step, away from the riser's cells
    c = torch.arange(MAP_SIZE, device=device)
    x_hi = hm.center[:, 0:1] + MAP_RES * ((MAP_SIZE // 2) - c)            # cell x in (x_hi - res, x_hi]
    y_hi = hm.center[:, 1:2] + MAP_RES * (c - (MAP_SIZE // 2))
    x_mid = (x_hi - MAP_RES / 2)[:, None, :].expand(B, MAP_SIZE, MAP_SIZE)
    y_mid = (y_hi - MAP_RES / 2)[:, :, None].expand(B, MAP_SIZE, MAP_SIZE)
    truth = SC.ground_z(terr, torch.stack([x_mid, y_mid], -1))
    clear = (x_mid - terr.edge_x[:, None, None]).abs() > 2 * MAP_RES
    seen = (hm.variance < 1.0) & clear
    top = seen & (x_mid > terr.edge_x[:, None, None])
    err = torch.where(seen, (hm.elevation - truth).abs(), torch.zeros_like(truth))
    per_robot = (seen.sum((1, 2)).min().item(), top.sum((1, 2)).min().item())
    print(f"[mapping] Kalman map after {ticks} ticks: largest |elevation - true| over the "
          f"observed cells clear of the riser {float(err.max()):.3g} m (gate "
          f"{MAPPING_CONVERGED}); fewest such cells a robot {per_robot[0]}, on the step "
          f"{per_robot[1]}")
    check(float(err.max()) < MAPPING_CONVERGED, "mapping: the map did not converge to the step")
    check(per_robot[0] >= MAPPING_MIN_CELLS and per_robot[1] >= MAPPING_MIN_CELLS // 4,
          f"mapping: too few observed cells {per_robot}")
    check(bool(torch.isfinite(trav.traversability).all()), "mapping: non-finite traversability")
    print(f"[mapping] phase 15 took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# slice 7: the sweeps (phase 16)
# ---------------------------------------------------------------------------

def reset_all_counts() -> None:
    """Every kernel wrapper's launch count set to 0."""
    from quad_periodic_mpc_tpu_torch.runtime import graphs

    graphs.reset_launches()


def dryrun_expected(tier: str, backend: str, entries: int) -> dict:
    """The launches a dry-run tier must count, by kernel (every other kernel
    0): a period of each of the split run's entries and of the oracle."""
    runs = entries + 1
    if tier == "2":
        return {"fused_stagewise_solve_srb": 8 * runs}
    if backend != "pallas":
        return {}
    if tier == "1":
        return {"fused_admm_iterations": 16 * runs}
    # tier 3: two full-stack periods of 13 ticks, and the one start-up
    # observation of the whole batch
    return {"fused_model_eval": 26 * runs, "fused_wbc": 26 * runs, "fused_substeps": 26 * runs,
            "fused_admm_iterations": 2 * runs, "fused_contact_kinematics": 1}


def _dryrun_job(job: dict) -> dict:
    """One tier (or one estimator arm of tier 1b) of the dry run in a process
    of its own, on an entries-long mesh of the one device; the launch counts
    set to 0 just before and read just after.  Returns the tier's figures,
    the counts, the seconds and the peak device memory."""
    import torch

    sys.path.insert(0, str(REPO))
    import quad_periodic_mpc_tpu_torch  # noqa: F401  (sets the f32 policy)
    from quad_periodic_mpc_tpu_torch.parallel import dryrun

    device = torch.device(job["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    reset_all_counts()
    t0 = time.perf_counter()
    out = dryrun.dryrun_multichip(job["entries"], devices=[device] * job["entries"],
                                  tiers=(job["tier"],), arms=job["arms"],
                                  backend=job["backend"])[job["tier"]]
    _sync(device)
    return {"out": out, "launches": all_launch_counts(), "secs": time.perf_counter() - t0,
            "peak": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0}


def _close(a, b, atol: float, rtol: float) -> bool:
    import torch

    return bool(torch.isclose(torch.as_tensor(a, dtype=torch.float64),
                              torch.as_tensor(b, dtype=torch.float64),
                              atol=atol, rtol=rtol).all())


def bucket_selection(device) -> None:
    """Phase 16a's first check: the Newton-Schulz bucket's escalated set
    (``linalg._escalated``) on the card equals the CPU's, and lax.top_k's
    on SELECTION_CASES."""
    import torch

    from quad_periodic_mpc_tpu_torch.ops import linalg

    g = torch.Generator().manual_seed(15)
    big = torch.floor(torch.rand(SELECTION_B, generator=g) * 61) / 64
    big[torch.randint(SELECTION_B, (20,), generator=g)] = float("nan")
    cases = {**{k: (torch.tensor(r), 2, want) for k, (r, want) in SELECTION_CASES.items()},
             "seeded": (big, 4, None)}
    for name, (r, frac, want) in cases.items():
        cpu = linalg._escalated(r, frac).tolist()
        on_card = linalg._escalated(r.to(device), frac).cpu().tolist()
        check(on_card == cpu and (want is None or cpu == want),
              f"bucket selection {name}: card {on_card[:8]}, CPU {cpu[:8]}, lax.top_k {want}")
    print(f"[dry run] the bucket's escalated set on the card equals the CPU's (and lax.top_k's "
          f"on the tied and NaN residuals): {', '.join(cases)} (B = {SELECTION_B}, "
          f"{len(cpu)} escalated)")


def dryrun_on_card(device, card: str, entries: int = DRYRUN_ENTRIES, ref=None) -> dict:
    """Phase 16a: parallel/dryrun.dryrun_multichip on a mesh of `entries`
    copies of the one card, its tiers (and tier 1b's three arms) side by side
    in spawned processes, each tier split against its oracle inside
    (atol 5e-4, rtol 1e-3; tier 3 atol 1e-4).  The oracles' figures are held
    to JAX's (`ref`, at eight entries; None skips that), the best instance
    and the argmin arm under the tie rule.  Tier 1 again with the ADMM in
    fused_admm_iterations and tier 3 with every torque-tick kernel are held
    to their "xla" twins.  Returns the launches by kernel."""
    import multiprocessing

    from quad_periodic_mpc_tpu_torch.parallel import dryrun

    bucket_selection(device)
    jobs = {("1", "xla"): ("1", "xla", None), ("1", "pallas"): ("1", "pallas", None),
            ("2", "pallas"): ("2", "pallas", None),
            **{("1b", arm): ("1b", "xla", (arm,)) for arm in dryrun.ARMS},
            ("3", "xla"): ("3", "xla", None), ("3", "pallas"): ("3", "pallas", None)}
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            len(jobs), mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {key: pool.submit(_dryrun_job, {
            "device": str(device), "entries": entries, "tier": t, "backend": b,
            "arms": arms or dryrun.ARMS}) for key, (t, b, arms) in jobs.items()}
        res = {key: f.result() for key, f in futures.items()}
    print(f"[dry run] phase 16a: {len(jobs)} tiers and arms side by side on {entries} entries "
          f"of one card took {time.perf_counter() - t0:.1f} s")
    total: dict = {}
    for (tier, backend), r in res.items():
        want = dryrun_expected(tier, backend, entries)
        got = {k: v for k, v in r["launches"].items() if v}
        print(f"[dry run] tier {tier} {backend}: {r['secs']:.1f} s, launches {got}, peak "
              f"memory {r['peak'] / 2**20:.1f} MiB on {card}")
        if device.type == "cuda":   # the counts count CUDA launches only
            check(got == want, f"dry run tier {tier} {backend}: launches {got}, expected {want}")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v

    t1, t2, t3 = res["1", "xla"]["out"], res["2", "pallas"]["out"], res["3", "xla"]["out"]
    arms = {arm: res["1b", arm]["out"]["arms"][arm] for arm in dryrun.ARMS}
    means = [arms[a]["oracle_mean"] for a in dryrun.ARMS]
    pick = min(range(len(means)), key=means.__getitem__)
    split_pick = min(range(len(means)), key=lambda i: arms[dryrun.ARMS[i]]["mean"])
    check(split_pick == pick or abs(means[split_pick] - means[pick])
          <= dryrun.ATOL + dryrun.RTOL * means[pick],
          f"dry run tier 1b: argmin arm split {dryrun.ARMS[split_pick]} oracle "
          f"{dryrun.ARMS[pick]}")
    print(f"[dry run] oracles: tier 1 mean vx_rms {t1['oracle_mean']:.8f}, best "
          f"{t1['oracle_best']} (split {t1['best']}); tier 1b " + ", ".join(
              f"{a} {m:.8f}" for a, m in zip(dryrun.ARMS, means))
          + f", argmin {dryrun.ARMS[pick]!r}; tier 2 {t2['oracle_mean']:.8f}; tier 3 mean z "
          f"{t3['oracle_zmean']:.8f}; split gaps {t1['max_gap']:.3g} / {t2['max_gap']:.3g} / "
          f"{t3['max_gap']:.3g}")
    split_gaps = {"tier 1": t1["max_gap"], "tier 1 pallas": res["1", "pallas"]["out"]["max_gap"],
                  **{f"tier 1b {a}": arms[a]["max_gap"] for a in dryrun.ARMS}}
    print(f"[dry run] split in lockstep against the oracle, max |vx_rms gap| (each chunk "
          f"deciding alone: tier 1 {SPLIT_GAP_BEFORE:g}; bound {SPLIT_GAP:g}): " + ", ".join(
              f"{k} {v:.3g}" for k, v in split_gaps.items()))
    for k, v in split_gaps.items():
        check(v <= SPLIT_GAP, f"dry run {k}: split against oracle {v:.3g} > {SPLIT_GAP:g}")
    if ref is not None:
        tol = dict(atol=dryrun.ATOL, rtol=dryrun.RTOL)
        figures = [("tier 1 mean", t1["oracle_mean"], ref["1"]["mean"]),
                   ("tier 2 mean", t2["oracle_mean"], ref["2"]["mean"]),
                   ("tier 3 mean z", t3["oracle_zmean"], ref["3"]["zmean"])]
        figures += [(f"tier 1b {a}", m, ref["1b"][a]) for a, m in zip(dryrun.ARMS, means)]
        for what, got, want in figures:
            check(_close(got, want, **tol), f"dry run {what}: {got} against JAX's {want}")
        # the tie rule against JAX's two smallest tier-1 errors
        r1, best = ref["1"], t1["oracle_best"]
        near_tie = r1["next"] - r1["min"] < dryrun.ATOL + dryrun.RTOL * r1["min"]
        check(best == r1["best"] or (near_tie and _close(
            t1["oracle_vx_rms"][best], r1["min"], **tol)),
            f"dry run tier 1: best instance {best} against JAX's {r1['best']}")
        check(dryrun.ARMS[pick] == min(ref["1b"], key=ref["1b"].get),
              f"dry run tier 1b: argmin arm {dryrun.ARMS[pick]!r}")
        print(f"[dry run] the oracles equal JAX's figures within atol {dryrun.ATOL}, rtol "
              f"{dryrun.RTOL}: tier 1 best instance {best} (JAX {r1['best']}), argmin arm "
              f"{dryrun.ARMS[pick]!r}")
    # the kernels against their "xla" twins, split and oracle
    p1, p3 = res["1", "pallas"]["out"], res["3", "pallas"]["out"]
    gaps = {}
    for key in ("vx_rms", "oracle_vx_rms", "height_rms", "oracle_height_rms"):
        gaps[f"tier 1 {key}"] = float((p1[key] - t1[key]).abs().max())
        check(_close(p1[key], t1[key], dryrun.ATOL, dryrun.RTOL),
              f"dry run tier 1: the ADMM kernel's {key} against the xla loop's")
    for key in ("pos", "oracle_pos"):
        gaps[f"tier 3 {key}"] = float((p3[key] - t3[key]).abs().max())
        check(_close(p3[key], t3[key], dryrun.FS_ATOL, dryrun.RTOL),
              f"dry run tier 3: the kernels' {key} against the xla path's")
    print("[dry run] kernels against the xla twins: " + ", ".join(
        f"{k} {v:.3g}" for k, v in gaps.items()))
    return total


def timed_sweep(tag: str, device, card: str, spec, periods: int, mesh=None, **kw):
    """run_sweep with the launch counts set to 0 just before and read just
    after, its wall time, its peak device memory and every metric finite.
    Returns (result, launches by kernel, {run_s, periods, peak_mib})."""
    import torch

    from quad_periodic_mpc_tpu_torch.parallel import sweep as SW

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    reset_all_counts()
    t0 = time.perf_counter()
    res = SW.run_sweep(spec, n_mpc_steps=periods, mesh=mesh, device=device, **kw)
    _sync(device)
    secs = time.perf_counter() - t0
    launches = {k: v for k, v in all_launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated(device) / 2**20 if device.type == "cuda" else 0.0
    entries = 1 if mesh is None else mesh.size
    print(f"[{tag}] run_sweep B={res.batch} on {entries} entr{'y' if entries == 1 else 'ies'}: "
          f"{periods} periods in {secs:.2f} s ({1e3 * secs / periods:.1f} ms/period with the "
          f"set-up), launches {launches}, peak memory {peak:.1f} MiB; mean vx_rms "
          f"{float(res.mean_vx_rms):.6f}, best instance {int(res.best_instance)} on {card}")
    check(res.batch == spec.size and res.vx_rms.shape == (spec.size,), f"{tag}: batch")
    check(bool(torch.isfinite(res.vx_rms).all()) and bool(torch.isfinite(res.height_rms).all()),
          f"{tag}: non-finite metrics at instances "
          f"{torch.nonzero(~torch.isfinite(res.vx_rms)).flatten().tolist()[:10]}")
    check(0 <= int(res.best_instance) < res.batch, f"{tag}: best instance out of range")
    return res, launches, {"run_s": secs, "periods": periods, "peak_mib": peak}


def sweep_periods(tag: str, spec, device, card: str, solver) -> dict:
    """The sweep's periods without its set-up, on one entry: the chunk built
    once (sweep.build_chunks, timed: scenarios, plant, controller, maps),
    one warm period, SWEEP_TIMED_PERIODS periods in one rollout timed, then
    two one-period rollouts under the profiler.  Outside the counted runs.
    Returns the figures of PERF.md's "where the time goes"."""
    import torch

    from quad_periodic_mpc_tpu_torch.config import LoopConfig
    from quad_periodic_mpc_tpu_torch.parallel import mesh as ML
    from quad_periodic_mpc_tpu_torch.parallel import sweep as SW

    cfg = (SW.DEFAULT_MPC, LoopConfig(), SW.DEFAULT_EST, solver)
    _sync(device)
    t0 = time.perf_counter()
    (chunk,) = SW.build_chunks(spec, ML.make_mesh(devices=[device]), SW.DEFAULT_MPC,
                               SW.DEFAULT_EST, solver, torch.float32)
    _sync(device)
    setup_s = time.perf_counter() - t0

    def step(ctrl, plant):
        carry, _ = SW.rollout_chunk(1, chunk._replace(plant=plant, ctrl=ctrl), *cfg)
        return carry.ctrl, carry.plant

    ctrl, plant = step(chunk.ctrl, chunk.plant)
    _sync(device)
    t0 = time.perf_counter()
    SW.rollout_chunk(SWEEP_TIMED_PERIODS, chunk._replace(plant=plant, ctrl=ctrl), *cfg)
    _sync(device)
    ms = 1e3 * (time.perf_counter() - t0) / SWEEP_TIMED_PERIODS
    print(f"[{tag}] set-up (scenarios, plant, controller, maps) {setup_s:.3f} s; after it and "
          f"a warm period {ms:.2f} ms/period over {SWEEP_TIMED_PERIODS} periods on {card}")
    prof = profile_periods(step, ctrl, plant, n=2) or {}
    return {"setup_s": setup_s, "ms_per_period": ms,
            "device_ms_per_period": prof.get("device_ms"),
            "busy_pct": 100 * prof["device_ms"] / prof["wall_ms"] if prof else None,
            "launches_per_period": prof.get("launches")}


def _fused_build_only(tag: str, device, launches: dict, n: int) -> None:
    if device.type == "cuda":       # the counts count CUDA launches only
        check(launches == {"fused_stagewise_solve_srb": n},
              f"{tag}: expected {n} fused-build launches and no other, counted {launches}")


def gait_sweep(device, card: str, phases: int = CONFIG3_PHASES,
               periods: int = CONFIG3_PERIODS, split: int = CONFIG3_SPLIT) -> dict:
    """Phase 16b, BASELINE.json config 3: SweepSpec()'s four gaits x `phases`
    phase offsets under the reference disturbance at vx = 0.3, "ls" on the
    discrete residual, stagewise ADMM-30 at h = 10 in the fused-build kernel,
    `periods` periods: every metric finite, one fused_stagewise_solve_srb
    launch a period and no other; again split over `split` entries of the
    card, held to the first (atol 5e-4, rtol 1e-3, the tie rule).  Returns
    the fused-build launches of the unsplit and of the split run, and the
    figures of PERF.md's "where the time goes"."""
    import torch

    from quad_periodic_mpc_tpu_torch.config import ADMMConfig
    from quad_periodic_mpc_tpu_torch.parallel import dryrun
    from quad_periodic_mpc_tpu_torch.parallel import mesh as ML
    from quad_periodic_mpc_tpu_torch.parallel import sweep as SW

    tag = "config 3"
    spec = SW.SweepSpec(phase_offsets=phases)
    kw = dict(solver=ADMMConfig(iterations=ADMM_ITERS, formulation="stagewise",
                                backend="pallas"))
    res, launches, info = timed_sweep(tag, device, card, spec, periods, **kw)
    _fused_build_only(tag, device, launches, periods)
    per_gait = res.vx_rms.reshape(len(spec.gait_names), -1).double().cpu()
    q = torch.quantile(per_gait, torch.tensor([0.05, 0.5, 0.95], dtype=torch.float64), dim=1)
    for i, name in enumerate(spec.gait_names):
        print(f"[{tag}] {name}: vx_rms p5 {float(q[0, i]):.5f}, p50 {float(q[1, i]):.5f}, "
              f"p95 {float(q[2, i]):.5f}")
    if device.type == "cuda":
        info.update(sweep_periods(tag, spec, device, card, kw["solver"]))
    mesh = ML.make_mesh(devices=[device] * split)
    res_s, launches_s, info_s = timed_sweep(f"{tag} split", device, card, spec, periods, mesh=mesh,
                                    **kw)
    _fused_build_only(f"{tag} split", device, launches_s, periods * split)
    gap = max(float((res_s.vx_rms - res.vx_rms).abs().max()),
              float((res_s.height_rms - res.height_rms).abs().max()))
    print(f"[{tag}] split over {split} entries against one: max gap {gap:.3g}, best instance "
          f"{int(res_s.best_instance)} / {int(res.best_instance)}; "
          f"{1e3 * info_s['run_s'] / periods:.1f} ms/period with the set-up in lockstep "
          f"(one chunk after another: {SEQUENTIAL_SPLIT_MS[tag]} ms)")
    check(_close(res_s.vx_rms, res.vx_rms, dryrun.ATOL, dryrun.RTOL)
          and _close(res_s.height_rms, res.height_rms, dryrun.ATOL, dryrun.RTOL),
          f"{tag}: the split run differs from the unsplit one by {gap}")
    check(SW.argmin_agrees(res.vx_rms, int(res.best_instance), int(res_s.best_instance),
                           dryrun.ATOL, dryrun.RTOL), f"{tag}: the split run's best instance")
    info["split_run_s"] = info_s["run_s"]
    return (launches.get("fused_stagewise_solve_srb", 0),
            launches_s.get("fused_stagewise_solve_srb", 0), info)


def terrain_sweep(device, card: str, spec_kw=None, periods: int = CONFIG4_PERIODS) -> dict:
    """Phase 16c, BASELINE.json config 4 at full width: the 10,000 scenarios
    of tests/test_sweep_terrain.py::test_terrain_sweep_10k_scenarios (4
    gaits x 5 phases x 5 static x 5 amplitude x (4 risers x 5 edges), a
    32 x 32 map at 0.05 m each).  First the reference test's settings (2
    periods, h = 4, condensed ADMM-20 in the "xla" loop) with its
    assertions; then the production setting, h = 10, stagewise ADMM-30 in the
    fused-build kernel, map-aware footholds and the map's body height,
    `periods` periods: every metric finite, one launch a period and no
    other.  Returns the production run's fused-build launches and the
    figures of PERF.md's "where the time goes"."""
    from quad_periodic_mpc_tpu_torch.config import ADMMConfig, MPCConfig
    from quad_periodic_mpc_tpu_torch.parallel import sweep as SW

    tag = "config 4"
    spec = SW.SweepSpec(**(spec_kw or CONFIG4))
    ref_periods, ref_h, ref_iters = CONFIG4_REFERENCE
    res, launches, info_ref = timed_sweep(
        f"{tag} reference settings", device, card, spec, ref_periods,
        mpc_cfg=MPCConfig(horizon=ref_h), solver=ADMMConfig(iterations=ref_iters))
    if device.type == "cuda":
        check(not launches, f"{tag}: the xla loop launched {launches}")
    kw = dict(solver=ADMMConfig(iterations=ADMM_ITERS, formulation="stagewise",
                                backend="pallas"))
    res, launches, info = timed_sweep(tag, device, card, spec, periods, **kw)
    _fused_build_only(tag, device, launches, periods)
    if device.type == "cuda":
        info.update(sweep_periods(tag, spec, device, card, kw["solver"]))
    info["reference_settings_run_s"] = info_ref["run_s"]
    info["reference_settings_peak_mib"] = info_ref["peak_mib"]
    return launches.get("fused_stagewise_solve_srb", 0), info


def condensed_split(device, card: str) -> dict:
    """Phase 16e: config 4's condensed sweep (the 10,000 scenarios at the
    reference settings' h and ADMM iterations in the "xla" loop, so the
    Newton-Schulz bucket decides over the batch every period) for
    CONFIG4_CONDENSED_PERIODS periods, unsplit and then split CONFIG4_SPLIT
    ways on the card in lockstep: the split within SPLIT_GAP of the unsplit
    run at every instance, its best instance under the tie rule, no kernel
    launched.  Returns both runs' ms a period and the gap."""
    import torch

    from quad_periodic_mpc_tpu_torch.config import ADMMConfig, MPCConfig
    from quad_periodic_mpc_tpu_torch.parallel import mesh as ML
    from quad_periodic_mpc_tpu_torch.parallel import sweep as SW

    tag, periods = "config 4 condensed", CONFIG4_CONDENSED_PERIODS
    spec = SW.SweepSpec(**CONFIG4)
    _, ref_h, ref_iters = CONFIG4_REFERENCE
    kw = dict(mpc_cfg=MPCConfig(horizon=ref_h), solver=ADMMConfig(iterations=ref_iters))
    res, launches, info = timed_sweep(tag, device, card, spec, periods, **kw)
    mesh = ML.make_mesh(devices=[device] * CONFIG4_SPLIT)
    res_s, launches_s, info_s = timed_sweep(f"{tag} split", device, card, spec, periods,
                                            mesh=mesh, **kw)
    if device.type == "cuda":
        check(not launches and not launches_s, f"{tag}: the xla loop launched {launches} / "
              f"{launches_s}")
    gap = max(float((res_s.vx_rms - res.vx_rms).abs().max()),
              float((res_s.height_rms - res.height_rms).abs().max()))
    equal = torch.equal(res_s.vx_rms, res.vx_rms) and torch.equal(res_s.height_rms,
                                                                  res.height_rms)
    ms = {k: 1e3 * i["run_s"] / periods for k, i in (("unsplit", info), ("split", info_s))}
    print(f"[{tag}] split over {CONFIG4_SPLIT} entries in lockstep against one: max gap "
          f"{gap:.3g} ({'bit for bit' if equal else 'not bit for bit'}; bound {SPLIT_GAP:g}), "
          f"best instance {int(res_s.best_instance)} / {int(res.best_instance)}; "
          f"{ms['split']:.1f} / {ms['unsplit']:.1f} ms/period with the set-up on {card}")
    check(gap <= SPLIT_GAP, f"{tag}: the split run differs from the unsplit one by {gap}")
    check(SW.argmin_agrees(res.vx_rms, int(res.best_instance), int(res_s.best_instance),
                           SPLIT_GAP, 0.0), f"{tag}: the split run's best instance")
    return {"ms_per_period": ms["unsplit"], "split_ms_per_period": ms["split"], "gap": gap,
            "bit_equal": equal}


def dist_on_card(device, card: str) -> None:
    """Phase 16d: parallel/dist_check as one torch.distributed rank (NCCL on
    the card, or Gloo on the CPU, through --init-method at world size 1) and
    as one process without it, side by side: the two JSON lines equal on
    every key, and the rank's two all_gathers (the errors and the final
    states) taken through the group's backend."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = [sys.executable, "-m", "quad_periodic_mpc_tpu_torch.parallel.dist_check",
            "--device", device.type]
    cmds = [base, base + ["--init-method", f"tcp://127.0.0.1:{port}", "--world-size", "1",
                          "--rank", "0"]]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=REPO) for c in cmds]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    lines = []
    for p, (out, err) in zip(procs, outs):
        check(p.returncode == 0, f"dist_check failed: {err[-2000:]}")
        lines.append(json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1]))
    one, rank = lines
    backend = "nccl" if device.type == "cuda" else "gloo"
    gathers = [ln for ln in outs[1][1].splitlines() if ln.startswith("dist_check: all_gather")]
    print("[dist] " + "; ".join(gathers))
    check(len(gathers) == 2 and all(ln.endswith(f"over 1 rank(s), backend {backend}")
                                    for ln in gathers),
          f"dist_check as one rank: expected two {backend} all_gathers, saw {gathers}")
    # the Newton-Schulz decisions through the group: one gather (two
    # all_gathers) per MPC step
    decided = [ln for ln in outs[1][1].splitlines() if "decision collectives" in ln]
    print("[dist] " + "; ".join(decided))
    check(len(decided) == 1 and decided[0].endswith(f"over 1 rank(s), backend {backend}")
          and int(decided[0].split()[1]) > 0,
          f"dist_check as one rank: expected its decisions through {backend}, saw {decided}")
    print(f"[dist] dist_check one process {json.dumps({k: v for k, v in one.items() if k != 'vx_rms'})}"
          f"; as one {'NCCL' if device.type == 'cuda' else 'Gloo'} rank: "
          f"{'equal on every key' if one == rank else 'DIFFERENT'} "
          f"({time.perf_counter() - t0:.1f} s)")
    check(one == rank, f"dist_check: one rank {rank} against one process {one}")


def sweeps(device, card: str) -> tuple[dict, dict, dict]:
    """Phase 16.  Returns the launches of its counted runs by kernel, the
    fused-build launches at each of the sweeps' KC.PATH_CASES, and the sweeps'
    figures of PERF.md's "where the time goes"."""
    t0 = time.perf_counter()
    by_kernel = dryrun_on_card(device, card, ref=DRYRUN_REF)
    g_one, g_split, g_info = gait_sweep(device, card)
    t_one, t_info = terrain_sweep(device, card)
    tier2 = by_kernel.get("fused_stagewise_solve_srb", 0)
    by_kernel["fused_stagewise_solve_srb"] = tier2 + g_one + g_split + t_one
    dist_on_card(device, card)
    c_info = condensed_split(device, card)
    print(f"[sweeps] phase 16 took {time.perf_counter() - t0:.1f} s")
    # tier 2's counted launches (checked against dryrun_expected) are its
    # oracle's periods at B = 16 and those of the entries' chunks at B = 2
    oracle = tier2 // (DRYRUN_ENTRIES + 1)
    by_shape = {"config 3 sweep": g_one, "config 4 sweep": t_one,
                "dry run tier 2": oracle, "dry run tier 2 chunk": tier2 - oracle}
    return by_kernel, by_shape, {"config 3": g_info, "config 4": t_info,
                                 "config 4 condensed": c_info}


def _on(device, a, dtype=None):
    """numpy -> tensor on ``device`` (float64 arrays as float32 unless
    ``dtype`` says otherwise)."""
    import numpy as np
    import torch

    a = np.asarray(a)
    t = torch.from_numpy(a.copy())
    if dtype is not None:
        t = t.to(dtype)
    elif a.dtype == np.float64:
        t = t.to(torch.float32)
    return t.to(device)


def stand_offsets(B: int, seed: int = STAND_SEED):
    """17a's target height offsets, uniform in [-0.02, 0.02] m (instance 0:
    0); a prefix of a longer draw, so B = 8 gives the first eight of
    B = 2,048."""
    import numpy as np

    d = np.random.default_rng(seed).uniform(-0.02, 0.02, B)
    d[0] = 0.0
    return d


def stand_request(k: int) -> int:
    """17a's FSM request at tick k: STAND_UP at tick 0, BALANCE_STAND from
    tick 1."""
    from quad_periodic_mpc_tpu_torch.control.fsm import BALANCE_STAND, STAND_UP

    return STAND_UP if k == 0 else BALANCE_STAND


def three_leg_contacts(B: int, seed: int = STAND_SEED + 1):
    """17b's contact pattern: a seeded quarter of the instances with one
    seeded leg lifted."""
    import numpy as np

    rng = np.random.default_rng(seed)
    c = np.ones((B, 4))
    lifted = rng.permutation(B)[: B // 4]
    c[lifted, rng.integers(0, 4, lifted.size)] = 0.0
    return c


def vbl_inputs(com, footholds_rel) -> dict:
    """17b's inputs (numpy) from the stand's final states: the body at the
    target pose (x = x_des, at rest, level), the final stance feet relative
    to the CoM, three_leg_contacts."""
    import numpy as np

    B = com.shape[0]
    eye = np.tile(np.eye(3), (B, 1, 1))
    return dict(x_com=com, v_com=np.zeros((B, 3)), R_body=eye, omega_world=np.zeros((B, 3)),
                p_feet_des_rel=footholds_rel, x_des=com, v_des=np.zeros((B, 3)), R_des=eye,
                omega_des_world=np.zeros((B, 3)), contact=three_leg_contacts(B))


def stand_start(device, B: int):
    """17a's start: (mc, plant, stand target, FSMs, the two requests)."""
    import torch

    from quad_periodic_mpc_tpu_torch.control import force_stand as FSt
    from quad_periodic_mpc_tpu_torch.control import fsm
    from quad_periodic_mpc_tpu_torch.sim import articulated_sim as art

    mc = art.mc_cache(torch.float32, device)
    plant = art.init_on_ground((B,), penetration=3.8e-3, device=device)
    stand = FSt.target(plant, mc, _on(device, stand_offsets(B)))
    reqs = [torch.full((B,), stand_request(k), dtype=torch.int32, device=device) for k in (0, 1)]
    return mc, plant, stand, fsm.init((B,), device=device), reqs


def stand_tick_ms(device, B: int = STAND_BATCH, ticks: int = STAND_RETIMED_TICKS) -> float:
    """ms a tick of 17a's loop over ``ticks`` ticks from its start."""
    from quad_periodic_mpc_tpu_torch.control import force_stand as FSt

    mc, plant, stand, f, reqs = stand_start(device, B)
    plant, f, _ = FSt.tick(plant, f, reqs[0], stand, mc)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(ticks):
        plant, f, _ = FSt.tick(plant, f, reqs[1], stand, mc)
    _sync(device)
    return 1e3 * (time.perf_counter() - t0) / ticks


def force_stand(device, card: str, B: int = STAND_BATCH, ticks: int = STAND_TICKS) -> dict:
    """Phase 17a: the torque-level force stand at B instances for `ticks`
    ticks through control/force_stand.tick (the balance QP, the safety
    post-check with its clamps, the stance LegController, the FSM; one
    fused_model_eval and one fused_substeps launch a tick).  Returns the
    counted launches by kernel and the final plant and targets."""
    import torch

    from quad_periodic_mpc_tpu_torch.control import force_stand as FSt
    from quad_periodic_mpc_tpu_torch.control import fsm
    from quad_periodic_mpc_tpu_torch.ops.cuda import kinematics_kernel as KK
    from quad_periodic_mpc_tpu_torch.ops.cuda import plant_kernel as PK
    from quad_periodic_mpc_tpu_torch.sim import articulated_sim as art
    from quad_periodic_mpc_tpu_torch.testing import kernel_cases as KC

    fresh = stand_tick_ms(device, B)
    mc, plant, stand, f, reqs = stand_start(device, B)
    states = torch.empty((ticks, B), dtype=torch.int32, device=device)
    masks = torch.empty((ticks, 2, B), dtype=torch.bool, device=device)
    held = torch.ones(B, dtype=torch.bool, device=device)
    saved = {}
    reset_all_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    t0 = time.perf_counter()
    for k in range(ticks):
        before = plant
        plant, f, rec = FSt.tick(plant, f, reqs[min(k, 1)], stand, mc)
        if k in (0, ticks - 1):
            saved[k] = (before, rec.tau)
        held &= rec.safe_orientation & rec.locomotion_safe & rec.safe_p_des & rec.safe_force
        states[k] = f.state
        masks[k, 0] = rec.safe_orientation
        masks[k, 1] = rec.locomotion_safe
    _sync(device)
    wall = time.perf_counter() - t0
    counts = all_launch_counts()
    peak = torch.cuda.max_memory_allocated(device) / 2**20 if device.type == "cuda" else 0.0
    launches = {n: counts[n] for n in ("fused_model_eval", "fused_substeps")}
    if device.type == "cuda":
        check(launches == {"fused_model_eval": ticks, "fused_substeps": ticks}
              and sum(counts.values()) == 2 * ticks,
              f"force stand: expected one fused_model_eval and one fused_substeps launch a "
              f"tick and no other kernel over {ticks} ticks, saw {counts}")

    def step(fs, pl):
        pl, fs, _ = FSt.tick(pl, fs, reqs[1], stand, mc)
        return fs, pl

    prof = profile_periods(step, f, plant, n=3, unit="tick") if device.type == "cuda" else None
    after = stand_tick_ms(device, B)
    print(f"[force stand] B={B}, {STAND_RETIMED_TICKS} ticks from the start: {fresh:.3f} ms a "
          f"tick in this process before the counted run, {after:.3f} after its profiler session")
    print(f"[force stand] B={B}, {ticks} ticks: {1e3 * wall / ticks:.3f} ms a tick "
          f"({wall:.1f} s), {sum(launches.values()) / ticks:.0f} kernel launches a tick "
          f"({launches}), busy {'not measured' if prof is None else f'{100 * prof['device_ms'] / prof['wall_ms']:.1f}%'}"
          f", {'' if prof is None else f'{prof['launches']} launches of any kind a tick, '}"
          f"peak device memory {peak:.0f} MiB on {card}")

    # the capstone's gates (tests/test_articulated_sim.py:118-124) on every instance
    s = plant.fb
    z_err = (s.pos[:, 2] - stand.com[:, 2]).abs()
    quat0 = s.quat[:, 0].abs()
    vmax = s.v_body.abs().amax(-1)
    print(f"[force stand] worst instance: |z - target| {float(z_err.max()):.6f} (gate "
          f"{STAND_GATES['z']}), |quat[0]| {float(quat0.min()):.7f} (> {STAND_GATES['quat0']}), "
          f"max |v_body| {float(vmax.max()):.6f} (< {STAND_GATES['vmax']})")
    check(bool((z_err < STAND_GATES["z"]).all()), "force stand: a body height left the target")
    check(bool((quat0 > STAND_GATES["quat0"]).all()), "force stand: an attitude did not stay level")
    check(bool((vmax < STAND_GATES["vmax"]).all()), "force stand: a body did not come to rest")
    check(bool(held.all()), "force stand: a safety mask failed or a clamp bound on some tick")
    check(bool((f.state == fsm.BALANCE_STAND).all() and (f.mode == fsm.NORMAL).all()),
          "force stand: an FSM did not end in BALANCE_STAND / NORMAL")
    # instances 0-7 against JAX's figures for the same inputs
    ours = torch.stack([s.pos[:8, 2], s.quat[:8, 0], vmax[:8]], -1).cpu().tolist()
    worst = max(abs(a - b) for row, ref in zip(ours, STAND_REF) for a, b in zip(row, ref))
    print(f"[force stand] instances 0-7 (z, quat[0], max|v_body|) against JAX's: largest gap "
          f"{worst:.3g} (tol {STAND_REF_TOL}); instance 0 {[round(v, 7) for v in ours[0]]}")
    check(worst <= STAND_REF_TOL, f"force stand: instances 0-7 {ours} against JAX's {STAND_REF}")
    # the FSM trace replayed by the CPU port from the copied masks
    m_cpu, s_cpu = masks.cpu(), states.cpu()
    fc = fsm.init((B,), device="cpu")
    req_cpu = [r.cpu() for r in reqs]
    replay = torch.empty_like(s_cpu)
    for k in range(ticks):
        fc = fsm.step(fc, req_cpu[min(k, 1)], m_cpu[k, 0], m_cpu[k, 1])
        replay[k] = fc.state
    check(torch.equal(replay, s_cpu), "force stand: the FSM trace differs from the CPU port's")
    print(f"[force stand] FSM trace ({ticks} x {B} states) replayed on the CPU port: equal")

    # rows 2 and 4 against their plain versions on the first and last ticks' states
    for k, (pl, tau) in sorted(saved.items()):
        got = KK.fused_model_eval(pl.fb, mc)
        bad, gaps = KC.model_eval_mismatches(got, KK.model_eval_reference(pl.fb, mc))
        A, Ainv, G, C, info = got
        args = (pl, tau, 1e-4, art.ContactParams(), (Ainv, G, C), info.Jc, info.p_foot, 10)
        p_bad, p_gaps = KC.substeps_mismatches(PK.fused_substeps(*args),
                                               PK.fused_substeps_reference(*args))
        print(f"[force stand] tick {k} state, B={B}: fused_model_eval " + ", ".join(
            f"max|d{n}|={e:.3g}" for n, e in gaps.items()) + "; fused_substeps " + ", ".join(
            f"max|d{n}|={e:.3g}" for n, e in p_gaps.items()))
        check(not bad, f"force stand: fused_model_eval disagrees in {bad} at tick {k}")
        check(not p_bad, f"force stand: fused_substeps disagrees in {p_bad} at tick {k}")
    timing = {}
    if device.type == "cuda":
        pl, tau = saved[ticks - 1]
        _, Ainv, G, C, info = KK.fused_model_eval(pl.fb, mc)
        args = (pl, tau, 1e-4, art.ContactParams(), (Ainv, G, C), info.Jc, info.p_foot, 10)
        timing["fused_model_eval"] = (queued_ms(lambda: KK.fused_model_eval(pl.fb, mc)),
                                      time_ms(lambda: KK.fused_model_eval(pl.fb, mc), 20))
        timing["fused_substeps"] = (queued_ms(lambda: PK.fused_substeps(*args)),
                                    time_ms(lambda: PK.fused_substeps(*args), 20))
        for (name, (ms, call)), key, flops_per in zip(
                timing.items(), ("model", "plant"), (model_eval_flops(), substep_flops(10))):
            per_in, per_out, shared = TICK_FLOATS[key]
            bound_ms, bound_by = bound(B * flops_per, 4 * (B * (per_in + per_out) + shared))
            print(f"[force stand] {name} B={B}: {ms:.4f} ms per call on the device (queued "
                  f"behind a sleep), {call:.4f} ms per call as issued, bound {bound_ms:.5f} ms "
                  f"({bound_by}) on {card}")
    return {"launches": launches, "plant": plant, "stand": stand, "timing": timing}


def queued_ms(fn, reps: int = 20) -> float:
    """ms per call on the device, the calls queued behind a sleep kernel so
    that the host's issue of them is not counted (tools/time_tick_cuda.py's
    device_ms); CUDA events, no profiler."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    fn()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def stand_job(job: dict) -> dict:
    """Phase 17a in a process of its own: a torch.profiler session leaves
    the host's loop slower for the rest of its process (PERF.md section 7),
    and the earlier phases profile; here the counted run comes before the
    process's one session.  Returns the counted launches, the kernel
    timings and the final state and targets as CPU tensors."""
    import torch

    sys.path.insert(0, str(REPO))
    import quad_periodic_mpc_tpu_torch  # noqa: F401  (sets the f32 policy)

    device = torch.device(job["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    res = force_stand(device, job["card"], job["B"], job["ticks"])
    if "jax" in sys.modules or "quad_periodic_mpc_tpu" in sys.modules:
        raise SmokeFailure("JAX or the JAX package was imported in the force stand's process")
    return {"launches": res["launches"], "timing": res["timing"],
            "fb": [a.cpu() for a in res["plant"].fb],
            "target": [a.cpu() for a in res["stand"]]}


def vbl_on_card(device, card: str, state, stand) -> None:
    """Phase 17b: balance_vbl.solve at B on 17a's final stances, at the
    target pose and displaced +0.05 m in x, a seeded quarter on three legs;
    the card against the CPU port on the same inputs (F, and P of the
    CARE), and tests/test_balance_vbl.py:82-98's gates on every instance
    with four feet in stance."""
    import torch

    from quad_periodic_mpc_tpu_torch.control import balance_vbl as vbl
    from quad_periodic_mpc_tpu_torch.models import floating_base as fb
    from quad_periodic_mpc_tpu_torch.sim import articulated_sim as art

    mc = art.mc_cache(torch.float32, device)
    feet = fb.contact_jacobians(state, mc).p_foot
    com = stand.com.cpu().numpy()
    base = vbl_inputs(com, (feet - stand.com[:, None, :]).cpu().numpy())
    cfg = vbl.VBLSettings()
    for label, dx in (("at the target", 0.0), ("displaced +0.05 m in x", 0.05)):
        inp = dict(base, x_com=com + [dx, 0.0, 0.0])
        on = {k: _on(device, v) for k, v in inp.items()}
        _sync(device)
        t0 = time.perf_counter()
        F = vbl.solve(**on)
        _sync(device)
        ms = 1e3 * (time.perf_counter() - t0)
        on_cpu = {k: _on("cpu", v) for k, v in inp.items()}
        t0 = time.perf_counter()
        Fc = vbl.solve(**on_cpu)
        cpu_ms = 1e3 * (time.perf_counter() - t0)
        F, P, Pc = F.cpu(), vbl.variation_lqr(**on).P.cpu(), vbl.variation_lqr(**on_cpu).P
        eF = float(((F - Fc).abs().amax((-1, -2)) / Fc.abs().amax((-1, -2)).clamp(min=1.0)).max())
        eP = float(((P - Pc).abs().amax((-1, -2)) / Pc.abs().amax((-1, -2))).max())
        f_ref = vbl.reference_grf(on["p_feet_des_rel"], on["contact"], cfg).cpu()
        print(f"[vbl] B={F.shape[0]} {label}: card {ms:.1f} ms, CPU port {cpu_ms:.1f} ms; "
              f"card vs CPU: F {eF:.3g} (tol {VBL_TOL['F']}), P {eP:.3g} (tol {VBL_TOL['P']}) "
              f"relative, largest |P| {float(Pc.abs().max()):.6g} on {card}")
        check(bool(torch.isfinite(F).all() and torch.isfinite(P).all()), "vbl: not finite")
        check(eF <= VBL_TOL["F"] and eP <= VBL_TOL["P"], f"vbl {label}: card vs CPU F {eF}, P {eP}")
        # the reference test's gates are for four feet in stance: on three,
        # the foot diagonal to the lifted one gets f_ref ~ 0 and the QP's
        # 10 N minimum moves it off the reference by design
        four = on["contact"].cpu().sum(-1) == 4
        F4, f_ref4 = F[four], f_ref[four]
        if dx == 0.0:
            gap = float((F4 - f_ref4).abs().max())
            print(f"[vbl]   equilibrium, {int(four.sum())} four-legged instances: max |F - "
                  f"f_ref| {gap:.4f} (gate 0.5)")
            check(gap < 0.5, f"vbl: equilibrium forces {gap} from f_ref")
        else:
            fx = F4[..., 0].sum(-1)
            cone = (F4[..., 0] - f_ref4[..., 0]).abs() - cfg.mu * 0.7071 * f_ref4[..., 2]
            print(f"[vbl]   restoring: largest sum f_x {float(fx.max()):.3f} (gate < -5), "
                  f"largest cone excess {float(cone.max()):.3g} (gate 1e-4)")
            check(bool((fx < -5.0).all()), "vbl: a displaced instance got no restoring force")
            check(bool((cone <= 1e-4).all()), "vbl: the linearized friction cone was left")


def _fleet_equal(tag: str, card_vals: dict, cpu_vals: dict, tol: float = 0.0) -> None:
    for name, v in card_vals.items():
        c = cpu_vals[name]
        v = v.cpu()
        if tol and v.dtype.is_floating_point:
            gap = float((v - c).abs().max())
            check(gap <= tol, f"{tag}: {name} {gap} from the CPU port's (tol {tol})")
        else:
            check(torch_equal(v, c), f"{tag}: {name} differs from the CPU port's")


def torch_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


def fsm_fleet(device, B: int, ticks: int, rng_seed: int = 17):
    """2,048 FSMs under seeded requests, masks and completion flags; returns
    the traces of (state, mode, damp_iter) and ms a tick."""
    import numpy as np
    import torch

    from quad_periodic_mpc_tpu_torch.control import fsm

    rng = np.random.default_rng(rng_seed)
    pool = np.array([fsm.PASSIVE, fsm.STAND_UP, fsm.BALANCE_STAND, fsm.LOCOMOTION,
                     fsm.RECOVERY_STAND, fsm.LAY_DOWN, fsm.VISION, fsm.BACKFLIP, fsm.TESTING,
                     fsm.TESTING_CV], np.int32)
    req = pool[rng.integers(0, pool.size, (ticks, B))]
    hold = rng.integers(1, 50, (ticks, B))
    for k in range(1, ticks):
        req[k] = np.where(k % hold[k] != 0, req[k - 1], req[k])
    req[:20, : B // 4] = fsm.STAND_UP
    safe = rng.uniform(size=(ticks, B)) > 0.01
    safe[30:, : B // 4] = False                  # a long fault: EDAMP, then ESTOP at 1,000
    loco = rng.uniform(size=(ticks, B)) > 0.02
    done = rng.uniform(size=(ticks, B)) > 0.3
    inputs = [_on(device, a) for a in (req, safe, loco, done)]
    f = fsm.init((B,), device=device)
    out = {n: torch.empty((ticks, B), dtype=torch.int32, device=device)
           for n in ("state", "mode", "damp_iter")}
    _sync(device)
    t0 = time.perf_counter()
    for k in range(ticks):
        f = fsm.step(f, *(a[k] for a in inputs))
        for n in out:
            out[n][k] = getattr(f, n)
    _sync(device)
    return out, 1e3 * (time.perf_counter() - t0) / ticks


def gait_fleet(device, B: int, ticks: int, dt: float = FLEET_DT, rng_seed: int = 23):
    """2,048 gait schedulers through step_full with seeded gait types (all
    15), override modes 0 / 2 / 4 and user periods that change every 1-80
    ticks; returns the contact / touchdown / liftoff traces, the phases
    every 100 ticks, and ms a tick."""
    import numpy as np
    import torch

    from quad_periodic_mpc_tpu_torch.ops import gait_scheduler as gs

    rng = np.random.default_rng(rng_seed)
    mode = rng.choice(np.array([0, 2, 4], np.int32), B)
    gait = rng.integers(0, 15, (ticks, B)).astype(np.int32)
    period = rng.uniform(0.3, 0.9, (ticks, B)).astype(np.float32)
    switching = rng.uniform(0.3, 0.8, B).astype(np.float32)
    change = rng.integers(1, 80, B)
    for k in range(1, ticks):
        keep = k % change != 0
        gait[k] = np.where(keep, gait[k - 1], gait[k])
        period[k] = np.where(keep, period[k - 1], period[k])
    mode_t, sw_t = _on(device, mode), _on(device, switching)
    gait_t, period_t = _on(device, gait), _on(device, period)
    gd = gs.gait_data_init((B,), gait="trot", device=device)
    out = {"contact": torch.empty((ticks, B, 4), device=device),
           "touchdown": torch.empty((ticks, B, 4), dtype=torch.bool, device=device),
           "liftoff": torch.empty((ticks, B, 4), dtype=torch.bool, device=device),
           "current_gait": torch.empty((ticks, B), dtype=torch.int32, device=device)}
    phases = []
    _sync(device)
    t0 = time.perf_counter()
    for k in range(ticks):
        gd, o = gs.step_full(gd, dt, override_mode=mode_t, user_gait=gait_t[k],
                             user_period=period_t[k], user_switching=sw_t)
        out["contact"][k], out["touchdown"][k], out["liftoff"][k] = o.contact, o.touchdown, o.liftoff
        out["current_gait"][k] = gd.current_gait
        if k % 100 == 99:
            phases.append(gd.phase)
    _sync(device)
    ms = 1e3 * (time.perf_counter() - t0) / ticks
    return out, torch.stack(phases), ms


def small_fleets(device, n: int = FLEET_B) -> dict:
    """adaptive_gait_update, the poses, playback over a synthesized plan saved
    and loaded through a temporary file, and the filters, at B = n from
    seeded inputs; returns every output by name."""
    import tempfile

    import numpy as np
    import torch

    from quad_periodic_mpc_tpu_torch.control import cmpc_variant as cv
    from quad_periodic_mpc_tpu_torch.control import playback, poses
    from quad_periodic_mpc_tpu_torch.ops import gait as gait_ops
    from quad_periodic_mpc_tpu_torch.utils import filters

    rng = np.random.default_rng(29)
    names = ["trotting", "bounding", "pronking", "pacing", "galloping", "walking"]
    g = gait_ops.stacked_presets(names, device=device)
    idx = _on(device, rng.integers(0, len(names), n))
    g = type(g)(*(leaf[idx] for leaf in g))
    swing = rng.uniform(0.0, 1.0, (n, 4)).astype(np.float32)
    phase = rng.uniform(0.0, 1.0, n).astype(np.float32)
    sensor = (rng.uniform(size=(n, 4)) > 0.4).astype(np.float32)
    out = {}
    g2 = cv.adaptive_gait_update(g, *(_on(device, a) for a in (swing, phase, sensor)))
    out.update(adaptive_offsets=g2.offsets, adaptive_durations=g2.durations)

    t = _on(device, rng.uniform(-0.5, 2.5, n))
    feet = _on(device, rng.uniform(-0.3, 0.1, (n, 4, 3)))
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    z0 = _on(device, rng.uniform(-0.15, -0.05, (n, 4)))
    for tag, cmd in (("stand_up", poses.stand_up_impedance(t, feet, _on(device, q))),
                     ("lay_down", poses.lay_down(t, feet, z0)),
                     ("fold", poses.joint_ramp(t, feet, "fold", 1.5)),
                     ("rollover", poses.joint_ramp(t, feet, "rollover", 1.5))):
        out.update({f"{tag}.{k}": v for k, v in cmd._asdict().items()})

    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/plan.dat"
        playback.save_plan(path, playback.synthesize_jump_plan(800))
        plan = playback.load_plan(path, device=device)
    its = _on(device, rng.integers(-5, 820, n).astype(np.int32))
    prep = _on(device, rng.uniform(size=n) > 0.5)
    out.update({f"playback.{k}": v for k, v in
                playback.playback_command(plan, its, prep)._asdict().items()})

    x = _on(device, np.sin(np.arange(300)[:, None] * 0.05 + rng.uniform(0, 6, n))
            + 0.1 * rng.normal(size=(300, n)))
    lp = filters.LowPassState(torch.zeros(n, device=device))
    bi_init, bi = filters.make_digital_lp(30.0, 0.002)
    de_init, de = filters.make_deriv_lp(60.0, 0.002)
    b, dd = bi_init((n,), device=device), de_init((n,), device=device)
    m = filters.moving_average_init(7, (n,), device=device)
    ys = []
    for k in range(x.shape[0]):
        (lp, y1), (b, y2), (dd, y3), (m, y4) = (filters.first_order_lp(lp, x[k], 0.2), bi(b, x[k]),
                                                 de(dd, x[k]), filters.moving_average(m, x[k]))
        ys.append(torch.stack([y1, y2, y3 / 100.0, y4]))   # the derivative's scale ~1/dt
    out["filters"] = torch.stack(ys)
    return out


def wbc_tasks_on(device, plant_cpu, info_cpu, model_cpu) -> dict:
    """The six wbc_tasks builders on the given states (CPU tensors, copied to
    ``device`` in their dtype), then wbic with each task list of WBC_LISTS
    and kin_wbc with the body-pinned contact and the joint task; returns
    every output."""
    import torch

    from quad_periodic_mpc_tpu_torch.control import wbc, wbc_tasks
    from quad_periodic_mpc_tpu_torch.control.force_stand import total_mass
    from quad_periodic_mpc_tpu_torch.models import floating_base as fb

    st = fb.FBState(*(a.to(device) for a in plant_cpu))
    info = fb.ContactInfo(*(a.to(device) for a in info_cpu))
    A, Ainv, cori, grav = (a.to(device) for a in model_cpu)
    B, kw = st.pos.shape[0], {"dtype": st.pos.dtype, "device": device}
    quat_des = torch.tensor([1.0, 0.0, 0.0, 0.0], **kw).expand(B, 4)
    tasks = {
        "jpos": wbc_tasks.jpos_task(st, st.q + 0.05),
        "ryrz": wbc_tasks.body_ryrz_task(st, quat_des),
        "ryrz_rpy": wbc_tasks.body_ryrz_task_rpy(st, torch.full((B, 3), 0.02, **kw)),
        "local_pos": wbc_tasks.local_pos_task(st, info, 2, 3,
                                              info.p_foot[:, 2] - info.p_foot[:, 3] + 0.01),
        "posture": wbc_tasks.body_posture_task(st, quat_des, st.pos + 0.01),
        "roll": wbc_tasks.local_roll_task(st, torch.full((B,), 0.02, **kw)),
    }
    out = {f"{k}.{i}": v for k, tup in tasks.items() for i, v in enumerate(tup)}
    Jc6 = wbc_tasks.fixed_body_contact((B,), **kw)[0]
    out["fixed.Jc"] = Jc6
    gains = wbc.WBCGains()
    out["kin_wbc.q"], out["kin_wbc.qd"] = wbc.kin_wbc(
        st, Jc6, [tasks["jpos"][0]], [tasks["jpos"][1]], [tasks["jpos"][2]], gains)
    fr_des = torch.zeros((B, 4, 3), **kw)
    fr_des[..., 2] = total_mass() * 9.81 / 4
    for name, names in WBC_LISTS.items():
        pick = [tasks[k] for k in names]
        tau, fr, qddot = wbc.wbic(st, A, Ainv, cori, grav, info.Jc, info.Jcdqd,
                                  [t[0] for t in pick], [t[3] for t in pick],
                                  [t[4] for t in pick], fr_des, torch.ones((B, 4), **kw), gains)
        out.update({f"wbic {name}.tau": tau, f"wbic {name}.fr": fr,
                    f"wbic {name}.qddot": qddot})
    return out


def wbc_tasks_fleet(device, card: str, state) -> None:
    """17c's WBC tasks on 17a's final states, in float64 and in their own
    float32, on the card and on the CPU port with the CPU port's model
    terms."""
    import torch

    from quad_periodic_mpc_tpu_torch.models import floating_base as fb
    from quad_periodic_mpc_tpu_torch.ops import linalg

    def rel(a, b):
        """Largest |a - b| over the largest |b| (at least 1)."""
        return float((a - b).abs().max() / b.abs().max().clamp(min=1.0))

    outs = {}
    for dtype in (torch.float64, torch.float32):
        cpu_plant = fb.FBState(*(a.cpu().to(dtype) for a in state))
        mc = fb.build_a1_constants(str(dtype).split(".")[-1], "cpu")
        A = fb.mass_matrix(cpu_plant, mc)
        model = (A, linalg.spd_inverse(A), fb.generalized_coriolis(cpu_plant, mc),
                 fb.generalized_gravity(cpu_plant, mc))
        info = fb.contact_jacobians(cpu_plant, mc)
        _sync(device)
        t1 = time.perf_counter()
        card_w = wbc_tasks_on(device, cpu_plant, info, model)
        _sync(device)
        ms = 1e3 * (time.perf_counter() - t1)
        card_w = {k: v.cpu() for k, v in card_w.items()}
        outs[dtype] = card_w, wbc_tasks_on(torch.device("cpu"), cpu_plant, info, model)
        card_w, cpu_w = outs[dtype]
        builders = max(rel(v, cpu_w[k]) for k, v in card_w.items()
                       if not k.startswith(("wbic", "kin_wbc")))
        errs = {k: rel(v, cpu_w[k]) for k, v in card_w.items() if k.startswith(("wbic", "kin"))}
        print(f"[fleets] wbc_tasks at B={state.pos.shape[0]}, {dtype}: builders within "
              f"{builders:.3g} relative of the CPU port; " + ", ".join(
                  f"{k} {v:.3g}" for k, v in errs.items()) + f"; {ms:.1f} ms on the card")
        check(builders <= FLEET_TOL, f"wbc_tasks builders {builders} from the CPU port, {dtype}")
        for k, v in card_w.items():
            check(bool(torch.isfinite(v).all() and torch.isfinite(cpu_w[k]).all()),
                  f"wbc_tasks {k} not finite, {dtype}")
        if dtype == torch.float64:
            for name in WBC_LISTS:
                e = errs[f"wbic {name}.tau"]
                check(e <= WBC_TASK_TOL, f"wbic tau with the {name} list {e}, float64")
        else:
            e = errs["wbic independent.tau"]
            check(e <= WBC_TASK_F32_TOL, f"wbic tau with the independent list {e}, float32")
    # the CPU port's float32 against its float64, for scale
    c64, c32 = outs[torch.float64][1], outs[torch.float32][1]
    print("[fleets] wbic float32 from float64 on the CPU port: " + ", ".join(
        f"{name} list {rel(c32[f'wbic {name}.tau'].double(), c64[f'wbic {name}.tau']):.3g}"
        for name in WBC_LISTS) + f" relative on tau (card vs CPU port, float32: tol "
        f"{WBC_TASK_F32_TOL} on the independent list; float64: tol {WBC_TASK_TOL}) on {card}")


def fleets(device, card: str, state) -> None:
    """Phase 17c: each fleet on the card and again on the CPU port from the
    same inputs."""
    import torch

    from quad_periodic_mpc_tpu_torch.control import fsm

    B = FLEET_B
    t0 = time.perf_counter()
    card_f, ms = fsm_fleet(device, B, FLEET_FSM_TICKS)
    cpu_f, cpu_ms = fsm_fleet(torch.device("cpu"), B, FLEET_FSM_TICKS)
    _fleet_equal("fsm fleet", card_f, cpu_f)
    estop = int((card_f["mode"][-1] == fsm.ESTOP).sum())
    print(f"[fleets] {B} FSMs x {FLEET_FSM_TICKS} ticks: {ms:.3f} ms a tick on the card, "
          f"{cpu_ms:.3f} on the CPU port; state, mode and EDAMP counter equal on every tick; "
          f"{estop} in ESTOP at the end")
    check(estop >= B // 8, "fsm fleet: the long faults did not reach ESTOP")

    card_g, card_ph, ms = gait_fleet(device, B, FLEET_GAIT_TICKS)
    cpu_g, cpu_ph, cpu_ms = gait_fleet(torch.device("cpu"), B, FLEET_GAIT_TICKS)
    _fleet_equal("gait fleet", card_g, cpu_g)
    gap = float((card_ph.cpu() - cpu_ph).abs().max())
    print(f"[fleets] {B} gait schedulers x {FLEET_GAIT_TICKS} ticks at {FLEET_DT} s: {ms:.3f} ms "
          f"a tick on the card, {cpu_ms:.3f} on the CPU port; contact, touchdown, liftoff and "
          f"gait equal on every tick, phases within {gap:.3g} (tol {FLEET_TOL})")
    check(gap <= FLEET_TOL, f"gait fleet: phases {gap} from the CPU port's")

    _sync(device)
    t1 = time.perf_counter()
    card_s = small_fleets(device)
    _sync(device)
    ms = 1e3 * (time.perf_counter() - t1)
    cpu_s = small_fleets(torch.device("cpu"))
    exact = {k: v for k, v in card_s.items() if k.startswith("adaptive")}
    _fleet_equal("adaptive gait update", exact, cpu_s)
    worst = 0.0
    for k, v in card_s.items():
        if k in exact:
            continue
        v, c = v.cpu(), cpu_s[k]
        both_nan = torch.isnan(v) & torch.isnan(c)
        check(torch.equal(torch.isnan(v), torch.isnan(c)), f"{k}: NaN pattern differs")
        worst = max(worst, float(torch.where(both_nan, 0.0, (v - c).abs()).max()))
    print(f"[fleets] B={B}: adaptive_gait_update equal; poses, playback (plan through a file) "
          f"and filters within {worst:.3g} of the CPU port (tol {FLEET_TOL}); {ms:.1f} ms on the card")
    check(worst <= FLEET_TOL, f"poses / playback / filters: {worst} from the CPU port")

    wbc_tasks_fleet(device, card, state)
    print(f"[fleets] phase 17c took {time.perf_counter() - t0:.1f} s")


def slice8(device, card: str) -> dict:
    """Phase 17: 17a's loop timed here for a few ticks, then 17a in a
    spawned process, then 17b and 17c here on its final states.  Returns
    17a's counted launches by kernel and its kernel timings at B =
    STAND_BATCH."""
    import multiprocessing

    from quad_periodic_mpc_tpu_torch.control.force_stand import StandTarget
    from quad_periodic_mpc_tpu_torch.models.floating_base import FBState

    t0 = time.perf_counter()
    here = stand_tick_ms(device, STAND_BATCH)
    print(f"[force stand] B={STAND_BATCH}, {STAND_RETIMED_TICKS} ticks in the smoke run's own "
          f"process, after phases 1-16: {here:.3f} ms a tick")
    job = {"device": str(device), "card": card, "B": STAND_BATCH, "ticks": STAND_TICKS}
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        res = pool.submit(stand_job, job).result()
    state = FBState(*(a.to(device) for a in res["fb"]))
    stand = StandTarget(*(a.to(device) for a in res["target"]))
    vbl_on_card(device, card, state, stand)
    fleets(device, card, state)
    print(f"[fsm] phase 17 took {time.perf_counter() - t0:.1f} s")
    return res


# ---------------------------------------------------------------------------
# slice 9: the CLI and the operator surfaces (phase 18)
# ---------------------------------------------------------------------------

class _RetuneAfterRows:
    """stdout of an in-process ``cli live``: collects its rows and, once
    ``after`` rows are complete, rewrites the tune file (with an mtime of
    its own), which the loop polls before its next chunk."""

    def __init__(self, path: Path, values: dict, after: int):
        import io

        self.buf, self.path, self.values, self.after, self.done = io.StringIO(), path, values, \
            after, False

    def write(self, s: str) -> int:
        import os

        n = self.buf.write(s)
        if not self.done and self.buf.getvalue().count("\n") >= self.after:
            self.path.write_text(json.dumps(self.values))
            st = self.path.stat()
            os.utime(self.path, (st.st_atime, st.st_mtime + 10.0))
            self.done = True
        return n

    def flush(self) -> None:
        pass

    def getvalue(self) -> str:
        return self.buf.getvalue()


def cli_run(argv, out=None):
    """cli.main(argv) in this process with its standard output captured:
    (the parsed JSON, or the JSON lines as a list, and the wall seconds).
    The counts and the card are those of this process."""
    import contextlib
    import io

    from quad_periodic_mpc_tpu_torch import cli

    out = out if out is not None else io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    wall = time.perf_counter() - t0
    text = out.getvalue()
    try:
        return json.loads(text), wall
    except json.JSONDecodeError:
        return [json.loads(line) for line in text.splitlines()], wall


def _numeric_gap(a: dict, b: dict) -> float:
    """The largest |a - b| over the numeric fields (lists flattened); the
    other fields must be equal."""
    gap = 0.0
    for k, v in b.items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            gap = max(gap, abs(a[k] - v))
        elif isinstance(v, list):
            gap = max([gap, *(abs(x - y) for x, y in zip(a[k], v))])
        else:
            check(a[k] == v, f"field {k}: {a[k]!r} against {v!r}")
    return gap


def _add(total: dict, launched: dict) -> None:
    for k, v in launched.items():
        total[k] = total.get(k, 0) + v


def cli_rollouts(device, card: str, counts: dict) -> None:
    """18a and 18b."""
    import os

    reset_all_counts()
    out, wall = cli_run(["rollout", "--steps", str(CLI_STEPS), *CLI_ROLLOUT_FLAGS])
    launched = {k: v for k, v in all_launch_counts().items() if v}
    _add(counts, launched)
    print(f"[cli rollout] {CLI_STEPS} periods, stagewise ADMM-30 in the fused-build kernel: "
          f"{wall:.2f} s, {1e3 * wall / CLI_STEPS:.2f} ms a period, launches {launched}, "
          f"height_final {out['height_final']:.5f}, vx_mean {out['vx_mean']:.5f}, vx_rms_err "
          f"{out['vx_rms_err']:.5f} on {card}")
    check(launched == {"fused_stagewise_solve_srb": CLI_STEPS},
          f"18a: launches {launched}, expected {CLI_STEPS} of fused_stagewise_solve_srb alone")
    check(abs(out["height_final"] - CLI_HEIGHT) < CLI_HEIGHT_TOL,
          f"18a: height_final {out['height_final']}")
    check(abs(out["vx_mean"] - CLI_VX) < CLI_VX_TOL, f"18a: vx_mean {out['vx_mean']}")

    flags = ["rollout", "--steps", str(CLI_SHORT_STEPS), *CLI_ROLLOUT_FLAGS, "--disturbance"]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "quad_periodic_mpc_tpu_torch", *flags],
                          cwd=REPO, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(REPO)})
    sub_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"18b: python -m quad_periodic_mpc_tpu_torch exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    sub = json.loads(proc.stdout)
    reset_all_counts()
    here, here_s = cli_run(flags)
    _add(counts, {k: v for k, v in all_launch_counts().items() if v})
    on_cpu, cpu_s = cli_run(flags + ["--device", "cpu"])
    gap = _numeric_gap(here, on_cpu)
    print(f"[cli rollout] python -m quad_periodic_mpc_tpu_torch {' '.join(flags[:3])} ... "
          f"--disturbance (no --device): exit 0 in {sub_s:.2f} s, its JSON "
          f"{'equal to' if sub == here else 'NOT equal to'} this process's card run "
          f"({here_s:.2f} s); the CPU port's ({cpu_s:.2f} s) largest gap {gap:.3g} on {card}")
    check(sub == here, f"18b: the subprocess's JSON {sub} differs from the card run's {here}")
    check(gap <= CLI_CPU_TOL, f"18b: card vs CPU port gap {gap}")


def cli_live(device, card: str, counts: dict) -> None:
    """18c."""
    import socket

    from quad_periodic_mpc_tpu_torch.control import loop as L

    tmp = REPO / "build" / "cli"
    tmp.mkdir(parents=True, exist_ok=True)
    tune = tmp / "tune.json"
    retune = {"alpha": 3e-5, "swing_height": 0.12}
    argv = ["live", "--steps", "40", "--chunk", "10", "--tune-file", str(tune)]

    def live(extra):
        tune.write_text(json.dumps({"alpha": 2e-5}))
        return cli_run(argv + extra, out=_RetuneAfterRows(tune, retune, after=2))

    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    ptrs = []
    real = L.rollout

    def recording(*args, tunable=None, **kw):
        ptrs.append(tuple(t.data_ptr() for t in tunable))
        return real(*args, tunable=tunable, **kw)

    L.rollout = recording
    try:
        reset_all_counts()
        rows, wall = live(["--telemetry-udp", f"127.0.0.1:{rx.getsockname()[1]}"])
        launched = {k: v for k, v in all_launch_counts().items() if v}
        rx.settimeout(5.0)
        grams = [json.loads(rx.recv(65536)) for _ in rows]
        rx.setblocking(False)
        try:
            extra = rx.recv(65536)
        except BlockingIOError:
            extra = None
    finally:
        L.rollout = real
        rx.close()
    _add(counts, launched)
    cpu_rows, cpu_s = live(["--device", "cpu"])
    check(len(cpu_rows) == len(rows), f"18c: {len(cpu_rows)} rows on the CPU port")
    gaps = {k: max(abs(r[k] - c[k]) for r, c in zip(rows, cpu_rows)) for k in LIVE_STATE}
    gap = max(gaps.values())
    print(f"[cli live] 40 periods in chunks of 10: {wall:.2f} s, chunks "
          f"{[r['chunk_wall_ms'] for r in rows]} ms, tune_seq {[r['tune_seq'] for r in rows]}, "
          f"alpha {[r['alpha'] for r in rows]}, swing_height {[r['swing_height'] for r in rows]}, "
          f"{len(grams)} datagrams, launches {launched}; the CPU port's rows ({cpu_s:.2f} s) "
          f"largest gap {gap:.3g} (by field {', '.join(f'{k} {v:.3g}' for k, v in gaps.items())})"
          f" on {card}")
    check(len(rows) == 4, f"18c: {len(rows)} rows")
    for tag, rs in (("card", rows), ("CPU port", cpu_rows)):
        check([r["tune_seq"] for r in rs] == [1, 1, 2, 2], f"18c: tune_seq on the {tag}")
        check(all(abs(r["alpha"] - (2e-5 if i < 2 else 3e-5)) < 1e-10 for i, r in enumerate(rs))
              and abs(rs[3]["swing_height"] - 0.12) < 1e-6, f"18c: the retuned values, {tag}")
        check([r["mpc_steps"] for r in rs] == [10, 20, 30, 40], f"18c: mpc_steps on the {tag}")
    check(len(ptrs) == 4 and len(set(ptrs)) == 1, "18c: the tunable's tensors moved")
    check(grams == rows and extra is None, "18c: the datagrams differ from the rows")
    check(launched == {"fused_stagewise_solve": 40},
          f"18c: launches {launched}, expected 40 of fused_stagewise_solve alone")
    check(gap <= CLI_CPU_TOL, f"18c: card vs CPU port gap {gaps}")


def cli_sweep(device, card: str, counts: dict) -> None:
    """18d."""
    from quad_periodic_mpc_tpu_torch.parallel import dryrun
    from quad_periodic_mpc_tpu_torch.parallel import sweep as SW

    flags = ["sweep", "--mpc-steps", "20", "--phase-offsets", "4", "--backend", "pallas"]
    results = []
    real = SW.run_sweep

    def recording(*args, **kw):
        results.append(real(*args, **kw))
        return results[-1]

    SW.run_sweep = recording
    try:
        reset_all_counts()
        card_out, card_s = cli_run(flags)
        launched = {k: v for k, v in all_launch_counts().items() if v}
        cpu_out, cpu_s = cli_run(flags + ["--device", "cpu"])
    finally:
        SW.run_sweep = real
    _add(counts, launched)
    on_card, on_cpu = results
    print(f"[cli sweep] {card_out['instances']} instances x 20 periods, condensed ADMM-100 in "
          f"fused_admm_iterations: {card_s:.2f} s ({cpu_s:.2f} s on the CPU port); card "
          f"{card_out}, CPU {cpu_out}, launches {launched} on {card}")
    check(card_out["instances"] == cpu_out["instances"], "18d: instances")
    check(SW.argmin_agrees(on_cpu.vx_rms, cpu_out["best_instance"], card_out["best_instance"],
                           dryrun.ATOL, dryrun.RTOL), "18d: best_instance under the tie rule")
    for k in ("mean_vx_rms", "vx_rms_p50", "vx_rms_p95"):
        check(abs(card_out[k] - cpu_out[k]) <= dryrun.ATOL + dryrun.RTOL * abs(cpu_out[k]),
              f"18d: {k} {card_out[k]} against {cpu_out[k]}")
    check(launched == {"fused_admm_iterations": 20},
          f"18d: launches {launched}, expected 20 of fused_admm_iterations alone")


def cli_parity(device, card: str) -> None:
    """18e."""
    out, wall = cli_run(["parity", "--horizon", "10", "--problems", "5"])
    for row, ref in zip(out["rows"], PARITY_REF["rows"]):
        print(f"[cli parity] seed {row['seed']}: admm_vs_pdip_max {row['admm_vs_pdip_max']:.6g} "
              f"(JAX {ref['admm_vs_pdip_max']:.6g}), primal {row['primal']:.3g} (JAX "
              f"{ref['primal']:.3g}), dual {row['dual']:.3g} (JAX {ref['dual']:.3g})")
    check(len(out["rows"]) == 5, f"18e: {len(out['rows'])} rows")
    gaps = [abs(r["admm_vs_pdip_max"] - ref["admm_vs_pdip_max"])
            for r, ref in zip(out["rows"], PARITY_REF["rows"])]
    worst = abs(out["worst_force_diff_N"] - PARITY_REF["worst_force_diff_N"])
    print(f"[cli parity] worst_force_diff_N {out['worst_force_diff_N']:.6g} N against JAX's "
          f"{PARITY_REF['worst_force_diff_N']:.6g} (gap {worst:.3g} N); by seed "
          f"{[float(f'{g:.3g}') for g in gaps]} N (tol {PARITY_TOL}), {wall:.2f} s on {card}")
    check(max(gaps) <= PARITY_TOL and worst <= PARITY_TOL, f"18e: parity gaps {gaps} N")


def golden_on_card(device, card: str, counts: dict) -> None:
    """18f: the three golden scenes in float32 on the card, through
    fused_admm_iterations, fused_stagewise_solve and the PDIP, against the
    reference's qpOASES."""
    import numpy as np
    import torch

    from quad_periodic_mpc_tpu_torch.config import ADMMConfig, PDIPConfig
    from quad_periodic_mpc_tpu_torch.ops import qp_admm, qp_pdip, qp_stagewise
    from quad_periodic_mpc_tpu_torch.testing import fixtures, golden

    t0 = time.perf_counter()
    golden.load()
    solvers = {
        "admm": lambda qp, sw: qp_admm.solve(qp, ADMMConfig(iterations=400, backend="pallas"))[0],
        "pdip": lambda qp, sw: qp_pdip.solve(qp, PDIPConfig(iterations=40))[0],
        "stagewise": lambda qp, sw: qp_stagewise.solve(
            sw, ADMMConfig(iterations=400, backend="pallas"))[0],
    }
    reset_all_counts()
    for sc, ref in zip(fixtures.GOLDEN_SCENES, GOLDEN_XLA_GAP):
        qp, _, _ = fixtures.golden_scene(**sc, dtype=torch.float32, device=device)
        sw = fixtures.golden_stagewise_scene(**sc, dtype=torch.float32, device=device)
        x_gold, status, _ = golden.solve(qp.P, qp.q, golden.dense_constraint_matrix(
            qp.F, sc["horizon"]), qp.l, qp.u, reduced=True)
        check(status == 0, f"18f: qpOASES status {status}")
        for name, solve in solvers.items():
            x = solve(qp, sw).double().cpu().numpy().reshape(-1)
            err = np.abs(x - x_gold)
            excess = float((err - (GOLDEN_ATOL[name] + GOLDEN_RTOL * np.abs(x_gold))).max())
            jax_gap = ref[name]
            ok = excess <= 0.0 or float(err.max()) <= jax_gap * 4.0 / 3.0
            print(f"[golden] h={sc['horizon']} seed {sc['seed']} {name}: max |x - qpOASES| "
                  f"{float(err.max()):.4g} (JAX float32 XLA {jax_gap:.4g}), over the "
                  f"golden gate by {excess:.3g}{'' if excess <= 0 else ' (MISSED, held to JAX)'}")
            check(ok, f"18f: {name} at h={sc['horizon']} seed {sc['seed']}: {float(err.max())}")
    launched = {k: v for k, v in all_launch_counts().items() if v}
    _add(counts, launched)
    print(f"[golden] float32 on the card, 3 scenes, {time.perf_counter() - t0:.2f} s, "
          f"launches {launched} on {card}")
    check(launched == {"fused_admm_iterations": 3, "fused_stagewise_solve": 3},
          f"18f: launches {launched}")


def native_runtime(card: str) -> None:
    """18g: the native runtime built with g++ on this machine; host figures."""
    import os
    import socket

    import numpy as np

    from quad_periodic_mpc_tpu_torch.runtime import native_bridge as nb

    t0 = time.perf_counter()
    lib = nb.build()
    build_s = time.perf_counter() - t0
    ring = nb.StateRing(f"/qpm_smoke_ring_{os.getpid()}", frame_bytes=nb.STATE_BYTES, slots=4)
    try:
        frames = [bytes([i]) * nb.STATE_BYTES for i in range(10)]
        seqs = [ring.write(f) for f in frames]
        seq, data = ring.read_latest()
    finally:
        ring.close(unlink=True)
    check(seqs == list(range(1, 11)) and seq == 10 and data == frames[-1], "18g: the ring")
    probes = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM) for _ in range(2)]
    for s in probes:
        s.bind(("127.0.0.1", 0))
    pa, pb = (s.getsockname()[1] for s in probes)
    for s in probes:
        s.close()
    a = nb.UdpBridge(pa, "127.0.0.1", pb)
    b = nb.UdpBridge(pb, "127.0.0.1", pa)
    try:
        sent = a.send(b"x" * nb.CMD_BYTES)
        a.send(b"newest")
        time.sleep(0.01)
        got = b.recv_latest(nb.CMD_BYTES)
    finally:
        a.close()
        b.close()
    check(sent == nb.CMD_BYTES and got == b"newest", "18g: UDP loopback")
    tau, n = nb.clamp_torques(np.array([20.0, -20.0, 30.0] + [1.0] * 9))
    check(n == 3 and list(tau[:3]) == [17.0, -17.0, 26.0], "18g: clamp_torques")
    tau, applied = nb.power_protect(np.full(12, 10.0), np.full(12, 2.0), 120.0)
    check(applied and abs(float(np.sum(tau * 2.0)) - 120.0) < 1e-9, "18g: power_protect")
    q, n = nb.position_limit(np.array([5.0, 5.0, -3.0] + [0.0, 0.5, -1.5] * 3))
    check(n == 3 and q[1] == 4.19 and q[2] == -2.70, "18g: position_limit")
    q, n = nb.position_protect(np.full(12, 0.7), np.full(12, 0.5))
    check(n == 12 and abs(q[0] - 0.587) < 1e-12, "18g: position_protect")
    loop = nb.PeriodicLoop(2_000_000)
    loop.start()
    time.sleep(0.25)
    loop.stop()
    iters, overruns, jitter = loop.iterations, loop.overruns, loop.max_jitter_ns
    loop.destroy()
    print(f"[native] g++ build {build_s:.2f} s ({lib.name}); ring, UDP and the four safety "
          f"functions pass; the 500 Hz PeriodicLoop for 0.25 s: {iters} iterations, {overruns} "
          f"overruns, max jitter {jitter / 1e3:.1f} us (host figures, on the machine of {card})")
    check(80 <= iters <= 170, f"18g: {iters} loop iterations in 0.25 s")


def slice9(device, card: str) -> dict:
    """Phase 18.  Returns the launches by kernel of the CLI's runs (18a-e)
    and of the golden check (18f)."""
    t0 = time.perf_counter()
    cli, gold = {}, {}
    times = {}
    for tag, fn in (("18a-b", lambda: cli_rollouts(device, card, cli)),
                    ("18c", lambda: cli_live(device, card, cli)),
                    ("18d", lambda: cli_sweep(device, card, cli)),
                    ("18e", lambda: cli_parity(device, card)),
                    ("18f", lambda: golden_on_card(device, card, gold)),
                    ("18g", lambda: native_runtime(card))):
        t = time.perf_counter()
        fn()
        times[tag] = round(time.perf_counter() - t, 2)
    print(f"[cli] phase 18 took {time.perf_counter() - t0:.1f} s (by part, s: {times}) on {card}")
    return {"cli": cli, "golden": gold}


def first_difference(got, want) -> str | None:
    """None when every tensor of the two results is equal bit for bit;
    else the first that is not, with how many entries differ and by how
    much."""
    import torch

    g, w = _named_leaves(got), _named_leaves(want)
    if len(g) != len(w):
        return f"{len(g)} tensors against {len(w)}"
    for i, ((name, a), (_, b)) in enumerate(zip(g, w)):
        if a.shape != b.shape or a.dtype != b.dtype:
            return f"tensor {i} ({name}): {a.dtype} {tuple(a.shape)} against {b.dtype} " \
                   f"{tuple(b.shape)}"
        if not torch.equal(a, b):
            d = (a.double() - b.double()).abs()
            return (f"tensor {i} ({name}) {tuple(a.shape)}: {int((a != b).sum())} entries "
                    f"differ, largest |difference| {float(d.max()):.3g}")
    return None


def check_bit_equal(tag: str, got, want) -> None:
    diff = first_difference(got, want)
    print(f"[{tag}] replayed against eager: " + ("every tensor equal bit for bit"
                                                  if diff is None else f"DIFFER: {diff}"))
    check(diff is None, f"{tag}: the replay differs from the eager run: {diff}")


def _clone(tree):
    from quad_periodic_mpc_tpu_torch.utils.telemetry import leaves, unflatten

    return unflatten(tree, [t.clone() for t in leaves(tree)])


def graph_steps(device):
    """The steps phase 19 captures, each with its start, and the tunables
    of the tunable trot: ({name: (step, state)}, TunableParams).  The trot at BATCH (fused build), the tunable trot at BATCH
    (caller-built solve), the full stack's period at FS_BATCH, and at B = 1
    its MPC and plain ticks and the controller tick alone (the plant held),
    MPC and plain; and the trot's instance 0 with no batch axis (the CLI's
    rollout)."""
    from quad_periodic_mpc_tpu_torch.config import EstimatorConfig, SwingConfig, TunableParams
    from quad_periodic_mpc_tpu_torch.control import full_stack as FS
    from quad_periodic_mpc_tpu_torch.control import loop as L
    from quad_periodic_mpc_tpu_torch.utils.telemetry import leaves, unflatten

    mpc_cfg, loop_cfg, solver = _slice5_configs()
    est_cfg = EstimatorConfig()
    ctrl, plant, cmd, gait, dist = trot_inputs(device)
    tun = TunableParams.from_config(mpc_cfg, loop_cfg, est_cfg, SwingConfig(), device=device)
    trot = L.RolloutCarry(plant, ctrl)
    # instance 0 with no batch axis, as the CLI's rollout runs it
    one = lambda tree: unflatten(tree, [t[0] for t in leaves(tree)])
    steps = {
        "trot": (L.period_step(cmd, gait, dist, mpc_cfg, loop_cfg, est_cfg, solver), (trot,)),
        "trot, no batch axis": (L.period_step(one(cmd), gait, one(dist), mpc_cfg, loop_cfg,
                                              est_cfg, solver), (one(trot),)),
        "tunable trot": (L.period_step(cmd, gait, dist, mpc_cfg, loop_cfg, est_cfg, solver,
                                       tunable=tun), (trot,)),
    }
    mc, fs_gait, kw, fs_plant, fs_ctrl, fs_cmd = full_stack_setup(device, FS_BATCH)
    steps["full stack period"] = (FS.period_step(fs_cmd, fs_gait, mc, substeps=10, **kw),
                                  (FS.FullStackCarry(fs_plant, fs_ctrl),))
    mc, fs_gait, kw, p1, c1, cmd1 = full_stack_setup(device, 1)
    for do_mpc, which in ((True, "MPC"), (False, "plain")):
        steps[f"B=1 {which} tick"] = (FS.tick_step(cmd1, fs_gait, mc, do_mpc, substeps=10, **kw),
                                      (FS.FullStackCarry(p1, c1),))
        steps[f"B=1 controller {which} tick"] = (controller_alone(p1, cmd1, fs_gait, mc, do_mpc,
                                                                  kw), (c1,))
    return steps, tun


def controller_alone(plant, cmd, gait, mc, do_mpc: bool, kw: dict):
    """The controller tick with the plant held (bench.py:854-878's
    controller stream): step(ctrl) -> (ctrl',)."""
    from quad_periodic_mpc_tpu_torch.control import full_stack as FS

    return lambda ctrl: (FS.controller_tick(plant, ctrl, cmd, gait, mc, do_mpc, **kw)[0],)


def graph_sync_check(device, card: str) -> None:
    """(e) One eager run of every step phase 19 captures under
    torch.cuda.set_sync_debug_mode("error"): a call that makes the host
    wait for the card raises."""
    import torch

    steps, _ = graph_steps(device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for step, state in steps.values():
            step(*state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"[graphs] (e) one eager run of each of {len(steps)} captured steps ("
          f"{', '.join(steps)}) under set_sync_debug_mode('error'): no synchronising call, "
          f"{time.perf_counter() - t0:.2f} s on {card}")


def timed_calls(fn, state, n: int):
    """n calls of fn from state, each ending in a synchronize: (the state
    after them, ms of each call)."""
    import torch

    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        state = fn(state)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return state, times


def graph_main_path(device, card: str) -> dict:
    """(a) The bench trot at BATCH (fused build, ADMM-30, h = 10):
    loop.rollout and loop.rollout_graphed from one start for GRAPH_PERIODS
    periods, every tensor of the carry and the trace equal bit for bit and
    one fused-build launch a period; then the period timed eagerly and
    replayed, each period ending in a synchronize, and three replayed
    periods profiled.  Returns the counted launches."""
    import torch

    from quad_periodic_mpc_tpu_torch.config import EstimatorConfig
    from quad_periodic_mpc_tpu_torch.control import loop as L
    from quad_periodic_mpc_tpu_torch.runtime import graphs

    mpc_cfg, loop_cfg, solver = _slice5_configs()
    est_cfg = EstimatorConfig()
    ctrl, plant, cmd, gait, dist = trot_inputs(device)
    args = (cmd, gait, dist, mpc_cfg, loop_cfg, est_cfg, solver)
    want = L.rollout(GRAPH_PERIODS, plant, ctrl, *args)
    reset_all_counts()
    got = L.rollout_graphed(GRAPH_PERIODS, plant, ctrl, *args)
    torch.cuda.synchronize()
    launched = {k: v for k, v in all_launch_counts().items() if v}
    print(f"[graphs] (a) bench trot B={BATCH}: loop.rollout_graphed, {GRAPH_PERIODS} periods "
          f"({graphs.WARMUP} eager warm-up periods, then replays): launches {launched}")
    check(launched == {"fused_stagewise_solve_srb": GRAPH_PERIODS},
          f"(a): launches {launched}, expected {GRAPH_PERIODS} fused-build launches alone")
    check_bit_equal("graphs (a)", got, want)

    step = L.period_step(*args)
    first = L.RolloutCarry(plant, ctrl)
    _, eager = timed_calls(lambda c: step(c)[0], first, GRAPH_PERIODS)
    g = graphs.capture(step, first)
    carry, warm = timed_calls(lambda c: g(c)[0], first, graphs.WARMUP + 1)
    reset_all_counts()
    carry, replay = timed_calls(lambda c: g(c)[0], carry, GRAPH_PERIODS)
    launched = {k: v for k, v in all_launch_counts().items() if v}
    check(launched == {"fused_stagewise_solve_srb": GRAPH_PERIODS},
          f"(a): {GRAPH_PERIODS} replays launched {launched}")
    med_e, med_r = statistics.median(eager), statistics.median(replay)
    print(f"[graphs] (a) ms a period: eager median {med_e:.3f} (min {min(eager):.3f}), "
          f"replayed median {med_r:.3f} (min {min(replay):.3f}, max {max(replay):.3f}), "
          f"{med_e / med_r:.2f}x; the capturing call {warm[-1]:.1f} ms (the warm-up periods "
          f"{', '.join(f'{t:.1f}' for t in warm[:-1])} ms) on {card}")
    prof = profile_periods(lambda c, p: tuple(g(L.RolloutCarry(p, c))[0])[::-1], carry.ctrl,
                           carry.plant, unit="replayed period")
    busy_of_replay("(a)", prof, med_r)
    return launched


def busy_of_replay(tag: str, prof: dict | None, replay_ms: float) -> None:
    """The profiled device ms of a replayed period over its unprofiled
    median ms (the profiler slows the replays' issue)."""
    if prof is not None:
        print(f"[graphs] {tag} device {prof['device_ms']:.2f} ms of the {replay_ms:.3f} ms "
              f"unprofiled replayed period: {100 * prof['device_ms'] / replay_ms:.1f}% busy")


def graph_retune(device, card: str) -> dict:
    """(b) The tunable trot at BATCH (TunableParams, one
    fused_stagewise_solve a period): GRAPH_TUNE_PERIODS periods, the
    z weight x10, alpha 4e-4 and f_max 60 written into the tunables by
    copy_, GRAPH_TUNE_PERIODS more; replayed and eager equal bit for bit,
    and the retune moved the forces.  Returns the replays' launches."""
    import torch

    from quad_periodic_mpc_tpu_torch.runtime import graphs

    steps, tun = graph_steps(device)
    step, (start,) = steps["tunable trot"]
    base = [t.clone() for t in tun]

    def retune():
        w = tun.weights.clone()
        w[5] *= 10.0
        tun.weights.copy_(w)
        tun.alpha.copy_(torch.full_like(tun.alpha, 4e-4))
        tun.f_max.copy_(torch.full_like(tun.f_max, 60.0))

    def run(fn, retuned: bool):
        for t, b in zip(tun, base):
            t.copy_(b)
        carry = start
        for i in range(2 * GRAPH_TUNE_PERIODS):
            if retuned and i == GRAPH_TUNE_PERIODS:
                retune()
            carry = fn(carry)[0]
        torch.cuda.synchronize()
        return _clone(carry)

    want = run(step, True)
    untuned = run(step, False)
    g = graphs.capture(step, start)
    reset_all_counts()
    got = run(g, True)
    launched = {k: v for k, v in all_launch_counts().items() if v}
    moved = _maxdiff(want.ctrl.fr_des, untuned.ctrl.fr_des)
    print(f"[graphs] (b) tunable trot B={BATCH}: {GRAPH_TUNE_PERIODS} periods, a retune by "
          f"copy_ (z weight x10, alpha 4e-4, f_max 60), {GRAPH_TUNE_PERIODS} more: launches "
          f"{launched}; the retune moved the forces by {moved:.3g} N")
    check(launched == {"fused_stagewise_solve": 2 * GRAPH_TUNE_PERIODS},
          f"(b): launches {launched}")
    check(moved > 1.0, f"(b): the retune moved the forces by only {moved}")
    check_bit_equal("graphs (b)", got, want)
    for t, b in zip(tun, base):
        t.copy_(b)
    return launched


def graph_full_stack(device, card: str) -> dict:
    """(c) The full stack at FS_BATCH (full_stack_setup): GRAPH_FS_EQUAL
    periods of rollout_articulated_graphed against rollout_articulated, bit
    for bit; then FS_PERIODS periods from the start through one capture,
    (13, 13, 13, 1, 0) launches each, the trot-walks gates, the replays'
    ms (the periods full_stack_path times) and three profiled.  Returns
    the launches of the FS_PERIODS periods."""
    import torch

    from quad_periodic_mpc_tpu_torch.control import full_stack as FS
    from quad_periodic_mpc_tpu_torch.runtime import graphs

    mc, gait, kw, plant, ctrl, cmd = full_stack_setup(device, FS_BATCH)
    z0 = float(plant.fb.pos[0, 2])
    want = FS.rollout_articulated(GRAPH_FS_EQUAL, plant, ctrl, cmd, gait, mc, substeps=10, **kw)
    got = FS.rollout_articulated_graphed(GRAPH_FS_EQUAL, plant, ctrl, cmd, gait, mc,
                                         substeps=10, **kw)
    check_bit_equal("graphs (c)", got, want)

    g = graphs.capture(FS.period_step(cmd, gait, mc, substeps=10, **kw),
                       FS.FullStackCarry(plant, ctrl))
    reset_all_counts()
    carry, traces, times, finite = FS.FullStackCarry(plant, ctrl), [], [], True
    for i in range(FS_PERIODS):
        before = fs_counts()
        t0 = time.perf_counter()
        carry, end = g(carry)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        per = tuple(a - b for a, b in zip(fs_counts(), before))
        check(per == (13, 13, 13, 1, 0), f"(c) period {i}: launches (model_eval, wbc, "
              f"substeps, stagewise, contact) = {per}, expected (13, 13, 13, 1, 0)")
        traces.append({k: v[None].clone() for k, v in end.items()})
        finite &= all(bool(torch.isfinite(t).all()) for t in (*carry.plant.fb, carry.ctrl.fr_des))
    check(finite, "(c): non-finite state")
    launched = dict(zip(FS_KERNELS[:4], fs_counts()))
    timed = times[FS_WARM:FS_WARM + FS_TIMED]
    med = statistics.median(timed)
    print(f"[graphs] (c) full stack B={FS_BATCH}: {FS_PERIODS} periods through one capture "
          f"({graphs.WARMUP} eager, the capturing period {times[graphs.WARMUP]:.1f} ms), "
          f"periods {FS_WARM}-{FS_WARM + FS_TIMED - 1} replayed: median {med:.3f} ms/period "
          f"(min {min(timed):.3f}, max {max(timed):.3f}), {med / 13:.4f} ms per batched tick; "
          f"launches {launched} on {card}")
    trot_walks("graphs (c)", traces, carry.plant, z0)
    prof = profile_periods(lambda c, p: tuple(g(FS.FullStackCarry(p, c))[0])[::-1],
                           carry.ctrl, carry.plant, unit="replayed period")
    busy_of_replay("(c)", prof, med)
    return launched


def _quantiles(ms: list) -> str:
    import numpy as np

    return (f"p50 {np.percentile(ms, 50):.3f} / p99 {np.percentile(ms, 99):.3f} / max "
            f"{max(ms):.3f} ms")


def graph_single_robot(device, card: str) -> dict:
    """(d) B = 1: the tick pair (full_stack.capture_ticks) for GRAPH_CHAINS
    chains of GRAPH_B1_PERIODS periods, and the controller alone (the plant
    held) the same, each tick ending in a synchronize; the eager ticks the
    same.  The first GRAPH_B1_EQUAL periods equal rollout_articulated's bit
    for bit.  p50 / p99 / max ms a tick beside the 2 ms budget (printed,
    not gated).  Returns the tick pair's launches."""
    import torch

    from quad_periodic_mpc_tpu_torch.control import full_stack as FS
    from quad_periodic_mpc_tpu_torch.runtime import graphs

    mc, gait, kw, plant, ctrl, cmd = full_stack_setup(device, 1)
    ticks = 13 * GRAPH_B1_PERIODS * GRAPH_CHAINS
    start = FS.FullStackCarry(plant, ctrl)
    want = FS.rollout_articulated(GRAPH_B1_EQUAL, plant, ctrl, cmd, gait, mc, substeps=10,
                                  **kw)[0]

    def run(mpc_tick, plain_tick, state):
        times, equal_at = [], None
        for i in range(ticks):
            t0 = time.perf_counter()
            state = (mpc_tick if i % 13 == 0 else plain_tick)(state)[0]
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            if i == 13 * GRAPH_B1_EQUAL - 1:
                equal_at = _clone(state)
        return state, times, equal_at

    tick = lambda do_mpc: FS.tick_step(cmd, gait, mc, do_mpc, substeps=10, **kw)
    alone = lambda do_mpc: controller_alone(plant, cmd, gait, mc, do_mpc, kw)
    _, eager, _ = run(tick(True), tick(False), start)
    _, eager_c, _ = run(alone(True), alone(False), ctrl)
    reset_all_counts()
    mpc_tick, plain_tick = FS.capture_ticks(plant, ctrl, cmd, gait, mc, substeps=10, **kw)
    end, replay, got = run(mpc_tick, plain_tick, start)
    launched = {k: v for k, v in all_launch_counts().items() if v}
    check_bit_equal("graphs (d)", got, want)
    check(bool(torch.isfinite(end.plant.fb.pos).all()), "(d): non-finite B = 1 plant")
    periods = ticks // 13
    check(launched == {"fused_model_eval": ticks, "fused_wbc": ticks, "fused_substeps": ticks,
                       "fused_stagewise_solve_srb": periods},
          f"(d): launches {launched} over {ticks} ticks")
    mpc_c = graphs.capture(alone(True), ctrl)
    _, replay_c, _ = run(mpc_c, mpc_c.also(alone(False)), ctrl)
    # the replayed ticks only: each graph's first WARMUP calls run eagerly,
    # the next captures
    warm = {13 * k for k in range(graphs.WARMUP + 1)} | set(range(1, graphs.WARMUP + 2))
    replayed = lambda ms: [t for i, t in enumerate(ms) if i not in warm]
    print(f"[graphs] (d) B=1, {GRAPH_CHAINS} chains of {13 * GRAPH_B1_PERIODS} ticks, a "
          f"synchronize after each: composed tick replayed {_quantiles(replayed(replay))}, "
          f"eager {_quantiles(eager)}; controller alone replayed "
          f"{_quantiles(replayed(replay_c))}, eager {_quantiles(eager_c)}; budget "
          f"{TICK_BUDGET_MS} ms (printed, not gated); launches {launched} on {card}")
    return launched


def slice10(device, card: str) -> dict:
    """Phase 19.  Returns the launches by kernel of its counted runs."""
    t0 = time.perf_counter()
    launches, times = {}, {}
    for tag, fn in (("e", lambda: graph_sync_check(device, card)),
                    ("a", lambda: _add(launches, graph_main_path(device, card))),
                    ("b", lambda: _add(launches, graph_retune(device, card))),
                    ("c", lambda: _add(launches, graph_full_stack(device, card))),
                    ("d", lambda: _add(launches, graph_single_robot(device, card)))):
        t = time.perf_counter()
        fn()
        times[tag] = round(time.perf_counter() - t, 2)
    print(f"[graphs] phase 19 took {time.perf_counter() - t0:.1f} s (by part, s: {times}) "
          f"on {card}")
    return launches


# ---------------------------------------------------------------------------
# slice 12: the evidence tools (phase 20)
# ---------------------------------------------------------------------------

def evidence_table(device, card: str) -> dict:
    """20a: the port's parity_table on the card, every scene and setting
    held by evidence_cell; the walking scenes' applied first step within
    EVIDENCE_REL of JAX's; the fused ADMM kernel launched exactly
    EVIDENCE_LAUNCHES times and no other kernel.  Returns the launches."""
    import numpy as np

    from quad_periodic_mpc_tpu_torch.testing import golden
    from quad_periodic_mpc_tpu_torch.tools import parity_table as PT

    golden.load()
    t0 = time.perf_counter()
    reset_all_counts()
    rows, failed, misses, wide = [], [], 0, []
    for sc in PT.SCENES:
        walking = bool(sc.get("walking"))
        solves = PT.solve_scene(sc, device)
        gaps = PT.scene_gaps(solves, walking)
        rows.append((sc, gaps))
        name = PT.scene_name(sc)
        ref = EVIDENCE_GAPS[name]
        cells = []
        for setting, x in solves.x.items():
            err = np.abs(x - solves.x_gold)
            atol = EVIDENCE_ATOL[setting]
            excess = float((err - (atol + GOLDEN_RTOL * np.abs(solves.x_gold))).max())
            held, how = evidence_cell(gaps[setting], excess, ref[setting], setting,
                                      (name, setting) in EVIDENCE_SPREAD)
            misses += how.startswith("JAX's own miss")
            cells.append(f"{setting} {gaps[setting]:.6g} (JAX {ref[setting][0]:.6g}, draws "
                         f"{max(ref[setting]):.6g}; {how})")
            if not held:
                failed.append(f"{name} {setting}: {gaps[setting]:.4g} N (JAX "
                              f"{ref[setting]}, over the gate by {excess:.3g})")
        if walking:
            first, jax_first = gaps["_walk_first_step"], ref["_walk_first_step"][0]
            tail, jax_tail = gaps["production warm x6"], ref["production warm x6"][0]
            cells.append(f"applied first step {first:.6g} (JAX {jax_first:.6g}, held within "
                         f"{EVIDENCE_REL:.0%})")
            if not abs(first / jax_first - 1.0) <= EVIDENCE_REL:
                failed.append(f"{name} applied first step: {first:.6g} N (JAX {jax_first:.6g})")
            wide.append(f"{name}: tail {tail:.6g} >= {EVIDENCE_MISS} N "
                        f"{tail >= EVIDENCE_MISS}, first step {first / jax_first:.6f}x JAX's "
                        f"<= {EVIDENCE_FIRST_STEP}x {first <= EVIDENCE_FIRST_STEP * jax_first}; "
                        f"tail {tail / jax_tail:.6f}x JAX's")
        print(f"[evidence] {name}: " + "; ".join(cells))
    secs = time.perf_counter() - t0
    launched = {k: v for k, v in all_launch_counts().items() if v}
    print(f"[evidence] 20a, the gap table on the card ({len(rows)} scenes x "
          f"{len(PT.SOLVERS)} settings, float32; qpOASES float64 on the host), on {card}:")
    for line in PT.format_table(rows).splitlines():
        print(f"[evidence table] {line}")
    for line in wide:
        print(f"[evidence] the issue's wider walking gates, {line}")
    print(f"[evidence] 20a took {secs:.1f} s; launches {launched}; {misses} cells JAX's own "
          f"misses (>= {EVIDENCE_JAX_MISS} N): PDIP held to miss too, ADMM within "
          f"{EVIDENCE_REL:.0%} of JAX's")
    check(not failed, "20a: " + "; ".join(failed))
    # the production setting warm x6 on each of the 9 still scenes, and the
    # walking scenes' 12 condensed mpc_steps each through the kernel; ADMM-400
    # cold, ADMM-30 warm and the stagewise ADMM-400 take their "xla" paths
    check(launched == {"fused_admm_iterations": EVIDENCE_LAUNCHES},
          f"20a: launches {launched}, expected {EVIDENCE_LAUNCHES} fused_admm_iterations")
    return launched


def xla_loops(device, card: str) -> None:
    """20c: the two solver loops 20a and 20b put on the card, alone: the
    condensed ADMM's "xla" loop (qp_admm.solve) at 20a's B = 1 and 20b's B
    = 72, h = 10 (the fixture QP of seed 3), and the stagewise ADMM's scan
    path (qp_stagewise.solve) at B = 1 on 20a's first h = 10 and h = 19
    scenes: ms an iteration (CUDA events around 101 iterations less 1, over
    100; host-bound, so the host's issue) and launches an iteration (the
    profiler over 11 iterations less 1, over 10)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from quad_periodic_mpc_tpu_torch.config import ADMMConfig
    from quad_periodic_mpc_tpu_torch.ops import qp_admm, qp_stagewise
    from quad_periodic_mpc_tpu_torch.testing.fixtures import make_mpc_qp
    from quad_periodic_mpc_tpu_torch.tools import parity_table as PT

    def launches(fn) -> int:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0)

    cases = {}
    for B in (1, 72):
        qp, _, _ = make_mpc_qp(horizon=10, batch=(B,) if B > 1 else (), seed=3, device=device)
        cases[f"condensed ADMM 'xla' loop, B = {B}, h = 10"] = (
            lambda n, qp=qp: qp_admm.solve(qp, ADMMConfig(iterations=n)))
    for sc in (PT.SCENES[0], PT.SCENES[3]):
        _, sw, _ = PT.scene_problems(**sc, device=device)
        cases[f"stagewise ADMM scan path, B = 1, h = {sc['horizon']}"] = (
            lambda n, sw=sw: qp_stagewise.solve(sw, ADMMConfig(iterations=n)))
    for name, solve in cases.items():
        ms = (time_ms(lambda: solve(101), 2) - time_ms(lambda: solve(1), 2)) / 100
        per = (launches(lambda: solve(11)) - launches(lambda: solve(1))) / 10
        print(f"[evidence] 20c, {name}: {ms:.4f} ms and {per:.1f} launches an iteration "
              f"on {card}")


def _ab_job(job: dict) -> dict:
    """One arm of 20b in a process of its own: the port's estimator_ab
    run_arm over the tool's grid at job["window"], timed, its launches read
    in that process, then a warm and two profiled periods of a fresh chunk
    of the same sweep (before the estimator's release)."""
    import torch

    sys.path.insert(0, str(REPO))
    import quad_periodic_mpc_tpu_torch  # noqa: F401  (sets the f32 policy)
    from quad_periodic_mpc_tpu_torch.config import ADMMConfig, LoopConfig
    from quad_periodic_mpc_tpu_torch.parallel import mesh as ML
    from quad_periodic_mpc_tpu_torch.parallel import sweep as SW
    from quad_periodic_mpc_tpu_torch.tools import estimator_ab as AB

    device = torch.device(job["device"])
    torch.cuda.set_device(device)
    spec, window = AB.grid(), job["window"]
    _sync(device)
    reset_all_counts()
    t0 = time.perf_counter()
    row = AB.run_arm(job["arm"], spec, window, device=device)
    _sync(device)
    secs = time.perf_counter() - t0
    launches = {k: v for k, v in all_launch_counts().items() if v}

    est_cfg = AB.arm_config(job["arm"], window)
    cfg = (SW.DEFAULT_MPC, LoopConfig(), est_cfg, ADMMConfig(iterations=100))
    (chunk,) = SW.build_chunks(spec, ML.make_mesh(devices=[device]), SW.DEFAULT_MPC, est_cfg,
                               cfg[-1], torch.float32)

    def step(ctrl, plant):
        carry, _ = SW.rollout_chunk(1, chunk._replace(plant=plant, ctrl=ctrl), *cfg)
        return carry.ctrl, carry.plant

    ctrl, plant = step(chunk.ctrl, chunk.plant)
    prof = profile_periods(step, ctrl, plant, n=2) or {}
    return {"row": row, "secs": secs, "periods": 2 * window, "launches": launches,
            "prof": prof}


def evidence_ab(device, card: str, window: int = AB_WINDOW) -> dict:
    """20b: the port's estimator_ab at the JAX tool's grid (72 instances),
    window ``window`` (2 x window periods an arm), its four arms side by side
    in spawned processes (each period is host-bound); held to JAX's CPU run
    at the same window (EVIDENCE_AB): the order of the arms in mean vx RMS,
    "ls" against "off" under AB_RATIO, each arm's mean within AB_REL of
    JAX's.  Returns the launches (none: the sweep's ADMM-100 is the "xla"
    loop)."""
    import multiprocessing

    from quad_periodic_mpc_tpu_torch.tools import estimator_ab as AB

    t0 = time.perf_counter()
    jobs = [{"device": str(device), "arm": arm, "window": window} for arm in AB.ARMS]
    with concurrent.futures.ProcessPoolExecutor(
            len(jobs), mp_context=multiprocessing.get_context("spawn")) as pool:
        out = dict(zip(AB.ARMS, pool.map(_ab_job, jobs)))
    secs = time.perf_counter() - t0
    rows = [out[arm]["row"] for arm in AB.ARMS]
    ref = {r["arm"]: r for r in EVIDENCE_AB[str(window)]}
    print(f"[evidence] 20b, the estimator A/B on the card (window {window}, "
          f"{rows[0]['instances']} instances, {2 * window} periods an arm, the four arms side by "
          f"side), on {card}:")
    for line in AB.format_table(rows, window).splitlines():
        print(f"[evidence ab] {line}")
    launches = {}
    for arm in AB.ARMS:
        o, p = out[arm], out[arm]["prof"]
        busy = f"{100 * p['device_ms'] / p['wall_ms']:.1f} %" if p else "not measured"
        print(f"[evidence ab] {arm}: {1e3 * o['secs'] / o['periods']:.2f} ms a period over "
              f"{o['periods']} periods with the set-up ({o['secs']:.1f} s); one profiled period "
              f"(before release): {p.get('wall_ms', float('nan')):.2f} ms wall, "
              f"{p.get('device_ms', float('nan')):.2f} ms device, busy {busy}, "
              f"{p.get('launches')} launches; mean vx RMS {o['row']['vx_rms_mean']:.5f} (JAX CPU "
              f"{ref[arm]['vx_rms_mean']:.5f})")
        _add(launches, o["launches"])
    by_mean = sorted(AB.ARMS, key=lambda a: out[a]["row"]["vx_rms_mean"])
    jax_order = sorted(AB.ARMS, key=lambda a: ref[a]["vx_rms_mean"])
    ratio = out["ls"]["row"]["vx_rms_mean"] / out["off"]["row"]["vx_rms_mean"]
    jax_ratio = ref["ls"]["vx_rms_mean"] / ref["off"]["vx_rms_mean"]
    gate = AB_RATIO if window == 400 else jax_ratio + 0.05
    rel = {a: out[a]["row"]["vx_rms_mean"] / ref[a]["vx_rms_mean"] - 1.0 for a in AB.ARMS}
    print(f"[evidence ab] order {' < '.join(by_mean)} (JAX CPU {' < '.join(jax_order)}); ls vs "
          f"off {ratio:.4f} (JAX CPU {jax_ratio:.4f}, gate {gate:.4f}); mean vx RMS against JAX "
          f"{ {a: float(f'{v:+.3e}') for a, v in rel.items()} } (gate +-{AB_REL}; the issue's "
          f"+-{AB_ISSUE_REL}: {all(abs(v) <= AB_ISSUE_REL for v in rel.values())}); 20b took "
          f"{secs:.1f} s, launches {launches}")
    check(by_mean == jax_order, f"20b: the arms' order {by_mean}, JAX's {jax_order}")
    check(ratio <= gate, f"20b: ls vs off {ratio} over {gate}")
    check(all(abs(v) <= AB_REL for v in rel.values()), f"20b: against JAX {rel}")
    check(not launches, f"20b: the sweep's 'xla' ADMM launched {launches}")
    return launches


def slice12(device, card: str) -> dict:
    """Phase 20.  Returns the launches by kernel of 20a."""
    t0 = time.perf_counter()
    launched = evidence_table(device, card)
    t = time.perf_counter()
    evidence_ab(device, card)
    t_c = time.perf_counter()
    xla_loops(device, card)
    print(f"[evidence] phase 20 took {time.perf_counter() - t0:.1f} s (20a {t - t0:.1f}, 20b "
          f"{t_c - t:.1f}, 20c {time.perf_counter() - t_c:.1f}) on {card}")
    return launched


def slice5(device, card: str) -> dict:
    """Phases 11-13.  Returns the launches of their counted runs, by path
    and kernel."""
    launches = estimator_experiments(device, card)
    return {
        "experiment": {"fused_stagewise_solve_srb": launches["experiment"]},
        "lateral": {"fused_stagewise_solve_srb": launches["lateral"]},
        "tunable": tunable_period(device, card),
        "weight sweep": {"fused_admm_iterations": weight_sweep(device, card)},
        "go1": {"fused_stagewise_solve_srb": go1_rollout(device, card)},
    }


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
        by_name = kernel_table(device, card)
        record = by_name["fused_stagewise_solve_srb"]
        srb_plant, swing = by_name["srb_plant_step"], by_name["swing_update"]
        plant_paths = srb_plant["launches_by_path"] = {}
        # the paths that run a swing update (bench.py's glide, on the main
        # path's timed periods and the walking lines, runs none)
        swing_paths = swing["launches_by_path"] = {}
        # the paths that run the foothold search: those with a heightmap
        foothold = by_name["foothold_update"]
        foothold_paths = foothold["launches_by_path"] = {}
        take_foothold_launches()
        counts = main_path(device, card)
        n = take_foothold_launches()
        check(n == 0, f"the main path passes no heightmap, yet launched foothold_update {n} times")
        srb_plant["launches"] = counts["srb_plant_step"]
        swing["launches"] = swing_paths["main path"] = counts["swing_update"]
        take_swing_launches()
        srb_shapes = {s["path"]: s for s in record["shapes"]}
        record["launches"] = counts["fused_stagewise_solve_srb"]
        srb_shapes["main path"]["launches"] = record["launches"]
        dumps = counts["srb_build_dump"]
        for name, n in full_stack_path(device, card).items():
            if name == "fused_stagewise_solve_srb":
                srb_shapes["full stack"]["launches"] = n
            else:
                by_name[name]["launches"] = n
        swing_paths["full stack"] = take_swing_launches()
        single_robot(device, card)
        swing_paths["single robot"] = take_swing_launches()
        take_srb_plant_launches()
        solve_records = [by_name[n] for n in ("fused_stagewise_solve",
                                               "fused_stagewise_solve_stream", "srb_build_dump")]
        counts = walking_line(device, card, "predictive", BATCH, HORIZON, ADMM_ITERS,
                              PREDICTIVE_WARM, LINE_TIMED, "fused_stagewise_solve",
                              predictive=True)
        solve_records[0]["launches"] = counts["fused_stagewise_solve"]
        for line in LONG_LINES:
            counts = walking_line(device, card, *line)
            dumps += counts["srb_build_dump"]
            if line[-1] == "fused_stagewise_solve_stream":
                solve_records[1]["launches"] = counts[line[-1]]
            if f"line {line[0]}" in srb_shapes:
                srb_shapes[f"line {line[0]}"]["launches"] = counts["fused_stagewise_solve_srb"]
        solve_records[2]["launches"] = dumps
        plant_paths["walking lines"] = take_srb_plant_launches()
        for rec in [*solve_records,
                    *(s for s in record["shapes"] if s["path"] not in SWEEP_SHAPES)]:
            check(rec.get("launches", 0) > 0, f"{rec.get('name', rec.get('path'))} was "
                  "launched on no driven path")
        slice4(device, card, by_name)
        take_srb_plant_launches()
        take_swing_launches()
        for path, counts in [*slice5(device, card).items(),
                             ("terrain", terrain_experiment(device, card))]:
            for name, n in counts.items():
                check(n > 0, f"{name} was launched no time on the {path} path")
                by_name[name].setdefault("launches_by_path", {})[path] = n
        plant_paths["tunable, weight sweep, go1"] = take_srb_plant_launches()   # in this process
        swing_paths["estimator, tunable, go1, terrain"] = take_swing_launches()
        elevation_mapping(device, card)
        take_srb_plant_launches()
        take_swing_launches()
        take_foothold_launches()
        by_kernel, by_shape, sweep_figures = sweeps(device, card)
        plant_paths["sweeps"] = take_srb_plant_launches()
        swing_paths["sweeps"] = take_swing_launches()
        foothold_paths["sweeps"] = take_foothold_launches()     # config 4's map-aware sweep
        for name, n in by_kernel.items():
            by_name[name].setdefault("launches_by_path", {})["sweeps"] = n
        for path, n in by_shape.items():
            srb_shapes[path]["launches"] = n
            check(n > 0, f"fused_stagewise_solve_srb was launched no time at the {path} shape")
        for name in ("fused_stagewise_solve_srb", "fused_admm_iterations", "fused_model_eval",
                     "fused_wbc", "fused_substeps", "fused_contact_kinematics"):
            check(by_kernel.get(name, 0) > 0, f"{name} was launched no time on the sweeps path")
        stand = slice8(device, card)
        for name, n in stand["launches"].items():
            check(n > 0, f"{name} was launched no time on the force stand path")
            by_name[name].setdefault("launches_by_path", {})["force stand"] = n
        take_srb_plant_launches()
        take_swing_launches()
        surfaces = slice9(device, card)
        plant_paths["cli"] = take_srb_plant_launches()
        swing_paths["cli"] = take_swing_launches()
        for path, names in (("cli", ("fused_stagewise_solve_srb", "fused_stagewise_solve",
                                     "fused_admm_iterations")),
                            ("golden", ("fused_stagewise_solve", "fused_admm_iterations"))):
            for name in names:
                check(surfaces[path].get(name, 0) > 0,
                      f"{name} was launched no time on the {path} path")
            for name, n in surfaces[path].items():
                by_name[name].setdefault("launches_by_path", {})[path] = n
        graphed = slice10(device, card)
        plant_paths["graphs"] = take_srb_plant_launches()       # the eager warm-ups
        swing_paths["graphs"] = take_swing_launches()
        for name in ("fused_stagewise_solve_srb", "fused_stagewise_solve", "fused_model_eval",
                     "fused_wbc", "fused_substeps"):
            check(graphed.get(name, 0) > 0, f"{name} was launched no time on the graphs path")
        for name, n in graphed.items():
            by_name[name].setdefault("launches_by_path", {})["graphs"] = n
        for name, n in slice12(device, card).items():
            by_name[name].setdefault("launches_by_path", {})["evidence"] = n
        plant_paths["evidence"] = take_srb_plant_launches()
        check(srb_plant["launches"] > 0, "srb_plant_step was launched on no driven path")
        for path, n in plant_paths.items():
            check(n > 0, f"srb_plant_step was launched no time on the {path} path")
        for path, n in swing_paths.items():
            check(n > 0, f"swing_update was launched no time on the {path} path")
        foothold["launches"] = sum(foothold_paths.values())
        for path, n in foothold_paths.items():
            check(n > 0, f"foothold_update was launched no time on the {path} path")
        if "jax" in sys.modules or "quad_periodic_mpc_tpu" in sys.modules:
            raise SmokeFailure("JAX or the JAX package was imported")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print("[sweep figures] " + json.dumps(sweep_figures))
    print(card)
    print(json.dumps({"kernels": list(by_name.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
