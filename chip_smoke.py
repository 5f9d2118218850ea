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
2. hold each kernel against its plain PyTorch version on the card with the
   tolerances stated below, and time both: the fused-build stagewise solve
   at every (B, h, ADMM iterations) at which the driven paths launch it,
   each timed, and at ragged shapes (B = 1, 133, 1000; h = 48); the torque
   tick's model evaluation, contact kinematics, WBC and plant substeps at
   B = 256 (the full stack's batch), 1 and 37, from seeded numpy inputs,
   the model evaluation, WBC and plant kernels timed at B = 1 as well (the
   single robot);
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
6. hold the caller-built stagewise kernels against their plain versions:
   fused_stagewise_solve (per-step c at the predictive path's shape, a
   ragged long-horizon batch with a shared c, dense Ad, and a dense-Ad case
   whose warm Newton-Schulz seeds fail the gate, so that the cold restart
   runs), the streamed
   solve at h = 128 and 72 (with the KKT residuals of both answers), and
   srb_build_dump, also against the independent problem build;
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
8. hold the slice-4 kernels against their plain versions: fused_kf_innovate
   on conditioned seeded states at B = 2048, 37 and 1 (timed at 2048 and
   1) and on states from
   tick 3 of a cold start (the looser, stated tolerance; ticks 0 and 1 are
   printed, not gated), the kernel's and the plain version's x' also within
   a stated multiple of eps * cond(S) of float64 instance by instance, and
   the "xla" backend's dense chain timed on the same inputs as the nearest
   library figure; fused_admm_iterations at B = 2048, h = 10, 30
   iterations in float32 and with bfloat16 storage, B = 37 at h = 16, B = 1,
   h = 20 / 28 (resident) and one horizon past each resident size (23 / 31),
   from zero and non-zero starts; past KC.admm_tol's calibration (h > 28,
   KC.admm_f64_gated) the kernel is held to the float64 plain version
   instead, no farther from it than KC.ADMM_F64_FACTOR times the float32
   plain version;
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
   and printed beside it (not gated).

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
# the fused-build kernel vs its plain version at every (B, h, ADMM
# iterations) of the paths that launch it, each timed: the main path's
# first, then the h = 16 / 32 / 64 lines' and the full stack's; then
# untimed ragged batches (B = 133 is one block more than the card's SMs)
SRB_SHAPES = ((BATCH, HORIZON, ADMM_ITERS, "main path"), (1024, 16, 40, "line h=16"),
              (512, 32, 50, "line h=32"), (256, 64, 50, "line h=64"),
              (256, HORIZON, ADMM_ITERS, "full stack"))
KERNEL_CASES = ((1000, HORIZON), (256, 48), (133, HORIZON), (1, HORIZON))
# U and z are forces (~100 N): FMA contraction and summation order differ
# between the kernel and the plain version's batched products, amplified
# through 30 ADMM sweeps (this is the gate the JAX kernel is held to
# against its XLA path).  y is rho-scaled (rho = 3e-4).
TOL = {"U": 2e-3, "z": 2e-3, "y": 1e-5}
# The long-horizon solve, 50 sweeps: the same sources of roundoff through a
# chain of h (1 + 2 iters) dependent stage steps, 12,928 at h = 128 against
# 610 at h = 10 (where the gap measures ~4e-4, and ~1e-3 at h = 48).  The
# KKT residuals of the kernel's and the plain version's answers are held
# together as well: the kernel's may exceed the plain version's by at most
# a tenth plus 1e-4.
TOL_STREAM = {"U": 5e-3, "z": 5e-3, "y": 1e-5}
TOL_DUMP = 1e-6       # the same entries in exact f32; 3x3 products may round differently
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
# torque tick: bench.py's full-stack batch, the kernel-check batches, and
# the reference's trot-walks test (45 periods, vx = 0.15)
FS_BATCH, FS_VX, FS_PERIODS, FS_WARM, FS_TIMED = 256, 0.15, 45, 3, 10
TICK_CASES = (FS_BATCH, 1, 37)
B1_CHAINS, B1_PERIODS = 10, 2
# kernel vs plain version, the tolerances of the reference's kernel tests
# (tests/test_kinematics_kernel.py): f32 sums in another order.  The model
# evaluation's, the WBC's and the plant's are testing/kernel_cases.MODEL_TOL,
# WBC_TOL and PLANT_TOL, which say why they are what they are
TICK_TOL = {"contact": {"Jc": 2e-5, "p_foot": 2e-5, "Jcdqd": 5e-4}}
# slice 4: the estimation tick (KFParams.dt = 0.002: 500 ticks are 1 s) and
# the condensed line (bench.py audits its sixth warm step)
EST_TICKS, EST_PROFILE_TICKS, EST_XLA_TICKS = 500, 20, 300
# the dense chain against the kernel's path after EST_XLA_TICKS ticks from a
# cold start: the reference's gate between its two float32 backends.  The
# dense chain refines neither solve, so through the transient it is the
# further of the two from float64, and is held once it settles
EST_XLA_GAP = 2e-3
CONDENSED_WARM, CONDENSED_TIMED = 6, 10
KF_CASES = ((BATCH, 10), (37, 11), (1, 12))            # (B, seed)
# (B, h, iterations, non-zero start, bf16 storage); the first two are the
# main path's; h = 20 / 28 lie past the first design's resident sizes and
# inside this one's, h = 23 / 31 just past this one's (K^-1 streamed)
ADMM_CASES = ((BATCH, HORIZON, ADMM_ITERS, False, False), (BATCH, HORIZON, ADMM_ITERS, True, True),
              (37, 16, 40, True, False), (37, 16, 40, False, True),
              (1, HORIZON, ADMM_ITERS, True, False), (5, 20, ADMM_ITERS, True, False),
              (5, 28, ADMM_ITERS, True, True), (5, 23, ADMM_ITERS, True, False),
              (5, 31, ADMM_ITERS, True, True))
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
                rescued: int, assemble: bool = True, srb_ad: bool = True,
                stream: bool = False) -> int:
    """Floating-point operations of one stagewise solve (multiply and add
    each count one), from the loops of csrc/stagewise_body.cuh.  ``rescued``
    is the number of (instance, stage) warm inverses that failed the gate
    and restarted cold in this run's data (the plain version counts them).
    assemble: the in-kernel SRB build (the fused-build kernel); srb_ad: Ad
    products over 7 live terms and Bd's row 12 skipped, else 13 dense terms;
    stream: r_lin and q recomputed in the sweeps."""
    mm12 = 144 * 23                    # one 12x12x12 product
    ns_round = 2 * mm12 + 144
    norm = 3 * 144
    n_ad = 14 if srb_ad else 25        # one entry of an Ad product
    n_bd = 23 if srb_ad else 25        # one entry of a contraction against Bd
    riccati_stage = (156 * n_bd + 144 * (n_bd + 1) + 156 * n_ad + 3588 + 325
                     + 2 * 169 * n_ad + 3887 + 676)
    warm_inverse = 3 * mm12 + 2 * norm + 3 * 144 + 2 + (ns_warm - 1) * ns_round
    cold_inverse = norm + ns_it * ns_round
    r_lin = 148
    backward = r_lin + 13 + 12 * (n_bd + 1) + 13 * n_ad + 299 + 26
    forward = (12 * (n_bd + 1) + 276 + 300 + 24 + 13 * n_ad + 299 + 26 + 36 + 100 + 60
               + 80 + 60)
    if stream:
        backward += 26                 # q_k = -Q xref_{k-1}
        forward += r_lin
    per_instance = (
        (54 + 4 * 110 + 12 + 31 if assemble else 0) + h * riccati_stage + cold_inverse
        + (h - 1) * warm_inverse + h * iters * (backward + forward))
    return B * per_instance + rescued * (cold_inverse + 144)


def solve_bytes(B: int, h: int, built: bool = False, per_step_c: bool = False) -> int:
    """Each input read once, each output written once (float32).  built:
    caller-built Ad, Bd and c instead of the raw observation."""
    dynamics = 169 + 156 + (h * 13 if per_step_c else 13) if built else 9 + 12 + 1 + 6
    per_instance = dynamics + 13 + h * (13 + 20 + 20 + 12 + 20 + 20)
    shared = 13 + 144 + 15
    outputs = h * (12 + 20 + 20)
    return 4 * (B * (per_instance + outputs) + shared)


# Operation counts of the torque-tick kernels' building blocks (multiply and
# add each count one; csrc/kinematics.cu, wbc.cu, plant.cu)
MM3, MV3, CROSS3 = 45, 15, 9
XAPPLY = 2 * MV3 + CROSS3 + 3             # X(R, r) v
XT_FORCE = 2 * MV3 + CROSS3 + 3           # X(R, r)^T f
FORCE_CROSS = 3 * CROSS3 + 3
MV6 = 6 * 11


def gemm_flops(r: int, k: int, s: int) -> int:
    return r * s * (2 * k - 1)


# warp_linalg.cuh inv3 (the damped 3x3 closed form); wbc.cu cone_apply and
# cone_apply_T (the four legs' 6x3 friction blocks) and max_step (24 rows)
INV3 = 3 + 6 * 3 + 5 + 1 + 9
CONE_APPLY, CONE_APPLY_T = 4 * 11, 4 * 14
MAX_STEP = 24 * 2 + 2


def spd_inv_flops(n: int) -> int:
    """The recursive Schur inverse (warp_linalg.cuh SpdInv)."""
    if n <= 3:
        return {1: 1, 2: 8, 3: INV3}[n]
    h, r = (n + 1) // 2, n - (n + 1) // 2
    return (spd_inv_flops(h) + gemm_flops(h, h, r) + gemm_flops(r, h, r) + r * r
            + spd_inv_flops(r) + gemm_flops(h, r, r) + gemm_flops(h, r, h) + h * h)


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


def pdip_row_flops() -> int:
    """The row and vector work of one PDIP iteration besides the KKT
    inverse and its three mat-vecs (wbc.cu: the floors, A x, the dual
    residual, the complementarity sums, the rows' residuals, the KKT
    right-hand side and matrix, the step, its length and the update), loop
    by loop, each counted once: the lanes share it out (one a cone row or
    a variable) and every lane repeats the two row-ordered sums, which
    counts once here as the work the function needs.  The step's ratio is
    counted on every row and the update on every iteration: an upper count
    where a row's step does not shrink or an instance freezes."""
    NJ, NCON = 12, 24
    floors = 4 * NCON                                   # fmaxf on sl, su, zl, zu
    rdual = CONE_APPLY + NCON + CONE_APPLY_T + NJ * (2 * NJ - 1 + 2)
    mu_t = 2 * (2 * NCON - 1) + 2 + 2                   # the two sums, mu_c, mu_t
    rows = NCON * (2 + 2 + 2 + 2 + 3)                   # r_pl, r_pu, r_cl, r_cu, d
    rhs = 2 * (3 * NCON + CONE_APPLY_T) + 2 * NJ
    kkt = 4 * (4 * 3 + 11 + 7) + NJ                     # the legs' blocks, reg
    step = CONE_APPLY + NCON * (1 + 1 + 3 + 3) + 4 * MAX_STEP + 3
    update = 2 * NJ + 4 * 2 * NCON
    return floors + rdual + mu_t + rows + rhs + kkt + step + update


def wbc_flops(iters: int) -> int:
    """Per instance, from wbc.cu's loops: the masking, KinWBC, the WBIC
    cascade, the QP set-up, `iters` PDIP iterations and the torques."""
    ND, NJ, NCON = 18, 12, 24
    task_J = lambda i: gemm_flops(3, 3 if i < 2 else ND, ND)
    task_v = lambda i: gemm_flops(3, 3 if i < 2 else ND, 1)
    proj = gemm_flops(ND, ND, 3) + gemm_flops(ND, 3, ND) + ND * ND
    mask = 3 * NJ * ND + NJ
    kin = (gemm_flops(NJ, ND, NJ) + NJ + spd_inv_flops(NJ)
           + gemm_flops(ND, NJ, NJ) + gemm_flops(ND, NJ, ND) + ND)
    for i in range(6):
        kin += task_J(i) + gemm_flops(3, ND, 3) + INV3 + gemm_flops(ND, 3, 3)
        kin += 2 * gemm_flops(ND, 3, 1) + (0 if i == 0 else 2 * task_v(i) + 6 + 2 * ND)
        kin += proj if i < 5 else 0
    kin += NJ                                                    # des_jpos
    wbic = (gemm_flops(ND, ND, NJ) + gemm_flops(NJ, ND, NJ) + NJ + spd_inv_flops(NJ)
            + gemm_flops(ND, NJ, NJ) + gemm_flops(ND, NJ, 1) + gemm_flops(ND, NJ, ND) + ND)
    for i in range(6):
        wbic += (task_J(i) + gemm_flops(ND, ND, 3) + gemm_flops(3, ND, 3) + INV3
                 + gemm_flops(ND, 3, 3) + task_v(i) + 6 + gemm_flops(ND, 3, 1) + ND)
        wbic += proj if i < 5 else 0
    resid = 6 * ((2 * ND - 1) + (2 * NJ - 1) + 2)
    bounds = CONE_APPLY + 4 + 2 * NCON                           # l, u - l
    qp_setup = (resid + spd_inv_flops(6) + gemm_flops(6, 6, 1) + gemm_flops(6, 6, NJ)
                + NJ * NJ * (2 * 6 - 1 + 2) + NJ * (2 * 6 - 1 + 1) + bounds)
    pdip_iter = (pdip_row_flops() + spd_inv_flops(NJ) + 3 * gemm_flops(NJ, NJ, 1)
                 + 2 * NJ)
    finish = NJ + 6 * (2 * NJ - 1 + 2) + NJ * ((2 * ND - 1) + (2 * NJ - 1) + 2)
    return mask + kin + wbic + qp_setup + iters * pdip_iter + finish


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


def admm_flops(n: int, m: int, iters: int) -> int:
    """Per instance, from csrc/admm.cu's loops: rhs (12 a variable), the
    K^{-1} product (2 n^2), the x update (3 a variable) and the z / y / w row
    work (17 a row) per iteration, and the set-up of 1/rho and w."""
    return iters * (2 * n * n + 15 * n + 17 * m) + 3 * m


def admm_bytes(B: int, n: int, m: int) -> int:
    """K^{-1}, q, x0 and l, u, rho, z0, y0 read once, x, z, y written once."""
    return 4 * (B * (n * n + 2 * n + 5 * m + n + 2 * m) + 15)


# floats per instance (inputs, outputs) and shared, each read or written once
TICK_FLOATS = {
    "model": (37, 324 + 324 + 18 + 18 + 216 + 12 + 12, 4 * 432 + 36 + 12),
    "contact": (37, 216 + 12 + 12, 432 + 12),
    "wbc": (324 + 324 + 18 + 216 + 12 + 4 + 9 + 4 * 18 + 12 + 12, 4 * 12, 0),
    "plant": (4 + 3 + 6 + 12 + 12 + 8 + 12 + 324 + 18 + 18 + 216 + 12,
              4 + 3 + 6 + 12 + 12 + 8 + 12 + 4, 0),
}


def bound(flops: int, nbytes: int) -> tuple[float, str]:
    t_ops = 1e3 * flops / FP32_FLOPS_PER_S
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


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


def compare_kernels(device, card: str) -> dict:
    """The fused-build kernel against its plain version at SRB_SHAPES, each
    timed (its record's "shapes"; launches are filled in from the paths),
    and at KERNEL_CASES.  Returns its record."""
    import torch

    from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel as SK
    from quad_periodic_mpc_tpu_torch.testing import kernel_cases

    shapes, plain_ms = [], None
    cases = [*SRB_SHAPES, *((B, h, ADMM_ITERS, None) for B, h in KERNEL_CASES)]
    for i, (B, h, iters, path) in enumerate(cases):
        args, kw = kernel_cases.stagewise_case(B, h, seed=100 + i, device=device, iters=iters)
        got = SK.fused_stagewise_solve_srb(*args, **kw)
        torch.cuda.synchronize()
        stats = {}
        want = SK.fused_stagewise_solve_srb_reference(*args, **kw, stats=stats)
        errs = {n: float((g - w).abs().max()) for n, g, w in zip("Uzy", got, want)}
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        print(f"[kernel] stagewise_srb B={B} h={h} ADMM-{iters}: max|dU|={errs['U']:.3g} "
              f"(tol {TOL['U']}), max|dz|={errs['z']:.3g} (tol {TOL['z']}), "
              f"max|dy|={errs['y']:.3g} (tol {TOL['y']}), rescued stages "
              f"{stats['rescued']}")
        check(finite, f"kernel output not finite at B={B} h={h}")
        for n in "Uzy":
            check(errs[n] <= TOL[n], f"kernel disagrees with plain version: "
                  f"max|d{n}|={errs[n]} > {TOL[n]} at B={B} h={h}")
        if path is None:
            continue
        ms, call_ms = kernel_ms(lambda: SK.fused_stagewise_solve_srb(*args, **kw), 20,
                                "stagewise_srb_kernel")
        flops = solve_flops(B, h, iters, kw["ns_it"], SK.ns_warm_rounds(kw["ns_it"]),
                            stats["rescued"])
        nbytes = solve_bytes(B, h)
        bound_ms, bound_by = bound(flops, nbytes)
        shapes.append({"path": path, "B": B, "h": h, "iters": iters, "launches": 0,
                       "ms": ms, "call_ms": call_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "max_abs_err": max(errs.values())})
        plain = ""
        if plain_ms is None:                        # the main path's shape
            plain_ms = time_ms(lambda: SK.fused_stagewise_solve_srb_reference(*args, **kw), 2)
            plain = f", plain version {plain_ms:.1f} ms"
        print(f"[kernel] B={B} h={h} ADMM-{iters} ({path}): kernel {ms:.3f} ms on the "
              f"device ({call_ms:.3f} ms per call){plain}, bound {bound_ms:.4f} ms "
              f"({flops:.3e} flop, {nbytes} B) on {card}")
    main = shapes[0]
    return {
        "name": "fused_stagewise_solve_srb", "route": "cuda",
        "source": "quad_periodic_mpc_tpu_torch/csrc/stagewise_srb.cu",
        "replaces": "quad_periodic_mpc_tpu/ops/pallas/stagewise_kernel.py:753",
        "launches": 0, "max_abs_err": max(r["max_abs_err"] for r in shapes),
        "ms": main["ms"], "plain_ms": plain_ms, "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None, "shapes": shapes,
    }


def _maxdiff(a, b) -> float:
    return float((a - b).abs().max())


def compare_solve_kernels(device, card: str) -> dict:
    """The caller-built stagewise kernels (fused_stagewise_solve, its
    streamed variant, srb_build_dump) against their plain versions, from
    seeded numpy inputs; each timed at its path's shape.  Returns
    {name: record}."""
    import torch

    from quad_periodic_mpc_tpu_torch.ops import qp_stagewise
    from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel as SK
    from quad_periodic_mpc_tpu_torch.testing import kernel_cases as KC

    csrc = "quad_periodic_mpc_tpu_torch/csrc/"
    tpu = "quad_periodic_mpc_tpu/ops/pallas/stagewise_kernel.py:"
    records = {}

    def record(name, source, line, worst, ms, plain_ms, flops, nbytes):
        bound_ms, bound_by = bound(flops, nbytes)
        records[name] = {
            "name": name, "route": "cuda", "source": csrc + source, "replaces": tpu + line,
            "launches": 0, "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        return bound_ms, bound_by

    def solve_case(name, fn, plain, tol, B, h, iters, per_step_c, dense_ad, seed, kkt,
                   rescue=False):
        if rescue:          # dense Ad whose warm NS seeds fail the gate
            (args, kw), sw = KC.rescue_case(B, h, seed=seed, device=device, iters=iters), None
        else:
            args, kw, sw = KC.solve_case(B, h, seed=seed, device=device, iters=iters,
                                         per_step_c=per_step_c, dense_ad=dense_ad,
                                         with_problem=True)
        if name == "fused_stagewise_solve":
            kw["srb_ad"] = not dense_ad
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        stats = {}
        want = plain(*args, **kw, stats=stats)
        errs = {n: _maxdiff(g, w) for n, g, w in zip("Uzy", got, want)}
        what = (f"{name} B={B} h={h} ADMM-{iters} "
                f"{'per-step' if per_step_c else 'shared'} c"
                f"{', dense Ad' if dense_ad else ''}{', rescue case' if rescue else ''}")
        print(f"[kernel] {what}: " + ", ".join(
            f"max|d{n}|={errs[n]:.3g} (tol {tol[n]})" for n in "Uzy")
            + f", rescued stages {stats['rescued']}")
        check(all(bool(torch.isfinite(g).all()) for g in got), f"{what}: output not finite")
        for n in "Uzy":
            check(errs[n] <= tol[n], f"{what} disagrees with its plain version: "
                  f"max|d{n}|={errs[n]} > {tol[n]}")
        check(not rescue or stats["rescued"] > 0, f"{what}: no stage was rescued")
        if kkt:
            res_k, res_p = (qp_stagewise.kkt_residuals(sw, *out) for out in (got, want))
            for r in ("primal", "dual"):
                k_, p_ = float(res_k[r].max()), float(res_p[r].max())
                print(f"[kernel] {what}: KKT {r} max {k_:.3g} (kernel) / {p_:.3g} (plain)")
                check(k_ <= 1.1 * p_ + 1e-4, f"{what}: the kernel's KKT {r} residual {k_} "
                      f"exceeds the plain version's {p_}")
        return args, kw, stats, max(errs.values())

    # ---- fused_stagewise_solve ----
    name = "fused_stagewise_solve"
    worst = 0.0
    for B, h, per_step_c, dense_ad, seed in ((37, 48, False, False, 201),
                                             (37, HORIZON, True, True, 202),
                                             (BATCH, HORIZON, True, False, 200)):
        args, kw, stats, err = solve_case(
            name, SK.fused_stagewise_solve, SK.fused_stagewise_solve_reference, TOL,
            B, h, ADMM_ITERS, per_step_c, dense_ad, seed, kkt=False)
        worst = max(worst, err)
    worst = max(worst, solve_case(
        name, SK.fused_stagewise_solve, SK.fused_stagewise_solve_reference, TOL, 5, HORIZON,
        ADMM_ITERS, False, True, 7, kkt=False, rescue=True)[3])
    ms, call_ms = kernel_ms(lambda: SK.fused_stagewise_solve(*args, **kw), 20,
                            "stagewise_solve_kernel")
    plain_ms = time_ms(lambda: SK.fused_stagewise_solve_reference(*args, **kw), 2)
    flops = solve_flops(BATCH, HORIZON, ADMM_ITERS, kw["ns_it"], SK.ns_warm_rounds(kw["ns_it"]),
                        stats["rescued"], assemble=False)
    nbytes = solve_bytes(BATCH, HORIZON, built=True, per_step_c=True)
    bound_ms, by = record(name, "stagewise_solve.cu", "610", worst, ms, plain_ms, flops, nbytes)
    print(f"[kernel] {name} B={BATCH} h={HORIZON}: kernel {ms:.3f} ms on the device "
          f"({call_ms:.3f} ms per call), plain version {plain_ms:.1f} ms, bound "
          f"{bound_ms:.4f} ms ({by}; {flops:.3e} flop, {nbytes} B) on {card}")

    # ---- fused_stagewise_solve_stream ----
    name = "fused_stagewise_solve_stream"
    worst = 0.0
    for B, h, per_step_c, seed in ((5, 72, True, 211), (128, 128, False, 210)):
        args, kw, stats, err = solve_case(
            name, SK.fused_stagewise_solve_stream, SK.fused_stagewise_solve_stream_reference,
            TOL_STREAM, B, h, STREAM_ITERS, per_step_c, False, seed, kkt=True)
        worst = max(worst, err)
    ms, call_ms = kernel_ms(lambda: SK.fused_stagewise_solve_stream(*args, **kw), 3,
                            "stagewise_stream_kernel")
    plain_ms = time_ms(lambda: SK.fused_stagewise_solve_stream_reference(*args, **kw), 1)
    flops = solve_flops(128, 128, STREAM_ITERS, kw["ns_it"], SK.ns_warm_rounds(kw["ns_it"]),
                        stats["rescued"], assemble=False, stream=True)
    nbytes = solve_bytes(128, 128, built=True)
    bound_ms, by = record(name, "stagewise_stream.cu", "1103", worst, ms, plain_ms, flops,
                          nbytes)
    print(f"[kernel] {name} B=128 h=128 ADMM-{STREAM_ITERS}: kernel {ms:.2f} ms on the "
          f"device ({call_ms:.2f} ms per call), plain version {plain_ms:.0f} ms, bound "
          f"{bound_ms:.4f} ms ({by}; {flops:.3e} flop, {nbytes} B) on {card}")

    # ---- srb_build_dump ----
    name = "srb_build_dump"
    worst = 0.0
    for B in (37, BATCH):
        args, sw = KC.srb_dump_case(B, seed=220 + B, device=device)
        got = SK.srb_build_dump(*args)
        torch.cuda.synchronize()
        errs = {}
        for n, g, w, b in zip(("Ad", "Bd", "c"), got, SK.srb_assemble(*args),
                              (sw.Ad, sw.Bd, sw.c)):
            errs[n] = _maxdiff(g, w)
            errs[n + " vs build_stagewise"] = _maxdiff(g, b)
        print(f"[kernel] {name} B={B}: " + ", ".join(
            f"max|d{n}|={e:.3g}" for n, e in errs.items()) + f" (tol {TOL_DUMP})")
        check(max(errs.values()) <= TOL_DUMP, f"{name} disagrees at B={B}: {errs}")
        worst = max(worst, *errs.values())
    ms, call_ms = kernel_ms(lambda: SK.srb_build_dump(*args), 20, "srb_build_dump_kernel")
    plain_ms = time_ms(lambda: SK.srb_assemble(*args), 3)
    flops, nbytes = BATCH * (54 + 4 * 110 + 12 + 31 + 13), 4 * BATCH * (28 + 338)
    bound_ms, by = record(name, "stagewise_srb.cu", "1225", worst, ms, plain_ms, flops, nbytes)
    print(f"[kernel] {name} B={BATCH}: kernel {ms:.4f} ms on the device ({call_ms:.4f} ms "
          f"per call), plain version {plain_ms:.3f} ms, bound {bound_ms:.6f} ms ({by}; "
          f"{flops:.3e} flop, {nbytes} B) on {card}")
    return records


def compare_tick_kernels(device, card: str) -> dict:
    """Kernels 2-5 of the torque tick against their plain versions at
    TICK_CASES, from seeded numpy inputs; timed at the full stack's batch.
    Returns {name: record}."""
    import torch

    from quad_periodic_mpc_tpu_torch.control.wbc import WBCGains
    from quad_periodic_mpc_tpu_torch.models import floating_base as fb
    from quad_periodic_mpc_tpu_torch.ops.cuda import kinematics_kernel as KK
    from quad_periodic_mpc_tpu_torch.ops.cuda import plant_kernel as PK
    from quad_periodic_mpc_tpu_torch.ops.cuda import wbc_kernel as WK
    from quad_periodic_mpc_tpu_torch.sim.articulated_sim import ContactParams
    from quad_periodic_mpc_tpu_torch.testing import kernel_cases as KC

    mc = fb.build_a1_constants("float32", str(device))
    gains, params, sub_dt, substeps = WBCGains(), ContactParams(), 2e-4, 10
    eye = torch.eye(18, device=device)

    def model(B):
        st = KC.model_states(B, seed=4, device=device)
        A, Ainv, G, C, info = KK.fused_model_eval(st, mc)
        A_r, _, G_r, C_r, info_r = KK.model_eval_reference(st, mc)
        errs = {"A": _maxdiff(A, A_r), "G": _maxdiff(G, G_r), "C": _maxdiff(C, C_r),
                "Jc": _maxdiff(info.Jc, info_r.Jc), "p_foot": _maxdiff(info.p_foot, info_r.p_foot),
                "Jcdqd": _maxdiff(info.Jcdqd, info_r.Jcdqd), "AinvA-I": _maxdiff(Ainv @ A, eye)}
        return errs, (A, Ainv, G, C, *info), (lambda: KK.fused_model_eval(st, mc),
                                              lambda: KK.model_eval_reference(st, mc))

    def contact(B):
        st = KC.model_states(B, seed=2, device=device)
        got, want = KK.fused_contact_kinematics(st, mc), fb.contact_jacobians(st, mc)
        errs = {f: _maxdiff(getattr(got, f), getattr(want, f)) for f in ("Jc", "p_foot", "Jcdqd")}
        return errs, tuple(got), (lambda: KK.fused_contact_kinematics(st, mc),
                                  lambda: fb.contact_jacobians(st, mc))

    def wbc(B):
        args = KC.wbc_kernel_args(*KC.wbc_state_and_input(B, device=device))
        got = WK.fused_wbc(*args, gains, KC.WBC_PDIP)
        want = WK.fused_wbc_reference(*args, gains, KC.WBC_PDIP)
        errs = {n: _maxdiff(g, w) for n, g, w in zip(("q_des", "qd_des", "tau", "fr"), got, want)}
        # where qd_des disagrees most, and the plain version's own float32
        # error there (against itself in float64): the gap's cause
        want64 = WK.fused_wbc_reference(*(a.double() for a in args), gains, KC.WBC_PDIP)
        i = int((got[1] - want[1]).abs().amax(-1).argmax())
        own = float((want[1][i] - want64[1][i]).abs().max())
        print(f"[kernel] fused_wbc B={B}: max|dqd_des| at instance {i}, stance "
              f"{[int(c) for c in args[5][i].tolist()]}; there the plain version's "
              f"float32 qd_des is {own:.3g} from its float64 one")
        return errs, got, (lambda: WK.fused_wbc(*args, gains, KC.WBC_PDIP),
                           lambda: WK.fused_wbc_reference(*args, gains, KC.WBC_PDIP))

    def plant(B):
        case = KC.plant_case(B, device=device)
        p0, tau, cache, Jc, pf = case
        run = lambda fn: fn(p0, tau, sub_dt, params, cache, Jc, pf, substeps)
        (pb, pf_b), (pa, pf_a) = run(PK.fused_substeps), run(PK.fused_substeps_reference)
        errs = {f: _maxdiff(getattr(pb.fb, f), getattr(pa.fb, f))
                for f in ("pos", "quat", "v_body", "q", "qd")}
        errs["p_foot"] = _maxdiff(pf_b, pf_a)
        errs["anchor"] = _maxdiff(pb.anchor, pa.anchor)
        check(torch.equal(pb.in_contact, pa.in_contact), "plant kernel: contact flags differ")
        return errs, (*pb.fb, pb.anchor, pf_b), (lambda: run(PK.fused_substeps),
                                                 lambda: run(PK.fused_substeps_reference))

    specs = {   # record name, source, kernel symbol, TPU kernel, case, flop/instance
        "model": ("fused_model_eval", "kinematics.cu", "model_eval_kernel",
                  "quad_periodic_mpc_tpu/ops/pallas/kinematics_kernel.py:727", model,
                  model_eval_flops()),
        "wbc": ("fused_wbc", "wbc.cu", "wbc_kernel",
                "quad_periodic_mpc_tpu/ops/pallas/wbc_kernel.py:493",
                wbc, wbc_flops(KC.WBC_PDIP.iterations)),
        "plant": ("fused_substeps", "plant.cu", "plant_kernel",
                  "quad_periodic_mpc_tpu/ops/pallas/plant_kernel.py:224", plant,
                  substep_flops(substeps)),
        "contact": ("fused_contact_kinematics", "kinematics.cu", "contact_kinematics_kernel",
                    "quad_periodic_mpc_tpu/ops/pallas/kinematics_kernel.py:286", contact,
                    contact_kinematics_flops(False)),
    }
    records = {}
    for key, (name, src, symbol, replaces, case, flops_per) in specs.items():
        worst = 0.0
        for B in TICK_CASES:
            errs, outs, (kernel_fn, plain_fn) = case(B)
            torch.cuda.synchronize()
            tol = {**TICK_TOL, "model": KC.MODEL_TOL, "wbc": KC.WBC_TOL,
                   "plant": KC.PLANT_TOL}[key]
            print(f"[kernel] {name} B={B}: " + ", ".join(
                f"max|d{n}|={e:.3g} (tol {tol[n]})" for n, e in errs.items()))
            check(all(bool(torch.isfinite(o).all()) for o in outs),
                  f"{name} output not finite at B={B}")
            for n, e in errs.items():
                check(e <= tol[n], f"{name} disagrees with its plain version: "
                      f"max|d{n}|={e} > {tol[n]} at B={B}")
            worst = max(worst, *errs.values())
            if B == FS_BATCH:
                ms, call_ms = kernel_ms(kernel_fn, 20, symbol)
                plain_ms = time_ms(plain_fn, 3)
            elif B == 1 and key in ("model", "wbc", "plant"):     # the single-robot user's
                b1_ms, b1_call_ms = kernel_ms(kernel_fn, 20, symbol)
        per_in, per_out, shared = TICK_FLOATS[key]
        nbytes = 4 * (FS_BATCH * (per_in + per_out) + shared)
        flops = FS_BATCH * flops_per
        bound_ms, bound_by = bound(flops, nbytes)
        records[name] = {
            "name": name, "route": "cuda", "source": f"quad_periodic_mpc_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": 0, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
        }
        print(f"[kernel] {name} B={FS_BATCH}: kernel {ms:.4f} ms on the device "
              f"({call_ms:.4f} ms per call), plain version "
              f"{plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by}; {flops:.3e} flop, "
              f"{nbytes} B) on {card}")
        if key in ("model", "wbc", "plant"):
            print(f"[kernel] {name} B=1: kernel {b1_ms:.4f} ms on the device "
                  f"({b1_call_ms:.4f} ms per call between CUDA events), beside "
                  f"{ms:.4f} ({call_ms:.4f}) at B={FS_BATCH} on {card}")
    return records


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


def make_period(device, mpc_cfg, est_cfg, solver):
    """bench.py's step for one configuration: solve, hold the first-step
    forces over the period, swing feet glide toward a half-stance Raibert
    touchdown.  period(ctrl, plant, cmd, gait, dist, return_qp=False) ->
    (ctrl, plant, forces, qp or None)."""
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
        errs = [_maxdiff(g, w) for g, w in zip(built, (qp.Ad, qp.Bd, qp.c))]
        print(f"[{tag}] fused build (srb_build_dump) vs audited problem: max|dAd|="
              f"{errs[0]:.3g}, max|dBd|={errs[1]:.3g}, max|dc|={errs[2]:.3g} (tol {TOL_DUMP})")
        check(max(errs) <= TOL_DUMP, f"{tag}: the kernel's build differs from the audit's")
    return ctrl, plant, qp


def profile_periods(step, ctrl, plant, n: int = 3, unit: str = "period") -> None:
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
    print(f"[profile] per {unit}: device busy {busy:.2f} ms of {wall_ms / n:.2f} ms "
          f"wall ({100 * busy * n / wall_ms:.1f}% busy), "
          f"{sum(r[1] for r in rows)} kernel launches")
    for ms, count, key in sorted(rows, reverse=True)[:8]:
        print(f"[profile]   {ms:8.3f} ms  x{count:<4d} {key[:90]}")


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
    print(f"[main path] bench trot B={BATCH} h={HORIZON} ADMM-{ADMM_ITERS}: "
          f"{TIMED_PERIODS} periods, median {statistics.median(times):.2f} ms/period "
          f"(min {min(times):.2f}, max {max(times):.2f}), kernel launches {launches} "
          f"on {card}")
    check(launches == TIMED_PERIODS and sum(counts.values()) == launches,
          f"expected {TIMED_PERIODS} fused-build launches and no other, counted {counts}")
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
    t0 = time.perf_counter()
    carry, trace = L.rollout(ROLLOUT_PERIODS, plant, ctrl, cmd, gait, dist,
                             mpc_cfg, loop_cfg, est_cfg, solver)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / ROLLOUT_PERIODS
    rollout_launches = SK.LAUNCHES["fused_stagewise_solve_srb"]
    print(f"[main path] loop.rollout B={BATCH}: {ROLLOUT_PERIODS} periods, "
          f"{ms:.1f} ms/period (13 control ticks each), kernel launches "
          f"{rollout_launches} on {card}")
    check(rollout_launches == ROLLOUT_PERIODS,
          f"expected {ROLLOUT_PERIODS} rollout launches, counted {rollout_launches}")
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
    from quad_periodic_mpc_tpu_torch.ops.cuda import kinematics_kernel as KK
    from quad_periodic_mpc_tpu_torch.ops.cuda import plant_kernel as PK
    from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel as SK
    from quad_periodic_mpc_tpu_torch.ops.cuda import wbc_kernel as WK

    def counts():
        return (KK.LAUNCHES["fused_model_eval"], WK.LAUNCHES, PK.LAUNCHES,
                SK.LAUNCHES["fused_stagewise_solve_srb"],
                KK.LAUNCHES["fused_contact_kinematics"])

    for k in KK.LAUNCHES:
        KK.LAUNCHES[k] = 0
    WK.LAUNCHES = PK.LAUNCHES = 0
    reset_stagewise_counts()
    mc, gait, kw, plant, ctrl, cmd = full_stack_setup(device, FS_BATCH)

    def periods(plant, ctrl, n):
        carry, trace = FS.rollout_articulated(n, plant, ctrl, cmd, gait, mc, substeps=10,
                                              **kw)
        return carry.plant, carry.ctrl, trace

    z0 = float(plant.fb.pos[0, 2])
    torch.cuda.synchronize()
    traces, times, all_finite = [], [], True
    for i in range(FS_PERIODS):
        before = counts()
        t0 = time.perf_counter()
        plant, ctrl, trace = periods(plant, ctrl, 1)
        torch.cuda.synchronize()
        if FS_WARM <= i < FS_WARM + FS_TIMED:
            times.append(1e3 * (time.perf_counter() - t0))
        per = tuple(a - b for a, b in zip(counts(), before))
        check(per == (13, 13, 13, 1, 0), f"full-stack period {i}: launches (model_eval, "
              f"wbc, substeps, stagewise, contact) = {per}, expected (13, 13, 13, 1, 0)")
        traces.append(trace)
        all_finite &= all(bool(torch.isfinite(t).all()) for t in (*plant.fb, ctrl.fr_des))
    launches = dict(zip(("fused_model_eval", "fused_wbc", "fused_substeps",
                         "fused_stagewise_solve_srb", "fused_contact_kinematics"), counts()))
    check(launches["fused_contact_kinematics"] == 1,
          f"contact kinematics launched {launches['fused_contact_kinematics']} times, expected 1")
    check(all_finite, "non-finite state on the full-stack path")
    med = statistics.median(times)
    print(f"[full stack] B={FS_BATCH} trot vx={FS_VX}, ADMM-{ADMM_ITERS} h={HORIZON}, "
          f"WBC PDIP-15, 10 substeps: {FS_TIMED} timed periods, median {med:.2f} ms/period "
          f"(min {min(times):.2f}, max {max(times):.2f}), {FS_BATCH / med * 1e3:.1f} "
          f"periods/s, {med / 13:.3f} ms per batched tick; launches {launches} on {card}")

    pos = torch.cat([t["pos"] for t in traces]).cpu()          # (periods, B, 3)
    vb = torch.cat([t["v_body"] for t in traces]).cpu()
    dist = float(pos[-1, :, 0].min())
    dz = float((pos[10:, :, 2] - z0).abs().max())
    qw = float(plant.fb.quat[:, 0].abs().min())
    vx = vb[15:, :, 3].mean(0)
    print(f"[full stack] trot walks ({FS_PERIODS} periods): forward {dist:.4f} m (> 0.10), "
          f"max|z - z0| after period 10 {dz:.4f} (< 0.04), min|quat_w| {qw:.5f} (> 0.99), "
          f"mean v_x after period 15 in [{float(vx.min()):.4f}, {float(vx.max()):.4f}] "
          f"(0.05, 0.3)")
    check(dist > 0.10, f"the robot did not walk forward: {dist} m")
    check(dz < 0.04, f"body height left the band: {dz}")
    check(qw > 0.99, f"attitude tumbled: |quat_w| = {qw}")
    check(bool(((vx > 0.05) & (vx < 0.3)).all()), "mean forward speed out of (0.05, 0.3)")

    profile_periods(lambda c, p: periods(p, c, 1)[1::-1], ctrl, plant)
    return launches


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


def compare_slice4_kernels(device, card: str) -> dict:
    """fused_kf_innovate and fused_admm_iterations against their plain
    versions from seeded numpy inputs, each timed at its path's shape.
    Returns {name: record}."""
    import torch

    from quad_periodic_mpc_tpu_torch.estimation import kf as KF
    from quad_periodic_mpc_tpu_torch.ops.cuda import admm_kernel as AK
    from quad_periodic_mpc_tpu_torch.ops.cuda import kf_kernel as FK
    from quad_periodic_mpc_tpu_torch.testing import kernel_cases as KC

    records = {}

    def hold(what, got, want, tol, names):
        errs = {n: _maxdiff(g, w) for n, g, w in zip(names, got, want)}
        print(f"[kernel] {what}: " + ", ".join(
            f"max|d{n}|={errs[n]:.3g} (tol {tol[n]})" for n in names))
        check(all(bool(torch.isfinite(g).all()) for g in got), f"{what}: output not finite")
        for n in names:
            check(errs[n] <= tol[n], f"{what} disagrees with its plain version: "
                  f"max|d{n}|={errs[n]} > {tol[n]}")
        return max(errs.values())

    # ---- fused_kf_innovate ----
    name, worst = "fused_kf_innovate", 0.0
    kf = lambda a: FK.fused_kf_innovate(*a, dt=KC.KF_DT)
    kf_plain = lambda a: FK.fused_kf_innovate_reference(*a, dt=KC.KF_DT)
    for B, seed in reversed(KF_CASES):
        args = KC.kf_case(B, seed=seed, device=device)
        if B == 1:
            b1_args = args
        got = kf(args)
        torch.cuda.synchronize()
        want = kf_plain(args)
        worst = max(worst, hold(f"{name} B={B} conditioned states", got, want, KC.KF_TOL, "xP"))
        # both float32 answers against float64, instance by instance, in
        # units of eps * cond(S): a fault of order would stand out of these
        scaled = [KC.kf_x_error_over_conditioning(args, x) for x in (got[0], want[0])]
        print(f"[kernel] {name} B={B}: |x' - float64| / (eps cond(S)) per instance: kernel max "
              f"{float(scaled[0].max()):.3g} (median {float(scaled[0].median()):.3g}), plain "
              f"version max {float(scaled[1].max()):.3g} (median {float(scaled[1].median()):.3g}); "
              f"gate {KC.KF_COND_FACTOR}")
        for who, r in zip(("kernel", "plain version"), scaled):
            check(float(r.max()) < KC.KF_COND_FACTOR,
                  f"{name} B={B}: the {who}'s x' is {float(r.max())} eps cond(S) from float64")
    main_args, got_main = args, got                   # B = BATCH, the path's shape
    want64 = FK.fused_kf_innovate_reference(*(a.double() for a in args), dt=KC.KF_DT)
    print(f"[kernel] {name} B={B}: against the plain version in float64 the kernel's x' is "
          f"{_maxdiff(got[0], want64[0]):.3g} off, the plain version's "
          f"{_maxdiff(want[0], want64[0]):.3g}")
    for ticks in (0, 1, 3):
        t_args = KC.kf_transient_case(256, ticks=ticks, seed=7, device=device)
        got, want = kf(t_args), kf_plain(t_args)
        if ticks == 3:
            hold(f"{name} B=256 at tick 3 of a cold start", got, want, KC.KF_TOL_TRANSIENT, "xP")
        else:
            want64 = FK.fused_kf_innovate_reference(*(a.double() for a in t_args), dt=KC.KF_DT)
            print(f"[kernel] {name} B=256 at tick {ticks} of a cold start (not gated): "
                  f"max|dx|={_maxdiff(got[0], want[0]):.3g}, max|dP|={_maxdiff(got[1], want[1]):.3g}"
                  f"; against the plain version in float64 the kernel's P' is "
                  f"{_maxdiff(got[1], want64[1]):.3g} off, the plain version's "
                  f"{_maxdiff(want[1], want64[1]):.3g}")
    ms, call_ms = kernel_ms(lambda: kf(main_args), 20, "kf_kernel")
    plain_ms = time_ms(lambda: kf_plain(main_args), 3)
    # the nearest thing to a library version: the "xla" backend's dense
    # chain (products with A, B, C on PyTorch's batched matmul) on the same
    # inputs; it is one function of the port, not one PyTorch call
    # (it refines neither solve, so on these states it is not held to the
    # kernel's gate: its gap is printed)
    dense = lambda: KF.dense_predict_innovate(*main_args, KF.KFParams(dt=KC.KF_DT))
    dense_out = dense()
    check(all(bool(torch.isfinite(t).all()) for t in dense_out), "the dense chain is not finite")
    print(f"[kernel] {name} B={BATCH}: the dense chain is max|dx|="
          f"{_maxdiff(dense_out[0], got_main[0]):.3g}, max|dP|="
          f"{_maxdiff(dense_out[1], got_main[1]):.3g} from the kernel (not gated)")
    dense_ms = time_ms(dense, 3)
    flops, nbytes = BATCH * kf_flops(), 4 * BATCH * 761
    bound_ms, by = bound(flops, nbytes)
    records[name] = {
        "name": name, "route": "cuda", "source": "quad_periodic_mpc_tpu_torch/csrc/kf.cu",
        "replaces": "quad_periodic_mpc_tpu/ops/pallas/kf_kernel.py:159", "launches": 0,
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": by, "library_ms": dense_ms,
        "library": "estimation/kf.dense_predict_innovate, the 'xla' backend's dense chain"}
    print(f"[kernel] {name} B={BATCH}: kernel {ms:.4f} ms on the device ({call_ms:.4f} ms per "
          f"call), plain version {plain_ms:.3f} ms, the dense chain {dense_ms:.3f} ms, bound "
          f"{bound_ms:.5f} ms ({by}; {flops:.3e} flop, {nbytes} B) on {card}")
    b1_ms, b1_call_ms = kernel_ms(lambda: kf(b1_args), 20, "kf_kernel")
    print(f"[kernel] {name} B=1: kernel {b1_ms:.4f} ms on the device ({b1_call_ms:.4f} ms per "
          f"call between CUDA events), beside {ms:.4f} ({call_ms:.4f}) at B={BATCH} on {card}")

    # ---- fused_admm_iterations ----
    name, worst, timed = "fused_admm_iterations", 0.0, {}
    for B, h, iters, warm, bf16 in reversed(ADMM_CASES):
        args = KC.admm_case(B, h, seed=300 + h + B, device=device, warm=warm)
        kw = dict(iters=iters, kinv_bf16=bf16)
        got = AK.fused_admm_iterations(*args, **kw)
        torch.cuda.synchronize()
        what = (f"{name} B={B} h={h} {iters} iterations, {'non-zero' if warm else 'zero'} "
                f"start, K^-1 {'bf16' if bf16 else 'f32'} "
                f"{'resident' if AK.kinv_resident(12 * h, 20 * h, bf16) else 'streamed'}")
        plain = AK.fused_admm_iterations_reference(*args, **kw)
        if not KC.admm_f64_gated(B, h):
            worst = max(worst, hold(what, got, plain, KC.admm_tol(h), "xzy"))
        else:   # past admm_tol's calibration: as close to float64 as the plain version
            exact = AK.fused_admm_iterations_reference(*(a.double() for a in args), **kw)
            far = {n: (_maxdiff(g.double(), e), _maxdiff(w.double(), e))
                   for n, g, w, e in zip("xzy", got, plain, exact)}
            print(f"[kernel] {what}: |kernel - float64| / |plain version - float64| " + ", ".join(
                f"{n} {k:.3g} / {pl:.3g}" for n, (k, pl) in far.items())
                  + f" (gate {KC.ADMM_F64_FACTOR}x)")
            check(all(bool(torch.isfinite(g).all()) for g in got), f"{what}: output not finite")
            check(all(k <= KC.ADMM_F64_FACTOR * pl for k, pl in far.values()),
                  f"{what} is farther from float64 than {KC.ADMM_F64_FACTOR}x the plain "
                  f"version: {far}")
            worst = max(worst, *(_maxdiff(g, w) for g, w in zip(got, plain)))
        if (B, h) == (BATCH, HORIZON):
            ms, call_ms = kernel_ms(lambda: AK.fused_admm_iterations(*args, **kw), 20,
                                    "admm_kernel")
            plain_ms = time_ms(lambda: AK.fused_admm_iterations_reference(*args, **kw), 3)
            timed[bf16] = (ms, call_ms, plain_ms)
    n, m = 12 * HORIZON, 20 * HORIZON
    flops, nbytes = BATCH * admm_flops(n, m, ADMM_ITERS), admm_bytes(BATCH, n, m)
    bound_ms, by = bound(flops, nbytes)
    ms, call_ms, plain_ms = timed[False]
    records[name] = {
        "name": name, "route": "cuda", "source": "quad_periodic_mpc_tpu_torch/csrc/admm.cu",
        "replaces": "quad_periodic_mpc_tpu/ops/pallas/admm_kernel.py:138", "launches": 0,
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": by, "library_ms": None, "bf16_ms": timed[True][0]}
    print(f"[kernel] {name} B={BATCH} h={HORIZON} ADMM-{ADMM_ITERS}: kernel {ms:.3f} ms on the "
          f"device ({call_ms:.3f} ms per call), with bf16 storage {timed[True][0]:.3f} ms "
          f"({timed[True][1]:.3f}); plain version {plain_ms:.2f} ms (bf16 {timed[True][2]:.2f}), "
          f"bound {bound_ms:.4f} ms ({by}; {flops:.3e} flop, {nbytes} B) on {card}")
    return records


def all_launch_counts() -> dict:
    """Every kernel's launch count, by record name."""
    from quad_periodic_mpc_tpu_torch.ops.cuda import admm_kernel as AK
    from quad_periodic_mpc_tpu_torch.ops.cuda import kf_kernel as FK
    from quad_periodic_mpc_tpu_torch.ops.cuda import kinematics_kernel as KK
    from quad_periodic_mpc_tpu_torch.ops.cuda import plant_kernel as PK
    from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel as SK
    from quad_periodic_mpc_tpu_torch.ops.cuda import wbc_kernel as WK

    return {**SK.LAUNCHES, **KK.LAUNCHES, "fused_wbc": WK.LAUNCHES,
            "fused_substeps": PK.LAUNCHES, "fused_kf_innovate": FK.LAUNCHES,
            "fused_admm_iterations": AK.LAUNCHES}


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


def slice4(device, card: str) -> dict:
    """Phases 8-10.  Returns the two kernels' records with the launches of
    their paths' counted runs."""
    records = compare_slice4_kernels(device, card)
    records["fused_kf_innovate"]["launches"] = estimation_path(device, card)
    records["fused_admm_iterations"]["launches"] = condensed_line(device, card, bf16=False)
    records["fused_admm_iterations"]["bf16_launches"] = condensed_line(device, card, bf16=True)
    for rec in records.values():
        check(rec["launches"] > 0, f"{rec['name']} was launched on no driven path")
    return records


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
        tick_records = compare_tick_kernels(device, card)
        counts = main_path(device, card)
        srb_shapes = {s["path"]: s for s in record["shapes"]}
        record["launches"] = counts["fused_stagewise_solve_srb"]
        srb_shapes["main path"]["launches"] = record["launches"]
        dumps = counts["srb_build_dump"]
        for name, n in full_stack_path(device, card).items():
            if name in tick_records:
                tick_records[name]["launches"] = n
            if name == "fused_stagewise_solve_srb":
                srb_shapes["full stack"]["launches"] = n
        single_robot(device, card)
        solve_records = compare_solve_kernels(device, card)
        counts = walking_line(device, card, "predictive", BATCH, HORIZON, ADMM_ITERS,
                              PREDICTIVE_WARM, LINE_TIMED, "fused_stagewise_solve",
                              predictive=True)
        solve_records["fused_stagewise_solve"]["launches"] = counts["fused_stagewise_solve"]
        for line in LONG_LINES:
            counts = walking_line(device, card, *line)
            dumps += counts["srb_build_dump"]
            if line[-1] in solve_records:
                solve_records[line[-1]]["launches"] = counts[line[-1]]
            if f"line {line[0]}" in srb_shapes:
                srb_shapes[f"line {line[0]}"]["launches"] = counts["fused_stagewise_solve_srb"]
        solve_records["srb_build_dump"]["launches"] = dumps
        for rec in [*solve_records.values(), *record["shapes"]]:
            check(rec["launches"] > 0, f"{rec.get('name', rec.get('path'))} was launched "
                  "on no driven path")
        slice4_records = slice4(device, card)
        if "jax" in sys.modules or "quad_periodic_mpc_tpu" in sys.modules:
            raise SmokeFailure("JAX or the JAX package was imported")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": [record, *tick_records.values(), *solve_records.values(),
                                  *slice4_records.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
