"""Operations and bytes of the port's hand-written kernels, for their
roofline shares: a frozen copy of ``chip_smoke.py``'s counts (``solve_flops``,
``solve_bytes``, ``gemm_flops``, ``spd_inv_flops``, ``pdip_row_flops``,
``wbc_flops``, ``TICK_FLOATS``, ``bound``), so that a later change to the
program cannot move the yardstick.  Multiply and add each count one;
float32 bytes, each input read once and each output written once.

Peaks: NVIDIA's H100 SXM data sheet, float32 outside the tensor cores and
HBM3, at the full 700 W power limit."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


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
