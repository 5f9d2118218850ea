"""Seeded inputs for the port's kernels, made with numpy.

The recipes of the reference package's kernel tests
(``tests/test_stagewise.py``'s fused-build test, ``test_kinematics_kernel.py``,
``test_wbc_kernel.py``, ``test_plant_kernel.py``, ``test_kf.py``), built on the port's own
functions, so the card tests and the CPU tests hold each kernel to its plain
version, with the tolerances stated here, and ``chip_smoke.py`` times it,
on the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from quad_periodic_mpc_tpu_torch.config import (
    ADMMConfig, LoopConfig, MPCConfig, PDIPConfig, SwingConfig, TunableParams,
)
from quad_periodic_mpc_tpu_torch.control import mpc, wbc
from quad_periodic_mpc_tpu_torch.models.a1 import A1
from quad_periodic_mpc_tpu_torch.models import floating_base as fb
from quad_periodic_mpc_tpu_torch.ops import constraints, gait, linalg, problem, qp_admm, qp_stagewise
from quad_periodic_mpc_tpu_torch.ops.cuda import kinematics_kernel, swing_update_kernel
from quad_periodic_mpc_tpu_torch.ops.rotations import quat_to_rotmat, rpy_to_quat
from quad_periodic_mpc_tpu_torch.sim import articulated_sim as art
from quad_periodic_mpc_tpu_torch.sim import srb_sim
from quad_periodic_mpc_tpu_torch.terrain import heightmap as hmap

Q_STAND = np.array([0.0, 0.8, -1.6] * 4, np.float32)
# stance patterns of the reference's WBC kernel test
CONTACTS = np.array(
    [[1, 1, 1, 1], [0, 1, 1, 0], [1, 0, 0, 1], [0, 1, 1, 1], [1, 1, 0, 1]], np.float32)
WBC_PDIP = PDIPConfig(iterations=15)      # the full stack's WBC PDIP
# Fused model evaluation vs its plain version, max abs error: the
# reference's test_model_kernel_matches_xla (A entries up to ~20, G up to
# ~200; sums in another order); A^{-1} is held by |A^{-1} A - I|.
MODEL_TOL = {"A": 1e-4, "G": 1e-3, "C": 2e-3, "Jc": 2e-5, "p_foot": 2e-5, "Jcdqd": 5e-4,
             "AinvA-I": 5e-3}
# Fused WBC kernel vs its plain version, max abs error.  q_des and qd_des
# keep the reference kernel test's 1.5e-3 and 1e-2: with three feet in
# stance the swing-foot task gets exactly the 3 DoF that the contact and
# body tasks leave, so its damped pseudo-inverse is near singular and
# amplifies f32 sums taken in another order (the plain version's own
# float32-vs-float64 gap there is of that size).  tau and fr (up to ~60 N)
# are tighter than the reference's 1e-1: f32 roundoff is ~4e-6 there, and
# one PDIP iteration fewer moves both by more than 5e-5 on the B = 256 case
# (tests/test_torch_wbc.py holds that).
WBC_TOL = {"q_des": 1.5e-3, "qd_des": 1e-2, "tau": 5e-5, "fr": 5e-5}
# Fused plant substeps vs their plain version, max abs error: the
# reference's test_fused_substeps_match_step_fast (ten substeps of stiff
# penalty contact amplify f32 sums taken in another order, most in qd
# through qdd); the contact flags must be equal.
PLANT_TOL = {"pos": 1e-5, "quat": 1e-6, "v_body": 5e-4, "q": 1e-5, "qd": 2e-3,
             "p_foot": 1e-5, "anchor": 1e-5}
# Fused contact kinematics vs fb.contact_jacobians: the model evaluation's
# tolerances on the same outputs (the reference's
# test_kinematics_kernel_matches_xla).
CONTACT_TOL = {k: MODEL_TOL[k] for k in ("Jc", "p_foot", "Jcdqd")}
# The stagewise kernels vs their plain versions, max abs error.  U and z are
# forces (~100 N): FMA contraction and summation order differ between the
# kernel and the plain version's batched products, amplified through 30
# ADMM sweeps (the gate the reference's kernel is held to against its XLA
# path).  y is rho-scaled (rho = 3e-4).
STAGEWISE_TOL = {"U": 2e-3, "z": 2e-3, "y": 1e-5}
# The streamed solve, 50 sweeps at h = 72 and 128: the same sources of
# roundoff through a chain of h (1 + 2 iters) dependent stage steps, 12,928
# at h = 128 against 610 at h = 10 (where the gap measures ~4e-4, and ~1e-3
# at h = 48).  From a zero start the kernel's KKT residuals may exceed the
# plain version's by at most STREAM_KKT_FACTOR times plus STREAM_KKT_SLACK.
STREAM_TOL = {"U": 5e-3, "z": 5e-3, "y": 1e-5}
STREAM_KKT_FACTOR, STREAM_KKT_SLACK = 1.1, 1e-4
# srb_build_dump vs srb_assemble and build_stagewise's Ad, Bd, c: the same
# entries in exact float32; only the 3x3 products inside may round
# differently.
DUMP_TOL = 1e-6
# The seeds of model_states for the model evaluation's and the contact
# kinematics' cases.
MODEL_SEED, CONTACT_SEED = 4, 2


# One comparison per kernel: each *_mismatches returns (the outputs that
# break the kernel's rule, its gaps: the largest |kernel - plain| of each
# output under the output's name, and any other figure the rule reads under
# a name with a space).  The card tests and the CPU tests assert the first
# is empty; chip_smoke.py's kernel table checks it at every shape it times
# and records the second; tools/time_tick_cuda.py prints both.  A
# non-finite output is a gap that no tolerance holds (NaN is below nothing).
def _gaps(names, got, want) -> dict:
    return {n: float((g - w).abs().max()) for n, g, w in zip(names, got, want)}


def _held(gaps: dict, tol: dict) -> tuple[list, dict]:
    return [n for n, g in gaps.items() if not g < tol[n]], gaps


def stagewise_mismatches(got, want, tol=STAGEWISE_TOL, problem=None) -> tuple[list, dict]:
    """A stagewise kernel's (U, z, y) against its plain version's, within
    ``tol`` (STAGEWISE_TOL, or STREAM_TOL for the streamed solve at long
    horizons).  Given the ``problem`` (``solve_case(..., with_problem=True)``'s),
    also the KKT residuals of both answers: the kernel's primal and dual
    max within STREAM_KKT_FACTOR times the plain version's plus
    STREAM_KKT_SLACK."""
    bad, gaps = _held(_gaps("Uzy", got, want), tol)
    if problem is not None:
        res = [qp_stagewise.kkt_residuals(problem, *out) for out in (got, want)]
        for r in ("primal", "dual"):
            kernel, plain = (float(x[r].max()) for x in res)
            if not kernel <= STREAM_KKT_FACTOR * plain + STREAM_KKT_SLACK:
                bad.append("KKT " + r)
    return bad, gaps


def dump_mismatches(got, want, built=None) -> tuple[list, dict]:
    """srb_build_dump's (Ad, Bd, c) against srb_assemble's and, where
    given, build_stagewise's (``srb_dump_case``'s problem): DUMP_TOL."""
    gaps = _gaps(("Ad", "Bd", "c"), got, want)
    if built is not None:
        gaps.update(_gaps(("Ad built", "Bd built", "c built"), got, (built.Ad, built.Bd, built.c)))
    return _held(gaps, dict.fromkeys(gaps, DUMP_TOL))


def model_eval_mismatches(got, want) -> tuple[list, dict]:
    """fused_model_eval's (A, A^{-1}, G, C, contact info) against
    model_eval_reference's: MODEL_TOL, A^{-1} by |A^{-1} A - I|."""
    (A, Ainv, G, C, info), (A_r, _, G_r, C_r, info_r) = got, want
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    gaps = {**_gaps("AGC", (A, G, C), (A_r, G_r, C_r)),
            **_gaps(("Jc", "p_foot", "Jcdqd"), (info.Jc, info.p_foot, info.Jcdqd),
                    (info_r.Jc, info_r.p_foot, info_r.Jcdqd)),
            "AinvA-I": float((Ainv @ A - eye).abs().max())}
    return _held(gaps, MODEL_TOL)


def contact_mismatches(got, want) -> tuple[list, dict]:
    """fused_contact_kinematics' info against fb.contact_jacobians':
    CONTACT_TOL."""
    return _held({n: float((getattr(got, n) - getattr(want, n)).abs().max())
                  for n in CONTACT_TOL}, CONTACT_TOL)


def wbc_mismatches(got, want) -> tuple[list, dict]:
    """fused_wbc's (q_des, qd_des, tau, fr) against fused_wbc_reference's:
    WBC_TOL."""
    return _held(_gaps(WBC_TOL, got, want), WBC_TOL)


def substeps_mismatches(got, want) -> tuple[list, dict]:
    """fused_substeps' (plant, p_foot) against fused_substeps_reference's:
    PLANT_TOL, and the contact flags equal."""
    (pb, pf_b), (pa, pf_a) = got, want
    names = ("pos", "quat", "v_body", "q", "qd")
    gaps = _gaps(names, (getattr(pb.fb, n) for n in names), (getattr(pa.fb, n) for n in names))
    gaps.update(_gaps(("p_foot", "anchor"), (pf_b, pb.anchor), (pf_a, pa.anchor)))
    bad, gaps = _held(gaps, PLANT_TOL)
    return bad + ([] if torch.equal(pb.in_contact, pa.in_contact) else ["in_contact"]), gaps


def _t(a, device, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, np.float32), device=device).to(dtype)


def _trot_obs(rng, B: int, h: int, device, dtype=torch.float32):
    """Random trot observations: (obs, x_ref, gait table, f_est, x_drag),
    float32 values held in ``dtype``."""
    t = lambda a: _t(a, device, dtype)
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
    seg = torch.as_tensor(rng.integers(0, 16, B), dtype=torch.int32, device=device)
    table = gait.mpc_table(gait.preset("trotting", device=device), seg, h)
    f_est, x_drag = t(rng.uniform(-3, 3, (B, 6))), t(rng.uniform(-0.5, 0.5, B))
    return obs, t(xref), table, f_est, x_drag


def _trot_problem(rng, B: int, h: int, device, per_step_c: bool = False):
    """A stagewise problem from random trot observations, through the
    port's own build.  Returns (problem, x0, R, r_feet, x_drag, f_est)."""
    obs, xref, table, f_est, x_drag = _trot_obs(rng, B, h, device)
    f_steps = None
    if per_step_c:      # a wrench that varies over the horizon, as a predictive fit gives
        k = np.arange(h)[None, :, None]
        f_steps = _t(rng.uniform(-3, 3, (B, 1, 6)) + rng.uniform(-2, 2, (B, 1, 6)) * np.sin(
            0.054 * k + rng.uniform(0, 6, (B, 1, 6))), device)
    sw, x0 = problem.build_stagewise(obs, xref, table, MPCConfig(horizon=h),
                                     f_est=f_est, x_drag=x_drag, f_est_steps=f_steps)
    return sw, x0, quat_to_rotmat(obs.quat), obs.r_feet, x_drag, f_est


def _solver_tail(sw, B: int, h: int, device, iters: int):
    """(Q, R_eff, F, l, u, zero warm start) and the keyword args of an
    ADMM-``iters`` solve at the default rho."""
    rho = ADMMConfig().rho
    R_eff = torch.diag(sw.R) + rho * torch.kron(torch.eye(4, device=device), sw.F.T @ sw.F)
    z = lambda r: torch.zeros(B, h, r, device=device)
    tail = [sw.Q, R_eff, sw.F, sw.l, sw.u, z(12), z(20), z(20)]
    return tail, dict(iters=iters, rho=rho, ns_it=qp_stagewise.ns_combine_iters(h))


def stagewise_case(B: int, h: int, seed: int, device="cuda", iters: int = 30):
    """Well-posed inputs of the fused-build stagewise solve (positional
    args, and the keyword args of an ADMM-``iters`` solve)."""
    sw, x0, R, r_feet, x_drag, f_est = _trot_problem(np.random.default_rng(seed), B, h, device)
    tail, kw = _solver_tail(sw, B, h, device, iters)
    args = [R, r_feet, x_drag, f_est, x0, sw.x_ref, *tail]
    return [a.contiguous() for a in args], kw


def solve_case(B: int, h: int, seed: int, device="cuda", iters: int = 30,
               per_step_c: bool = False, dense_ad: bool = False, with_problem: bool = False):
    """Inputs of ``fused_stagewise_solve`` / ``fused_stagewise_solve_stream``
    (Ad, Bd, c, x0, x_ref, Q, R_eff, F, l, u, U0, z0, y0 and the keyword
    args): Ad and Bd from ``build_stagewise``, so that they carry the real
    sparsity; c shared (B, 13) or per step (B, h, 13).  dense_ad: every
    entry of Ad and Bd perturbed (the problem stays close to the trot's),
    for ``srb_ad=False``.  with_problem: also return the StagewiseProblem
    these are the inputs of (for ``qp_stagewise.kkt_residuals``)."""
    rng = np.random.default_rng(seed)
    sw, x0, *_ = _trot_problem(rng, B, h, device, per_step_c)
    if dense_ad:
        sw = sw._replace(Ad=sw.Ad + _t(rng.uniform(-2e-3, 2e-3, (B, 13, 13)), device),
                         Bd=sw.Bd + _t(rng.uniform(-2e-4, 2e-4, (B, 13, 12)), device))
    tail, kw = _solver_tail(sw, B, h, device, iters)
    args = [a.contiguous() for a in (sw.Ad, sw.Bd, sw.c, x0, sw.x_ref, *tail)]
    return (args, kw, sw) if with_problem else (args, kw)


def srb_rescue_case(B: int, h: int, seed: int, device="cuda", iters: int = 30):
    """Inputs of ``fused_stagewise_solve_srb`` on which the odd instances'
    warm Newton-Schulz seeds fail the 2e-3 gate at every warm stage and the
    even instances' pass it at every one (``stats["rescued"]`` is
    (B // 2) (h - 1) in the plain version): ``stagewise_case`` with Q
    scaled by 1e3 and the odd instances' feet 10x as far from the body,
    which turns Quu from stage to stage.  At seed 3, B = 4, h = 10 the
    gate's residuals lie 12 % or more from 2e-3 on either side."""
    args, kw = stagewise_case(B, h, seed, device=device, iters=iters)
    args[1] = args[1].clone()
    args[1][1::2] *= 10.0                                # r_feet
    args[6] = 1e3 * args[6]                              # Q
    return [a.contiguous() for a in args], kw


def rescue_case(B: int, h: int, seed: int, device="cuda", iters: int = 30):
    """Inputs of ``fused_stagewise_solve`` with ``srb_ad=False`` whose warm
    Newton-Schulz seeds fail the 2e-3 gate, so that the cold restart runs
    (``stats["rescued"] > 0`` in the plain version): every entry of the
    trot's Ad perturbed by up to 0.2, which makes it unstable, so that P
    grows and turns from stage to stage.  c, x0 and x_ref are scaled by
    0.01 so that the forces stay at tens of N and the gap between two
    float32 summation orders stays that of the trot's cases."""
    rng = np.random.default_rng(seed)
    args, kw = solve_case(B, h, seed, device=device, iters=iters, dense_ad=True)
    args[0] = (args[0] + _t(rng.uniform(-0.2, 0.2, (B, 13, 13)), device)).contiguous()
    for i in (2, 3, 4):                                  # c, x0, x_ref
        args[i] = (0.01 * args[i]).contiguous()
    return args, kw


def srb_dump_case(B: int, seed: int, device="cuda"):
    """(R, r_feet, x_drag, f_est) of ``srb_build_dump`` and the problem
    ``build_stagewise`` makes of the same observations."""
    sw, _, R, r_feet, x_drag, f_est = _trot_problem(np.random.default_rng(seed), B, 1, device)
    return [a.contiguous() for a in (R, r_feet, x_drag, f_est)], sw


def model_states(B: int, seed: int = 0, device="cuda") -> fb.FBState:
    """Random poses, velocities and joint states around the stand pose
    (test_kinematics_kernel.make_states)."""
    rng = np.random.default_rng(seed)
    return fb.FBState(
        quat=rpy_to_quat(_t(rng.uniform(-0.3, 0.3, (B, 3)), device)),
        pos=_t(rng.uniform(-0.5, 0.5, (B, 3)), device),
        v_body=_t(rng.uniform(-1, 1, (B, 6)), device),
        q=_t(Q_STAND + rng.uniform(-0.4, 0.4, (B, 12)), device),
        qd=_t(rng.uniform(-3, 3, (B, 12)), device))


def wbc_state_and_input(B: int, seed: int = 3, device="cuda"):
    """(FBState, WBCInput) near a standing robot, stance patterns cycling
    through CONTACTS (test_wbc_kernel.make_states / make_inputs)."""
    rng = np.random.default_rng(seed)
    q = Q_STAND + rng.uniform(-0.15, 0.15, (B, 12))
    rpy = rng.uniform(-0.1, 0.1, (B, 3))
    st = fb.FBState(
        quat=rpy_to_quat(_t(rpy, device)),
        pos=_t(np.c_[rng.uniform(-.1, .1, (B, 2)), rng.uniform(0.25, 0.32, (B, 1))], device),
        v_body=_t(rng.uniform(-0.4, 0.4, (B, 6)), device),
        q=_t(q, device), qd=_t(rng.uniform(-1, 1, (B, 12)), device))
    contact = np.resize(CONTACTS, (B, 4))
    info = fb.contact_jacobians(st, fb.build_a1_constants("float32", str(device)))
    fz = 12.0 * 9.81 / np.maximum(contact.sum(-1, keepdims=True), 1)
    fr = np.zeros((B, 4, 3), np.float32)
    fr[..., 2] = fz * contact
    fr[..., 0:2] = rng.uniform(-8, 8, (B, 4, 2)) * contact[..., None]
    inp = wbc.WBCInput(
        p_body_des=st.pos + _t(rng.uniform(-0.02, 0.02, (B, 3)), device),
        v_body_des=_t(rng.uniform(-.3, .3, (B, 3)), device),
        a_body_des=torch.zeros(B, 3, device=device),
        rpy_des=_t(rng.uniform(-.05, .05, (B, 3)), device),
        omega_des=_t(rng.uniform(-.3, .3, (B, 3)), device),
        p_foot_des=info.p_foot + _t(rng.uniform(-0.04, 0.04, (B, 4, 3)), device),
        v_foot_des=_t(rng.uniform(-.5, .5, (B, 4, 3)), device),
        a_foot_des=_t(rng.uniform(-2, 2, (B, 4, 3)), device),
        fr_des=_t(fr, device), contact_state=_t(contact, device))
    return st, inp


def wbc_kernel_args(st: fb.FBState, inp: wbc.WBCInput, gains=wbc.WBCGains()):
    """The fused WBC's 13 input tensors for (state, input), as
    ``wbc.run(backend="pallas")`` builds them (model from the plain
    functions)."""
    mc = fb.build_a1_constants("float32", str(st.pos.device))
    A, Ainv, G, C, info = kinematics_kernel.model_eval_reference(st, mc)
    B = st.pos.shape[0]
    cmask = (inp.contact_state > 0.0).float()
    _, errors, vels, cmds, jdqd = wbc._build_tasks(st, info, inp, gains)
    stack6 = lambda parts: torch.cat([p.reshape(B, 3) for p in parts], -1).contiguous()
    args = [A, Ainv, C + G, info.Jc.reshape(B, 12, 18), info.Jcdqd.reshape(B, 12), cmask,
            quat_to_rotmat(st.quat), stack6(errors), stack6(vels), stack6(cmds),
            stack6(jdqd), (inp.fr_des * cmask[..., None]).reshape(B, 12), st.q]
    return [a.contiguous() for a in args]


def plant_case(B: int, seed: int = 0, device="cuda", penetration: float = 3e-3):
    """(plant, tau, cache, Jc, p_foot) of one tick: feet in the ground, the
    instances perturbed so tangential contact engages
    (test_plant_kernel.test_fused_substeps_match_step_fast)."""
    rng = np.random.default_rng(seed)
    plant = art.init_on_ground((B,), penetration=penetration, device=device)
    plant = plant._replace(fb=plant.fb._replace(
        v_body=_t(rng.uniform(-0.3, 0.3, (B, 6)), device),
        qd=_t(rng.uniform(-1, 1, (B, 12)), device)))
    tau = _t(rng.uniform(-8, 8, (B, 12)), device)
    mc = fb.build_a1_constants("float32", str(device))
    cache = art.model_cache(plant, mc)
    info = fb.contact_jacobians(plant.fb, mc)
    return plant, tau, cache, info.Jc, info.p_foot


# SRB plant kernel vs its plain version (srb_sim.step_dense): x' to
# SRB_PLANT_TOL[dtype] * (1 + |x'|) entry by entry (rounding: the kernel
# applies the ZOH matrix-free, the plain version through dense GEMMs, and
# |x'| runs to ~10 in position and 9.8 in the gravity state); feet and t
# exactly (a select and one add).
SRB_PLANT_TOL = {torch.float32: 1e-6, torch.float64: 2e-15}
SRB_STANCES = ("mixed", "all", "none")


def srb_plant_mismatches(got, want) -> tuple[list, dict]:
    """The fields of a kernel step's ``PlantState`` outside SRB_PLANT_TOL of
    the plain version's (empty where it matches), and the largest
    |kernel - plain| of each field."""
    tol = SRB_PLANT_TOL[want.x.dtype]
    bad = [] if bool(((got.x - want.x).abs() <= tol * (1 + want.x.abs())).all()) else ["x"]
    bad += [f for f in ("p_feet", "t") if not torch.equal(getattr(got, f), getattr(want, f))]
    return bad, _gaps(("x", "p_feet", "t"), got, want)


def srb_plant_case(B: int, seed: int = 0, device="cuda", stance: str = "mixed",
                   wrench: bool = False, t_max: float = 100.0, dtype=torch.float32):
    """(plant, forces, p_foot_des, stance_mask, dist) of one SRB plant step:
    rpy up to +-0.5 rad, the body up to 5 m from the origin, feet near the
    hips, stance forces up to 120 N, t up to t_max s, and the paper's
    x-force disturbance or a six-component ``WrenchDisturbance``; float32
    values held in ``dtype``."""
    t = lambda a: _t(a, device, dtype)
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, *shape: rng.uniform(lo, hi, (B,) + shape)
    p = np.concatenate([u(-5, 5, 2), u(0.2, 0.35, 1)], -1)
    x = np.concatenate([u(-0.5, 0.5, 3), p, u(-1, 1, 3), u(-1, 1, 3), np.full((B, 1), -9.8)], -1)
    hips = np.array([[0.18, -0.13, 0], [0.18, 0.13, 0], [-0.18, -0.13, 0], [-0.18, 0.13, 0]])
    feet = p[:, None, :] * np.array([1, 1, 0]) + hips + u(-0.05, 0.05, 4, 3) * [1, 1, 0]
    forces = np.concatenate([u(-20, 20, 4, 2), u(0, 120, 4, 1)], -1)
    des = feet + u(-0.05, 0.05, 4, 3)
    mask = {"mixed": rng.integers(0, 2, (B, 4)), "all": np.ones((B, 4)),
            "none": np.zeros((B, 4))}[stance]
    plant = srb_sim.PlantState(x=t(x), p_feet=t(feet), t=t(u(0, t_max)))
    if wrench:
        n = (6,)
        dist = srb_sim.WrenchDisturbance(t(u(-1, 1, *n)), t(u(0, 2, *n)), t(u(0.2, 0.5, *n)),
                                         t(u(0, 2 * np.pi, *n)))
    else:
        dist = srb_sim.DisturbanceParams(t(np.full(B, -10.0)), t(u(10, 20)), t(u(0.2, 0.5)),
                                         t(u(0, 2 * np.pi)))
    return plant, t(forces), t(des), t(mask), dist


# Swing update kernel vs its plain version (control/mpc.swing_update_plain):
# bit for bit, but for the fields that pass through a 3x3 product (cuBLAS
# or the CPU's bmm on the plain path, index order in the kernel) or a
# transcendental (the host's atan2f / asinf / sinf / cosf against PyTorch's
# CPU kernels): the Raibert targets' xy, world_position_desired, rpy_int and
# rpy_comp, each within SWING_ULPS ulps of its value in its own dtype.
SWING_ULPS = 4
SWING_GAITS = ("trot", "stacked", "standing")


def swing_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| in ulps of want's value in want's dtype
    (float32 or float64)."""
    np_dt = np.float64 if want.dtype == torch.float64 else np.float32
    w = want.double().abs().cpu().numpy().astype(np_dt)
    gap = (got.double() - want.double()).abs().cpu().numpy()
    return float((gap / np.spacing(w)).max())


def swing_update_case(B: int, seed: int = 0, device="cuda", gait_kind: str = "trot",
                      per_instance_tunable: bool = False, first_swing: str = "random",
                      dtype=torch.float32) -> tuple:
    """The arguments of ``mpc.swing_update`` after ``tunable``'s place:
    (state, obs, cmd, gait, model, swing_cfg, mpc_cfg, loop_cfg,
    swing_height, tunable), float32 values held in ``dtype``.

    Any iteration of the gait cycle; gaits ``trot`` (the preset, shared),
    ``stacked`` (every preset at a period of 10 or 16 segments, one per
    instance) or ``standing``; rpy up to +-0.5 rad on quaternions scaled
    by 0.97-1.03; the first rows' body velocities on both sides of the
    roll/pitch integral's guards (0.2 and 0.1 m/s in ``dtype``, the next
    numbers above and below them) and exactly 0, a zero velocity command
    in row 0.  ``first_swing`` is random per leg or "all" (every leg that
    swings starts its swing).  The body, world_position_desired and the
    rpy integral lie 1-5 m and 0.05-0.3 rad from 0, so that a gap of a few
    ulps of a value (``SWING_ULPS``) is one of the rounding, not of a
    cancellation near 0."""
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    t = lambda a: _t(a, device, dtype)
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, *shape: rng.uniform(lo, hi, (B,) + shape)
    sign = lambda *shape: rng.choice([-1.0, 1.0], (B,) + shape)
    p = np.concatenate([sign(2) * u(1, 5, 2), u(0.2, 0.35, 1)], -1)
    hips = np.array([[0.18, -0.13, 0], [0.18, 0.13, 0], [-0.18, -0.13, 0], [-0.18, 0.13, 0]])
    feet = p[:, None, :] * np.array([1, 1, 0]) + hips + u(-0.05, 0.05, 4, 3) * [1, 1, 0]
    feet[..., 2] = u(0, 0.05, 4)
    quat = rpy_to_quat(torch.as_tensor(u(-0.5, 0.5, 3))) * torch.as_tensor(u(0.97, 1.03, 1))
    v = torch.as_tensor(np.asarray(u(-1, 1, 3), np.float32)).to(dtype)
    guard = lambda g: np.array([0, g, -g, np.nextafter(g, np_dt(1)), np.nextafter(g, np_dt(0)),
                                -np.nextafter(g, np_dt(1))], np_dt)
    n = min(B, 6)
    v[:n, 0] = torch.as_tensor(guard(np_dt(0.2))[:n])
    v[:n, 1] = torch.as_tensor(guard(np_dt(0.1))[::-1].copy()[:n])
    obs = mpc.Observation(p=t(p), v=v.to(device), quat=t(quat.numpy()),
                          omega=t(u(-1, 1, 3)), p_feet=t(feet))
    if gait_kind == "stacked":
        stacks = [gait.stacked_presets(period=period, device=device) for period in (10, 16)]
        which = torch.as_tensor(rng.integers(0, 2, B), device=device)
        name = torch.as_tensor(rng.integers(0, len(gait.PRESET_NAMES), B), device=device)
        g = gait.GaitParams(*(torch.where(which.reshape((B,) + (1,) * (a.ndim - 1)) == 1,
                                          b[name], a[name]) for a, b in zip(*stacks)))
    else:
        g = gait.preset({"trot": "trotting", "standing": "standing"}[gait_kind], device=device)
    vel_des = u(-1, 1, 2) * [1, 0.5]
    vel_des[0] = 0.0
    fs = np.ones((B, 4), bool) if first_swing == "all" else rng.integers(0, 2, (B, 4)) == 1
    wpd = np.concatenate([sign(2) * u(1, 5, 2), np.full((B, 1), 0.24)], -1)
    state = mpc.init_state((B,), obs, window=8, dtype=dtype, horizon=2,
                           formulation="stagewise")._replace(
        iteration=torch.as_tensor(rng.integers(0, 10_000, B), dtype=torch.int32, device=device),
        x_vel_des=t(vel_des[:, 0]), y_vel_des=t(vel_des[:, 1]),
        world_position_desired=t(wpd), rpy_int=t(sign(2) * u(0.05, 0.3, 2)),
        first_swing=torch.as_tensor(fs, device=device),
        swing_time_remaining=t(u(-0.05, 0.3, 4)),
        swing_p0=t(feet + u(-0.1, 0.1, 4, 3)), swing_pf=t(feet + u(-0.2, 0.2, 4, 3)))
    cmd = mpc.Command(vx=t(vel_des[:, 0]), vy=t(vel_des[:, 1]), yaw_rate=t(u(-1, 1)),
                      body_height=t(np.full(B, 0.29)))
    loop_cfg, swing_cfg = LoopConfig(), SwingConfig()
    tunable = None
    if per_instance_tunable:
        tunable = TunableParams.from_config(loop=loop_cfg, swing=swing_cfg, dtype=dtype,
                                            device=device)._replace(
            swing_height=t(u(0.05, 0.15, 1)), bonus_swing=t(u(-0.1, 0.3, 1)),
            p_rel_max=t(u(0.05, 0.3, 1)))
    return (state, obs, cmd, g, A1, swing_cfg, MPCConfig(), loop_cfg, loop_cfg.swing_height,
            tunable)


def swing_update_mismatches(args, foothold_adjust=None) -> tuple[list, dict]:
    """``mpc.swing_update_kernel`` on ``args`` (``swing_update_case``'s)
    against ``mpc.swing_update_plain``: (the fields that break
    SWING_ULPS's rule, the largest |kernel - plain| on swing_p0, swing_pf,
    p_foot_des, v_foot_des and a_foot_des).  The kernel's Raibert targets
    are held to the plain version's within SWING_ULPS ("pf_target"); then
    the plain version, handed the kernel's targets through its foothold hook
    (after ``foothold_adjust``, where given), is held to the kernel field by
    field.  The gaps are those of the two updates on their own targets."""
    state, obs, cmd, g, model, swing_cfg, _, loop_cfg, swing_height, tunable = args
    targets = swing_update_kernel.launch(state, obs, cmd, g, model, swing_cfg, loop_cfg,
                                         swing_height, tunable, targets_only=True)["pf_target"]
    adjust = foothold_adjust or (lambda pf, s, o: pf)
    plain_targets = []

    def handed(pf, s, o):
        plain_targets.append(pf)
        return adjust(targets, s, o)

    got_state, got = mpc.swing_update_kernel(*args, foothold_adjust=foothold_adjust)
    want_state, want = mpc.swing_update_plain(*args, foothold_adjust=handed)
    own_state, own = mpc.swing_update_plain(*args, foothold_adjust=foothold_adjust)
    bad = []
    if not (swing_ulps(targets[..., :2], plain_targets[0][..., :2]) <= SWING_ULPS
            and torch.equal(targets[..., 2], plain_targets[0][..., 2])):
        bad.append("pf_target")
    near = ("world_position_desired", "rpy_int", "rpy_comp")
    pairs = [(f, getattr(got_state, f), getattr(want_state, f))
             for f in mpc.ControllerState._fields if f != "est"]
    pairs += [(f, getattr(got, f), getattr(want, f)) for f in mpc.ControlOutput._fields]
    for name, a, b in pairs:
        same = a.dtype == b.dtype and a.shape == b.shape and (
            swing_ulps(a, b) <= SWING_ULPS if name in near else torch.equal(a, b))
        if not same:
            bad.append(name)
    if got_state.est is not state.est:
        bad.append("est")
    gaps = {f: float((getattr(got_state, f) - getattr(own_state, f)).abs().max())
            for f in ("swing_p0", "swing_pf")}
    gaps.update({f: float((getattr(got, f) - getattr(own, f)).abs().max())
                 for f in ("p_foot_des", "v_foot_des", "a_foot_des")})
    return bad, gaps


# Foothold kernel vs its plain version (control/cmpc_variant.
# foothold_update_plain): selects, lookups and elementwise operations with no
# sum, each rounded as PyTorch rounds it, so the swing targets are equal bit
# for bit and both counters gain the same.
FOOTHOLD_MAP = (96, 0.03)       # the terrain cell's map: cells a side, m a cell


def foothold_case(B: int, seed: int = 0, device="cuda", dtype=torch.float32) -> tuple:
    """The arguments of ``cmpc_variant.foothold_update``: (hm, pf_raibert,
    swing_p0, search_radius_m, traversability_min, max_step_height,
    first_swing, p_feet), float values drawn in ``dtype``.

    B maps of FOOTHOLD_MAP, each one of eight seeded fields: elevations
    within 2 cm of two steps (up 0.08 m, up 0.25 m, past the step clamp),
    traversability uniform over 0.7-1 (a third of the cells below 0.8) with
    cells at 0.8 itself and at the next number above it in ``dtype``, and
    blocked patches of 2-10 cells; every fourth instance (instance 0 too)
    also has a blocked 13 x 13 square, which holds the whole 0.10-m spiral
    of leg 0's target at its middle (the fallback).  Map centers within 2 m
    of the origin; targets within 1.6 m of the center (the map reaches
    1.44 m), a quarter of them on cell boundaries (the center plus a whole
    number of cells, up to 50: at the grid's edge and past it); swing
    starts and feet within 0.3 m of the targets; ``first_swing`` random per
    leg."""
    H = W = FOOTHOLD_MAP[0]
    res = FOOTHOLD_MAP[1]
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    t = lambda a: torch.as_tensor(np.asarray(a, np_dt), device=device)
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, *shape: rng.uniform(lo, hi, (B,) + shape)
    M = 8
    rows, cols = np.arange(H)[:, None], np.arange(W)[None, :]
    elev = rng.uniform(-0.02, 0.02, (M, H, W))
    elev += 0.08 * (cols > rng.integers(20, 60, (M, 1, 1)))
    elev += 0.25 * (rows > rng.integers(20, 76, (M, 1, 1)))
    trav = rng.uniform(0.7, 1.0, (M, H, W)).astype(np_dt)
    edge = rng.random((M, H, W))
    trav[edge < 0.03] = np_dt(0.8)
    trav[edge > 0.97] = np.nextafter(np_dt(0.8), np_dt(1))
    for m in range(M):
        for _ in range(6):
            r, c = rng.integers(0, H - 2, 2)
            h, w = rng.integers(2, 11, 2)
            trav[m, r:r + h, c:c + w] = 0
    which = torch.as_tensor(rng.integers(0, M, B), device=device)
    elevation, traversability = t(elev)[which], t(trav)[which]
    r0, c0 = (torch.as_tensor(rng.integers(5, H - 18, B), device=device) for _ in range(2))
    blocked = torch.arange(B, device=device) % 4 == 0
    ar = torch.arange(H, device=device)
    square = (blocked[:, None, None]
              & ((ar >= r0[:, None]) & (ar < r0[:, None] + 13))[:, :, None]
              & ((ar >= c0[:, None]) & (ar < c0[:, None] + 13))[:, None, :])
    traversability = torch.where(square, torch.zeros((), dtype=dtype, device=device),
                                 traversability)
    center = u(-2, 2, 2).astype(np_dt)
    xy = center[:, None, :] + u(-1.6, 1.6, 4, 2)
    on_edge = rng.random((B, 4, 2)) < 0.25
    cells = rng.integers(-50, 51, (B, 4, 2)).astype(np_dt)
    xy = np.where(on_edge, center[:, None, :] + np_dt(res) * cells, xy.astype(np_dt))
    # leg 0 of a blocked instance at its square's middle cell
    mid = np.stack([W // 2 - (c0.cpu().numpy() + 6), (r0.cpu().numpy() + 6) - H // 2], -1)
    inside = blocked.cpu().numpy()
    xy[inside, 0] = center[inside] + np_dt(res) * mid[inside].astype(np_dt)
    pf = np.concatenate([xy, u(0, 0.1, 4, 1)], -1)
    start = lambda: np.concatenate([xy + u(-0.3, 0.3, 4, 2), u(0, 0.1, 4, 1)], -1)
    hm = hmap.HeightMap(elevation=elevation, variance=torch.full_like(elevation, 1e-4),
                        traversability=traversability, center=t(center), resolution=res)
    first_swing = torch.as_tensor(rng.integers(0, 2, (B, 4)) == 1, device=device)
    return hm, t(pf), t(start()), 0.10, 0.8, 0.17, first_swing, t(start())


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


def foothold_mismatches(args) -> tuple[list, dict]:
    """``cmpc_variant.foothold_update_kernel`` on ``args``
    (``foothold_case``'s) against ``foothold_update_plain``: (["pf"] unless
    the swing targets are equal bit for bit, of one dtype and shape, with
    "moved" / "searched" where the two calls added different counts to
    that counter; the largest |kernel - plain| of pf, and the legs the
    plain version counted moved under "moved legs")."""
    from quad_periodic_mpc_tpu_torch.control import cmpc_variant

    def counted(update):
        before = cmpc_variant.foothold_counts()
        out = update(*args)
        return out, [a - b for a, b in zip(cmpc_variant.foothold_counts(), before)]

    got, got_counts = counted(cmpc_variant.foothold_update_kernel)
    want, want_counts = counted(cmpc_variant.foothold_update_plain)
    same = (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(_bits(got), _bits(want)))
    bad = [] if same else ["pf"]
    bad += [name for name, g, w in zip(("moved", "searched"), got_counts, want_counts) if g != w]
    return bad, {"pf": float((got - want).abs().max()), "moved legs": want_counts[0]}


# Fused KF kernel vs its plain version, max abs error over x' and P'.  On
# conditioned states (kf_case: measurements ~N(0, 1) against r down to 1e-3,
# x' up to ~4, P' up to ~10) the two differ by f32 sums taken in another
# order, and the gap follows cond(S): over the 2048 draws of seed 10 the gap
# on x' has median 2.5e-5, 99th percentile 2.2e-4 and a worst instance of
# 3.05e-3 on an H100 (3.3e-3 through the host compiler).  Against the plain version's
# float64 run the H100 read 3.88e-3 for the kernel and 1.16e-3 for the plain
# version at their worst instances; the host compiler read the reverse, 1.0e-3
# and 3.5e-3: neither order is the better one.  So the absolute gate on x' is
# 5e-3, and beside it every comparison holds both the kernel and the plain
# version, instance by instance, to KF_COND_FACTOR * eps_f32 * cond(S) from
# float64 (kf_x_error_over_conditioning): that ratio measured 2.89 (kernel)
# and 1.63 (plain version) at its worst on an H100, medians 0.16 and 0.17
# (chip_smoke.py).  A fault of order in the kernel would show as a ratio far above the
# plain version's on well-conditioned instances.  P' stays within 4.2e-5.  (The
# reference holds its kernel to a float64 oracle at 2e-3 and 5e-3 on five
# such draws.)  Inside the start-up
# transient (kf_transient_case: P0 = 100 I against r ~ 1e-3, cond(S) ~ 5e5)
# the update (I - K C) Pm cancels Pm's 100s down to ~1e-3 and amplifies any
# reordering of the inverse's sums by ~Pm^2, so the transient states get a
# second, looser tolerance (the reference's tests/test_kf.py says ~1e-2 of
# its kernel against its XLA chain).  It is held at tick 3.  Measured on the
# CPU at B = 16, kernel's order against the plain version's: 6e-3 on P' at
# tick 0, 3e-8 at tick 3, and at tick 1 (foot variances still 20, body
# variances already 2) up to 1.3 on entries of 1.8 for single instances,
# where the reference's kernel in interpret mode gives this kernel's numbers
# to 3e-8 and float64 sits with the plain version: the filter forgets it
# within two ticks, and no tolerance is stated for that tick.
KF_TOL = {"x": 5e-3, "P": 2e-4}
KF_TOL_TRANSIENT = {"x": 2e-3, "P": 2e-2}
KF_COND_FACTOR = 8.0
KF_DT = 0.002


def kf_x_error_over_conditioning(args, x_new: torch.Tensor) -> torch.Tensor:
    """Per instance, max |x' - x'_float64| / (eps_f32 * cond(S)) for an
    answer ``x_new`` of ``fused_kf_innovate`` on ``args``: x'_float64 from the
    plain version run in float64, S = C Pm C^T + diag(r) and its 2-norm
    condition number in float64.  Held below KF_COND_FACTOR."""
    from quad_periodic_mpc_tpu_torch.ops.cuda import kf_kernel

    xhat, P, a, y, qd, rd = (t.double() for t in args)
    x64, _ = kf_kernel.fused_kf_innovate_reference(xhat, P, a, y, qd, rd, dt=KF_DT)
    P1 = torch.cat([P[:, 0:3] + KF_DT * P[:, 3:6], P[:, 3:]], dim=1)
    Pm = torch.cat([P1[:, :, 0:3] + KF_DT * P1[:, :, 3:6], P1[:, :, 3:]], dim=2)
    CP = kf_kernel._cp_rows(Pm + torch.diag_embed(qd))
    S = kf_kernel._cp_rows(CP.transpose(1, 2)) + torch.diag_embed(rd)
    err = (x_new.double() - x64).abs().amax(dim=1)
    return err / (2.0 ** -24 * torch.linalg.cond(S))


def kf_mismatches(args, got, want, transient: bool = False) -> tuple[list, dict]:
    """fused_kf_innovate's (x', P') on ``args`` against the plain
    version's: KF_TOL, and both answers' x' within KF_COND_FACTOR * eps *
    cond(S) of float64 instance by instance ("x cond kernel" / "x cond
    plain" in the gaps); on a cold start's states (``transient``)
    KF_TOL_TRANSIENT alone."""
    bad, gaps = _held(_gaps("xP", got, want), KF_TOL_TRANSIENT if transient else KF_TOL)
    if not transient:
        for who, x_new in (("kernel", got[0]), ("plain", want[0])):
            gaps[f"x cond {who}"] = float(kf_x_error_over_conditioning(args, x_new).max())
            if not gaps[f"x cond {who}"] < KF_COND_FACTOR:
                bad.append(f"x cond {who}")
    return bad, gaps


def kf_case(B: int, seed: int = 0, device="cuda"):
    """Conditioned seeded inputs of ``fused_kf_innovate`` (the generator of
    the reference's test_kf_pallas_kernel_matches_oracle): (xhat, P, a, y,
    q_diag, r_diag)."""
    rng = np.random.default_rng(seed)
    xhat = rng.normal(size=(B, 18))
    Ph = rng.normal(size=(B, 18, 18)).astype(np.float32)
    P = Ph @ Ph.transpose(0, 2, 1) + 18 * np.eye(18)
    a, y = rng.normal(size=(B, 3)), rng.normal(size=(B, 28))
    qd, rd = rng.uniform(0.001, 1, (B, 18)), rng.uniform(0.001, 1, (B, 28))
    return [_t(v, device).contiguous() for v in (xhat, P, a, y, qd, rd)]


def kf_transient_case(B: int, ticks: int = 3, seed: int = 0, device="cuda"):
    """The kernel's inputs at tick ``ticks`` of a cold start (P0 = 100 I): a
    standing robot, slightly tilted, contact phases spread over the batch so
    the trust inflation varies, the earlier ticks run through the plain
    version."""
    from quad_periodic_mpc_tpu_torch.control import leg_controller as lc
    from quad_periodic_mpc_tpu_torch.estimation import kf
    from quad_periodic_mpc_tpu_torch.models.a1 import A1
    from quad_periodic_mpc_tpu_torch.ops.cuda import kf_kernel
    from quad_periodic_mpc_tpu_torch.ops.rotations import rpy_to_rotmat

    rng = np.random.default_rng(seed)
    q = _t(np.tile([0.0, 0.67, -1.3], (B, 4, 1)) + rng.uniform(-0.05, 0.05, (B, 4, 3)), device)
    legs = lc.update_data(q, torch.zeros_like(q), A1)
    p_rel = _t(A1.hip_locations(), device) + legs.p
    inputs = (_t(np.tile([0.0, 0.0, 9.81], (B, 1)), device),
              rpy_to_rotmat(_t(rng.uniform(-0.1, 0.1, (B, 3)), device)).transpose(1, 2),
              torch.zeros(B, 3, device=device),
              p_rel, legs.v, _t(rng.uniform(0.0, 1.0, (B, 4)), device))
    state, params = kf.init((B,), device=device), kf.KFParams(dt=KF_DT)
    for tick in range(ticks + 1):
        a, y, qd, rd = kf.innovation_inputs(state, *inputs, params)
        args = [v.contiguous() for v in (state.xhat, state.P, a, y, qd, rd)]
        if tick < ticks:
            state = kf.KFState(*kf_kernel.fused_kf_innovate_reference(*args, dt=KF_DT))
    return args


# Fused ADMM kernel vs its plain version, max abs error: x and z are forces
# (~100 N), y is rho-scaled (rho = 3e-4).  The kernel sums each row of
# K^{-1} rhs in the order j = 0.., the plain version as a batched product,
# and every iteration carries the difference on.  The gap grows with the
# length of that sum, n = 12 h, more than with the iteration count: on an
# H100 it reads 4.4e-4, 7.7e-4, 1.2e-3 and 4.2e-3 at h = 10, 16, 20 and 28
# after 30 to 40 iterations, and 3.1e-3 at h = 28 after 10 (chip_smoke.py).  So one tolerance,
# proportional to h: 2e-4 h on x and z, which at h = 10 is the stagewise
# kernels' gate of 2e-3 on the same quantities, and 1e-5 on y.  The
# bf16-storage variant is held to the plain version on the same rounded
# operator, so the same tolerance applies, and so do the sizes past the
# resident ones (K^{-1} read from device memory every iteration).
def admm_tol(h: int) -> dict:
    return {"x": 2e-4 * h, "z": 2e-4 * h, "y": 1e-5}


ADMM_TOL_MAX_H = 28     # the longest horizon admm_tol was calibrated on


def admm_f64_gated(B: int, h: int) -> bool:
    """Whether a (B, h) case that misses admm_tol is held to the float64
    plain version instead (see ADMM_F64_FACTOR): past admm_tol's
    calibration, or from h = 22 at hundreds of instances, where the first
    design's kernel already lay past admm_tol on an H100 (B = 2048 at
    h = 22, 27 and 33, B = 256 at h = 23, 28 and 34, with f32 and bf16
    storage alike) and inside it at h <= 20 (tools/time_tick_cuda.py)."""
    return h > ADMM_TOL_MAX_H or (B >= 256 and h >= 22)


# The last horizons at which admm.cu holds K^{-1} on chip (in registers and
# shared memory), by storage, and the shared memory a block may take on
# sm_90 (an H100's opt-in limit).
ADMM_LAST_RESIDENT_H = {False: 22, True: 30}
SMEM_PER_BLOCK = 232448


# (B, h, iterations, kinv_bf16, resident) around admm.cu's register part
# (n = 12 h against J = 120), the change from J to J / 2 register columns,
# and the resident limits, for the emulated and card tests; B is the
# emulated tests' (the card tests take more instances).
ADMM_LIMIT_CASES = [
    *((2, h, 12, bf16, True) for bf16 in (False, True)
      for h in (9, 10, 11)),     # n = 108 < J (guarded), n = J, n = 132 > J
    *((1, h, 4, bf16, True) for bf16 in (False, True)
      for h in (15, 16)),        # the last horizon with J register columns, the first with J / 2
    (1, 22, 6, False, True),     # the largest resident f32 horizon
    (1, 23, 6, False, False),    # the smallest streamed one
    (1, 30, 4, True, True),      # the largest resident bf16 horizon
    (1, 31, 4, True, False),     # the smallest streamed one
]
# n = 972, past 32 warps of 30 variables: two variables a thread.  cond(K)
# is ~6e4 there, and float32 sums in any order sit ~0.07 from float64 on x
# after two iterations, beyond admm_tol's calibration (ADMM_TOL_MAX_H);
# such cases (and the shapes admm_f64_gated names) are held to the float64
# plain version instead, no farther from it than ADMM_F64_FACTOR times the
# float32 plain version is.  On an H100 the kernel's distance was at most
# 0.82 times the plain version's over 8 seeds at each of
# tools/time_tick_cuda.py's six gated shapes, and 0.98 times at
# chip_smoke.py's one (B = 5, h = 31).
ADMM_TWO_A_LANE_H = 81
ADMM_F64_FACTOR = 2.0


def admm_mismatches(args, got, want, f64: bool | None = None, **kw) -> tuple[list, dict]:
    """fused_admm_iterations' (x, z, y) on ``args`` (run with ``kw``:
    iters, kinv_bf16) against the float32 plain version's within
    admm_tol(h); or, where ``f64`` (by default admm_f64_gated(B, h)), no
    farther from the float64 plain version than ADMM_F64_FACTOR times the
    float32 plain version is, with those distances in the gaps as
    "<output> kernel to f64" and "<output> plain to f64"."""
    B, h = got[0].shape[0], got[0].shape[-1] // 12
    gaps = _gaps("xzy", got, want)
    if not (admm_f64_gated(B, h) if f64 is None else f64):
        return _held(gaps, admm_tol(h))
    from quad_periodic_mpc_tpu_torch.ops.cuda import admm_kernel

    exact = admm_kernel.fused_admm_iterations_reference(*(a.double() for a in args), **kw)
    bad = []
    for n, g, w, e in zip("xzy", got, want, exact):
        kernel, plain = (float((a.double() - e).abs().max()) for a in (g, w))
        gaps.update({f"{n} kernel to f64": kernel, f"{n} plain to f64": plain})
        if not kernel <= ADMM_F64_FACTOR * plain:
            bad.append(n)
    return bad, gaps


def admm_case(B: int, h: int, seed: int = 0, device="cuda", warm: bool = False,
              with_qp: bool = False):
    """Inputs of ``fused_admm_iterations`` (K_inv, q, l, u, rho, F, x0, z0,
    y0) for the condensed QP of random trot observations: K^{-1} the exact
    (Cholesky) inverse of the uniform-rho KKT matrix, the upper bounds as
    ``build_qp`` gives them (5e10 on the friction rows).  warm: a start near
    a previous answer instead of zeros.  with_qp: also return the QPData.
    The QP and K^{-1} are built in float64 and rounded to float32 once, so a
    case is the same whatever order the host's BLAS sums in (its thread
    count) and on either device: at h = 81 (cond(K) ~6e4) a float32 build
    moved the checks' reference distances by tens of percent with the
    thread count."""
    rng = np.random.default_rng(seed)
    obs, xref, table, f_est, x_drag = _trot_obs(rng, B, h, device, torch.float64)
    qp, _, _ = problem.build_qp(obs, xref, table, MPCConfig(horizon=h), f_est=f_est,
                                x_drag=x_drag)
    cfg = ADMMConfig()
    K_inv = linalg.cho_inverse(linalg.cholesky_factor(qp_admm.build_kkt_uniform(qp, cfg)))
    K_inv = (K_inv + K_inv.transpose(1, 2)) / 2.0
    rho = torch.full_like(qp.l, cfg.rho)
    n, m = 12 * h, 20 * h
    if warm:
        x0 = _t(rng.uniform(-5, 5, (B, n)), device, torch.float64)
        x0[:, 2::3] += 30.0
        z0 = torch.clamp(constraints.apply(qp.F, x0), qp.l, qp.u)
        y0 = _t(rng.uniform(-1e-3, 1e-3, (B, m)), device)
    else:
        x0, z0, y0 = (torch.zeros(B, w, device=device) for w in (n, m, m))
    args = [a.float().contiguous() for a in (K_inv, qp.q, qp.l, qp.u, rho, qp.F, x0, z0, y0)]
    if with_qp:
        return args, type(qp)(*(a.float() if torch.is_tensor(a) and a.is_floating_point() else a
                                for a in qp))
    return args


# Each kernel's cases at the shapes its driven paths launch it at, with
# their seeds: {kernel: {path: arguments of the kernel's case}}.
# chip_smoke.py's kernel table gates and times these, the first of each
# also beside its plain version, and tests/test_torch_kernels_gpu.py gates
# them among its other cases, so that the timed input is a gated one.  The
# tick kernels' seeds are their case builders' (MODEL_SEED, CONTACT_SEED,
# the defaults of wbc_state_and_input and plant_case).
PATH_CASES = {
    # (B, h, ADMM iterations, seed): the main path, the h = 16 / 32 / 64
    # lines, the full stack, the config 3 and 4 sweeps, the dry run's tier 2
    # oracle and its chunks (16 instances over 8 entries)
    "fused_stagewise_solve_srb": {
        "main path": (2048, 10, 30, 100), "line h=16": (1024, 16, 40, 101),
        "line h=32": (512, 32, 50, 102), "line h=64": (256, 64, 50, 103),
        "full stack": (256, 10, 30, 104), "config 3 sweep": (1024, 10, 30, 105),
        "config 4 sweep": (10000, 10, 30, 106), "dry run tier 2": (16, 32, 30, 107),
        "dry run tier 2 chunk": (2, 32, 30, 108)},
    # (B,): the full stack's batch and the single robot
    "fused_model_eval": {"full stack": (256,), "single robot": (1,)},
    "fused_wbc": {"full stack": (256,), "single robot": (1,)},
    "fused_substeps": {"full stack": (256,), "single robot": (1,)},
    "fused_contact_kinematics": {"full stack": (256,)},
    # (B, h, per-step c, dense Ad, seed): the predictive path's
    "fused_stagewise_solve": {"predictive": (2048, 10, True, False, 200)},
    # (B, h, per-step c, warm start, seed): bench.py's h = 128 line, 50 sweeps
    "fused_stagewise_solve_stream": {"h=128 streamed": (128, 128, False, False, 210)},
    # (B, seed): the main path's KKT audit
    "srb_build_dump": {"audit": (2048, 2268)},
    # (B, seed): the estimation tick's batch and the single robot
    "fused_kf_innovate": {"estimation tick": (2048, 10), "single robot": (1, 12)},
    # (B, h, iterations, non-zero start, bf16 storage, seed): the condensed line
    "fused_admm_iterations": {"condensed f32": (2048, 10, 30, False, False, 2358),
                              "condensed bf16": (2048, 10, 30, True, True, 2358)},
    # (B, wrench, seed): the trot cell's batch and the main path's, with the
    # x-force and the six-component disturbance
    "srb_plant_step": {"trot cell": (32768, False, 32768), "main path": (2048, False, 2048),
                       "trot cell, wrench": (32768, True, 32769),
                       "main path, wrench": (2048, True, 2049)},
    # (B, seed): the trot cell's, the main path's and the single robot's
    "swing_update": {"trot cell": (32768, 32772), "main path": (2048, 2052),
                     "single robot": (1, 5)},
    # (B, seed): the terrain cell's and the terrain experiment's; and one
    # robot, the CLI's terrain rollout's shape, which no smoke path drives
    "foothold_update": {"terrain cell": (32768, 32773), "terrain experiment": (2048, 2053),
                        "one robot, shape only": (1, 6)},
}
