"""Seeded inputs for the port's kernels, made with numpy.

The recipes of the reference package's kernel tests
(``tests/test_stagewise.py``'s fused-build test, ``test_kinematics_kernel.py``,
``test_wbc_kernel.py``, ``test_plant_kernel.py``), built on the port's own
functions, so the card tests, the CPU tests and ``chip_smoke.py`` hold each
kernel to its plain version on the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from quad_periodic_mpc_tpu_torch.config import ADMMConfig, MPCConfig, PDIPConfig
from quad_periodic_mpc_tpu_torch.control import wbc
from quad_periodic_mpc_tpu_torch.models import floating_base as fb
from quad_periodic_mpc_tpu_torch.ops import gait, problem, qp_stagewise
from quad_periodic_mpc_tpu_torch.ops.cuda import kinematics_kernel
from quad_periodic_mpc_tpu_torch.ops.rotations import quat_to_rotmat, rpy_to_quat
from quad_periodic_mpc_tpu_torch.sim import articulated_sim as art

Q_STAND = np.array([0.0, 0.8, -1.6] * 4, np.float32)
# stance patterns of the reference's WBC kernel test
CONTACTS = np.array(
    [[1, 1, 1, 1], [0, 1, 1, 0], [1, 0, 0, 1], [0, 1, 1, 1], [1, 1, 0, 1]], np.float32)
WBC_PDIP = PDIPConfig(iterations=15)      # the full stack's WBC PDIP
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


def _t(a, device):
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _trot_problem(rng, B: int, h: int, device, per_step_c: bool = False):
    """A stagewise problem from random trot observations, through the
    port's own build.  Returns (problem, x0, R, r_feet, x_drag, f_est)."""
    hips = np.array([[0.18, -0.13, -0.27], [0.18, 0.13, -0.27],
                     [-0.18, -0.13, -0.27], [-0.18, 0.13, -0.27]])
    quat = rpy_to_quat(_t(rng.uniform(-0.15, 0.15, (B, 3)), device))
    obs = problem.RobotObs(
        p=_t(np.tile([0.0, 0.0, 0.27], (B, 1)), device),
        v=_t(rng.uniform(-0.3, 0.3, (B, 3)), device), quat=quat,
        omega=_t(rng.uniform(-0.2, 0.2, (B, 3)), device),
        r_feet=_t(hips + rng.uniform(-0.03, 0.03, (B, 4, 3)), device))
    xref = np.zeros((B, h, 13), np.float32)
    xref[..., 5] = 0.27
    seg = torch.as_tensor(rng.integers(0, 16, B), dtype=torch.int32, device=device)
    table = gait.mpc_table(gait.preset("trotting", device=device), seg, h)
    f_est, x_drag = _t(rng.uniform(-3, 3, (B, 6)), device), _t(rng.uniform(-0.5, 0.5, B), device)
    f_steps = None
    if per_step_c:      # a wrench that varies over the horizon, as a predictive fit gives
        k = np.arange(h)[None, :, None]
        f_steps = _t(rng.uniform(-3, 3, (B, 1, 6)) + rng.uniform(-2, 2, (B, 1, 6)) * np.sin(
            0.054 * k + rng.uniform(0, 6, (B, 1, 6))), device)
    sw, x0 = problem.build_stagewise(obs, _t(xref, device), table, MPCConfig(horizon=h),
                                     f_est=f_est, x_drag=x_drag, f_est_steps=f_steps)
    return sw, x0, quat_to_rotmat(quat), obs.r_feet, x_drag, f_est


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
