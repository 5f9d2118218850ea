"""The port's whole-body control against the JAX package: ``wbc.run`` on the
batched ("xla") path, the plain version of the fused WBC kernel against
the JAX Pallas kernel in interpret mode, the cone PDIP on one WBIC-sized
QP, and the leg controller.

Inputs are made with numpy from a seed (the recipe of
tests/test_wbc_kernel.py, five stance patterns) and handed to both
packages.  WBC tolerances are the JAX kernel test's: q_des 1.5e-3, qd_des
1e-2 (damped pseudo-inverses of near-singular projected task Jacobians
amplify f32 sums taken in another order), fr and tau 1e-1 N / Nm after 15
interior-point iterations.
"""

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from quad_periodic_mpc_tpu import config as j_config
from quad_periodic_mpc_tpu.control import leg_controller as j_lc
from quad_periodic_mpc_tpu.control import wbc as j_wbc
from quad_periodic_mpc_tpu.models import floating_base as j_fb
from quad_periodic_mpc_tpu.models.a1 import A1 as J_A1
from quad_periodic_mpc_tpu.ops import qp_pdip as j_pdip
from quad_periodic_mpc_tpu.ops.qp_admm import QPData as JQPData
from quad_periodic_mpc_tpu_torch import config as t_config
from quad_periodic_mpc_tpu_torch import convert
from quad_periodic_mpc_tpu_torch.control import leg_controller as t_lc
from quad_periodic_mpc_tpu_torch.control import wbc as t_wbc
from quad_periodic_mpc_tpu_torch.models import floating_base as t_fb
from quad_periodic_mpc_tpu_torch.models.a1 import A1 as T_A1
from quad_periodic_mpc_tpu_torch.ops import qp_pdip as t_pdip
from quad_periodic_mpc_tpu_torch.ops.qp_admm import QPData as TQPData
from quad_periodic_mpc_tpu_torch.testing import kernel_cases

MC_J = j_fb.build_a1_constants("float32")
MC_T = t_fb.build_a1_constants("float32", "cpu")
WBC_TOL = {"q_des": 1.5e-3, "qd_des": 1e-2, "fr": 1e-1, "tau_ff": 1e-1}
B = 10


def _case():
    """Port state/input and the same arrays as JAX NamedTuples."""
    st, inp = kernel_cases.wbc_state_and_input(B, seed=3, device="cpu")
    j = lambda nt, cls: cls(**{f: jnp.asarray(getattr(nt, f).numpy()) for f in cls._fields})
    return st, inp, j(st, j_fb.FBState), j(inp, j_wbc.WBCInput)


def _compare(out_t, out_j):
    for f, tol in WBC_TOL.items():
        np.testing.assert_allclose(getattr(out_t, f).numpy(), np.asarray(getattr(out_j, f)),
                                   atol=tol, rtol=0, err_msg=f)


def test_wbc_run_xla_matches_reference():
    """Both batched paths (Cholesky KKT in the PDIP), model computed inside."""
    st, inp, st_j, inp_j = _case()
    out_t = t_wbc.run(st, inp, MC_T, pdip=t_config.PDIPConfig(iterations=15))
    out_j = jax.jit(lambda s, i: j_wbc.run(
        s, i, MC_J, pdip=j_config.PDIPConfig(iterations=15)))(st_j, inp_j)
    _compare(out_t, out_j)
    np.testing.assert_array_equal(out_t.kd_joint.numpy(), np.asarray(out_j.kd_joint))


def test_wbc_kernel_plain_version_matches_jax_kernel():
    """wbc.run(backend="pallas") on CPU tensors runs the fused kernel's
    plain version; JAX runs its Pallas kernel in interpret mode."""
    st, inp, st_j, inp_j = _case()
    out_t = t_wbc.run(st, inp, MC_T, pdip=t_config.PDIPConfig(iterations=15),
                      backend="pallas")
    out_j = jax.jit(lambda s, i: j_wbc.run(
        s, i, MC_J, pdip=j_config.PDIPConfig(iterations=15), backend="pallas"))(st_j, inp_j)
    _compare(out_t, out_j)
    fr = out_t.fr.numpy()
    swing = inp.contact_state.numpy() <= 0
    assert np.abs(fr[swing]).max() < 1e-4            # swing feet carry no force


def _wbic_qp(seed=5):
    """One WBIC-sized cone QP (12 variables, 24 rows) as wbic builds it:
    P = 2 (wf M^T M + wrf I), swing leg 1 pinned by fz_max = 0."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(6, 12)) * 0.3
    P = 2.0 * (0.1 * M.T @ M + np.eye(12))
    q = rng.normal(size=12) * 5.0
    mu = 0.4
    F = np.array([[0, 0, 1], [1, 0, mu], [-1, 0, mu], [0, 1, mu], [0, -1, mu], [0, 0, -1.0]])
    fr_des = np.zeros((4, 3))
    fr_des[[0, 2, 3], 2] = 40.0
    fz_max = np.array([1500.0, 0.0, 1500.0, 1500.0])
    ieq = np.zeros((4, 6))
    ieq[:, 5] = -fz_max
    l = ieq.reshape(24) - (fr_des @ F.T).reshape(24)
    u = np.full(24, 1e4)
    f32 = lambda a: a.astype(np.float32)
    return f32(P[None]), f32(q[None]), f32(F), f32(l[None]), f32(u[None])


def test_wbc_run_pallas_float64_on_cpu_takes_plain_version():
    """float64 CPU tensors with backend="pallas" run the kernel's plain
    version, which is the batched composition: equal to backend="xla" to
    1e-12 (float64 roundoff), and nothing is launched."""
    from quad_periodic_mpc_tpu_torch.ops.cuda import wbc_kernel as WK

    st, inp = kernel_cases.wbc_state_and_input(B, seed=3, device="cpu")
    st = t_fb.FBState(*(t.double() for t in st))
    inp = t_wbc.WBCInput(*(t.double() for t in inp))
    mc = t_fb.build_a1_constants("float64", "cpu")
    pdip = t_config.PDIPConfig(iterations=15)
    before = WK.LAUNCHES
    got = t_wbc.run(st, inp, mc, pdip=pdip, backend="pallas")
    want = t_wbc.run(st, inp, mc, pdip=pdip, backend="xla")
    assert WK.LAUNCHES == before
    assert got.tau_ff.dtype == torch.float64
    for f in ("tau_ff", "q_des", "qd_des", "fr"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f).numpy(),
                                   atol=1e-12, rtol=0, err_msg=f)


def test_wbc_kernel_wrapper_rejects_float64():
    """The kernel's C interface takes float32: its launch path raises on
    float64 before it builds or launches anything."""
    from quad_periodic_mpc_tpu_torch.ops.cuda import wbc_kernel as WK

    args = kernel_cases.wbc_kernel_args(*kernel_cases.wbc_state_and_input(2, device="cpu"))
    before = WK.LAUNCHES
    with pytest.raises(TypeError):
        WK._fused_wbc_cuda(*(a.double() for a in args), t_wbc.WBCGains(),
                           kernel_cases.WBC_PDIP)
    assert WK.LAUNCHES == before


def test_wbc_tolerance_catches_one_pdip_iteration_fewer():
    """kernel_cases.WBC_TOL's tau and fr bounds (5e-5) are tight enough to
    see a kernel that ran one interior-point iteration fewer: on the B = 256
    case the plain version's tau and fr move by more than that."""
    import dataclasses

    from quad_periodic_mpc_tpu_torch.ops.cuda import wbc_kernel as WK

    args = kernel_cases.wbc_kernel_args(*kernel_cases.wbc_state_and_input(256, device="cpu"))
    gains, pdip = t_wbc.WBCGains(), kernel_cases.WBC_PDIP
    full = WK.fused_wbc_reference(*args, gains, pdip)
    short = WK.fused_wbc_reference(
        *args, gains, dataclasses.replace(pdip, iterations=pdip.iterations - 1))
    for name, i in (("tau", 2), ("fr", 3)):
        assert float((full[i] - short[i]).abs().max()) > kernel_cases.WBC_TOL[name], name


@pytest.mark.parametrize("kkt", ["spd", "cholesky"])
def test_pdip_solve_matches_reference(kkt):
    """20 iterations on one QP: x to 1e-3 (forces of ~10-100 N; the f32
    KKT solves near complementarity lose digits in another order)."""
    P, q, F, l, u = _wbic_qp()
    cfg_t = t_config.PDIPConfig(iterations=20, kkt=kkt)
    cfg_j = j_config.PDIPConfig(iterations=20, kkt=kkt)
    x_t, s_t = t_pdip.solve(TQPData(*(torch.from_numpy(a) for a in (P, q, F, l, u))), cfg_t)
    x_j, s_j = j_pdip.solve(JQPData(*(jnp.asarray(a) for a in (P, q, F, l, u))), cfg_j)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=1e-3, rtol=0)
    assert np.isfinite(s_t.zl.numpy()).all()
    assert abs(float(x_t[0, 5])) < 1e-3        # the swing foot's fz stays pinned at 0


def test_leg_controller_matches_reference():
    """update_data and torque_output (clamp, safe mode, sign flip): 1e-5
    on torques of a few N m (f32 trig and reordered 3x3 products)."""
    rng = np.random.default_rng(13)
    q = (np.array([0.0, 0.8, -1.6]) + rng.uniform(-0.3, 0.3, (3, 4, 3))).astype(np.float32)
    qd = rng.uniform(-2, 2, (3, 4, 3)).astype(np.float32)
    fields = {f: rng.uniform(-5, 5, (3, 4, 3)).astype(np.float32)
              for f in j_lc.LegCommand._fields}
    data_t = t_lc.update_data(torch.from_numpy(q), torch.from_numpy(qd), T_A1)
    data_j = j_lc.update_data(jnp.asarray(q), jnp.asarray(qd), J_A1)
    for f in j_lc.LegData._fields:
        np.testing.assert_allclose(getattr(data_t, f).numpy(), np.asarray(getattr(data_j, f)),
                                   atol=1e-5, rtol=0, err_msg=f)
    cmd_t = t_lc.LegCommand(**{f: torch.from_numpy(a) for f, a in fields.items()})
    cmd_j = j_lc.LegCommand(**{f: jnp.asarray(a) for f, a in fields.items()})
    safe = np.array([False, True, False])
    for kw in (dict(), dict(low_level=True, flip_signs=False)):
        got = t_lc.torque_output(cmd_t, data_t, T_A1, safe_mode=torch.from_numpy(safe), **kw)
        want = j_lc.torque_output(cmd_j, data_j, J_A1, safe_mode=jnp.asarray(safe), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_wbc_input_carried_across():
    st, inp, st_j, inp_j = _case()
    back = convert.wbc_input(inp_j, "cpu")
    for f in t_wbc.WBCInput._fields:
        assert torch.equal(getattr(back, f), getattr(inp, f))
    assert torch.equal(convert.fb_state(st_j, "cpu").q, st.q)
