"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and the CUDA toolkit; elsewhere they skip.
The module imports nothing of JAX, so it also runs where JAX is not
installed (the repository's conftest does import JAX, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from quad_periodic_mpc_tpu_torch.control.wbc import WBCGains
from quad_periodic_mpc_tpu_torch.models import floating_base as fb
from quad_periodic_mpc_tpu_torch.ops.cuda import kinematics_kernel as KK
from quad_periodic_mpc_tpu_torch.ops.cuda import plant_kernel as PK
from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel as SK
from quad_periodic_mpc_tpu_torch.ops.cuda import wbc_kernel as WK
from quad_periodic_mpc_tpu_torch.sim.articulated_sim import ContactParams
from quad_periodic_mpc_tpu_torch.testing import kernel_cases as KC


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("B,h", [(37, 10), (300, 48)])
def test_stagewise_kernel_matches_plain_version(cuda, B, h):
    """U and z to atol 2e-3 (forces ~100 N; FMA contraction and summation
    order differ, amplified through 30 ADMM sweeps); y to 1e-5
    (rho-scaled).  One launch per call."""
    args, kw = KC.stagewise_case(B, h, seed=B, device=cuda)
    before = SK.LAUNCHES["fused_stagewise_solve_srb"]
    got = SK.fused_stagewise_solve_srb(*args, **kw)
    torch.cuda.synchronize()
    assert SK.LAUNCHES["fused_stagewise_solve_srb"] == before + 1
    want = SK.fused_stagewise_solve_srb_reference(*args, **kw)
    for g, w, tol in zip(got, want, (2e-3, 2e-3, 1e-5)):
        assert bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) < tol


@pytest.mark.gpu
def test_stagewise_kernel_warm_start_matches_plain_version(cuda):
    """Seeded with a previous answer (the warm-start carry of mpc_step),
    kernel and plain version still agree: same tolerances as above."""
    args, kw = KC.stagewise_case(256, 10, seed=3, device=cuda)
    torch.manual_seed(0)
    warm = SK.fused_stagewise_solve_srb_reference(*args, **kw)
    warm = [(w + s * torch.randn_like(w)).contiguous()
            for w, s in zip(warm, (0.5, 0.5, 1e-4))]   # N, N, rho-scaled
    got = SK.fused_stagewise_solve_srb(*args[:11], *warm, **kw)
    want = SK.fused_stagewise_solve_srb_reference(*args[:11], *warm, **kw)
    for g, w, tol in zip(got, want, (2e-3, 2e-3, 1e-5)):
        assert float((g - w).abs().max()) < tol


def _maxdiff(a, b):
    return float((a - b).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("B,h,per_step_c,dense_ad", [
    (37, 10, True, False), (300, 48, False, False), (37, 10, False, True),
    (130, 64, True, False)])
def test_stagewise_solve_kernel_matches_plain_version(cuda, B, h, per_step_c, dense_ad):
    """fused_stagewise_solve on caller-built dynamics (per-step and shared
    c, structured and dense Ad, the longest resident horizon): U and z 2e-3,
    y 1e-5, as the fused-build kernel.  One launch per call, none of the
    other entry points."""
    args, kw = KC.solve_case(B, h, seed=B + h, device=cuda, per_step_c=per_step_c,
                             dense_ad=dense_ad)
    before = dict(SK.LAUNCHES)
    got = SK.fused_stagewise_solve(*args, srb_ad=not dense_ad, **kw)
    torch.cuda.synchronize()
    assert SK.LAUNCHES == {**before, "fused_stagewise_solve": before["fused_stagewise_solve"] + 1}
    want = SK.fused_stagewise_solve_reference(*args, srb_ad=not dense_ad, **kw)
    for g, w, tol in zip(got, want, (2e-3, 2e-3, 1e-5)):
        assert bool(torch.isfinite(g).all())
        assert _maxdiff(g, w) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("B,h,per_step_c", [(5, 72, True), (40, 128, False)])
def test_stagewise_stream_kernel_matches_plain_version(cuda, B, h, per_step_c):
    """fused_stagewise_solve_stream from a warm start, 50 sweeps: U and z
    5e-3 (roundoff between kernel and plain version grows with the chain:
    h (1 + 2 iters) is 12,928 dependent stage steps at h = 128 against 610
    at h = 10, where the gap is ~4e-4), y 1e-5; the warm start is left as
    it was."""
    args, kw = KC.solve_case(B, h, seed=B + h, device=cuda, iters=50, per_step_c=per_step_c)
    warm = [w.contiguous() for w in SK.fused_stagewise_solve_stream(
        *args, **dict(kw, iters=5))]
    kept = [w.clone() for w in warm]
    before = SK.LAUNCHES["fused_stagewise_solve_stream"]
    got = SK.fused_stagewise_solve_stream(*args[:10], *warm, **kw)
    torch.cuda.synchronize()
    assert SK.LAUNCHES["fused_stagewise_solve_stream"] == before + 1
    want = SK.fused_stagewise_solve_stream_reference(*args[:10], *warm, **kw)
    for g, w, tol in zip(got, want, (5e-3, 5e-3, 1e-5)):
        assert bool(torch.isfinite(g).all())
        assert _maxdiff(g, w) < tol
    assert all(torch.equal(a, b) for a, b in zip(warm, kept))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 37, 2048])
def test_srb_build_dump_kernel_matches_build(cuda, B):
    """The dump kernel against srb_assemble and against build_stagewise's
    Ad, Bd, c: 1e-6 (the same entries in exact f32; only the 3x3 products
    inside may round differently)."""
    args, sw = KC.srb_dump_case(B, seed=B, device=cuda)
    before = SK.LAUNCHES["srb_build_dump"]
    got = SK.srb_build_dump(*args)
    torch.cuda.synchronize()
    assert SK.LAUNCHES["srb_build_dump"] == before + 1
    for g, w, b in zip(got, SK.srb_assemble(*args), (sw.Ad, sw.Bd, sw.c)):
        assert _maxdiff(g, w) < 1e-6
        assert _maxdiff(g, b) < 1e-6


@pytest.mark.gpu
def test_solve_on_the_card_rejects_float64_in_the_kernel_wrappers(cuda):
    """float64 CUDA tensors raise in the wrappers (no plain version on the
    card); qp_stagewise.solve sends float64 to the scan path instead."""
    from quad_periodic_mpc_tpu_torch.config import ADMMConfig
    from quad_periodic_mpc_tpu_torch.ops import qp_stagewise

    args, kw = KC.solve_case(4, 10, seed=1, device=cuda)
    before = dict(SK.LAUNCHES)
    with pytest.raises(TypeError):
        SK.fused_stagewise_solve(*(a.double() for a in args), **kw)
    Ad, Bd, c, x0, x_ref, Q, _, F, l, u = (a.double() for a in args[:10])
    R = torch.full((12,), 8e-5, dtype=torch.float64, device=cuda)
    prob = qp_stagewise.StagewiseProblem(Ad, Bd, c, x0, x_ref, Q, R, F, l, u)
    U, _ = qp_stagewise.solve(prob, ADMMConfig(iterations=5, backend="pallas"))
    assert U.dtype == torch.float64 and U.is_cuda and SK.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 37, 256])
def test_model_eval_kernel_matches_plain_version(cuda, B):
    """The tolerances of the reference's test_model_kernel_matches_xla: A
    1e-4 (entries up to ~20), G 1e-3 (up to ~200), C 2e-3, Jc and p_foot
    2e-5, Jc qdot 5e-4 (sums in another order); A^{-1} is held by
    |A^{-1} A - I| < 5e-3, the exact Schur inverse of the kernel's own A."""
    st = KC.model_states(B, seed=4, device=cuda)
    mc = fb.build_a1_constants("float32", str(cuda))
    before = KK.LAUNCHES["fused_model_eval"]
    A, Ainv, G, C, info = KK.fused_model_eval(st, mc)
    torch.cuda.synchronize()
    assert KK.LAUNCHES["fused_model_eval"] == before + 1
    A_r, _, G_r, C_r, info_r = KK.model_eval_reference(st, mc)
    assert _maxdiff(A, A_r) < 1e-4
    assert _maxdiff(G, G_r) < 1e-3
    assert _maxdiff(C, C_r) < 2e-3
    assert _maxdiff(info.Jc, info_r.Jc) < 2e-5
    assert _maxdiff(info.p_foot, info_r.p_foot) < 2e-5
    assert _maxdiff(info.Jcdqd, info_r.Jcdqd) < 5e-4
    eye = torch.eye(18, device=cuda).expand(B, 18, 18)
    assert _maxdiff(Ainv @ A, eye) < 5e-3


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 37])
def test_contact_kinematics_kernel_matches_plain_version(cuda, B):
    """Jc and p_foot 2e-5, Jc qdot 5e-4, as test_kinematics_kernel_matches_xla."""
    st = KC.model_states(B, seed=2, device=cuda)
    mc = fb.build_a1_constants("float32", str(cuda))
    before = KK.LAUNCHES["fused_contact_kinematics"]
    info = KK.fused_contact_kinematics(st, mc)
    torch.cuda.synchronize()
    assert KK.LAUNCHES["fused_contact_kinematics"] == before + 1
    ref = fb.contact_jacobians(st, mc)
    assert _maxdiff(info.Jc, ref.Jc) < 2e-5
    assert _maxdiff(info.Jcdqd, ref.Jcdqd) < 5e-4
    assert _maxdiff(info.p_foot, ref.p_foot) < 2e-5


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 37, 256])
def test_wbc_kernel_matches_plain_version(cuda, B):
    """KC.WBC_TOL: q_des 1.5e-3, qd_des 1e-2 (damped pinvs of near-singular
    projected task Jacobians amplify reordered sums), fr and tau 5e-5 N /
    Nm after 15 interior-point iterations (below what one iteration fewer
    moves them)."""
    st, inp = KC.wbc_state_and_input(B, device=cuda)
    args = KC.wbc_kernel_args(st, inp)
    before = WK.LAUNCHES
    got = WK.fused_wbc(*args, WBCGains(), KC.WBC_PDIP)
    torch.cuda.synchronize()
    assert WK.LAUNCHES == before + 1
    want = WK.fused_wbc_reference(*args, WBCGains(), KC.WBC_PDIP)
    for g, w, name in zip(got, want, ("q_des", "qd_des", "tau", "fr")):
        assert bool(torch.isfinite(g).all())
        assert _maxdiff(g, w) < KC.WBC_TOL[name], name


@pytest.mark.gpu
def test_wbc_run_pallas_rejects_float64(cuda):
    """The fused WBC takes float32 only: wbc.run(backend="pallas") on
    float64 CUDA tensors raises instead of running the plain version."""
    from quad_periodic_mpc_tpu_torch.control import wbc

    st, inp = KC.wbc_state_and_input(2, device=cuda)
    st = fb.FBState(*(t.double() for t in st))
    inp = wbc.WBCInput(*(t.double() for t in inp))
    mc = fb.build_a1_constants("float64", str(cuda))
    before = WK.LAUNCHES
    with pytest.raises(TypeError):
        wbc.run(st, inp, mc, pdip=KC.WBC_PDIP, backend="pallas")
    assert WK.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 37, 256])
def test_plant_kernel_matches_plain_version(cuda, B):
    """The tolerances of test_fused_substeps_match_step_fast: pos 1e-5,
    quat 1e-6, v_body 5e-4, q 1e-5, qd 2e-3, p_foot and anchors 1e-5
    (10 substeps of stiff penalty contact amplify reordered sums in qdd)."""
    plant, tau, cache, Jc, pf = KC.plant_case(B, device=cuda)
    params = ContactParams()
    before = PK.LAUNCHES
    pb, pf_b = PK.fused_substeps(plant, tau, 2e-4, params, cache, Jc, pf, 10)
    torch.cuda.synchronize()
    assert PK.LAUNCHES == before + 1
    pa, pf_a = PK.fused_substeps_reference(plant, tau, 2e-4, params, cache, Jc, pf, 10)
    for g, w, tol in ((pb.fb.pos, pa.fb.pos, 1e-5), (pb.fb.quat, pa.fb.quat, 1e-6),
                      (pb.fb.v_body, pa.fb.v_body, 5e-4), (pb.fb.q, pa.fb.q, 1e-5),
                      (pb.fb.qd, pa.fb.qd, 2e-3), (pf_b, pf_a, 1e-5),
                      (pb.anchor, pa.anchor, 1e-5)):
        assert _maxdiff(g, w) < tol
    assert torch.equal(pb.in_contact, pa.in_contact)
