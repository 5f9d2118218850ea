"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and the CUDA toolkit; elsewhere they skip.
The module imports nothing of JAX, so it also runs where JAX is not
installed (the repository's conftest does import JAX, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py
"""

import dataclasses

import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

from quad_periodic_mpc_tpu_torch.control.wbc import WBCGains
from quad_periodic_mpc_tpu_torch.models import floating_base as fb
from quad_periodic_mpc_tpu_torch.ops.cuda import admm_kernel as AK
from quad_periodic_mpc_tpu_torch.ops.cuda import kf_kernel as FK
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
@pytest.mark.parametrize("B,h", [(37, 10), (300, 48), (1, 10), (133, 10), (256, 64)])
def test_stagewise_kernel_matches_plain_version(cuda, B, h):
    """U and z to atol 2e-3 (forces ~100 N; FMA contraction and summation
    order differ, amplified through 30 ADMM sweeps); y to 1e-5
    (rho-scaled).  One block per instance: B = 1, and B = 133, one block
    more than the card's SMs; h = 64 is the longest line of the fused
    build.  One launch per call."""
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
    (130, 64, True, False), (1, 10, True, False), (133, 10, False, True)])
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
def test_stagewise_solve_kernel_rescue_matches_plain_version(cuda):
    """Dense Ad whose warm Newton-Schulz seeds fail the gate
    (KC.rescue_case): the plain version restarts some stages cold, and the
    kernel, whose warp takes the same per-instance branch, meets U and z
    2e-3, y 1e-5."""
    args, kw = KC.rescue_case(5, 10, seed=7, device=cuda)
    got = SK.fused_stagewise_solve(*args, srb_ad=False, **kw)
    torch.cuda.synchronize()
    stats = {}
    want = SK.fused_stagewise_solve_reference(*args, srb_ad=False, **kw, stats=stats)
    assert stats["rescued"] > 0
    for g, w, tol in zip(got, want, (2e-3, 2e-3, 1e-5)):
        assert bool(torch.isfinite(g).all())
        assert _maxdiff(g, w) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("B,h,per_step_c", [(5, 72, True), (40, 128, False), (1, 72, False),
                                            (128, 128, False), (133, 72, True)])
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
@pytest.mark.parametrize("B", [1, 37, 2048, 5, 33])
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
@pytest.mark.parametrize("pdip_iters", [0, 1, 15])
@pytest.mark.parametrize("B", [1, 37, 256])
def test_wbc_kernel_matches_plain_version(cuda, B, pdip_iters):
    """KC.WBC_TOL: q_des 1.5e-3, qd_des 1e-2 (damped pinvs of near-singular
    projected task Jacobians amplify reordered sums), fr and tau 5e-5 N /
    Nm after 15 interior-point iterations (below what one iteration fewer
    moves them); also with none (the cascades, QP set-up and torques alone)
    and one, the settings tools/time_tick_cuda.py times."""
    st, inp = KC.wbc_state_and_input(B, device=cuda)
    args = KC.wbc_kernel_args(st, inp)
    pdip = dataclasses.replace(KC.WBC_PDIP, iterations=pdip_iters)
    before = WK.LAUNCHES
    got = WK.fused_wbc(*args, WBCGains(), pdip)
    torch.cuda.synchronize()
    assert WK.LAUNCHES == before + 1
    want = WK.fused_wbc_reference(*args, WBCGains(), pdip)
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
@pytest.mark.parametrize("substeps", [1, 10])
@pytest.mark.parametrize("B", [1, 37, 256])
def test_plant_kernel_matches_plain_version(cuda, B, substeps):
    """KC.PLANT_TOL, the tolerances of test_fused_substeps_match_step_fast:
    pos 1e-5, quat 1e-6, v_body 5e-4, q 1e-5, qd 2e-3, p_foot and anchors
    1e-5 (10 substeps of stiff penalty contact amplify reordered sums in
    qdd).  B = 1 and 37 leave the last block of two instances half empty."""
    plant, tau, cache, Jc, pf = KC.plant_case(B, device=cuda)
    params = ContactParams()
    before = PK.LAUNCHES
    pb, pf_b = PK.fused_substeps(plant, tau, 2e-4, params, cache, Jc, pf, substeps)
    torch.cuda.synchronize()
    assert PK.LAUNCHES == before + 1
    pa, pf_a = PK.fused_substeps_reference(plant, tau, 2e-4, params, cache, Jc, pf, substeps)
    for name in ("pos", "quat", "v_body", "q", "qd"):
        assert _maxdiff(getattr(pb.fb, name), getattr(pa.fb, name)) < KC.PLANT_TOL[name], name
    assert _maxdiff(pf_b, pf_a) < KC.PLANT_TOL["p_foot"]
    assert _maxdiff(pb.anchor, pa.anchor) < KC.PLANT_TOL["anchor"]
    assert torch.equal(pb.in_contact, pa.in_contact)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 37, 1585, 2048])
def test_kf_kernel_matches_plain_version(cuda, B):
    """Conditioned seeded states: KC.KF_TOL (x 5e-3, P 2e-4: f32 sums in
    another order; the reasons are stated there), and the kernel's and the
    plain version's x' within KC.KF_COND_FACTOR * eps * cond(S) of float64
    instance by instance.  One launch per call.  B = 1585 is one instance
    past the first design's one-wave limit (12 blocks on each of 132 SMs),
    B = 2048 the estimation tick's batch."""
    args = KC.kf_case(B, seed=B, device=cuda)
    before = FK.LAUNCHES
    got = FK.fused_kf_innovate(*args, dt=KC.KF_DT)
    torch.cuda.synchronize()
    assert FK.LAUNCHES == before + 1
    want = FK.fused_kf_innovate_reference(*args, dt=KC.KF_DT)
    for g, w, name in zip(got, want, "xP"):
        assert bool(torch.isfinite(g).all())
        assert _maxdiff(g, w) < KC.KF_TOL[name], name
    for x_new in (got[0], want[0]):
        assert float(KC.kf_x_error_over_conditioning(args, x_new).max()) < KC.KF_COND_FACTOR


@pytest.mark.gpu
def test_kf_kernel_matches_plain_version_from_a_cold_start(cuda):
    """Inputs at tick 3 of a cold start (P0 = 100 I): KC.KF_TOL_TRANSIENT
    (x 2e-3, P 2e-2), the looser gate of the start-up transient."""
    args = KC.kf_transient_case(256, ticks=3, device=cuda)
    got = FK.fused_kf_innovate(*args, dt=KC.KF_DT)
    want = FK.fused_kf_innovate_reference(*args, dt=KC.KF_DT)
    for g, w, name in zip(got, want, "xP"):
        assert _maxdiff(g, w) < KC.KF_TOL_TRANSIENT[name], name


@pytest.mark.gpu
@pytest.mark.parametrize("B,h,iters,warm,kinv_bf16", [
    (2048, 10, 30, False, False), (2048, 10, 30, True, True), (37, 16, 40, True, False),
    (37, 16, 40, False, True), (1, 10, 30, True, False), (5, 20, 30, True, False),
    (5, 28, 30, True, True)])
def test_admm_kernel_matches_plain_version(cuda, B, h, iters, warm, kinv_bf16):
    """Both storage variants, zero and non-zero starts, resident horizons
    and the two just past the first design's resident sizes (h = 20 f32 and
    28 bf16, resident now): KC.admm_tol(h) (x and z 2e-4 h, y 1e-5).  One
    launch per call."""
    args = KC.admm_case(B, h, seed=h + B, device=cuda, warm=warm)
    before = AK.LAUNCHES
    got = AK.fused_admm_iterations(*args, iters=iters, kinv_bf16=kinv_bf16)
    torch.cuda.synchronize()
    assert AK.LAUNCHES == before + 1
    want = AK.fused_admm_iterations_reference(*args, iters=iters, kinv_bf16=kinv_bf16)
    for g, w, name in zip(got, want, "xzy"):
        assert bool(torch.isfinite(g).all())
        assert _maxdiff(g, w) < KC.admm_tol(h)[name], name


@pytest.mark.gpu
@pytest.mark.parametrize("B,h,iters,kinv_bf16,resident", KC.ADMM_LIMIT_CASES)
def test_admm_kernel_register_and_resident_limits(cuda, B, h, iters, kinv_bf16, resident):
    """n = 12 h below, at and past the columns of K^{-1} held in registers,
    on both sides of the change from J to J / 2 register columns and of
    the resident limits, at 37 or 5 instances: KC.admm_tol(h)."""
    B = 37 if B > 1 else 5
    args = KC.admm_case(B, h, seed=h + 7 * B, device=cuda, warm=True)
    assert AK.kinv_resident(12 * h, 20 * h, kinv_bf16) == resident
    got = AK.fused_admm_iterations(*args, iters=iters, kinv_bf16=kinv_bf16)
    want = AK.fused_admm_iterations_reference(*args, iters=iters, kinv_bf16=kinv_bf16)
    for g, w, name in zip(got, want, "xzy"):
        assert bool(torch.isfinite(g).all())
        assert _maxdiff(g, w) < KC.admm_tol(h)[name], name


@pytest.mark.gpu
@pytest.mark.parametrize("kinv_bf16", [False, True])
def test_admm_kernel_two_variables_a_lane(cuda, kinv_bf16):
    """h = 81 (two variables a lane, K^{-1} streamed), three instances, two
    iterations: no farther from the float64 plain version than
    KC.ADMM_F64_FACTOR times the float32 plain version."""
    h = KC.ADMM_TWO_A_LANE_H
    args = KC.admm_case(3, h, seed=h + 21, device=cuda, warm=True)
    got = AK.fused_admm_iterations(*args, iters=2, kinv_bf16=kinv_bf16)
    want = AK.fused_admm_iterations_reference(*args, iters=2, kinv_bf16=kinv_bf16)
    exact = AK.fused_admm_iterations_reference(*(a.double() for a in args), iters=2,
                                               kinv_bf16=kinv_bf16)
    for g, w, e, name in zip(got, want, exact, "xzy"):
        assert bool(torch.isfinite(g).all())
        assert _maxdiff(g.double(), e) <= KC.ADMM_F64_FACTOR * _maxdiff(w.double(), e), name


@pytest.mark.gpu
def test_kinv_resident_matches_the_shared_memory_sizes(cuda):
    """The built kernel's resident rule at h = 1..40: resident up to
    KC.ADMM_LAST_RESIDENT_H and not past it, where the shared memory it
    reports for holding K^{-1} on chip first exceeds the card's opt-in
    limit a block (KC.SMEM_PER_BLOCK); and a launch at each last resident
    horizon, which takes all of that shared memory."""
    optin = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    assert optin == KC.SMEM_PER_BLOCK
    for bf16 in (False, True):
        last = KC.ADMM_LAST_RESIDENT_H[bf16]
        flags = [AK.kinv_resident(12 * h, 20 * h, bf16) for h in range(1, 41)]
        assert flags == [h <= last for h in range(1, 41)]
        size = [AK.kinv_shared_bytes(12 * h, 20 * h, bf16) for h in (last, last + 1)]
        assert size[0] <= optin < size[1]
        args = KC.admm_case(2, last, seed=last, device=cuda, warm=True)
        got = AK.fused_admm_iterations(*args, iters=3, kinv_bf16=bf16)
        want = AK.fused_admm_iterations_reference(*args, iters=3, kinv_bf16=bf16)
        assert _maxdiff(got[0], want[0]) < KC.admm_tol(last)["x"]


@pytest.mark.gpu
def test_kf_and_admm_wrappers_reject_float64(cuda):
    """float64 CUDA tensors raise TypeError in both wrappers (there is no
    plain version on the card); kf.update sends float64 to the dense chain
    instead, whatever the backend."""
    from quad_periodic_mpc_tpu_torch.estimation import kf

    before = (FK.LAUNCHES, AK.LAUNCHES)
    with pytest.raises(TypeError):
        FK.fused_kf_innovate(*(a.double() for a in KC.kf_case(2, device=cuda)), dt=KC.KF_DT)
    with pytest.raises(TypeError):
        AK.fused_admm_iterations(*(a.double() for a in KC.admm_case(2, 4, device=cuda)),
                                 iters=3)
    st = kf.init((2,), torch.float64, cuda)
    z = lambda *s: torch.zeros(2, *s, dtype=torch.float64, device=cuda)
    eye = torch.eye(3, dtype=torch.float64, device=cuda).expand(2, 3, 3)
    out = kf.update(st, z(3), eye, z(3), z(4, 3), z(4, 3), z(4) + 0.5, kf.KFParams(),
                    backend="pallas")
    assert out.P.dtype == torch.float64 and out.P.is_cuda
    assert (FK.LAUNCHES, AK.LAUNCHES) == before


@pytest.mark.gpu
@pytest.mark.parametrize("sigma", [7.0, 27.0])
def test_band_filter_float32_on_the_card(cuda, sigma):
    """The estimator's blurs (one banded matrix product each; sigma 27 has
    radius 81) in float32 on the card, B = 2048, window 400: within 1e-5 of
    the largest |x| of the same filter in float64, which TF32 products
    (~1e-3) would miss; the package keeps TF32 off."""
    from quad_periodic_mpc_tpu_torch.ops import estimator as E

    assert not torch.backends.cuda.matmul.allow_tf32
    g = torch.Generator().manual_seed(int(sigma))
    x = torch.randn(2048, 400, generator=g, dtype=torch.float64) + 5 * torch.sin(
        torch.arange(400, dtype=torch.float64) * 0.05)
    got = E.gaussian_filter(x.float().to(cuda), sigma).cpu().double()
    want = E.gaussian_filter(x.float().double(), sigma)
    assert float((got - want).abs().max()) < 1e-5 * float(x.abs().max())
