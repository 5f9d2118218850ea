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

from quad_periodic_mpc_tpu_torch.config import MPCConfig
from quad_periodic_mpc_tpu_torch.control import mpc as M
from quad_periodic_mpc_tpu_torch.control.wbc import WBCGains
from quad_periodic_mpc_tpu_torch.models import floating_base as fb
from quad_periodic_mpc_tpu_torch.ops.cuda import admm_kernel as AK
from quad_periodic_mpc_tpu_torch.ops.cuda import kf_kernel as FK
from quad_periodic_mpc_tpu_torch.ops.cuda import kinematics_kernel as KK
from quad_periodic_mpc_tpu_torch.ops.cuda import plant_kernel as PK
from quad_periodic_mpc_tpu_torch.ops.cuda import srb_plant_kernel as SPK
from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel as SK
from quad_periodic_mpc_tpu_torch.ops.cuda import swing_update_kernel as SUK
from quad_periodic_mpc_tpu_torch.ops.cuda import wbc_kernel as WK
from quad_periodic_mpc_tpu_torch.runtime import graphs
from quad_periodic_mpc_tpu_torch.sim import srb_sim as S
from quad_periodic_mpc_tpu_torch.sim.articulated_sim import ContactParams
from quad_periodic_mpc_tpu_torch.testing import kernel_cases as KC


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("B,h,iters,seed", [
    (37, 10, 30, 37), (300, 48, 30, 300), (1, 10, 30, 1), (133, 10, 30, 133),
    (256, 64, 30, 256), *KC.PATH_CASES["fused_stagewise_solve_srb"].values(),
    (1000, 10, 30, 109), (256, 48, 30, 110), (133, 10, 30, 111), (1, 10, 30, 112)])
def test_stagewise_kernel_matches_plain_version(cuda, B, h, iters, seed):
    """KC.stagewise_mismatches (U and z 2e-3, y 1e-5), at every driven
    path's (B, h, ADMM iterations) and ragged batches.  One block per
    instance: B = 1, and B = 133, one block more than the card's SMs; h = 64
    is the longest line of the fused build.  One launch per call."""
    args, kw = KC.stagewise_case(B, h, seed=seed, device=cuda, iters=iters)
    before = SK.LAUNCHES["fused_stagewise_solve_srb"]
    got = SK.fused_stagewise_solve_srb(*args, **kw)
    torch.cuda.synchronize()
    assert SK.LAUNCHES["fused_stagewise_solve_srb"] == before + 1
    want = SK.fused_stagewise_solve_srb_reference(*args, **kw)
    assert KC.stagewise_mismatches(got, want)[0] == []


@pytest.mark.gpu
def test_stagewise_kernel_warm_start_matches_plain_version(cuda):
    """Seeded with a previous answer (the warm-start carry of mpc_step),
    kernel and plain version still agree: KC.stagewise_mismatches."""
    args, kw = KC.stagewise_case(256, 10, seed=3, device=cuda)
    torch.manual_seed(0)
    warm = SK.fused_stagewise_solve_srb_reference(*args, **kw)
    warm = [(w + s * torch.randn_like(w)).contiguous()
            for w, s in zip(warm, (0.5, 0.5, 1e-4))]   # N, N, rho-scaled
    got = SK.fused_stagewise_solve_srb(*args[:11], *warm, **kw)
    want = SK.fused_stagewise_solve_srb_reference(*args[:11], *warm, **kw)
    assert KC.stagewise_mismatches(got, want)[0] == []


@pytest.mark.gpu
@pytest.mark.parametrize("B,h,per_step_c,dense_ad,seed", [
    (37, 10, True, False, 47), (300, 48, False, False, 348), (37, 10, False, True, 47),
    (130, 64, True, False, 194), (1, 10, True, False, 11), (133, 10, False, True, 143),
    (37, 48, False, False, 201), (37, 10, True, True, 202),
    # the tunable period's shape (shared c), cli live's (B = 1) and the
    # predictive path's
    (2048, 10, False, False, 203), (1, 10, False, False, 204),
    *KC.PATH_CASES["fused_stagewise_solve"].values()])
def test_stagewise_solve_kernel_matches_plain_version(cuda, B, h, per_step_c, dense_ad, seed):
    """fused_stagewise_solve on caller-built dynamics (per-step and shared
    c, structured and dense Ad, the longest resident horizon):
    KC.stagewise_mismatches, as the fused-build kernel.  One launch per
    call, none of the other entry points."""
    args, kw = KC.solve_case(B, h, seed=seed, device=cuda, per_step_c=per_step_c,
                             dense_ad=dense_ad)
    before = dict(SK.LAUNCHES)
    got = SK.fused_stagewise_solve(*args, srb_ad=not dense_ad, **kw)
    torch.cuda.synchronize()
    assert SK.LAUNCHES == {**before, "fused_stagewise_solve": before["fused_stagewise_solve"] + 1}
    want = SK.fused_stagewise_solve_reference(*args, srb_ad=not dense_ad, **kw)
    assert KC.stagewise_mismatches(got, want)[0] == []


@pytest.mark.gpu
def test_stagewise_solve_kernel_rescue_matches_plain_version(cuda):
    """Dense Ad whose warm Newton-Schulz seeds fail the gate
    (KC.rescue_case): the plain version restarts some stages cold, and the
    kernel, whose warp takes the same per-instance branch, meets
    KC.stagewise_mismatches."""
    args, kw = KC.rescue_case(5, 10, seed=7, device=cuda)
    got = SK.fused_stagewise_solve(*args, srb_ad=False, **kw)
    torch.cuda.synchronize()
    stats = {}
    want = SK.fused_stagewise_solve_reference(*args, srb_ad=False, **kw, stats=stats)
    assert stats["rescued"] > 0
    assert KC.stagewise_mismatches(got, want)[0] == []


@pytest.mark.gpu
@pytest.mark.parametrize("B,h,per_step_c,warm,seed", [
    (5, 72, True, True, 77), (40, 128, False, True, 168), (1, 72, False, True, 73),
    (128, 128, False, True, 256), (133, 72, True, True, 205),
    (5, 72, True, False, 211), *KC.PATH_CASES["fused_stagewise_solve_stream"].values()])
def test_stagewise_stream_kernel_matches_plain_version(cuda, B, h, per_step_c, warm, seed):
    """fused_stagewise_solve_stream, 50 sweeps, from a warm start or from
    zeros: KC.stagewise_mismatches at KC.STREAM_TOL (U and z 5e-3, y 1e-5);
    the start is left as it was.  From zeros also the KKT residuals of both
    answers: the kernel's within KC.STREAM_KKT_FACTOR times the plain
    version's plus KC.STREAM_KKT_SLACK."""
    args, kw, sw = KC.solve_case(B, h, seed=seed, device=cuda, iters=50,
                                 per_step_c=per_step_c, with_problem=True)
    if warm:
        args[10:] = [w.contiguous() for w in SK.fused_stagewise_solve_stream(
            *args, **dict(kw, iters=5))]
    kept = [w.clone() for w in args[10:]]
    before = SK.LAUNCHES["fused_stagewise_solve_stream"]
    got = SK.fused_stagewise_solve_stream(*args, **kw)
    torch.cuda.synchronize()
    assert SK.LAUNCHES["fused_stagewise_solve_stream"] == before + 1
    want = SK.fused_stagewise_solve_stream_reference(*args, **kw)
    assert KC.stagewise_mismatches(got, want, KC.STREAM_TOL, None if warm else sw)[0] == []
    assert all(torch.equal(a, b) for a, b in zip(args[10:], kept))


@pytest.mark.gpu
@pytest.mark.parametrize("B,seed", [(1, 1), (37, 37), (2048, 2048), (5, 5), (33, 33),
                                    (37, 257), *KC.PATH_CASES["srb_build_dump"].values()])
def test_srb_build_dump_kernel_matches_build(cuda, B, seed):
    """The dump kernel against srb_assemble and against build_stagewise's
    Ad, Bd, c: KC.dump_mismatches (KC.DUMP_TOL)."""
    args, sw = KC.srb_dump_case(B, seed=seed, device=cuda)
    before = SK.LAUNCHES["srb_build_dump"]
    got = SK.srb_build_dump(*args)
    torch.cuda.synchronize()
    assert SK.LAUNCHES["srb_build_dump"] == before + 1
    assert KC.dump_mismatches(got, SK.srb_assemble(*args), sw)[0] == []


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


# the torque tick's batches: the full stack's 256, the single robot, a
# ragged 37, and the dry run's tier 3 (16 instances, 2 a chunk)
TICK_BATCHES = [1, 37, 256, 16, 2]


@pytest.mark.gpu
@pytest.mark.parametrize("B", TICK_BATCHES)
def test_model_eval_kernel_matches_plain_version(cuda, B):
    """KC.model_eval_mismatches: KC.MODEL_TOL, the tolerances of the
    reference's test_model_kernel_matches_xla; A^{-1} is held by
    |A^{-1} A - I|, the exact Schur inverse of the kernel's own A."""
    st = KC.model_states(B, seed=KC.MODEL_SEED, device=cuda)
    mc = fb.build_a1_constants("float32", str(cuda))
    before = KK.LAUNCHES["fused_model_eval"]
    got = KK.fused_model_eval(st, mc)
    torch.cuda.synchronize()
    assert KK.LAUNCHES["fused_model_eval"] == before + 1
    assert KC.model_eval_mismatches(got, KK.model_eval_reference(st, mc))[0] == []


@pytest.mark.gpu
@pytest.mark.parametrize("B", TICK_BATCHES)
def test_contact_kinematics_kernel_matches_plain_version(cuda, B):
    """KC.contact_mismatches (KC.CONTACT_TOL), as
    test_kinematics_kernel_matches_xla."""
    st = KC.model_states(B, seed=KC.CONTACT_SEED, device=cuda)
    mc = fb.build_a1_constants("float32", str(cuda))
    before = KK.LAUNCHES["fused_contact_kinematics"]
    info = KK.fused_contact_kinematics(st, mc)
    torch.cuda.synchronize()
    assert KK.LAUNCHES["fused_contact_kinematics"] == before + 1
    assert KC.contact_mismatches(info, fb.contact_jacobians(st, mc))[0] == []


@pytest.mark.gpu
@pytest.mark.parametrize("pdip_iters", [0, 1, 15])
@pytest.mark.parametrize("B", TICK_BATCHES)
def test_wbc_kernel_matches_plain_version(cuda, B, pdip_iters):
    """KC.wbc_mismatches: q_des 1.5e-3, qd_des 1e-2 (damped pinvs of near-singular
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
    assert KC.wbc_mismatches(got, WK.fused_wbc_reference(*args, WBCGains(), pdip))[0] == []


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
@pytest.mark.parametrize("B", TICK_BATCHES)
def test_plant_kernel_matches_plain_version(cuda, B, substeps):
    """KC.substeps_mismatches: the tolerances of
    test_fused_substeps_match_step_fast,
    pos 1e-5, quat 1e-6, v_body 5e-4, q 1e-5, qd 2e-3, p_foot and anchors
    1e-5 (10 substeps of stiff penalty contact amplify reordered sums in
    qdd).  B = 1 and 37 leave the last block of two instances half empty."""
    plant, tau, cache, Jc, pf = KC.plant_case(B, device=cuda)
    params = ContactParams()
    before = PK.LAUNCHES
    got = PK.fused_substeps(plant, tau, 2e-4, params, cache, Jc, pf, substeps)
    torch.cuda.synchronize()
    assert PK.LAUNCHES == before + 1
    want = PK.fused_substeps_reference(plant, tau, 2e-4, params, cache, Jc, pf, substeps)
    assert KC.substeps_mismatches(got, want)[0] == []


@pytest.mark.gpu
@pytest.mark.parametrize("B,wrench,seed", [*KC.PATH_CASES["srb_plant_step"].values(),
                                           (37, False, 37), (37, True, 38)])
def test_srb_plant_kernel_matches_plain_version(cuda, B, wrench, seed):
    """srb_sim.step on the card (one launch) against the dense plain
    version at the trot cell's B = 32,768, the main path's 2,048 and a
    ragged B = 37, by KC.srb_plant_mismatches: mixed
    stances, rpy up to +-0.5 rad, t up to 100 s, both disturbance forms.
    A float64 step launches the double kernel, held in float64."""
    cfg = MPCConfig()
    for dtype in (torch.float32, torch.float64):
        args = KC.srb_plant_case(B, seed=seed, device=cuda, wrench=wrench, dtype=dtype)
        before = SPK.LAUNCHES
        got = S.step(*args, cfg, 0.002)
        torch.cuda.synchronize()
        assert SPK.LAUNCHES == before + 1
        assert got.x.dtype == dtype
        assert KC.srb_plant_mismatches(got, S.step_dense(*args, cfg, 0.002))[0] == []


@pytest.mark.gpu
def test_srb_plant_kernel_replays_bit_equal_to_eager(cuda):
    """srb_sim.step captured in a CUDA graph (runtime/graphs.capture) at
    B = 32,768: the replay's state bit-equal to the eager kernel's.  The
    eager warm-up calls are counted launches; the capture and the replays
    add nothing to LAUNCHES."""
    plant, *rest = KC.srb_plant_case(32768, seed=7, device=cuda)
    cfg = MPCConfig()
    eager = S.step(plant, *rest, cfg, 0.002)
    graphed = graphs.capture(lambda p: (S.step(p, *rest, cfg, 0.002),), plant)
    before = SPK.LAUNCHES
    for _ in range(graphs.WARMUP + 2):
        (got,) = graphed(plant)
    torch.cuda.synchronize()
    assert graphed.graph is not None
    assert SPK.LAUNCHES == before + graphs.WARMUP
    for g, w in zip(got, eager):
        assert torch.equal(g, w)


def _shifted_targets(pf, state, obs):
    """A foothold hook that reads the state from before the update."""
    return pf + 0.1 * (obs.p_feet - state.swing_p0)


@pytest.mark.gpu
@pytest.mark.parametrize("B,seed", KC.PATH_CASES["swing_update"].values())
def test_swing_update_kernel_matches_plain_version(cuda, B, seed):
    """mpc.swing_update on the card (one launch; two around a foothold
    hook) against swing_update_plain at the tick cell's B = 1, the main
    path's 2,048 and the trot cell's 32,768, float32 and float64, the
    shared trot and per-instance stacked gaits, the latter with shared and
    with per-instance tunables: KC.swing_update_mismatches
    (the Raibert targets within KC.SWING_ULPS ulps of their dtype of cuBLAS's
    products, every other field bit-equal but world_position_desired,
    rpy_int and rpy_comp).  Prints the largest |kernel - plain| on p0, pf,
    p_des, v_des and a_des."""
    for dtype in (torch.float32, torch.float64):
        for gait, hook in (("trot", None), ("stacked", None), ("stacked", _shifted_targets)):
            args = KC.swing_update_case(B, seed=seed, device=cuda, gait_kind=gait,
                                        per_instance_tunable=hook is not None, dtype=dtype)
            before = SUK.LAUNCHES
            M.swing_update(*args, foothold_adjust=hook)
            torch.cuda.synchronize()
            assert SUK.LAUNCHES == before + 1 + (hook is not None)
            bad, gaps = KC.swing_update_mismatches(args, hook)
            print(f"swing_update B={B} {gait} {str(dtype)[6:]}: largest |kernel - plain| "
                  + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items()))
            assert bad == []


@pytest.mark.gpu
def test_swing_update_kernel_replays_bit_equal_to_eager(cuda):
    """mpc.swing_update captured in a CUDA graph (runtime/graphs.capture) at
    B = 32,768: the replay's state and output bit-equal to the eager
    kernel's.  The eager warm-up calls are counted launches; the capture
    and the replays add nothing to LAUNCHES."""
    state, obs, *rest = KC.swing_update_case(32768, seed=7, device=cuda)
    eager = M.swing_update(state, obs, *rest)
    graphed = graphs.capture(lambda s: M.swing_update(s, obs, *rest), state)
    before = SUK.LAUNCHES
    for _ in range(graphs.WARMUP + 2):
        got = graphed(state)
    torch.cuda.synchronize()
    assert graphed.graph is not None
    assert SUK.LAUNCHES == before + graphs.WARMUP
    for g, w in zip(graphs.leaves(got), graphs.leaves(eager)):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("B,seed", [(1, 1), (37, 37), (1585, 1585), (2048, 2048), (37, 11),
                                    *KC.PATH_CASES["fused_kf_innovate"].values()])
def test_kf_kernel_matches_plain_version(cuda, B, seed):
    """Conditioned seeded states, KC.kf_mismatches: KC.KF_TOL (x 5e-3, P
    2e-4: f32 sums in another order; the reasons are stated there), and the
    kernel's and the plain version's x' within KC.KF_COND_FACTOR * eps *
    cond(S) of float64 instance by instance.  One launch per call.  B = 1585 is one instance
    past the first design's one-wave limit (12 blocks on each of 132 SMs),
    B = 2048 the estimation tick's batch."""
    args = KC.kf_case(B, seed=seed, device=cuda)
    before = FK.LAUNCHES
    got = FK.fused_kf_innovate(*args, dt=KC.KF_DT)
    torch.cuda.synchronize()
    assert FK.LAUNCHES == before + 1
    want = FK.fused_kf_innovate_reference(*args, dt=KC.KF_DT)
    assert KC.kf_mismatches(args, got, want)[0] == []


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 7])
def test_kf_kernel_matches_plain_version_from_a_cold_start(cuda, seed):
    """Inputs at tick 3 of a cold start (P0 = 100 I): KC.KF_TOL_TRANSIENT
    (x 2e-3, P 2e-2), the looser gate of the start-up transient."""
    args = KC.kf_transient_case(256, ticks=3, seed=seed, device=cuda)
    got = FK.fused_kf_innovate(*args, dt=KC.KF_DT)
    want = FK.fused_kf_innovate_reference(*args, dt=KC.KF_DT)
    assert KC.kf_mismatches(args, got, want, transient=True)[0] == []


def _assert_admm_close(args, got, **kw):
    """KC.admm_mismatches: the float32 plain version's answer within
    KC.admm_tol(h), or where KC.admm_f64_gated(B, h) no farther from the
    float64 plain version than KC.ADMM_F64_FACTOR times the float32 one."""
    want = AK.fused_admm_iterations_reference(*args, **kw)
    assert KC.admm_mismatches(args, got, want, **kw)[0] == []


# (B, h, iterations, non-zero start, bf16 storage): the condensed line's two; h =
# 20 / 28 past the first design's resident sizes and inside this one's, h =
# 23 / 31 just past this one's (K^{-1} streamed); the dry run's tier 1 (128
# instances, 16 a chunk) and tier 3 (16, 2 a chunk)
ADMM_SHAPES = [
    (2048, 10, 30, False, False), (2048, 10, 30, True, True), (37, 16, 40, True, False),
    (37, 16, 40, False, True), (1, 10, 30, True, False), (5, 20, 30, True, False),
    (5, 28, 30, True, True), (5, 23, 30, True, False), (5, 31, 30, True, True),
    (128, 10, 30, True, False), (16, 10, 30, True, False), (2, 10, 30, True, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,h,iters,warm,kinv_bf16,seed", [
    *((*c, c[0] + c[1]) for c in ADMM_SHAPES[:7]),
    *KC.PATH_CASES["fused_admm_iterations"].values(),
    *((*c, 300 + c[0] + c[1]) for c in ADMM_SHAPES[2:])])
def test_admm_kernel_matches_plain_version(cuda, B, h, iters, warm, kinv_bf16, seed):
    """Both storage variants, zero and non-zero starts, resident horizons
    and one past each resident size: _assert_admm_close.  One launch per
    call."""
    args = KC.admm_case(B, h, seed=seed, device=cuda, warm=warm)
    before = AK.LAUNCHES
    got = AK.fused_admm_iterations(*args, iters=iters, kinv_bf16=kinv_bf16)
    torch.cuda.synchronize()
    assert AK.LAUNCHES == before + 1
    _assert_admm_close(args, got, iters=iters, kinv_bf16=kinv_bf16)


@pytest.mark.gpu
@pytest.mark.parametrize("B,h,iters,kinv_bf16,resident", KC.ADMM_LIMIT_CASES)
def test_admm_kernel_register_and_resident_limits(cuda, B, h, iters, kinv_bf16, resident):
    """n = 12 h below, at and past the columns of K^{-1} held in registers,
    on both sides of the change from J to J / 2 register columns and of
    the resident limits, at 37 or 5 instances: KC.admm_tol(h) (not the
    float64 rule)."""
    B = 37 if B > 1 else 5
    args = KC.admm_case(B, h, seed=h + 7 * B, device=cuda, warm=True)
    assert AK.kinv_resident(12 * h, 20 * h, kinv_bf16) == resident
    got = AK.fused_admm_iterations(*args, iters=iters, kinv_bf16=kinv_bf16)
    want = AK.fused_admm_iterations_reference(*args, iters=iters, kinv_bf16=kinv_bf16)
    assert KC.admm_mismatches(args, got, want, f64=False)[0] == []


@pytest.mark.gpu
@pytest.mark.parametrize("kinv_bf16", [False, True])
def test_admm_kernel_two_variables_a_lane(cuda, kinv_bf16):
    """h = 81 (two variables a lane, K^{-1} streamed), three instances, two
    iterations: no farther from the float64 plain version than
    KC.ADMM_F64_FACTOR times the float32 plain version (h > 28 is
    KC.admm_f64_gated)."""
    h = KC.ADMM_TWO_A_LANE_H
    args = KC.admm_case(3, h, seed=h + 21, device=cuda, warm=True)
    got = AK.fused_admm_iterations(*args, iters=2, kinv_bf16=kinv_bf16)
    _assert_admm_close(args, got, iters=2, kinv_bf16=kinv_bf16)


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
        assert float((got[0] - want[0]).abs().max()) < KC.admm_tol(last)["x"]


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
