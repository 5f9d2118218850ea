"""The port's CUDA kernels, compiled for the CPU, against their plain
versions.

``tests/_cuda_emulation`` compiles each ``csrc/*.cu`` with the host C++
compiler (a launch runs its blocks in turn on std::threads,
``__syncwarp()`` is a barrier over the warp and ``__syncthreads()`` one
over the block, the shuffles and votes exchange through the warp) and
routes the wrappers' CUDA branches to it, so each kernel's own arithmetic,
indexing and warp synchronisation run here on CPU tensors.  Speed is
measured only on the card (chip_smoke.py, tests/test_torch_kernels_gpu.py,
tools/time_tick_cuda.py).  Inputs are the seeded recipes of
``quad_periodic_mpc_tpu_torch/testing/kernel_cases``; tolerances are those
of the card tests: the host compiler sums in the kernel's order but
contracts FMAs differently from nvcc, so the gaps are of the card's size.
"""

import dataclasses

import _cuda_emulation as cuda_emulation
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

MC = fb.build_a1_constants("float32", "cpu")


@pytest.fixture(scope="module")
def emulated():
    if cuda_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler")
    with cuda_emulation.emulated():
        yield


def _maxdiff(a, b):
    return float((a - b).abs().max())


@pytest.mark.parametrize("B", [1, 2, 5])
def test_model_eval_kernel(emulated, B):
    """A 1e-4, G 1e-3, C 2e-3, Jc and p_foot 2e-5, Jc qdot 5e-4,
    |A^{-1} A - I| 5e-3 (the reference's test_model_kernel_matches_xla).
    A block of three warps per instance: B = 1 is one block, B = 2 the
    smallest batch with a second."""
    st = KC.model_states(B, seed=4, device="cpu")
    before = KK.LAUNCHES["fused_model_eval"]
    A, Ainv, G, C, info = KK._model_eval_cuda(st, MC)
    assert KK.LAUNCHES["fused_model_eval"] == before + 1
    A_r, _, G_r, C_r, info_r = KK.model_eval_reference(st, MC)
    assert _maxdiff(A, A_r) < 1e-4
    assert _maxdiff(G, G_r) < 1e-3
    assert _maxdiff(C, C_r) < 2e-3
    assert _maxdiff(info.Jc, info_r.Jc) < 2e-5
    assert _maxdiff(info.p_foot, info_r.p_foot) < 2e-5
    assert _maxdiff(info.Jcdqd, info_r.Jcdqd) < 5e-4
    assert _maxdiff(Ainv @ A, torch.eye(18).expand(B, 18, 18)) < 5e-3


def _check_contact_kinematics(B):
    st = KC.model_states(B, seed=2, device="cpu")
    info = KK._contact_kinematics_cuda(st, MC)
    ref = fb.contact_jacobians(st, MC)
    assert _maxdiff(info.Jc, ref.Jc) < 2e-5
    assert _maxdiff(info.Jcdqd, ref.Jcdqd) < 5e-4
    assert _maxdiff(info.p_foot, ref.p_foot) < 2e-5


def test_contact_kinematics_kernel(emulated):
    _check_contact_kinematics(3)


def test_contact_kinematics_kernel_one_instance(emulated):
    """One block: the walk's lanes 0..3 and the transforms' 0..12 alone."""
    _check_contact_kinematics(1)


def test_kinematics_kernels_take_the_a1_tree_only():
    """The kernels hard-wire the A1's four legs of three joints; a model
    with another tree raises in the wrapper before anything is built or
    launched, and counts no launch."""
    st = KC.model_states(2, seed=2, device="cpu")
    other = MC._replace(parents=(0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 10))
    before = dict(KK.LAUNCHES)
    with pytest.raises(ValueError, match="A1"):
        KK._model_eval_cuda(st, other)
    with pytest.raises(ValueError, match="A1"):
        KK._contact_kinematics_cuda(st, MC._replace(gc_body=(3, 6, 9, 11)))
    assert KK.LAUNCHES == before


@pytest.mark.parametrize("pdip_iters", [0, 1, 15])
def test_wbc_kernel(emulated, pdip_iters):
    """KC.WBC_TOL (q_des 1.5e-3, qd_des 1e-2, tau and fr 5e-5; the reasons
    are stated there), over the five stance patterns twice, with no PDIP
    iteration (the two cascades, the QP set-up and the torques alone), one,
    and the full stack's 15.  One launch per call."""
    args = KC.wbc_kernel_args(*KC.wbc_state_and_input(10, device="cpu"))
    pdip = dataclasses.replace(KC.WBC_PDIP, iterations=pdip_iters)
    before = WK.LAUNCHES
    got = WK._fused_wbc_cuda(*args, WBCGains(), pdip)
    assert WK.LAUNCHES == before + 1
    want = WK.fused_wbc_reference(*args, WBCGains(), pdip)
    for g, w, name in zip(got, want, ("q_des", "qd_des", "tau", "fr")):
        assert _maxdiff(g, w) < KC.WBC_TOL[name], name


@pytest.mark.parametrize("B,substeps", [(3, 1), (3, 10), (4, 10), (1, 10)])
def test_plant_kernel(emulated, B, substeps):
    """KC.PLANT_TOL (pos 1e-5, quat 1e-6, v_body 5e-4, q 1e-5, qd 2e-3,
    p_foot and anchors 1e-5; the reasons are stated there), one
    substep and ten; B = 3 and 1 leave the last two-instance block half
    empty, B = 4 fills both.  One launch per call."""
    plant, tau, cache, Jc, pf = KC.plant_case(B, device="cpu")
    run = lambda fn: fn(plant, tau, 2e-4, ContactParams(), cache, Jc, pf, substeps)
    before = PK.LAUNCHES
    got = run(PK._fused_substeps_cuda)
    assert PK.LAUNCHES == before + 1
    (pb, pf_b), (pa, pf_a) = got, run(PK.fused_substeps_reference)
    for name in ("pos", "quat", "v_body", "q", "qd"):
        assert _maxdiff(getattr(pb.fb, name), getattr(pa.fb, name)) < KC.PLANT_TOL[name], name
    assert _maxdiff(pf_b, pf_a) < KC.PLANT_TOL["p_foot"]
    assert _maxdiff(pb.anchor, pa.anchor) < KC.PLANT_TOL["anchor"]
    assert torch.equal(pb.in_contact, pa.in_contact)
    assert torch.equal(pb.t, pa.t)


def test_stagewise_kernel(emulated):
    """U and z 2e-3, y 1e-5 (the card test's tolerances: 30 ADMM sweeps
    amplify reordered sums; y is rho-scaled)."""
    args, kw = KC.stagewise_case(3, 10, seed=3, device="cpu")
    kw.update(over_relax=1.6, dt=0.026, mass=12.0, i_inv_diag=(1 / 0.07, 1 / 0.26, 1 / 0.242))
    got = SK._fused_stagewise_solve_srb_cuda(*args, **kw)
    want = SK.fused_stagewise_solve_srb_reference(*args, **kw)
    for g, w, tol in zip(got, want, (2e-3, 2e-3, 1e-5)):
        assert _maxdiff(g, w) < tol


@pytest.mark.parametrize("variant", ["shared_c", "per_step_c", "dense_ad"])
def test_stagewise_solve_kernel(emulated, variant):
    """The caller-built solve, structured Ad with a shared and a per-stage
    c, and dense Ad: U and z 2e-3, y 1e-5, as the fused-build kernel."""
    args, kw = KC.solve_case(3, 10, seed=5, device="cpu", per_step_c=variant == "per_step_c",
                             dense_ad=variant == "dense_ad")
    kw.update(over_relax=1.6, srb_ad=variant != "dense_ad")
    before = SK.LAUNCHES["fused_stagewise_solve"]
    got = SK._fused_stagewise_solve_cuda(*args, **kw)
    assert SK.LAUNCHES["fused_stagewise_solve"] == before + 1
    want = SK.fused_stagewise_solve_reference(*args, **kw)
    for g, w, tol in zip(got, want, (2e-3, 2e-3, 1e-5)):
        assert _maxdiff(g, w) < tol


def test_stagewise_solve_kernel_rescue(emulated):
    """Dense Ad whose warm Newton-Schulz seeds fail the gate
    (KC.rescue_case): the cold restart runs on every lane of the instance's
    warp, and the kernel still meets U and z 2e-3, y 1e-5."""
    args, kw = KC.rescue_case(5, 8, seed=7, device="cpu")
    kw.update(over_relax=1.6, srb_ad=False)
    got = SK._fused_stagewise_solve_cuda(*args, **kw)
    stats = {}
    want = SK.fused_stagewise_solve_reference(*args, **kw, stats=stats)
    assert stats["rescued"] > 0
    for g, w, tol in zip(got, want, (2e-3, 2e-3, 1e-5)):
        assert torch.isfinite(g).all()
        assert _maxdiff(g, w) < tol


@pytest.mark.parametrize("per_step_c", [False, True])
def test_stagewise_stream_kernel(emulated, per_step_c):
    """The streamed solve at h = 16 from a warm start (its in-place
    update): U and z 2e-3, y 1e-5; the warm start itself is left as it was."""
    args, kw = KC.solve_case(2, 16, seed=6, device="cpu", iters=20, per_step_c=per_step_c)
    kw.update(over_relax=1.6)
    warm = [w.contiguous() for w in SK.fused_stagewise_solve_stream_reference(
        *args[:10], *args[10:], **dict(kw, iters=3))]
    kept = [w.clone() for w in warm]
    before = SK.LAUNCHES["fused_stagewise_solve_stream"]
    got = SK._fused_stagewise_solve_stream_cuda(*args[:10], *warm, **kw)
    assert SK.LAUNCHES["fused_stagewise_solve_stream"] == before + 1
    want = SK.fused_stagewise_solve_stream_reference(*args[:10], *warm, **kw)
    for g, w, tol in zip(got, want, (2e-3, 2e-3, 1e-5)):
        assert _maxdiff(g, w) < tol
    assert all(torch.equal(a, b) for a, b in zip(warm, kept))


def test_srb_build_dump_kernel(emulated):
    """The dump kernel writes what srb_assemble builds (1e-6: the same
    entries in exact f32, only the 3x3 products may round differently), and
    that is the independent build's Ad, Bd, c (1e-6)."""
    args, sw = KC.srb_dump_case(5, seed=8, device="cpu")
    kw = dict(dt=0.026, mass=12.0, i_inv_diag=(1 / 0.07, 1 / 0.26, 1 / 0.242))
    before = SK.LAUNCHES["srb_build_dump"]
    got = SK._srb_build_dump_cuda(*args, **kw)
    assert SK.LAUNCHES["srb_build_dump"] == before + 1
    for g, w, b in zip(got, SK.srb_assemble(*args, **kw), (sw.Ad, sw.Bd, sw.c)):
        assert _maxdiff(g, w) < 1e-6
        assert _maxdiff(g, b) < 1e-6


@pytest.mark.parametrize("B", [1, 33])
def test_srb_build_dump_kernel_batches(emulated, B):
    """Four instances a block, one warp each: B = 1 leaves three warps of
    the only block idle, B = 33 one instance in the last block; 1e-6
    against srb_assemble and the independent build, as above."""
    args, sw = KC.srb_dump_case(B, seed=8 + B, device="cpu")
    kw = dict(dt=0.026, mass=12.0, i_inv_diag=(1 / 0.07, 1 / 0.26, 1 / 0.242))
    got = SK._srb_build_dump_cuda(*args, **kw)
    for g, w, b in zip(got, SK.srb_assemble(*args, **kw), (sw.Ad, sw.Bd, sw.c)):
        assert _maxdiff(g, w) < 1e-6
        assert _maxdiff(g, b) < 1e-6


@pytest.mark.parametrize("B", [1, 2, 5, 64])
def test_kf_kernel(emulated, B):
    """Conditioned seeded states: KC.KF_TOL (x 5e-3, P 2e-4; the reasons are
    stated there), and the kernel's and the plain version's x' within
    KC.KF_COND_FACTOR * eps * cond(S) of float64 instance by instance.  One
    launch per call; a block of two warps per instance (B = 2: the smallest
    batch with a second block)."""
    args = KC.kf_case(B, seed=B, device="cpu")
    before = FK.LAUNCHES
    got = FK._fused_kf_innovate_cuda(*args, dt=KC.KF_DT)
    assert FK.LAUNCHES == before + 1
    want = FK.fused_kf_innovate_reference(*args, dt=KC.KF_DT)
    for g, w, name in zip(got, want, "xP"):
        assert torch.isfinite(g).all()
        assert _maxdiff(g, w) < KC.KF_TOL[name], name
    for x_new in (got[0], want[0]):
        assert float(KC.kf_x_error_over_conditioning(args, x_new).max()) < KC.KF_COND_FACTOR


def _check_kf_cold_start(B, ticks):
    args = KC.kf_transient_case(B, ticks=ticks, seed=ticks, device="cpu")
    got = FK._fused_kf_innovate_cuda(*args, dt=KC.KF_DT)
    want = FK.fused_kf_innovate_reference(*args, dt=KC.KF_DT)
    for g, w, name in zip(got, want, "xP"):
        assert _maxdiff(g, w) < KC.KF_TOL_TRANSIENT[name], name


@pytest.mark.parametrize("ticks", [0, 3, 40])
def test_kf_kernel_from_a_cold_start(emulated, ticks):
    """States from inside and after the start-up transient (P0 = 100 I):
    KC.KF_TOL_TRANSIENT (x 2e-3, P 2e-2), the looser gate that kernel_cases
    explains."""
    _check_kf_cold_start(6, ticks)


def test_kf_kernel_from_a_cold_start_one_instance(emulated):
    """The same gate for one instance (one block) at tick 3."""
    _check_kf_cold_start(1, 3)


@pytest.mark.parametrize("B,h,iters,warm,kinv_bf16", [
    (3, 10, 30, False, False), (3, 10, 30, False, True), (2, 16, 40, True, False),
    (2, 16, 40, True, True), (1, 10, 30, True, False), (1, 1, 10, False, False),
    (1, 20, 30, True, False), (1, 28, 30, True, True)])
def test_admm_kernel(emulated, B, h, iters, warm, kinv_bf16):
    """Both storage variants, zero and non-zero starts, the main path's
    horizon, a ragged one, h = 1, and h = 20 in float32 and h = 28 in
    bfloat16 (past the first design's resident sizes, inside this one's):
    KC.admm_tol(h) (x and z 2e-4 h, y 1e-5).  The kernel's hand-written
    bfloat16 rounding is the plain version's ``.to(bfloat16)``.  One launch
    per call."""
    args = KC.admm_case(B, h, seed=h + B, device="cpu", warm=warm)
    before = AK.LAUNCHES
    got = AK._fused_admm_iterations_cuda(*args, iters=iters, kinv_bf16=kinv_bf16)
    assert AK.LAUNCHES == before + 1
    want = AK.fused_admm_iterations_reference(*args, iters=iters, kinv_bf16=kinv_bf16)
    for g, w, name in zip(got, want, "xzy"):
        assert torch.isfinite(g).all()
        assert _maxdiff(g, w) < KC.admm_tol(h)[name], name
    assert AK.kinv_resident(12 * h, 20 * h, kinv_bf16) == (
        h <= KC.ADMM_LAST_RESIDENT_H[kinv_bf16])


@pytest.mark.parametrize("B,h,iters,kinv_bf16,resident", KC.ADMM_LIMIT_CASES)
def test_admm_kernel_register_and_resident_limits(emulated, B, h, iters, kinv_bf16,
                                                  resident):
    """n = 12 h below, at and past the columns of K^{-1} held in registers,
    on both sides of the change from J to J / 2 register columns and of
    the resident limits, from non-zero starts: KC.admm_tol(h)."""
    args = KC.admm_case(B, h, seed=h + 7 * B, device="cpu", warm=True)
    assert AK.kinv_resident(12 * h, 20 * h, kinv_bf16) == resident
    got = AK._fused_admm_iterations_cuda(*args, iters=iters, kinv_bf16=kinv_bf16)
    want = AK.fused_admm_iterations_reference(*args, iters=iters, kinv_bf16=kinv_bf16)
    for g, w, name in zip(got, want, "xzy"):
        assert torch.isfinite(g).all()
        assert _maxdiff(g, w) < KC.admm_tol(h)[name], name


@pytest.mark.parametrize("kinv_bf16", [False, True])
def test_admm_kernel_two_variables_a_lane(emulated, kinv_bf16):
    """h = 81 (n = 972, two variables a lane, K^{-1} streamed), two
    iterations: held to the float64 plain version on the same operator, no
    farther than KC.ADMM_F64_FACTOR times the float32 plain version (the
    reason is stated there)."""
    h = KC.ADMM_TWO_A_LANE_H
    args = KC.admm_case(1, h, seed=h + 7, device="cpu", warm=True)
    got = AK._fused_admm_iterations_cuda(*args, iters=2, kinv_bf16=kinv_bf16)
    want = AK.fused_admm_iterations_reference(*args, iters=2, kinv_bf16=kinv_bf16)
    exact = AK.fused_admm_iterations_reference(*(a.double() for a in args), iters=2,
                                               kinv_bf16=kinv_bf16)
    for g, w, e, name in zip(got, want, exact, "xzy"):
        assert torch.isfinite(g).all()
        assert _maxdiff(g.double(), e) <= KC.ADMM_F64_FACTOR * _maxdiff(w.double(), e), name


def test_admm_kernel_takes_at_most_max_variables():
    """n = 1932 (h = 161), past AK.MAX_VARIABLES (32 warps of 30 variables,
    two a thread): the wrapper raises before anything is built or launched
    and counts no launch."""
    n = AK.MAX_VARIABLES + 12
    m = 5 * n // 3
    args = [torch.zeros(1, n, n)] + [torch.zeros(1, w) for w in (n, m, m, m)]
    args += [torch.zeros(5, 3), torch.zeros(1, n), torch.zeros(1, m), torch.zeros(1, m)]
    before = AK.LAUNCHES
    with pytest.raises(ValueError, match="n <= 1920"):
        AK._fused_admm_iterations_cuda(*args, iters=1)
    assert AK.LAUNCHES == before


def test_kinv_resident_matches_the_shared_memory_sizes(emulated):
    """admm_resident (the kernel's own rule) at h = 1..40: resident up to
    KC.ADMM_LAST_RESIDENT_H (22 in float32, 30 in bfloat16) and not past
    it, where the shared memory the kernel reports for holding K^{-1} on
    chip first exceeds a block's on sm_90."""
    for bf16 in (False, True):
        last = KC.ADMM_LAST_RESIDENT_H[bf16]
        flags = [AK.kinv_resident(12 * h, 20 * h, bf16) for h in range(1, 41)]
        assert flags == [h <= last for h in range(1, 41)]
        size = [AK.kinv_shared_bytes(12 * h, 20 * h, bf16) for h in (last, last + 1)]
        assert size[0] <= KC.SMEM_PER_BLOCK < size[1]
