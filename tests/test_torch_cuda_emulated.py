"""The port's CUDA kernels, compiled for the CPU, against their plain
versions.

``tests/_cuda_emulation`` compiles each ``csrc/*.cu`` with the host C++
compiler (a launch runs its blocks in turn on std::threads,
``__syncwarp()`` is a barrier) and routes the wrappers' CUDA branches to
it, so each kernel's own arithmetic, indexing and warp synchronisation run
here on CPU tensors.  Speed is measured only on the card (chip_smoke.py,
tests/test_torch_kernels_gpu.py).  Inputs are the seeded recipes of
``quad_periodic_mpc_tpu_torch/testing/kernel_cases``; tolerances are those
of the card tests: the host compiler sums in the kernel's order but
contracts FMAs differently from nvcc, so the gaps are of the card's size.
"""

import _cuda_emulation as cuda_emulation
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

MC = fb.build_a1_constants("float32", "cpu")


@pytest.fixture(scope="module")
def emulated():
    if cuda_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler")
    with cuda_emulation.emulated():
        yield


def _maxdiff(a, b):
    return float((a - b).abs().max())


@pytest.mark.parametrize("B", [1, 5])
def test_model_eval_kernel(emulated, B):
    """A 1e-4, G 1e-3, C 2e-3, Jc and p_foot 2e-5, Jc qdot 5e-4,
    |A^{-1} A - I| 5e-3 (the reference's test_model_kernel_matches_xla)."""
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


def test_contact_kinematics_kernel(emulated):
    st = KC.model_states(3, seed=2, device="cpu")
    info = KK._contact_kinematics_cuda(st, MC)
    ref = fb.contact_jacobians(st, MC)
    assert _maxdiff(info.Jc, ref.Jc) < 2e-5
    assert _maxdiff(info.Jcdqd, ref.Jcdqd) < 5e-4
    assert _maxdiff(info.p_foot, ref.p_foot) < 2e-5


def test_wbc_kernel(emulated):
    """KC.WBC_TOL (q_des 1.5e-3, qd_des 1e-2, tau and fr 5e-5; the reasons
    are stated there), over the five stance patterns twice."""
    args = KC.wbc_kernel_args(*KC.wbc_state_and_input(10, device="cpu"))
    got = WK._fused_wbc_cuda(*args, WBCGains(), KC.WBC_PDIP)
    want = WK.fused_wbc_reference(*args, WBCGains(), KC.WBC_PDIP)
    for g, w, name in zip(got, want, ("q_des", "qd_des", "tau", "fr")):
        assert _maxdiff(g, w) < KC.WBC_TOL[name], name


def test_plant_kernel(emulated):
    """pos 1e-5, quat 1e-6, v_body 5e-4, q 1e-5, qd 2e-3, p_foot and
    anchors 1e-5 (the reference's test_fused_substeps_match_step_fast)."""
    plant, tau, cache, Jc, pf = KC.plant_case(3, device="cpu")
    run = lambda fn: fn(plant, tau, 2e-4, ContactParams(), cache, Jc, pf, 10)
    (pb, pf_b), (pa, pf_a) = run(PK._fused_substeps_cuda), run(PK.fused_substeps_reference)
    for g, w, tol in ((pb.fb.pos, pa.fb.pos, 1e-5), (pb.fb.quat, pa.fb.quat, 1e-6),
                      (pb.fb.v_body, pa.fb.v_body, 5e-4), (pb.fb.q, pa.fb.q, 1e-5),
                      (pb.fb.qd, pa.fb.qd, 2e-3), (pf_b, pf_a, 1e-5),
                      (pb.anchor, pa.anchor, 1e-5)):
        assert _maxdiff(g, w) < tol
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
