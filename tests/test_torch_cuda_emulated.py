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

from quad_periodic_mpc_tpu_torch.config import (
    ADMMConfig, EstimatorConfig, LoopConfig, MPCConfig, SwingConfig,
)
from quad_periodic_mpc_tpu_torch.control import loop as L
from quad_periodic_mpc_tpu_torch.control import mpc as M
from quad_periodic_mpc_tpu_torch.control.wbc import WBCGains
from quad_periodic_mpc_tpu_torch.models import floating_base as fb
from quad_periodic_mpc_tpu_torch.ops import gait as G
from quad_periodic_mpc_tpu_torch.ops.cuda import admm_kernel as AK
from quad_periodic_mpc_tpu_torch.ops.cuda import kf_kernel as FK
from quad_periodic_mpc_tpu_torch.ops.cuda import kinematics_kernel as KK
from quad_periodic_mpc_tpu_torch.ops.cuda import plant_kernel as PK
from quad_periodic_mpc_tpu_torch.ops.cuda import srb_plant_kernel as SPK
from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel as SK
from quad_periodic_mpc_tpu_torch.ops.cuda import swing_update_kernel as SUK
from quad_periodic_mpc_tpu_torch.ops.cuda import wbc_kernel as WK
from quad_periodic_mpc_tpu_torch.sim import srb_sim as S
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
    """KC.model_eval_mismatches (the reference's test_model_kernel_matches_xla).
    A block of three warps per instance: B = 1 is one block, B = 2 the
    smallest batch with a second."""
    st = KC.model_states(B, seed=KC.MODEL_SEED, device="cpu")
    before = KK.LAUNCHES["fused_model_eval"]
    got = KK._model_eval_cuda(st, MC)
    assert KK.LAUNCHES["fused_model_eval"] == before + 1
    assert KC.model_eval_mismatches(got, KK.model_eval_reference(st, MC))[0] == []


def _check_contact_kinematics(B):
    st = KC.model_states(B, seed=KC.CONTACT_SEED, device="cpu")
    info = KK._contact_kinematics_cuda(st, MC)
    assert KC.contact_mismatches(info, fb.contact_jacobians(st, MC))[0] == []


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
    """KC.wbc_mismatches (q_des 1.5e-3, qd_des 1e-2, tau and fr 5e-5; the reasons
    are stated there), over the five stance patterns twice, with no PDIP
    iteration (the two cascades, the QP set-up and the torques alone), one,
    and the full stack's 15.  One launch per call."""
    args = KC.wbc_kernel_args(*KC.wbc_state_and_input(10, device="cpu"))
    pdip = dataclasses.replace(KC.WBC_PDIP, iterations=pdip_iters)
    before = WK.LAUNCHES
    got = WK._fused_wbc_cuda(*args, WBCGains(), pdip)
    assert WK.LAUNCHES == before + 1
    assert KC.wbc_mismatches(got, WK.fused_wbc_reference(*args, WBCGains(), pdip))[0] == []


@pytest.mark.parametrize("B,substeps", [(3, 1), (3, 10), (4, 10), (1, 10)])
def test_plant_kernel(emulated, B, substeps):
    """KC.substeps_mismatches (pos 1e-5, quat 1e-6, v_body 5e-4, q 1e-5, qd 2e-3,
    p_foot and anchors 1e-5; the reasons are stated there), one
    substep and ten; B = 3 and 1 leave the last two-instance block half
    empty, B = 4 fills both.  One launch per call."""
    plant, tau, cache, Jc, pf = KC.plant_case(B, device="cpu")
    run = lambda fn: fn(plant, tau, 2e-4, ContactParams(), cache, Jc, pf, substeps)
    before = PK.LAUNCHES
    got = run(PK._fused_substeps_cuda)
    assert PK.LAUNCHES == before + 1
    want = run(PK.fused_substeps_reference)
    assert KC.substeps_mismatches(got, want)[0] == []
    assert torch.equal(got[0].t, want[0].t)



@pytest.mark.parametrize("wrench", [False, True])
@pytest.mark.parametrize("stance", KC.SRB_STANCES)
@pytest.mark.parametrize("B", [1, 37, 300])
def test_srb_plant_kernel(emulated, B, stance, wrench):
    """One SRB plant step against the dense plain version, rpy up to
    +-0.5 rad, t up to 100 s, with the x-force and the six-component
    disturbance; B = 37 and 300 leave the last 128-instance block ragged.
    One launch per call."""
    args = KC.srb_plant_case(B, seed=B, device="cpu", stance=stance, wrench=wrench)
    before = SPK.LAUNCHES
    got = S.step_kernel(*args, MPCConfig(), 0.002)
    assert SPK.LAUNCHES == before + 1
    assert KC.srb_plant_mismatches(got, S.step_dense(*args, MPCConfig(), 0.002))[0] == []


@pytest.mark.parametrize("wrench", [False, True])
@pytest.mark.parametrize("B", [1, 37, 300])
def test_srb_plant_kernel_float64(emulated, B, wrench):
    """The double kernel (64 instances a block) against the plain version
    in float64, to SRB_PLANT_TOL[float64]; one launch per call."""
    args = KC.srb_plant_case(B, seed=B + 1, device="cpu", wrench=wrench, dtype=torch.float64)
    before = SPK.LAUNCHES
    got = S.step_kernel(*args, MPCConfig(), 0.002)
    assert SPK.LAUNCHES == before + 1
    assert got.x.dtype == torch.float64
    assert KC.srb_plant_mismatches(got, S.step_dense(*args, MPCConfig(), 0.002))[0] == []


def test_srb_plant_kernel_refuses_other_dtypes(emulated):
    """A float16 or mixed-dtype step raises TypeError; nothing launches."""
    plant, forces, des, stance, dist = KC.srb_plant_case(3, device="cpu")
    before = SPK.LAUNCHES
    with pytest.raises(TypeError):
        S.step_kernel(plant._replace(x=plant.x.half()), forces, des, stance, dist,
                                 MPCConfig(), 0.002)
    with pytest.raises(TypeError):
        S.step_kernel(plant, forces.double(), des, stance, dist, MPCConfig(), 0.002)
    assert SPK.LAUNCHES == before


def _riser(xy):
    """A 5 cm step up at x = 0."""
    return torch.where(xy[..., 0] > 0, 0.05, 0.0).to(xy.dtype)


@pytest.mark.parametrize("route", ["cpu", "card float64", "card float32"])
def test_srb_plant_routes_and_ground_clamp(emulated, monkeypatch, route):
    """srb_sim.step on CPU tensors takes step_dense and launches nothing;
    with the card's route (the kernel in step_dense's place) a float32 and
    a float64 step each launch the kernel once.  After each the feet are
    clamped onto the ground function's surface."""
    dtype = torch.float64 if route == "card float64" else torch.float32
    plant, forces, des, stance, dist = KC.srb_plant_case(37, seed=9, device="cpu",
                                                         stance="none", dtype=dtype)
    want = S.step_dense(plant, forces, des, stance, dist, MPCConfig(), 0.002)
    if route != "cpu":
        monkeypatch.setattr(S, "step_dense", S.step_kernel)
    launches = SPK.LAUNCHES
    got = S.step(plant, forces, des, stance, dist, MPCConfig(), 0.002, ground_fn=_riser)
    assert SPK.LAUNCHES - launches == (route != "cpu")
    assert got.x.dtype == dtype
    floor = _riser(des[..., 0:2])
    clamped = want._replace(p_feet=torch.cat(
        [want.p_feet[..., 0:2], torch.maximum(want.p_feet[..., 2], floor)[..., None]], -1))
    assert KC.srb_plant_mismatches(got, clamped)[0] == []
    assert bool((got.p_feet[..., 2] >= floor).all())
    assert bool((got.p_feet[..., 2] > des[..., 2]).any())      # some foot was lifted


def test_srb_plant_kernel_in_the_closed_loop(emulated, monkeypatch):
    """Three trot periods of loop.period_step at B = 4 with the kernel as
    the plant against the plain version: the plant state within the trot
    cell's plant limit (3e-3), no instance fallen (body above 0.15 m), and
    one launch a tick."""
    B = 4
    f32 = dict(dtype=torch.float32, device="cpu")
    plant = S.init_plant((B,), body_height=0.29, device="cpu")
    ctrl = M.init_state((B,), S.observe(plant), horizon=10, formulation="stagewise")
    ctrl = ctrl._replace(iteration=(torch.arange(B, dtype=torch.int32) * 53) % 208,
                         x_vel_des=torch.full((B,), 0.3, **f32))
    cmd = M.Command(vx=torch.full((B,), 0.3, **f32), vy=torch.zeros(B, **f32),
                    yaw_rate=torch.zeros(B, **f32), body_height=torch.full((B,), 0.29, **f32))
    dist = S.DisturbanceParams(torch.full((B,), -10.0, **f32), torch.linspace(10, 20, B),
                               torch.linspace(0.2, 0.5, B), torch.linspace(0, 6, B))
    step = L.period_step(cmd, G.preset("trotting", device="cpu"), dist, MPCConfig(horizon=10),
                         LoopConfig(), EstimatorConfig(),
                         ADMMConfig(iterations=30, backend="pallas", formulation="stagewise"),
                         swing_cfg=SwingConfig())

    def run():
        carry = L.RolloutCarry(plant, ctrl)
        for _ in range(3):
            carry, _ = step(carry)
        return carry.plant

    want = run()
    monkeypatch.setattr(S, "step_dense", S.step_kernel)
    before = SPK.LAUNCHES
    got = run()
    assert SPK.LAUNCHES == before + 3 * LoopConfig().iterations_between_mpc
    gap = max(_maxdiff(got.x[..., :12], want.x[..., :12]), _maxdiff(got.p_feet, want.p_feet))
    assert gap <= 3e-3
    assert bool(torch.isfinite(got.x).all()) and bool((got.x[:, 5] > 0.15).all())


# (B, gait, per-instance tunable, first_swing, dtype, foothold hook)
SWING_CASES = [
    (1, "trot", False, "random", torch.float32, False),
    (37, "trot", False, "random", torch.float32, False),
    (37, "stacked", False, "random", torch.float32, False),
    (37, "standing", False, "random", torch.float32, False),
    (37, "stacked", True, "random", torch.float32, False),
    (37, "trot", False, "all", torch.float32, False),
    (37, "stacked", True, "all", torch.float64, False),
    (37, "stacked", False, "random", torch.float32, True),
    (1, "trot", True, "all", torch.float64, True),
]


def _shifted_targets(pf, state, obs):
    """A foothold hook that reads the state from before the update, as the
    terrain tier's does: each target moved by a tenth of its leg's foot to
    swing-start gap."""
    return pf + 0.1 * (obs.p_feet - state.swing_p0)


@pytest.mark.parametrize("B,gait,tunable,first_swing,dtype,hook", SWING_CASES)
def test_swing_update_kernel(emulated, B, gait, tunable, first_swing, dtype, hook):
    """One swing update in the kernel against swing_update_plain
    (KC.swing_update_mismatches): the Raibert targets within KC.SWING_ULPS
    ulps (of their dtype) of the plain version's; then, with the plain version
    handed the kernel's targets through its foothold hook, every field of
    the new state and of the output bit-equal and of the same dtype, but
    world_position_desired, rpy_int and rpy_comp (a 3x3 product and atan2 /
    asin) within KC.SWING_ULPS.  One launch an update, two around a
    foothold hook (which reads the state from before the update)."""
    args = KC.swing_update_case(B, seed=B + len(gait), device="cpu", gait_kind=gait,
                                per_instance_tunable=tunable, first_swing=first_swing,
                                dtype=dtype)
    adjust = _shifted_targets if hook else None
    before = SUK.LAUNCHES
    M.swing_update_kernel(*args, foothold_adjust=adjust)
    assert SUK.LAUNCHES == before + 1 + hook
    assert KC.swing_update_mismatches(args, adjust)[0] == []


def test_swing_update_kernel_refuses_mixed_dtypes(emulated):
    """A float16 observation or a float64 command beside a float32 state
    raises TypeError; nothing launches."""
    state, obs, cmd, *rest = KC.swing_update_case(3, device="cpu")
    before = SUK.LAUNCHES
    with pytest.raises(TypeError):
        M.swing_update_kernel(state, obs._replace(p=obs.p.half()), cmd, *rest)
    with pytest.raises(TypeError):
        M.swing_update_kernel(state, obs, cmd._replace(yaw_rate=cmd.yaw_rate.double()), *rest)
    assert SUK.LAUNCHES == before


def test_swing_update_kernel_in_the_closed_loop(emulated, monkeypatch):
    """Three trot periods of loop.period_step at B = 4 with the swing
    update in the kernel against the plain version: the plant state within
    the trot cell's plant limit (3e-3), no instance fallen (body above
    0.15 m), and one launch a tick."""
    B = 4
    f32 = dict(dtype=torch.float32, device="cpu")
    plant = S.init_plant((B,), body_height=0.29, device="cpu")
    ctrl = M.init_state((B,), S.observe(plant), horizon=10, formulation="stagewise")
    ctrl = ctrl._replace(iteration=(torch.arange(B, dtype=torch.int32) * 53) % 208,
                         x_vel_des=torch.full((B,), 0.3, **f32))
    cmd = M.Command(vx=torch.full((B,), 0.3, **f32), vy=torch.zeros(B, **f32),
                    yaw_rate=torch.linspace(-0.2, 0.2, B), body_height=torch.full((B,), 0.29, **f32))
    dist = S.DisturbanceParams(torch.full((B,), -10.0, **f32), torch.linspace(10, 20, B),
                               torch.linspace(0.2, 0.5, B), torch.linspace(0, 6, B))
    step = L.period_step(cmd, G.preset("trotting", device="cpu"), dist, MPCConfig(horizon=10),
                         LoopConfig(), EstimatorConfig(),
                         ADMMConfig(iterations=30, backend="pallas", formulation="stagewise"),
                         swing_cfg=SwingConfig())

    def run():
        carry = L.RolloutCarry(plant, ctrl)
        for _ in range(3):
            carry, _ = step(carry)
        return carry

    want = run()
    monkeypatch.setattr(M, "swing_update_plain", M.swing_update_kernel)
    before = SUK.LAUNCHES
    got = run()
    assert SUK.LAUNCHES == before + 3 * LoopConfig().iterations_between_mpc
    assert torch.equal(got.ctrl.iteration, want.ctrl.iteration)
    gap = max(_maxdiff(got.plant.x[..., :12], want.plant.x[..., :12]),
              _maxdiff(got.plant.p_feet, want.plant.p_feet))
    assert gap <= 3e-3
    assert bool(torch.isfinite(got.plant.x).all()) and bool((got.plant.x[:, 5] > 0.15).all())


def test_stagewise_kernel(emulated):
    """KC.stagewise_mismatches (the card test's tolerances: 30 ADMM sweeps
    amplify reordered sums; y is rho-scaled)."""
    args, kw = KC.stagewise_case(3, 10, seed=3, device="cpu")
    kw.update(over_relax=1.6, dt=0.026, mass=12.0, i_inv_diag=(1 / 0.07, 1 / 0.26, 1 / 0.242))
    got = SK._fused_stagewise_solve_srb_cuda(*args, **kw)
    want = SK.fused_stagewise_solve_srb_reference(*args, **kw)
    assert KC.stagewise_mismatches(got, want)[0] == []


def test_stagewise_kernel_counts_the_plain_versions_rescues(emulated, monkeypatch):
    """The fused-build kernel's rescue counter on inputs whose odd
    instances restart every warm stage cold (KC.srb_rescue_case): it adds
    what the plain version's stats["rescued"] says, and the outputs are
    bit for bit those of a launch that counts nothing (a null counter)."""
    args, kw = KC.srb_rescue_case(4, 10, seed=3, device="cpu")
    kw.update(over_relax=1.6, dt=0.026, mass=12.0, i_inv_diag=(1 / 0.07, 1 / 0.26, 1 / 0.242))
    monkeypatch.setattr(SK, "RESCUES", {})
    got = SK._fused_stagewise_solve_srb_cuda(*args, **kw)
    stats = {}
    SK.fused_stagewise_solve_srb_reference(*args, **kw, stats=stats)
    assert stats["rescued"] == 2 * 9
    assert SK.rescues() == stats["rescued"]
    monkeypatch.setattr(SK, "_rescue_counter", lambda device: None)
    uncounted = SK._fused_stagewise_solve_srb_cuda(*args, **kw)
    assert SK.rescues() == stats["rescued"]
    for g, w in zip(got, uncounted):
        assert torch.equal(g, w)


@pytest.mark.parametrize("variant", ["shared_c", "per_step_c", "dense_ad"])
def test_stagewise_solve_kernel(emulated, variant):
    """The caller-built solve, structured Ad with a shared and a per-stage
    c, and dense Ad: KC.stagewise_mismatches, as the fused-build kernel."""
    args, kw = KC.solve_case(3, 10, seed=5, device="cpu", per_step_c=variant == "per_step_c",
                             dense_ad=variant == "dense_ad")
    kw.update(over_relax=1.6, srb_ad=variant != "dense_ad")
    before = SK.LAUNCHES["fused_stagewise_solve"]
    got = SK._fused_stagewise_solve_cuda(*args, **kw)
    assert SK.LAUNCHES["fused_stagewise_solve"] == before + 1
    want = SK.fused_stagewise_solve_reference(*args, **kw)
    assert KC.stagewise_mismatches(got, want)[0] == []


def test_stagewise_solve_kernel_rescue(emulated):
    """Dense Ad whose warm Newton-Schulz seeds fail the gate
    (KC.rescue_case): the cold restart runs on every lane of the instance's
    warp, and the kernel still meets KC.stagewise_mismatches."""
    args, kw = KC.rescue_case(5, 8, seed=7, device="cpu")
    kw.update(over_relax=1.6, srb_ad=False)
    got = SK._fused_stagewise_solve_cuda(*args, **kw)
    stats = {}
    want = SK.fused_stagewise_solve_reference(*args, **kw, stats=stats)
    assert stats["rescued"] > 0
    assert KC.stagewise_mismatches(got, want)[0] == []


@pytest.mark.parametrize("per_step_c", [False, True])
def test_stagewise_stream_kernel(emulated, per_step_c):
    """The streamed solve at h = 16 from a warm start (its in-place
    update): KC.stagewise_mismatches; the warm start itself is left as it
    was."""
    args, kw = KC.solve_case(2, 16, seed=6, device="cpu", iters=20, per_step_c=per_step_c)
    kw.update(over_relax=1.6)
    warm = [w.contiguous() for w in SK.fused_stagewise_solve_stream_reference(
        *args[:10], *args[10:], **dict(kw, iters=3))]
    kept = [w.clone() for w in warm]
    before = SK.LAUNCHES["fused_stagewise_solve_stream"]
    got = SK._fused_stagewise_solve_stream_cuda(*args[:10], *warm, **kw)
    assert SK.LAUNCHES["fused_stagewise_solve_stream"] == before + 1
    want = SK.fused_stagewise_solve_stream_reference(*args[:10], *warm, **kw)
    assert KC.stagewise_mismatches(got, want)[0] == []
    assert all(torch.equal(a, b) for a, b in zip(warm, kept))


def test_srb_build_dump_kernel(emulated):
    """The dump kernel writes what srb_assemble builds, and that is the
    independent build's Ad, Bd, c: KC.dump_mismatches (KC.DUMP_TOL for
    both)."""
    args, sw = KC.srb_dump_case(5, seed=8, device="cpu")
    kw = dict(dt=0.026, mass=12.0, i_inv_diag=(1 / 0.07, 1 / 0.26, 1 / 0.242))
    before = SK.LAUNCHES["srb_build_dump"]
    got = SK._srb_build_dump_cuda(*args, **kw)
    assert SK.LAUNCHES["srb_build_dump"] == before + 1
    assert KC.dump_mismatches(got, SK.srb_assemble(*args, **kw), sw)[0] == []


@pytest.mark.parametrize("B", [1, 33])
def test_srb_build_dump_kernel_batches(emulated, B):
    """Four instances a block, one warp each: B = 1 leaves three warps of
    the only block idle, B = 33 one instance in the last block; KC.DUMP_TOL
    against srb_assemble and the independent build, as above."""
    args, sw = KC.srb_dump_case(B, seed=8 + B, device="cpu")
    kw = dict(dt=0.026, mass=12.0, i_inv_diag=(1 / 0.07, 1 / 0.26, 1 / 0.242))
    got = SK._srb_build_dump_cuda(*args, **kw)
    assert KC.dump_mismatches(got, SK.srb_assemble(*args, **kw), sw)[0] == []


@pytest.mark.parametrize("B", [1, 2, 5, 64])
def test_kf_kernel(emulated, B):
    """Conditioned seeded states, KC.kf_mismatches: KC.KF_TOL (x 5e-3, P
    2e-4; the reasons are stated there), and the kernel's and the plain
    version's x' within KC.KF_COND_FACTOR * eps * cond(S) of float64
    instance by instance.  One launch per call; a block of two warps per
    instance (B = 2: the smallest batch with a second block)."""
    args = KC.kf_case(B, seed=B, device="cpu")
    before = FK.LAUNCHES
    got = FK._fused_kf_innovate_cuda(*args, dt=KC.KF_DT)
    assert FK.LAUNCHES == before + 1
    want = FK.fused_kf_innovate_reference(*args, dt=KC.KF_DT)
    assert KC.kf_mismatches(args, got, want)[0] == []


def _check_kf_cold_start(B, ticks):
    args = KC.kf_transient_case(B, ticks=ticks, seed=ticks, device="cpu")
    got = FK._fused_kf_innovate_cuda(*args, dt=KC.KF_DT)
    want = FK.fused_kf_innovate_reference(*args, dt=KC.KF_DT)
    assert KC.kf_mismatches(args, got, want, transient=True)[0] == []


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
    KC.admm_mismatches at KC.admm_tol(h) (x and z 2e-4 h, y 1e-5).  The kernel's hand-written
    bfloat16 rounding is the plain version's ``.to(bfloat16)``.  One launch
    per call."""
    args = KC.admm_case(B, h, seed=h + B, device="cpu", warm=warm)
    before = AK.LAUNCHES
    got = AK._fused_admm_iterations_cuda(*args, iters=iters, kinv_bf16=kinv_bf16)
    assert AK.LAUNCHES == before + 1
    want = AK.fused_admm_iterations_reference(*args, iters=iters, kinv_bf16=kinv_bf16)
    assert KC.admm_mismatches(args, got, want, f64=False)[0] == []
    assert AK.kinv_resident(12 * h, 20 * h, kinv_bf16) == (
        h <= KC.ADMM_LAST_RESIDENT_H[kinv_bf16])


@pytest.mark.parametrize("B,h,iters,kinv_bf16,resident", KC.ADMM_LIMIT_CASES)
def test_admm_kernel_register_and_resident_limits(emulated, B, h, iters, kinv_bf16,
                                                  resident):
    """n = 12 h below, at and past the columns of K^{-1} held in registers,
    on both sides of the change from J to J / 2 register columns and of
    the resident limits, from non-zero starts: KC.admm_tol(h) (not the
    float64 rule)."""
    args = KC.admm_case(B, h, seed=h + 7 * B, device="cpu", warm=True)
    assert AK.kinv_resident(12 * h, 20 * h, kinv_bf16) == resident
    got = AK._fused_admm_iterations_cuda(*args, iters=iters, kinv_bf16=kinv_bf16)
    want = AK.fused_admm_iterations_reference(*args, iters=iters, kinv_bf16=kinv_bf16)
    assert KC.admm_mismatches(args, got, want, f64=False)[0] == []


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
    assert KC.admm_mismatches(args, got, want, f64=True, iters=2, kinv_bf16=kinv_bf16)[0] == []


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
