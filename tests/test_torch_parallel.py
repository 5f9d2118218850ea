"""The port's sweep layer (``quad_periodic_mpc_tpu_torch/parallel``) against
the JAX package on the CPU: the scenario expansion field by field, the batch
split and gather, ``run_sweep`` against JAX's unsharded ``run_sweep`` in
float64 and float32 (JAX jitted, XLA path), the argmin tie rule, a run
split over eight CPU entries against the unsplit one (the analog of
tests/test_parallel.py's sharded step; the split's batch-global decisions
are tests/test_torch_batch_group.py's), and the weak-scaling harness
(tests/test_container_scaling.py::test_weak_scaling_mechanism)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

import jax.numpy as jnp

from quad_periodic_mpc_tpu.config import ADMMConfig as JADMM
from quad_periodic_mpc_tpu.config import MPCConfig as JMPC
from quad_periodic_mpc_tpu.parallel import sweep as j_sweep
from quad_periodic_mpc_tpu_torch.config import (
    ADMMConfig, EstimatorConfig, LoopConfig, MPCConfig,
)
from quad_periodic_mpc_tpu_torch.control import mpc as M
from quad_periodic_mpc_tpu_torch.ops import gait as G
from quad_periodic_mpc_tpu_torch.parallel import mesh as mesh_lib
from quad_periodic_mpc_tpu_torch.parallel import scaling
from quad_periodic_mpc_tpu_torch.parallel import sweep as t_sweep
from quad_periodic_mpc_tpu_torch.sim import srb_sim as S

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
ATOL, RTOL = 5e-4, 1e-3          # the dry run's split-vs-oracle tolerance

# a small sweep spec: in JAX's run_sweep, instances 1 and 3 (two trot
# phases at 0.33 Hz) lie ~7e-8 apart in float32, a near-tie of the argmin
SMALL = dict(gait_names=("trotting", "bounding"), phase_offsets=2, dist_freq=(0.33, 0.5),
             terrain_risers=(0.05,), terrain_edge_x=(0.30,))
SPECS = {
    "default": {},
    "terrain": dict(gait_names=("trotting",), phase_offsets=2, dist_static=(-10.0, 0.0),
                    dist_amp=(15.0,), terrain_risers=(0.0, 0.06), terrain_edge_x=(0.3, 0.5)),
    "dryrun tier 1": dict(gait_names=("trotting", "bounding"), phase_offsets=32,
                          dist_freq=(0.33, 0.5), terrain_risers=(0.05,),
                          terrain_edge_x=(0.30,)),
    "dryrun tier 1b": dict(gait_names=("trotting",), phase_offsets=8, dist_freq=(0.33,)),
    "dryrun tier 2": dict(gait_names=("trotting",), phase_offsets=16, dist_freq=(0.33,)),
    "config 3": dict(phase_offsets=256),
    "config 4": dict(phase_offsets=5, dist_static=(-10.0, -5.0, 0.0, 5.0, 10.0),
                     dist_amp=(0.0, 5.0, 10.0, 15.0, 20.0),
                     terrain_risers=(0.0, 0.03, 0.06, 0.09),
                     terrain_edge_x=(0.20, 0.25, 0.30, 0.35, 0.40),
                     map_size=32, map_resolution=0.05),
}


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("name", list(SPECS))
def test_build_scenarios_matches_jax(name):
    spec_t, spec_j = t_sweep.SweepSpec(**SPECS[name]), j_sweep.SweepSpec(**SPECS[name])
    assert spec_t.size == spec_j.size
    g_t, it_t, d_t, ter_t = t_sweep.build_scenarios(spec_t, device=CPU)
    g_j, it_j, d_j, ter_j = j_sweep.build_scenarios(spec_j, jnp.float32)
    for f in G.GaitParams._fields:
        assert getattr(g_t, f).dtype == torch.int32
        _eq(getattr(g_t, f), getattr(g_j, f))
    _eq(it_t, it_j)
    for f in S.DisturbanceParams._fields:
        assert getattr(d_t, f).dtype == torch.float32
        _eq(getattr(d_t, f), getattr(d_j, f))
    assert (ter_t is None) == (ter_j is None)
    if ter_t is not None:
        _eq(ter_t.riser, ter_j.riser)
        _eq(ter_t.edge_x, ter_j.edge_x)
        assert (ter_t.tread, ter_t.n_steps) == (ter_j.tread, ter_j.n_steps)
        assert isinstance(ter_t.tread, float) and isinstance(ter_t.n_steps, int)


def test_preset_gaits_match_jax():
    from quad_periodic_mpc_tpu.ops import gait as j_gait

    assert G.PRESET_GAITS == j_gait.PRESET_GAITS


def test_build_scenarios_terrain_axis():
    spec = t_sweep.SweepSpec(**SPECS["terrain"])
    assert spec.size == 2 * 2 * 2 * 2
    _, _, _, terrain = t_sweep.build_scenarios(spec, device=CPU)
    assert terrain is not None and terrain.riser.shape == (spec.size,)
    # terrain is the innermost axis: risers cycle fastest
    np.testing.assert_allclose(terrain.riser[:4].numpy(), [0.0, 0.0, 0.06, 0.06])
    np.testing.assert_allclose(terrain.edge_x[:4].numpy(), [0.3, 0.5, 0.3, 0.5], rtol=1e-7)
    _, _, _, t2 = t_sweep.build_scenarios(t_sweep.SweepSpec(gait_names=("trotting",)),
                                          device=CPU)
    assert t2 is None


def test_sweep_spec_size():
    assert t_sweep.SweepSpec().size == 16
    assert t_sweep.SweepSpec(**SPECS["config 3"]).size == 1024
    assert t_sweep.SweepSpec(**SPECS["config 4"]).size == 10_000
    assert t_sweep.SweepSpec(**SMALL).size == 8


def test_shard_batch_copies_shared_leaves_whole():
    """A shared (4,) gait on a 4-entry mesh is copied whole, not cut one leg
    per entry; batch leaves are cut; 0-dim tensors and Python numbers stay."""
    mesh = mesh_lib.make_mesh(devices=[CPU] * 4)
    gait = G.preset("trotting", device=CPU)
    x = torch.arange(16.0).reshape(8, 2)
    chunks = mesh_lib.shard_batch((gait, x, torch.tensor(3.0), 0.05, None), mesh, batch=8)
    assert len(chunks) == 4
    for i, (g, xc, s, res, none) in enumerate(chunks):
        for f in G.GaitParams._fields:
            _eq(getattr(g, f), getattr(gait, f))
        _eq(xc, x[2 * i:2 * i + 2])
        assert float(s) == 3.0 and res == 0.05 and none is None
    # round trip: gathering the batch leaves gives back the batch
    _eq(mesh_lib.gather([c[1] for c in chunks], CPU), x)
    rep = mesh_lib.replicated(gait, mesh)
    assert len(rep) == 4 and all(torch.equal(r.offsets, gait.offsets) for r in rep)


def test_shard_gather_round_trip_uneven():
    mesh = mesh_lib.make_mesh(3, devices=[CPU] * 8)
    assert mesh.size == 3
    tree = {"a": torch.arange(10), "b": (torch.arange(20.0).reshape(10, 2), 7)}
    chunks = mesh_lib.shard_batch(tree, mesh, batch=10)
    assert [c["a"].shape[0] for c in chunks] == [4, 3, 3]
    back = mesh_lib.gather(chunks, CPU)
    _eq(back["a"], tree["a"])
    _eq(back["b"][0], tree["b"][0])
    assert back["b"][1] == 7
    with pytest.raises(ValueError):
        mesh_lib.shard_batch(tree, mesh_lib.make_mesh(devices=[CPU] * 16), batch=10)


def test_round_up_batch():
    mesh = mesh_lib.make_mesh(devices=[CPU] * 8)
    assert [mesh_lib.round_up_batch(n, mesh) for n in (1, 8, 9, 16, 17)] == [8, 8, 16, 16, 24]


def test_argmin_tie_rule():
    """The small sweep's float32 figures (JAX): instances 1 and 3 lie 7e-8 apart,
    so either pick agrees with the reference's 1; a pick of a clear loser,
    or a differing pick without a near-tie, does not."""
    ref = np.array([0.23322365, 0.21838014, 0.23322362, 0.21838021,
                    0.23522495, 0.22043318, 0.40377286, 0.38530824])
    assert t_sweep.argmin_agrees(ref, 1, 1, ATOL, RTOL)
    assert t_sweep.argmin_agrees(ref, 1, 3, ATOL, RTOL)
    assert t_sweep.argmin_agrees(ref, 1, 3, 1e-7, 0.0)
    assert not t_sweep.argmin_agrees(ref, 1, 3, 1e-8, 0.0)
    assert not t_sweep.argmin_agrees(ref, 1, 5, ATOL, RTOL)
    clear = ref.copy()
    clear[3] += 1e-2
    assert not t_sweep.argmin_agrees(clear, 1, 3, ATOL, RTOL)


def _jax_sweep(dtype):
    res = j_sweep.run_sweep(j_sweep.SweepSpec(**SMALL), n_mpc_steps=8,
                            mpc_cfg=JMPC(horizon=5), solver=JADMM(iterations=30), dtype=dtype)
    return np.asarray(res.vx_rms), np.asarray(res.height_rms), int(res.best_instance)


def _torch_sweep(dtype, mesh=None):
    return t_sweep.run_sweep(t_sweep.SweepSpec(**SMALL), n_mpc_steps=8, mesh=mesh,
                             mpc_cfg=MPCConfig(horizon=5), solver=ADMMConfig(iterations=30),
                             dtype=dtype, device=CPU)


@pytest.mark.parametrize("dtype, atol, rtol", [("float64", 1e-6, 0.0), ("float32", ATOL, RTOL)])
def test_run_sweep_matches_jax(dtype, atol, rtol):
    """The small sweep (B = 8, h = 5, 8 periods, condensed ADMM-30, terrain)
    against JAX's run_sweep(mesh=None): float64 within 1e-6, float32 within
    the dry run's tolerance; best_instance under the tie rule."""
    vx_j, h_j, best_j = _jax_sweep(getattr(jnp, dtype))
    res = _torch_sweep(getattr(torch, dtype))
    assert res.batch == 8 and res.vx_rms.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(res.vx_rms.numpy(), vx_j, atol=atol, rtol=rtol)
    np.testing.assert_allclose(res.height_rms.numpy(), h_j, atol=atol, rtol=rtol)
    np.testing.assert_allclose(float(res.mean_vx_rms), vx_j.mean(), atol=atol, rtol=rtol)
    assert t_sweep.argmin_agrees(vx_j, best_j, int(res.best_instance), atol, rtol), (
        vx_j, best_j, int(res.best_instance))


# The CPU ops whose float32 bits for an instance depend on how many instances
# share the call, so that a chunk of one or two instances may differ from the
# unsplit batch in the last bits (and a closed loop carries that on):
# qp_admm._mv's K^-1 product, which torch computes at a batch of one as a
# matrix-vector product (gemv) and otherwise as a batched GEMM; the einsum of
# condense.state_response / disturbance_response over a table shared by the
# batch, which torch folds into one GEMM whose column count is the batch's;
# and the estimator's (batch, 442) @ (442, 400) product at one row.  Where a
# split takes them at such sizes it is held within SPLIT_ATOL, else bit for
# bit.  torch.atan2 rounds an element by its place in the tensor too (scalar
# libm past the last whole vector step, SLEEF before it); no pair here
# shows it, tests/test_torch_dryrun.py's tier 1 does.
SPLIT_ATOL = 1e-6


def test_split_sweep_matches_unsplit():
    """The small sweep split over two CPU entries (four instances each)
    equals the unsplit run bit for bit: its chunks take the Newton-Schulz
    bucket's decisions over the whole batch, in lockstep.  Over eight
    entries (one instance each) it is held within SPLIT_ATOL, for the ops
    named above."""
    whole = _torch_sweep(torch.float32)
    two = _torch_sweep(torch.float32, mesh_lib.make_mesh(devices=[CPU] * 2))
    split = _torch_sweep(torch.float32, mesh_lib.make_mesh(devices=[CPU] * 8))
    assert split.batch == 8 and bool(torch.isfinite(split.vx_rms).all())
    for f in ("vx_rms", "height_rms"):
        assert torch.equal(getattr(two, f), getattr(whole, f)), f
        np.testing.assert_allclose(getattr(split, f).numpy(), getattr(whole, f).numpy(),
                                   atol=SPLIT_ATOL, rtol=0)
    assert t_sweep.argmin_agrees(whole.vx_rms, int(whole.best_instance),
                                 int(split.best_instance), SPLIT_ATOL, 0.0)


def _batched_inputs(batch):
    dtype = torch.float32
    plant = S.init_plant((batch,), body_height=0.29, dtype=dtype, device=CPU)
    obs = S.observe(plant)
    ctrl = M.init_state((batch,), obs, dtype=dtype, horizon=5)
    f = lambda v: torch.full((batch,), v, dtype=dtype)
    cmd = M.Command(vx=f(0.3), vy=f(0.0), yaw_rate=f(0.0), body_height=f(0.29))
    return ctrl, obs, cmd, G.preset("trotting", device=CPU), plant.t


def test_split_mpc_step_matches_unsplit():
    """tests/test_parallel.py::test_sharded_mpc_step_matches_unsharded: one
    MPC step of 16 instances split over eight entries in lockstep, the
    shared gait copied whole, then a second from its warm state (the
    Newton-Schulz bucket's top k over the whole batch), against the unsplit
    steps: the forces bit for bit."""
    cfgs = (MPCConfig(horizon=5), LoopConfig(), EstimatorConfig(), ADMMConfig(iterations=50))

    def two_steps(inputs):
        ctrl, obs, cmd, gait, t = inputs
        ctrl, first = M.mpc_step(ctrl, obs, cmd, gait, t, *cfgs)
        return first, M.mpc_step(ctrl, obs, cmd, gait, t + 0.03, *cfgs)[1]

    inputs = _batched_inputs(16)
    ref = two_steps(inputs)
    mesh = mesh_lib.make_mesh(devices=[CPU] * 8)
    chunks = mesh_lib.shard_batch(inputs, mesh, 16)
    forces = mesh_lib.gather(mesh_lib.run_lockstep(two_steps, chunks, mesh), CPU)
    for got, want in zip(forces, ref):
        assert torch.equal(got, want), float((got - want).abs().max())


def test_weak_scaling_mechanism():
    """The harness runs on a 4-entry CPU mesh and reports efficiency."""
    res = scaling.measure_weak_scaling(
        lambda batch: (torch.ones((batch, 64, 64)),),
        lambda x: torch.sum(x @ x, dim=(-1, -2)),
        per_device=32, device_counts=[1, 2, 4], reps=2, devices=[CPU] * 4)
    assert set(res) == {1, 2, 4}
    assert res[1]["efficiency"] == 1.0
    for k in (2, 4):
        assert res[k]["throughput"] > 0


def test_make_mesh_needs_a_device():
    mesh = mesh_lib.make_mesh(2, devices=["cpu", "cpu", "cpu"])
    assert mesh.size == 2 and mesh.devices == (CPU, CPU)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError):
            mesh_lib.make_mesh()


def test_parallel_imports_leave_jax_out():
    """Importing the sweep layer loads neither JAX nor the JAX package (a
    fresh interpreter: this one has imported both)."""
    code = (
        "import sys\n"
        "from quad_periodic_mpc_tpu_torch.parallel import (\n"
        "    batch_group, dist_check, dryrun, mesh, scaling, sweep)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'quad_periodic_mpc_tpu')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_quat_to_rpy_pitch_clamp_matches_jax():
    """The sweep's falling robots pitch through -90 degrees: there the asin
    argument of a float32 unit quaternion can round below -1 (here w = -y =
    0.70710683: -2 w y = -1.0000001), where the reference's one-sided clamp
    gives NaN (dry-run tier 1 at eight entries, instance 79, bounding: NaN in
    the port and not in JAX, whose rounding of the same step stayed at -1).
    The port clamps at -1 and gives -pi/2 there, and JAX's pitch wherever
    JAX's is a number."""
    from quad_periodic_mpc_tpu.ops import rotations as j_rot
    from quad_periodic_mpc_tpu_torch.ops import rotations as t_rot

    w = np.float32(0.70710683)
    edge = np.array([[w, 0.0, -w, 0.0]], np.float32)
    rng = np.random.default_rng(11)
    q = rng.normal(size=(4096, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q = np.concatenate([q, edge])
    got = t_rot.quat_to_rpy(torch.from_numpy(q)).numpy()
    want = np.asarray(j_rot.quat_to_rpy(jnp.asarray(q)))
    finite = np.isfinite(want).all(-1)
    assert not finite[-1] and finite[:-1].all()
    np.testing.assert_allclose(got[finite], want[finite], atol=2e-6)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[-1, 1], -np.pi / 2, rtol=1e-7)
