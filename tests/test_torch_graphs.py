"""The CUDA-graph slice on the CPU (``runtime/graphs.py``, ``loop.period_step``
/ ``rollout_graphed``, ``full_stack.period_step`` / ``tick_step`` /
``rollout_articulated_graphed`` / ``capture_ticks``).

A graph replays what one run of a step launched, so the step must launch
the same work on every call and never stop for the host.  On the CPU no
graph is captured (``capture`` returns the eager step), so these tests
hold what a capture relies on:

- the factored period bodies, iterated, are the eager rollouts bit for bit
  (``rollout`` and ``rollout_articulated`` are those loops; the graphed
  entry points run them on the CPU);
- the launch bookkeeping: a capture's counts are taken back out and each
  replay adds them again (through the helpers, with a stand-in graph);
- no host read and no host data in any captured step: once its constants
  are made, one more run of each step with every way of reading a tensor
  into Python, every synchronising aten op, every factory call without a
  device and every ``torch.tensor`` / ``torch.as_tensor`` of Python or
  numpy data made to raise.  The kernels' plain versions are exempt: on a
  card the kernel runs in their place.  The same run shows that the step
  writes nothing into its input state (the warm-up runs it on the graph's
  own buffers);
- ``loop.rollout_graphed`` against JAX's ``loop.rollout`` is a case of
  tests/test_torch_mpc.py's three-period parity test; the B = 1 tick pair
  against JAX is tests/test_torch_graphs_chain.py.
"""

import contextlib

import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from quad_periodic_mpc_tpu_torch.config import (
    ADMMConfig, EstimatorConfig, LoopConfig, MPCConfig, SwingConfig, TunableParams,
)
from quad_periodic_mpc_tpu_torch.control import cmpc_variant as CV
from quad_periodic_mpc_tpu_torch.control import full_stack as FS
from quad_periodic_mpc_tpu_torch.control import loop as L
from quad_periodic_mpc_tpu_torch.control import mpc as M
from quad_periodic_mpc_tpu_torch.models import floating_base as fb
from quad_periodic_mpc_tpu_torch.ops import gait as G
from quad_periodic_mpc_tpu_torch.ops.cuda import kinematics_kernel as KK
from quad_periodic_mpc_tpu_torch.ops.cuda import plant_kernel as PK
from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel as SK
from quad_periodic_mpc_tpu_torch.ops.cuda import wbc_kernel as WK
from quad_periodic_mpc_tpu_torch.runtime import graphs
from quad_periodic_mpc_tpu_torch.sim import articulated_sim as art
from quad_periodic_mpc_tpu_torch.sim import srb_sim as S
from quad_periodic_mpc_tpu_torch.terrain import scenario
from quad_periodic_mpc_tpu_torch.utils.telemetry import leaves, unflatten

B, H, ITERS, VX = 2, 10, 30, 0.3
F32 = dict(dtype=torch.float32, device="cpu")
SOLVER = ADMMConfig(iterations=ITERS, backend="pallas", formulation="stagewise")
# the kernels' plain versions: what runs on the CPU where a card launches
# the kernel
PLAIN = ((SK, "fused_stagewise_solve_srb_reference"), (SK, "fused_stagewise_solve_reference"),
         (KK, "model_eval_reference"), (WK, "fused_wbc_reference"),
         (PK, "fused_substeps_reference"))


def _trot(batch: int = B):
    """bench.py's walking trot (vx = 0.3, reference disturbance, gait phases
    spread over the batch) on the CPU: (carry, cmd, gait, dist)."""
    plant = S.init_plant((batch,), body_height=0.29, device="cpu")
    ctrl = M.init_state((batch,), S.observe(plant), horizon=H, formulation="stagewise")
    ctrl = ctrl._replace(iteration=(torch.arange(batch, dtype=torch.int32) * 7) % 208,
                         x_vel_des=torch.full((batch,), VX, **F32))
    cmd = M.Command(vx=torch.full((batch,), VX, **F32), vy=torch.zeros(batch, **F32),
                    yaw_rate=torch.zeros(batch, **F32), body_height=torch.full((batch,), 0.29, **F32))
    return (L.RolloutCarry(plant, ctrl), cmd, G.preset("trotting", device="cpu"),
            S.DisturbanceParams.reference((batch,), device="cpu"))


def _configs():
    return MPCConfig(horizon=H), LoopConfig(), EstimatorConfig(), SOLVER


EDGE, RISER = 0.22, 0.06


def _terrain(batch: int = B, device="cpu"):
    """The map-aware trot of tests/test_torch_terrain_loop.py's doorstep
    experiment (vx = 0.25 from rest, no disturbance): instance 0 before a
    6 cm riser at 0.22 m, close enough that the search moves its front feet's
    targets in the first periods, the others on flat ground, each with its own
    96 x 96 map at 0.03 m.  (carry, cmd, gait, dist, heightmap, ground_fn)."""
    f32 = dict(dtype=torch.float32, device=device)
    terr = scenario.StairsTerrain(
        edge_x=torch.tensor([EDGE] + [1e6] * (batch - 1), **f32),
        riser=torch.tensor([RISER] + [0.0] * (batch - 1), **f32), tread=10.0, n_steps=1)
    hm = scenario.build_map(terr, size=96, resolution=0.03)
    plant = S.init_plant((batch,), body_height=0.29, device=device)
    ctrl = M.init_state((batch,), S.observe(plant), horizon=H, formulation="stagewise")
    ctrl = ctrl._replace(
        iteration=(torch.arange(batch, dtype=torch.int32, device=device) * 7) % 208)
    cmd = M.Command(vx=torch.full((batch,), 0.25, **f32), vy=torch.zeros(batch, **f32),
                    yaw_rate=torch.zeros(batch, **f32),
                    body_height=torch.full((batch,), 0.29, **f32))
    return (L.RolloutCarry(plant, ctrl), cmd, G.preset("trotting", device=device),
            S.DisturbanceParams.zero((batch,), device=device), hm,
            lambda xy: scenario.ground_z(terr, xy))


def _full_stack(batch: int = 1):
    """bench.py's full-stack configuration (the SRB-matched MPCConfig,
    stagewise ADMM-30, every kernel's backend "pallas": their plain versions
    here), from the ground stance: (carry, cmd, gait, mc, kw)."""
    mc = fb.build_a1_constants("float32", "cpu")
    p = fb.A1ModelParams()
    m_tot = p.body_mass + 4 * (p.abad_mass + p.hip_mass + p.knee_mass + 3 * p.rotor_mass)
    kw = dict(mpc_cfg=MPCConfig(horizon=H, mass=float(m_tot), inertia_body=(0.12, 0.45, 0.42)),
              solver=SOLVER, substeps=10, wbc_backend="pallas", kin_backend="pallas")
    plant = art.init_on_ground((batch,), penetration=3.8e-3, device="cpu")
    obs0, _, _ = FS.observe_plant(plant, mc, kin_backend="pallas")
    ctrl = M.init_state((batch,), obs0, formulation="stagewise")
    cmd = M.Command(vx=torch.full((batch,), 0.15, **F32), vy=torch.zeros(batch, **F32),
                    yaw_rate=torch.zeros(batch, **F32), body_height=plant.fb.pos[..., 2].clone())
    return FS.FullStackCarry(plant, ctrl), cmd, G.preset("trotting", device="cpu"), mc, kw


def _assert_bit_equal(got, want):
    got, want = leaves(got), leaves(want)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and torch.equal(a, b), f"leaf {i} differs"


@pytest.fixture(scope="module")
def full_stack_reference():
    """rollout_articulated for 2 periods at B = 1 (computed once)."""
    carry, cmd, gait, mc, kw = _full_stack()
    return FS.rollout_articulated(2, carry.plant, carry.ctrl, cmd, gait, mc, **kw)


@pytest.mark.parametrize("path", ["loop", "loop graphed"])
def test_loop_period_iterated_equals_rollout(path):
    """3 trot periods of loop.rollout against the period iterated and
    against rollout_graphed, which runs the same step on the CPU: every
    leaf of the carry and the trace equal."""
    carry, cmd, gait, dist = _trot()
    args = (cmd, gait, dist, *_configs())
    want = L.rollout(3, carry.plant, carry.ctrl, *args)
    if path == "loop graphed":
        got = L.rollout_graphed(3, carry.plant, carry.ctrl, *args)
    else:
        step, traces = L.period_step(*args), []
        for _ in range(3):
            carry, trace = step(carry)
            traces.append(trace)
        got = carry, L.RolloutTrace(*(torch.stack(t, dim=1) for t in zip(*traces)))
    _assert_bit_equal(got, want)


@pytest.mark.parametrize("path", ["period", "graphed", "tick pair"])
def test_full_stack_steps_iterated_equal_rollout_articulated(full_stack_reference, path):
    """2 periods of rollout_articulated at B = 1 against the period
    iterated, rollout_articulated_graphed and the tick pair of capture_ticks
    (26 ticks), each on the CPU: every leaf equal."""
    carry, cmd, gait, mc, kw = _full_stack()
    want = full_stack_reference
    if path == "graphed":
        got = FS.rollout_articulated_graphed(2, carry.plant, carry.ctrl, cmd, gait, mc, **kw)
    elif path == "period":
        step, ends = FS.period_step(cmd, gait, mc, **kw), []
        for _ in range(2):
            carry, end = step(carry)
            ends.append(end)
        got = carry, {k: torch.stack([e[k] for e in ends]) for k in FS.TRACE_FIELDS}
    else:
        mpc_tick, plain_tick = FS.capture_ticks(carry.plant, carry.ctrl, cmd, gait, mc, **kw)
        for i in range(26):
            carry, = (mpc_tick if i % 13 == 0 else plain_tick)(carry)
        got, want = carry, want[0]
    _assert_bit_equal(got, want)


def test_capture_on_cpu_tensors_is_the_eager_step():
    carry, cmd, gait, dist = _trot()
    step = L.period_step(cmd, gait, dist, *_configs())
    assert graphs.capture(step, carry) is step


@pytest.mark.parametrize("passed", ["by keyword", "positionally"])
def test_rollout_graphed_runs_the_terrain_period(passed):
    """3 periods of the map-aware trot over a doorstep (a heightmap and the
    plant's ground, given by keyword or in their places among the
    positional arguments) through rollout_graphed against rollout: every
    leaf of the carry and the trace equal."""
    carry, cmd, gait, dist, hm, ground = _terrain()
    args = (cmd, gait, dist, *_configs())
    counts = CV.foothold_counts()
    want = L.rollout(3, carry.plant, carry.ctrl, *args, heightmap=hm, ground_fn=ground)
    moved, searched = (b - a for a, b in zip(counts, CV.foothold_counts()))
    assert searched == 3 * 13 * 4 * B and moved > 0, "the map moved no foothold"
    if passed == "by keyword":
        got = L.rollout_graphed(3, carry.plant, carry.ctrl, *args, heightmap=hm,
                                ground_fn=ground)
    else:
        got = L.rollout_graphed(3, carry.plant, carry.ctrl, *args, L.A1, SwingConfig(), None,
                                hm, ground)
    _assert_bit_equal(got, want)


@contextlib.contextmanager
def _counts_restored():
    saved = graphs.launch_counts()
    try:
        yield
    finally:
        graphs.add_launches(graphs.launch_delta(graphs.launch_counts(), saved))
        assert graphs.launch_counts() == saved


def test_launch_bookkeeping_takes_the_capture_out_and_adds_each_replay():
    """What capturing one full-stack period records (13 model evaluations,
    WBC solves and substep launches, one fused-build solve), taken back
    out, then added by three replays."""
    with _counts_restored():
        before = graphs.launch_counts()
        KK.LAUNCHES["fused_model_eval"] += 13
        WK.LAUNCHES += 13
        PK.LAUNCHES += 13
        SK.LAUNCHES["fused_stagewise_solve_srb"] += 1
        delta = graphs.launch_delta(before, graphs.launch_counts())
        assert delta == {"fused_model_eval": 13, "fused_wbc": 13, "fused_substeps": 13,
                         "fused_stagewise_solve_srb": 1}
        graphs.add_launches(delta, -1)
        assert graphs.launch_counts() == before
        for _ in range(3):
            graphs.add_launches(delta)
        after = graphs.launch_counts()
        assert graphs.launch_delta(before, after) == {k: 3 * n for k, n in delta.items()}
        assert after["fused_contact_kinematics"] == before["fused_contact_kinematics"]


class _StandInGraph:
    """Stands for a captured graph: a replay adds 1 to every state buffer."""

    def __init__(self, static):
        self.static = static

    def replay(self):
        for s in self.static:
            s.add_(1.0)


def test_replay_copies_in_only_other_storage_and_counts_each_replay():
    """A Graphed past its warm-up, its graph stood in for."""
    static = (torch.zeros(3), torch.zeros(2, 2))
    g = graphs.Graphed(None, static, pool=None)
    g._calls, g.graph, g._out = graphs.WARMUP, _StandInGraph(static), static
    g.launches = {"fused_stagewise_solve_srb": 1}
    with _counts_restored():
        n0 = SK.LAUNCHES["fused_stagewise_solve_srb"]
        out = g(torch.full((3,), 5.0), torch.ones(2, 2))     # the caller's storage: copied in
        assert out is static
        assert torch.equal(static[0], torch.full((3,), 6.0))
        assert torch.equal(static[1], torch.full((2, 2), 2.0))
        out = g(*out)                                         # its own buffers: no copy
        assert torch.equal(static[0], torch.full((3,), 7.0))
        assert SK.LAUNCHES["fused_stagewise_solve_srb"] == n0 + 2
        with pytest.raises(ValueError, match="new capture"):
            g(torch.zeros(4), torch.zeros(2, 2))
        with pytest.raises(ValueError):
            g(torch.zeros(3))


# ---------------------------------------------------------------------------
# the host-read guard
# ---------------------------------------------------------------------------

class HostRead(AssertionError):
    pass


_GUARD = {"on": False}
_FACTORIES = {torch.zeros, torch.ones, torch.empty, torch.full, torch.arange, torch.linspace,
              torch.logspace, torch.eye, torch.rand, torch.randn, torch.randint,
              torch.scalar_tensor}
# aten ops that wait for the card: a value read into Python, a result whose
# size depends on the data, an error check of a factorisation
_ATEN_SYNCS = {"aten::_local_scalar_dense", "aten::nonzero", "aten::masked_select",
               "aten::_linalg_check_errors", "aten::_unique2", "aten::unique_dim",
               "aten::unique_consecutive", "aten::equal", "aten::is_nonzero",
               "aten::repeat_interleave"}
_INDEXING = {"aten::index", "aten::index_put", "aten::index_put_", "aten::_index_put_impl_"}
_METHODS = ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "cpu", "numpy",
            "nonzero")


def _fail(what: str):
    raise HostRead(f"host read or host data in a captured step: {what}")


class _Functions(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _GUARD["on"]:
            if func in (torch.tensor, torch.as_tensor) and not isinstance(args[0], torch.Tensor):
                _fail(f"torch.{func.__name__} of {type(args[0]).__name__} data")
            if func in _FACTORIES and kwargs.get("device") is None:
                _fail(f"torch.{func.__name__} without a device")
            if func is torch.from_numpy:
                _fail("torch.from_numpy")
        return func(*args, **kwargs)


class _Aten(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _GUARD["on"]:
            name = func._schema.name
            if name in _ATEN_SYNCS:
                _fail(name)
            if name in _INDEXING and any(i is not None and i.dtype == torch.bool
                                         for i in args[1]):
                _fail(f"{name} with a boolean mask")
        return func(*args, **kwargs)


@contextlib.contextmanager
def _host_read_guard():
    saved = []

    def patch(obj, name, new):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, new)

    def guarded(name, orig):
        def call(*a, **k):
            if _GUARD["on"]:
                _fail(name)
            return orig(*a, **k)
        return call

    def exempt(orig):
        def call(*a, **k):
            on, _GUARD["on"] = _GUARD["on"], False
            try:
                return orig(*a, **k)
            finally:
                _GUARD["on"] = on
        return call

    for m in _METHODS:
        patch(torch.Tensor, m, guarded(f"Tensor.{m}", getattr(torch.Tensor, m)))
    setitem = torch.Tensor.__setitem__

    def scalar_setitem(self, index, value):
        # a Python number into a 0-dim slice is a copy from a host scalar
        # (a larger slice takes fill_)
        if _GUARD["on"] and isinstance(value, (bool, int, float)) and self[index].dim() == 0:
            _fail("a Python number assigned into a 0-dim slice")
        return setitem(self, index, value)

    patch(torch.Tensor, "__setitem__", scalar_setitem)
    patch(torch, "nonzero", guarded("torch.nonzero", torch.nonzero))
    for mod, name in PLAIN:
        patch(mod, name, exempt(getattr(mod, name)))
    try:
        with _Functions(), _Aten():
            _GUARD["on"] = True
            yield
    finally:
        _GUARD["on"] = False
        for obj, name, orig in reversed(saved):
            setattr(obj, name, orig)


def test_host_read_guard_catches_what_it_should():
    x = torch.ones(3)
    for read in (lambda: bool(x.sum() > 0), lambda: x[x > 0], lambda: torch.tensor([1.0]),
                 lambda: x.__setitem__(0, 2.0),
                 lambda: torch.zeros(3), lambda: torch.linalg.solve(torch.eye(2, **F32),
                                                                     torch.ones(2, **F32))):
        with _host_read_guard(), pytest.raises(HostRead):
            read()
    with _host_read_guard():
        torch.where(x > 0, x, torch.zeros_like(x))
        x[1:] = 2.0


def _captured_steps(which: str):
    """The steps the card captures (chip_smoke.py's phase 19), each with
    its state: (step, state)."""
    if which == "trot, no batch axis":
        carry, cmd, gait, dist = _trot()
        carry, cmd, dist = (unflatten(t, [x[0] for x in leaves(t)]) for t in (carry, cmd, dist))
        return L.period_step(cmd, gait, dist, *_configs()), (carry,)
    if which == "terrain":
        carry, cmd, gait, dist, hm, ground = _terrain()
        return L.period_step(cmd, gait, dist, *_configs(), heightmap=hm,
                             ground_fn=ground), (carry,)
    if which in ("trot", "tunable"):
        carry, cmd, gait, dist = _trot()
        mpc_cfg, loop_cfg, est_cfg, solver = _configs()
        tun = (TunableParams.from_config(mpc_cfg, loop_cfg, est_cfg, SwingConfig(), device="cpu")
               if which == "tunable" else None)
        return L.period_step(cmd, gait, dist, mpc_cfg, loop_cfg, est_cfg, solver,
                             tunable=tun), (carry,)
    carry, cmd, gait, mc, kw = _full_stack()
    if which in ("mpc tick", "plain tick"):
        return FS.tick_step(cmd, gait, mc, which == "mpc tick", **kw), (carry,)
    # the controller alone, the plant held (bench.py's controller stream)
    return (lambda ctrl: (FS.controller_tick(carry.plant, ctrl, cmd, gait, mc, True,
                                             **{k: v for k, v in kw.items()
                                                if k != "substeps"})[0],)), (carry.ctrl,)


@pytest.mark.parametrize("which", ["trot", "trot, no batch axis", "tunable", "terrain",
                                   "mpc tick", "plain tick", "controller alone"])
def test_captured_steps_read_nothing_back_and_leave_their_input(which):
    """The trot period (fused build; also with no batch axis, as the CLI's
    rollout runs it), the tunable period (caller-built solve), the terrain
    period (a heightmap and the plant's ground), the full stack's MPC and
    plain ticks (its period is one and twelve of the other) and the
    controller tick with the plant held."""
    step, state = _captured_steps(which)
    step(*state)                               # makes the constants
    before = [t.clone() for t in leaves(state)]
    with _host_read_guard():
        out = step(*state)
    assert len(out) >= len(state)
    for a, b in zip(leaves(state), before):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("batch", [37, 2048])
def test_terrain_period_replays_bit_equal_to_eager_on_the_card(batch):
    """The map-aware trot's period captured (graphs.capture of
    loop.period_step with a heightmap and a ground) and replayed for 6
    periods against 6 eager periods: every leaf equal, one fused-build
    launch in the graph and in each eager period, the SRB plant kernel's
    13 launches in each eager period (its count holds eager launches
    only), and the foothold counters advanced by every replay alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from quad_periodic_mpc_tpu_torch.ops.cuda import srb_plant_kernel as SPK

    device = torch.device("cuda", 0)
    carry, cmd, gait, dist, hm, ground = _terrain(batch, device)
    step = L.period_step(cmd, gait, dist, *_configs(), heightmap=hm, ground_fn=ground)
    n = 6
    fused0, plant0 = SK.LAUNCHES["fused_stagewise_solve_srb"], SPK.LAUNCHES
    eager = carry
    for _ in range(n):
        eager, _ = step(eager)
    torch.cuda.synchronize()
    assert SK.LAUNCHES["fused_stagewise_solve_srb"] == fused0 + n
    assert SPK.LAUNCHES == plant0 + 13 * n
    graphed = graphs.capture(step, carry, name="terrain.period")
    fused0, plant0 = SK.LAUNCHES["fused_stagewise_solve_srb"], SPK.LAUNCHES
    got = carry
    searched = []
    for _ in range(n):
        got, _ = graphed(got)
        torch.cuda.synchronize()
        searched.append(CV.foothold_counts()[1])
    assert graphed.graph is not None and graphed.launches == {"fused_stagewise_solve_srb": 1}
    assert SK.LAUNCHES["fused_stagewise_solve_srb"] == fused0 + n
    assert SPK.LAUNCHES == plant0 + 13 * graphs.WARMUP
    steps = {b - a for a, b in zip(searched, searched[1:])}
    assert steps == {13 * 4 * batch}, steps
    _assert_bit_equal(got, eager)
