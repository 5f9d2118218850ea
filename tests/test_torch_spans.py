"""The port's spans (``utils/telemetry.span``) on the CPU: what a span does
with nothing in force, in set-up, under a capture and under a profiler; the
segment maps that a capture of the SRB period and of the full-stack ticks
builds (``runtime/graphs.Graphed``, its CUDA graph and libcuda's node
count stood in for); the replay log; and ``telemetry.attribute`` on
made-up device rows.

The stand-ins: ``torch.cuda``'s streams, graph and sync-debug calls do
nothing, a replay runs nothing, and a graph's node count is the number of
aten operations dispatched since its capture began (on the card it is
``cuGraphGetNodes`` on the graph under capture)."""

import contextlib
import types

import pytest
import torch

torch.set_num_threads(1)

from torch.utils._python_dispatch import TorchDispatchMode

from quad_periodic_mpc_tpu_torch.config import (
    ADMMConfig, EstimatorConfig, LoopConfig, MPCConfig,
)
from quad_periodic_mpc_tpu_torch.control import full_stack as FS
from quad_periodic_mpc_tpu_torch.control import loop as L
from quad_periodic_mpc_tpu_torch.control import mpc as M
from quad_periodic_mpc_tpu_torch.models import floating_base as fb
from quad_periodic_mpc_tpu_torch.ops import gait as G
from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel as SK
from quad_periodic_mpc_tpu_torch.runtime import graphs
from quad_periodic_mpc_tpu_torch.sim import articulated_sim as art
from quad_periodic_mpc_tpu_torch.sim import srb_sim as S
from quad_periodic_mpc_tpu_torch.testing import kernel_cases as KC
from quad_periodic_mpc_tpu_torch.utils import telemetry as T

F32 = dict(dtype=torch.float32, device="cpu")
SOLVER = ADMMConfig(iterations=30, backend="pallas", formulation="stagewise")
MPC_CHILDREN = ["mpc.mpc_step", "mpc.mpc_step/mpc.reference_trajectory", "mpc.mpc_step",
                "mpc.mpc_step/estimator.update", "mpc.mpc_step/mpc.qp_solve", "mpc.mpc_step"]


class _Ops(TorchDispatchMode):
    """Counts the aten operations dispatched: the stand-in node count."""

    n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        _Ops.n += 1
        return func(*args, **(kwargs or {}))


class _Graph:
    def replay(self):
        pass


@contextlib.contextmanager
def _stand_in_graph(graph, pool=None):
    _Ops.n = 0                       # a new graph has no node
    yield


@pytest.fixture
def stand_ins(monkeypatch):
    """CUDA graphs on CPU tensors: Graphed warms up, captures and replays
    with nothing of torch.cuda; the node count counts the aten operations
    that a test runs under ``_Ops()`` (the test body runs on a thread of
    its own, tests/conftest.py, where the fixture's dispatch mode is not)."""
    stream = types.SimpleNamespace(cuda_stream=0, wait_stream=lambda other: None)
    for name, value in (("current_stream", lambda device=None: stream),
                        ("Stream", lambda device=None: stream),
                        ("stream", lambda s: contextlib.nullcontext()),
                        ("get_sync_debug_mode", lambda: 0),
                        ("set_sync_debug_mode", lambda mode: None),
                        ("CUDAGraph", _Graph), ("graph", _stand_in_graph)):
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(T, "graph_nodes", lambda stream: _Ops.n)
    monkeypatch.setattr(T, "SETUP", [])
    monkeypatch.setattr(T, "REPLAYS", type(T.REPLAYS)(maxlen=T.REPLAY_LOG))


def _graphed(step, state, name):
    static = T.unflatten(state, [torch.empty_like(t) for t in T.leaves(state)])
    return graphs.Graphed(step, tuple(static), None, name)


def _trot(batch=2):
    """The walking trot (tests/test_torch_graphs.py's) at h = 10: (step, carry)."""
    plant = S.init_plant((batch,), body_height=0.29, device="cpu")
    ctrl = M.init_state((batch,), S.observe(plant), horizon=10, formulation="stagewise")
    ctrl = ctrl._replace(iteration=(torch.arange(batch, dtype=torch.int32) * 7) % 208,
                         x_vel_des=torch.full((batch,), 0.3, **F32))
    cmd = M.Command(vx=torch.full((batch,), 0.3, **F32), vy=torch.zeros(batch, **F32),
                    yaw_rate=torch.zeros(batch, **F32),
                    body_height=torch.full((batch,), 0.29, **F32))
    step = L.period_step(cmd, G.preset("trotting", device="cpu"),
                         S.DisturbanceParams.reference((batch,), device="cpu"),
                         MPCConfig(horizon=10), LoopConfig(), EstimatorConfig(), SOLVER)
    return step, L.RolloutCarry(plant, ctrl)


def _tick(do_mpc: bool):
    """The single robot's full-stack tick (every kernel's plain version):
    (step, carry)."""
    mc = fb.build_a1_constants("float32", "cpu")
    p = fb.A1ModelParams()
    m_tot = p.body_mass + 4 * (p.abad_mass + p.hip_mass + p.knee_mass + 3 * p.rotor_mass)
    plant = art.init_on_ground((1,), penetration=3.8e-3, device="cpu")
    obs0, _, _ = FS.observe_plant(plant, mc, kin_backend="pallas")
    ctrl = M.init_state((1,), obs0, formulation="stagewise")
    cmd = M.Command(vx=torch.full((1,), 0.15, **F32), vy=torch.zeros(1, **F32),
                    yaw_rate=torch.zeros(1, **F32), body_height=plant.fb.pos[..., 2].clone())
    step = FS.tick_step(cmd, G.preset("trotting", device="cpu"), mc, do_mpc,
                        mpc_cfg=MPCConfig(horizon=10, mass=float(m_tot),
                                          inertia_body=(0.12, 0.45, 0.42)),
                        solver=SOLVER, substeps=10, wbc_backend="pallas", kin_backend="pallas")
    return step, FS.FullStackCarry(plant, ctrl)


def _paths(segments):
    """The segments' paths, runs of one path taken once."""
    out = []
    for s in segments:
        if not out or out[-1] != s.path:
            out.append(s.path)
    return out


def _srb_tick(do_mpc: bool) -> list:
    mpc = [f"loop.control_tick/{c}" for c in MPC_CHILDREN] if do_mpc else []
    return ["loop.control_tick/srb_sim.observe", "loop.control_tick", *mpc,
            "loop.control_tick/mpc.swing_update", "loop.control_tick",
            "loop.control_tick/srb_sim.step"]


def _full_stack_tick(do_mpc: bool) -> list:
    c = "full_stack.controller_tick"
    mpc = [f"{c}/{m}" for m in MPC_CHILDREN] if do_mpc else []
    return [f"{c}/kinematics.model_eval", c, *mpc, f"{c}/mpc.swing_update", c,
            f"{c}/wbc.run", f"{c}/full_stack.joint_pd", "plant.substeps"]


EXPECTED = {
    "srb period": _srb_tick(True) + 12 * _srb_tick(False) + ["graphs.writeback"],
    "mpc tick": _full_stack_tick(True) + ["graphs.writeback"],
    "plain tick": _full_stack_tick(False) + ["graphs.writeback"],
}


def test_a_span_with_nothing_in_force_records_nothing(stand_ins, monkeypatch):
    """A captured step run eagerly with no profiler, no set-up and no
    capture: no set-up record, no replay logged, no record function
    entered, and every span the one object that does nothing; under a
    profiler the same spans enter a record function by name."""
    entered = []

    def spy(name, *args):
        entered.append(name)
        return torch._C._profiler._RecordFunctionFast(name, *args)

    monkeypatch.setattr(T, "_record", spy)
    step, carry = _trot()
    step(carry)
    assert T.span("mpc.mpc_step") is T.span("srb_sim.step")
    assert entered == [] and T.SETUP == [] and len(T.REPLAYS) == 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        step(carry)
    assert entered.count("loop.control_tick") == 13 and entered.count("mpc.mpc_step") == 1
    assert T.SETUP == [] and len(T.REPLAYS) == 0


def test_nested_spans_give_paths_and_parents(stand_ins):
    """Set-up records name each span's parent and end after it; a capture's
    segments take the innermost span's path below the spans around the
    capture, and nodes under no span the path ""."""
    def step(x):
        y = x + 1.0
        with T.span("a"):
            y = y * 2.0
            with T.span("b"):
                y = y.sin()
            with T.span("c"):
                with T.span("d"):
                    y = y - 1.0
        return (y,)

    x = torch.zeros(3)
    with _Ops(), T.setup("toy", torch.device("cpu")), T.span("outer"):
        step(x)
        with T.capturing(0) as rec:
            _Ops.n = 0
            step(x)
    got = [(s.name, s.parent) for s in T.SETUP]
    assert got == [("b", "a"), ("d", "c"), ("c", "a"), ("a", "outer"),
                   ("b", "a"), ("d", "c"), ("c", "a"), ("a", "outer"), ("outer", None)]
    assert all(s.graph == "toy" and s.start <= s.end for s in T.SETUP)
    assert T.SETUP[-1].start <= T.SETUP[0].start and T.SETUP[-1].end >= T.SETUP[-2].end
    assert [s.path for s in rec.segments] == ["", "a", "a/b", "a/c/d"]
    assert [s.nodes for s in rec.segments] == [1, 1, 1, 1] and rec.nodes == 4


@pytest.mark.parametrize("which", ["srb period", "mpc tick", "plain tick"])
def test_a_capture_builds_the_segment_map_of_the_layers(stand_ins, which):
    """loop.period_step (an MPC tick and 12 plain ticks) and the full
    stack's MPC and plain ticks: the segments follow the span paths in
    capture order, and they cover every node once, in order."""
    step, carry = _trot() if which == "srb period" else _tick(which == "mpc tick")
    g = _graphed(step, (carry,), which)
    g._calls = graphs.WARMUP
    with _Ops():
        g(carry)
    assert _paths(g.segments) == EXPECTED[which]
    first = 0
    for s in g.segments:
        assert s.first == first and s.nodes > 0
        first += s.nodes
    assert first == g.nodes == sum(s.nodes for s in g.segments) > 0


def test_set_up_spans_are_recorded_once_per_graph(stand_ins):
    """Two warm-up calls and the capture are a graph's set-up: one
    graphs.warmup record each and one graphs.capture record, named by the
    graph, with the step's spans inside them; the replays add none."""
    def step(x):
        with T.span("a"):
            return (x * 2.0,)

    x = torch.ones(3)
    one, two = _graphed(step, (x,), "one"), _graphed(step, (x,), "two")
    with _Ops():
        for _ in range(6):
            one(x)
            two(x)
    top = [(s.graph, s.name) for s in T.SETUP if s.parent is None]
    assert top == [("one", "graphs.warmup"), ("two", "graphs.warmup"),
                   ("one", "graphs.warmup"), ("two", "graphs.warmup"),
                   ("one", "graphs.capture"), ("two", "graphs.capture")]
    inner = [(s.graph, s.name, s.parent) for s in T.SETUP if s.parent is not None]
    warm = [(g, "a", "graphs.warmup") for g in ("one", "two", "one", "two")]
    assert inner == warm + [(g, name, "graphs.capture") for g in ("one", "two")
                            for name in ("a", "graphs.writeback")]
    # the step's product, then the state's write-back (one copy)
    assert one.segments == (T.Segment("a", 0, one.nodes - 1),
                            T.Segment("graphs.writeback", one.nodes - 1, 1))


def test_a_replay_is_logged_only_while_a_profiler_records(stand_ins):
    """Each replay under a profiler logs its graph's segment map and the
    copies into its buffers before it; a replay without one logs nothing."""
    def step(x):
        with T.span("a"):
            return (x + 1.0,)

    x = torch.ones(3)
    g = _graphed(step, (x,), "toy")
    with _Ops():
        for _ in range(graphs.WARMUP + 2):
            out, = g(x)
    assert len(T.REPLAYS) == 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        g(x)                     # the caller's storage: one copy in
        g(out)                   # the graph's own buffer: none
    assert list(T.REPLAYS) == [T.Replay("toy", g.segments, g.nodes, 1),
                               T.Replay("toy", g.segments, g.nodes, 0)]


def test_the_plain_version_feeds_the_rescue_counter(monkeypatch):
    """On the CPU the fused-build solve's plain version adds its
    stats["rescued"] to the device's counter and its pairs to PLAIN_PAIRS."""
    monkeypatch.setattr(SK, "RESCUES", {})
    monkeypatch.setattr(SK, "PLAIN_PAIRS", 0)
    args, kw = KC.srb_rescue_case(4, 10, seed=3, device="cpu", iters=2)
    U, _, _ = SK.fused_stagewise_solve_srb(*args, **kw)
    want = SK.fused_stagewise_solve_srb_reference(*args, **kw)[0]
    assert torch.equal(U, want)
    assert SK.rescues() == 18 and SK.PLAIN_PAIRS == 40
    SK.fused_stagewise_solve_srb(*args, **kw)
    assert SK.rescues() == 36 and SK.PLAIN_PAIRS == 80


# ---------------------------------------------------------------------------
# attribute
# ---------------------------------------------------------------------------

SEGS = (T.Segment("x", 0, 2), T.Segment("x/y", 2, 1), T.Segment("", 3, 1))


def _rows(t0):
    # four nodes: two under x (overlapping), one under x/y after a gap, one unspanned
    return [("k0", t0, t0 + 10.0), ("k1", t0 + 5.0, t0 + 12.0), ("k2", t0 + 20.0, t0 + 30.0),
            ("k3", t0 + 30.0, t0 + 31.0)]


def test_attribute_puts_device_time_down_to_span_paths():
    """Two replays, the second after a copy into the graph's buffers: each
    node's us to its segment's path, the copy to none."""
    rows = _rows(0.0) + [("Memcpy DtoD", 100.0, 101.0)] + _rows(200.0)
    log = [T.Replay("g", SEGS, 4, 0), T.Replay("g", SEGS, 4, 1)]
    got = T.attribute(rows, log)
    assert [a.graph for a in got] == ["g", "g"]
    for a in got:
        assert a.us == {"x": 17.0, "x/y": 10.0, "": 1.0}


def test_attribute_finds_the_idle_inside_each_replay():
    """From the first node's start to the last node's end (31 us), less the
    union of the nodes' intervals (12 + 10 + 1): 8 us."""
    got = T.attribute(_rows(0.0) + _rows(50.0), [T.Replay("g", SEGS, 4, 0)] * 2)
    assert [a.idle_us for a in got] == [8.0, 8.0]


@pytest.mark.parametrize("rows", [_rows(0.0)[:3], _rows(0.0) + [("extra", 40.0, 41.0)], []])
def test_attribute_gives_none_where_the_rows_do_not_match(rows):
    """A dropped row, one row too many, no rows: None, nothing guessed."""
    assert T.attribute(rows, [T.Replay("g", SEGS, 4, 0)]) is None
