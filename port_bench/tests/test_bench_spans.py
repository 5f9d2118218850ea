"""The per-layer metrics that read the port's own spans and counters, on
made-up device rows, replay logs, set-up records and counts."""

from __future__ import annotations

import collections
from types import SimpleNamespace

import pytest

from port_bench.lib import harness
from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel as SK
from quad_periodic_mpc_tpu_torch.utils import telemetry as T

TICK = "full_stack.controller_tick"
# one period of the SRB loop, cut to five segments: the MPC step and its
# estimator inside it, a swing update, a plant step, and the write-back
PERIOD = (T.Segment("loop.control_tick/mpc.mpc_step", 0, 1),
          T.Segment("loop.control_tick/mpc.mpc_step/estimator.update", 1, 2),
          T.Segment("loop.control_tick/mpc.swing_update", 3, 1),
          T.Segment("loop.control_tick/srb_sim.step", 4, 1),
          T.Segment("graphs.writeback", 5, 1))
# the MPC tick and the plain tick of the full stack
MPC_TICK = (T.Segment(f"{TICK}/mpc.mpc_step", 0, 2), T.Segment(f"{TICK}/wbc.run", 2, 1),
            T.Segment("plant.substeps", 3, 1))
PLAIN_TICK = (T.Segment(f"{TICK}/wbc.run", 0, 1), T.Segment("plant.substeps", 1, 1))


def _rows(durations, t0=0.0, gap=0.0):
    """Back-to-back rows of the given us, ``gap`` us apart."""
    rows, t = [], t0
    for i, d in enumerate(durations):
        rows.append((f"k{i}", t, t + d))
        t += d + gap
    return rows


def _ctx(rows, units, **kw):
    base = dict(rows=rows, profiled_units=units, instances=100, host=[], window_s=1.0,
                queued_s=None, service_s={}, cfg={"horizon": 10})
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.fixture
def log(monkeypatch):
    replays = collections.deque(maxlen=T.REPLAY_LOG)
    monkeypatch.setattr(T, "REPLAYS", replays)
    monkeypatch.setattr(T, "SETUP", [])
    return replays


def read(name, ctx):
    return harness.load_metric(name).read(ctx)


def test_fleet_span_metrics_are_device_ms_a_period(log):
    """Two periods (an older replay logged before them is not read): the
    MPC step holds its estimator."""
    log.extend([T.Replay("loop.period", PERIOD, 6, 0)] * 3)
    rows = _rows([100, 50, 50, 20, 30, 5]) + _rows([100, 50, 50, 20, 30, 5], t0=1000)
    ctx = _ctx(rows, 2)
    assert read("mpc_step_ms.fleet", ctx) == pytest.approx(0.2)
    assert read("estimator_ms.fleet", ctx) == pytest.approx(0.1)
    assert read("swing_update_ms.fleet", ctx) == pytest.approx(0.02)
    assert read("srb_plant_ms.fleet", ctx) == pytest.approx(0.03)


def test_span_metrics_read_nothing_where_rows_and_log_disagree(log):
    """A row dropped by the profiler, or fewer replays logged than units."""
    log.extend([T.Replay("loop.period", PERIOD, 6, 0)] * 2)
    ctx = _ctx(_rows([10] * 11), 2)
    assert read("mpc_step_ms.fleet", ctx) is None
    assert read("in_graph_idle_ms.tick", ctx) is None
    assert read("mpc_step_ms.fleet", _ctx(_rows([10] * 12), 3)) is None


def test_tick_metrics_take_the_mpc_ticks_and_the_idle_inside_replays(log):
    """Three ticks, one of them an MPC tick: the MPC step's ms over the MPC
    ticks alone; the idle inside each replay (the gaps between its nodes,
    not the time between replays), the mean over the three."""
    log.extend([T.Replay("full_stack.mpc_tick", MPC_TICK, 4, 0),
                T.Replay("full_stack.plain_tick", PLAIN_TICK, 2, 0),
                T.Replay("full_stack.plain_tick", PLAIN_TICK, 2, 0)])
    rows = (_rows([300, 200, 50, 10], gap=10) + _rows([50, 10], t0=2000, gap=40)
            + _rows([50, 10], t0=4000, gap=40))
    ctx = _ctx(rows, 3, instances=1)
    assert read("mpc_step_ms.tick", ctx) == pytest.approx(0.5)
    assert read("in_graph_idle_ms.tick", ctx) == pytest.approx((30 + 40 + 40) / 3 / 1e3)


def test_rescue_share_is_rescued_pairs_over_pairs_solved(monkeypatch):
    """40 launches at B = 100, h = 10 solve 40,000 pairs; 1,000 rescued."""
    import torch

    monkeypatch.setitem(SK.LAUNCHES, "fused_stagewise_solve_srb", 40)
    monkeypatch.setattr(SK, "PLAIN_PAIRS", 0)
    monkeypatch.setattr(SK, "RESCUES", {"cpu": torch.tensor(1000, dtype=torch.int64)})
    assert read("ns_rescue_pct.fleet", _ctx([], 1)) == pytest.approx(2.5)
    monkeypatch.setitem(SK.LAUNCHES, "fused_stagewise_solve_srb", 0)
    assert read("ns_rescue_pct.fleet", _ctx([], 1)) is None


def test_graph_setup_is_the_top_level_warmups_and_captures(log):
    """The graphs' warm-up and capture spans, not the spans inside them."""
    T.SETUP.extend([T.SetupSpan("loop.control_tick", "graphs.warmup", 0.0, 1.0, "g"),
                    T.SetupSpan("graphs.warmup", None, 0.0, 2.5, "g"),
                    T.SetupSpan("graphs.warmup", None, 3.0, 3.5, "g"),
                    T.SetupSpan("graphs.writeback", "graphs.capture", 4.0, 4.1, "g"),
                    T.SetupSpan("graphs.capture", None, 4.0, 4.25, "g")])
    assert read("graph_setup_s", _ctx([], 1)) == pytest.approx(3.25)


def test_a_program_without_spans_gives_nothing(monkeypatch):
    """A checkout from before the spans: every new reader returns None."""
    monkeypatch.delattr(T, "attribute")
    monkeypatch.delattr(SK, "rescues")
    ctx = _ctx(_rows([10] * 6), 1)
    for name in ("mpc_step_ms.fleet", "estimator_ms.fleet", "swing_update_ms.fleet",
                 "srb_plant_ms.fleet", "ns_rescue_pct.fleet", "mpc_step_ms.tick",
                 "in_graph_idle_ms.tick", "graph_setup_s"):
        assert read(name, ctx) is None
