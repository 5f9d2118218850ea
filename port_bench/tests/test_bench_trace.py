"""The per-layer metrics' arithmetic on made-up profiler rows."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from port_bench import counts
from port_bench.lib import harness, readers, trace, tree

# two units: a hand-written kernel, PyTorch kernels that overlap, a copy
ROWS = [
    ("void at::native::vectorized_elementwise_kernel<4>(...)", 0.0, 10.0),
    ("stagewise_srb_kernel(float const*, float*)", 12.0, 112.0),
    ("void at::native::reduce_kernel<512, 1>(...)", 100.0, 120.0),
    ("Memcpy DtoD (Device -> Device)", 130.0, 131.0),
    ("void wbc_kernel<false>(float const*)", 140.0, 150.0),
    ("void at::native::vectorized_elementwise_kernel<4>(...)", 1000.0, 1010.0),
    ("stagewise_srb_kernel(float const*, float*)", 1012.0, 1112.0),
    ("void wbc_kernel<false>(float const*)", 1140.0, 1150.0),
]
HOST = [("cudaGraphLaunch", 0.0, 5.0), ("cudaStreamSynchronize", 5.0, 1200.0),
        ("aten::copy_", 125.0, 129.0)]


def ctx(**kw):
    base = dict(rows=ROWS, host=HOST, profiled_units=2, window_s=20.0, queued_s=15.0,
                instances=256,
                cfg={"horizon": 10, "solver": {"iterations": 30},
                     "wbc_pdip": {"iterations": 15}},
                service_s={"mpc": [2e-3, 3e-3, 1e-3], "plain": [1e-3, 5e-4]})
    base.update(kw)
    return SimpleNamespace(**base)


def test_busy_is_the_union_of_intervals():
    # 10 + (12..120 = 108) + 1 + 10 + 10 + 100 + 10
    assert trace.busy_us(ROWS) == pytest.approx(249.0)
    assert trace.busy_us([]) == 0.0


def test_idle_share_is_the_timed_windows_time_without_queued_work():
    # work queued on the card 15 s of the 20-s window
    assert readers.idle_pct(ctx()) == pytest.approx(25.0)
    assert readers.idle_pct(ctx(queued_s=None)) is None


def test_launches_and_glue_ms_per_unit():
    assert readers.launches_per_unit(ctx()) == 4.0
    # not hand-written: 10 + 20 + 1 + 10 us over 2 units
    assert readers.other_ms_per_unit(ctx()) == pytest.approx(41e-3 / 2)


def test_hand_written_kernels_by_whole_symbol():
    assert trace.hand_written_counts(ROWS) == {"fused_stagewise_solve_srb": 2, "fused_wbc": 2}
    assert trace.kernel_of("my_wbc_kernel_v2") is None
    assert trace.kernel_of("void kf_kernel<28>(float*)") == "fused_kf_innovate"


def test_roofline_share_is_bound_over_device_ms_a_launch():
    flops = counts.solve_flops(256, 10, 30, 16, 6, 0)
    bound_ms, _ = counts.bound(flops, counts.solve_bytes(256, 10))
    assert readers.stagewise_srb_roofline(ctx()) == pytest.approx(100 * bound_ms / 0.1)
    assert readers.stagewise_srb_roofline(ctx(rows=ROWS[:1])) is None


def test_idle_gaps_are_named_by_the_host_event_running():
    gaps = dict(trace.idle_gaps(ROWS, HOST))
    # 10..12, 120..130 (aten::copy_ starts at 125: the sync runs at 120),
    # 131..140, 150..1000, 1010..1012, 1112..1140
    assert gaps == pytest.approx({"cudaStreamSynchronize": (2 + 10 + 9 + 850 + 2 + 28) / 1e6})
    assert trace.top_ops(ROWS, 1) == [["stagewise_srb_kernel(float const*, float*)", 200e-6]]


def test_tick_service_percentiles():
    assert readers.tick_service_ms(ctx(), "mpc", "p99") == pytest.approx(2.98)
    assert readers.tick_service_ms(ctx(), "plain", "mean") == pytest.approx(0.75)
    assert readers.tick_service_ms(ctx(service_s={}), "mpc", "p99") is None
    assert harness.percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.5


def test_max_gap_reads_the_worst_instance():
    a = torch.zeros(10, 3)
    b = a.clone()
    b[:, 0] = torch.arange(10, dtype=torch.float32) * 1e-6
    b[3, 2] = 0.5                                  # one instance far off
    assert tree.max_gap(a, b) == 0.5
    assert tree.max_gap((a, a), (b, a)) == 0.5
    b[0, 0] = float("nan")
    assert tree.max_gap(a, b) == float("inf")


class _Stack:
    """A stack whose ``failed`` reads a column of the carry."""

    @staticmethod
    def failed(carry):
        return carry[:, 0] > 0


def test_failures_count_failed_instances_by_the_units_since_the_last_check():
    f = harness.Failures(_Stack, tick=3)
    ok = torch.zeros(4, 1)
    f.check(ok, 11)                                 # 8 units, none failed
    two = ok.clone()
    two[1:3] = 1.0
    f.check(two, 19)                                # 8 units, 2 failed: 16
    f.check(ok, 21)                                 # restarted: 2 units, none
    f.check(two, 22)                                # 1 unit, 2 failed: 2
    assert f.total() == 18
    assert harness.Failures(_Stack, tick=0).total() == 0
