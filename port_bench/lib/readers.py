"""The arithmetic of the per-layer metrics, shared by their files under
``metrics/``.  ``ctx`` (built by ``harness.window_run`` in a traced run):
``rows`` the profiled window's device rows, ``profiled_units`` its units,
``window_s`` the timed (unprofiled) window's seconds, ``queued_s`` the
seconds of it in which the card had queued work (CUDA events around each
block of units or each tick; None where not measured),
``instances``, ``cfg`` the configuration, ``service_s`` {kind: [s]} each
tick's own time in the paced window.  A reader that finds nothing to read
returns None."""

from __future__ import annotations

import statistics

from port_bench import counts
from port_bench.lib import harness, trace
from port_bench.reference import stagewise


def idle_pct(ctx):
    """100 (1 - queued s / window s): the share of the timed window in which
    the card had no work queued, waiting for the host."""
    if ctx.queued_s is None:
        return None
    return 100.0 * (1.0 - ctx.queued_s / ctx.window_s)


def launches_per_unit(ctx):
    if not ctx.rows:
        return None
    return len(ctx.rows) / ctx.profiled_units


def other_ms_per_unit(ctx):
    """Device ms a unit in everything but the hand-written kernels."""
    if not ctx.rows:
        return None
    return trace.other_us(ctx.rows) / 1e3 / ctx.profiled_units


def roofline_pct(ctx, counter_name: str, flops: int, nbytes: int):
    """100 x the kernel's bound (max of operations over the float32 peak
    and bytes over the HBM rate) over its profiled device ms a launch."""
    n, us = trace.kernel_us(ctx.rows, counter_name)
    if n == 0 or us <= 0:
        return None
    bound_ms, _ = counts.bound(flops, nbytes)
    return 100.0 * bound_ms / (us / 1e3 / n)


def stagewise_srb_roofline(ctx):
    """The fused-build solve at the cell's batch, horizon and iterations,
    no warm inverse restarted cold (what these inputs need at the least)."""
    B, h = ctx.instances, int(ctx.cfg["horizon"])
    iters = int(ctx.cfg["solver"]["iterations"])
    ns_it = stagewise.ns_combine_iters(h)
    ns_warm = stagewise.ns_warm_rounds(ns_it)
    return roofline_pct(ctx, "fused_stagewise_solve_srb",
                        counts.solve_flops(B, h, iters, ns_it, ns_warm, 0),
                        counts.solve_bytes(B, h))


def tick_service_ms(ctx, kind: str, stat: str):
    """The p99 or the mean of one kind of tick's own ms."""
    vals = [1e3 * s for s in ctx.service_s.get(kind, [])]
    if not vals:
        return None
    return harness.percentile(vals, 99) if stat == "p99" else statistics.fmean(vals)
