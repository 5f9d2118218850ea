"""The arithmetic of the per-layer metrics that the port records itself:
the device time of its spans inside the replayed CUDA graphs
(``utils/telemetry``'s replay log, put down to span paths by
``telemetry.attribute``), the graphs' set-up spans, and the fused-build
solve's rescue counter (``ops/cuda/stagewise_kernel.RESCUES``).  ``ctx``
as in ``readers``.  A program that records none of them gives None: the
reader finds nothing to read."""

from __future__ import annotations

import statistics


def _telemetry():
    from quad_periodic_mpc_tpu_torch.utils import telemetry

    return telemetry if hasattr(telemetry, "attribute") else None


def replays(ctx):
    """The profiled window's replays, each an ``Attributed`` (device us by
    span path, idle us inside the replay), or None: no replay log, or rows
    that are not as many as the logged replays ran."""
    tel = _telemetry()
    if tel is None or not ctx.rows:
        return None
    log = list(tel.REPLAYS)[-ctx.profiled_units:]
    if len(log) < ctx.profiled_units:
        return None
    return tel.attribute(ctx.rows, log)


def under(us: dict, name: str) -> float:
    """Device us under the span ``name``: over the paths that hold it."""
    return sum(v for path, v in us.items() if name in path.split("/"))


def span_ms_per_unit(ctx, name: str):
    """Device ms a unit under the span ``name``."""
    reps = replays(ctx)
    if reps is None:
        return None
    return sum(under(r.us, name) for r in reps) / 1e3 / ctx.profiled_units


def span_ms_mean(ctx, name: str):
    """Device ms under the span ``name``, the mean over the replays that ran it."""
    reps = replays(ctx)
    if reps is None:
        return None
    ran = [under(r.us, name) for r in reps
           if any(name in path.split("/") for path in r.us)]
    return statistics.fmean(ran) / 1e3 if ran else None


def in_graph_idle_ms(ctx):
    """Device ms inside a replay in which none of its nodes ran, the mean
    over the profiled replays."""
    reps = replays(ctx)
    if reps is None:
        return None
    return statistics.fmean(r.idle_us for r in reps) / 1e3


def rescue_pct(ctx):
    """100 x the (instance, stage) pairs whose warm Newton-Schulz inverse
    restarted cold over the pairs solved (the fused-build kernel's launches
    x instances x horizon, and the plain version's on the CPU), over the
    run so far."""
    from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel as sk

    if not hasattr(sk, "rescues"):
        return None
    pairs = (sk.LAUNCHES["fused_stagewise_solve_srb"] * ctx.instances * int(ctx.cfg["horizon"])
             + sk.PLAIN_PAIRS)
    return 100.0 * sk.rescues() / pairs if pairs else None


def graph_setup_s(ctx):
    """Host s in every graph's eager warm-up calls and capture (0 where
    the program ran no graph: on the CPU)."""
    tel = _telemetry()
    if tel is None:
        return None
    return float(sum(s.end - s.start for s in tel.SETUP
                     if s.parent is None and s.name in ("graphs.warmup", "graphs.capture")))
