"""Device ms a replayed period under the 13 spans ``mpc.swing_update`` (swing
bookkeeping and foot targets, every tick), from the graph's segment map and
the profiled device rows."""

from port_bench.lib import spans


def read(ctx):
    return spans.span_ms_per_unit(ctx, "mpc.swing_update")
