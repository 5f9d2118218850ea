"""Device ms a replayed period under the span ``estimator.update`` (the
disturbance residual, the periodic estimator over its window, its horizon
prediction), from the graph's segment map and the profiled device rows."""

from port_bench.lib import spans


def read(ctx):
    return spans.span_ms_per_unit(ctx, "estimator.update")
