"""Device ms inside a tick's replay in which none of its graph's nodes ran
(from its first node's start to its last node's end, less their union), the
mean over the profiled ticks: the launch-bound part of the tick's idle."""

from port_bench.lib import spans


def read(ctx):
    return spans.in_graph_idle_ms(ctx)
