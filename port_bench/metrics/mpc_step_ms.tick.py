"""Device ms under the span ``mpc.mpc_step`` in an MPC tick (the B = 1 solve:
reference trajectory, estimator, problem build and row 1), the mean over the
profiled MPC ticks, from the graph's segment map and the profiled device rows."""

from port_bench.lib import spans


def read(ctx):
    return spans.span_ms_mean(ctx, "mpc.mpc_step")
