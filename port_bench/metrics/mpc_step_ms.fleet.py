"""Device ms a replayed period under the span ``mpc.mpc_step`` (the MPC
solve: reference trajectory, estimator, problem build and row 1), from the
graph's segment map and the profiled window's device rows."""

from port_bench.lib import spans


def read(ctx):
    return spans.span_ms_per_unit(ctx, "mpc.mpc_step")
