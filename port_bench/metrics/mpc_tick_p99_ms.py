"""The 99th percentile of the MPC ticks' own time (start to end, host clock) in the paced window."""

from port_bench.lib import readers


def read(ctx):
    return readers.tick_service_ms(ctx, 'mpc', 'p99')
