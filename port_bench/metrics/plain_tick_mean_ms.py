"""The mean of the plain ticks' own time (start to end, host clock) in the paced window."""

from port_bench.lib import readers


def read(ctx):
    return readers.tick_service_ms(ctx, 'plain', 'mean')
