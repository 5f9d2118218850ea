"""Device operations (kernels, copies, sets) a replayed period, from the profiled window."""

from port_bench.lib import readers


def read(ctx):
    return readers.launches_per_unit(ctx)
