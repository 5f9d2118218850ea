"""Device ms a replayed period in everything but the port's hand-written
kernels: the PyTorch glue of the loop, the MPC build, the estimator, the
swing update, the plants and the WBC's task build."""

from port_bench.lib import readers


def read(ctx):
    return readers.other_ms_per_unit(ctx)
