"""The share of the fused-build solve's (instance, stage) pairs whose warm
Newton-Schulz inverse failed the 2e-3 gate and restarted cold, over the run:
the kernel's own counter over its launches x instances x horizon."""

from port_bench.lib import spans


def read(ctx):
    return spans.rescue_pct(ctx)
