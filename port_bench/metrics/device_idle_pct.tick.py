"""The device's idle share of the paced 500 Hz window: the share of the window
in which the card had no tick to run (CUDA events around each tick)."""

from port_bench.lib import readers


def read(ctx):
    return readers.idle_pct(ctx)
