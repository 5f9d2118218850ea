"""The device's idle share of the replayed periods back to back: the share of
the timed window in which the card had no work queued (CUDA events around each
block of periods)."""

from port_bench.lib import readers


def read(ctx):
    return readers.idle_pct(ctx)
