"""The fused-build stagewise kernel's share of its roofline: its bound
(operations and bytes of port_bench/counts.py over the H100's float32 and
HBM peaks) over its profiled device ms a launch."""

from port_bench.lib import readers


def read(ctx):
    return readers.stagewise_srb_roofline(ctx)
