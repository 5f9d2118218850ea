"""Host s of set-up in the CUDA graphs' eager warm-up calls and captures (the
spans ``graphs.warmup`` and ``graphs.capture``, each ended after the device
finished)."""

from port_bench.lib import spans


def read(ctx):
    return spans.graph_setup_s(ctx)
