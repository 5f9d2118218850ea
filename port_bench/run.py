#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on a CUDA card.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout (the repository, or any copy holding
``BENCHMARK.json``, ``port_bench/`` and the port
``quad_periodic_mpc_tpu_torch/``).  The cell is an entry of
``BENCHMARK.json``'s ``workloads``; ``port_bench/workloads/<cell>.json``
holds its entry, window mode, traffic parameters and limits.  The run builds
the cell's inputs from ``--seed`` on the card, builds the cell's kernels
into ``build/kernels/`` in the checkout (the first run only), warms up
and captures the timed unit, then measures for ``--seconds``: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` the same
window, then a short profiled one, and the cell's per-layer metrics.  It then holds
what the timed path produced to the plain reference
(``port_bench/reference/``) and prints each number compared beside its
limit, on standard error and under ``checks`` in the result.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``busy_s`` and
``window_s`` when traced), ``breakdown`` when traced, and ``checks``.
Without a card, with fewer cards than the cell asks for, or with JAX or
the JAX package loaded, the run exits non-zero and prints no result."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # every cache at a fixed path inside the checkout
    for var, sub in (("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
        os.makedirs(os.environ[var], exist_ok=True)
    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench.lib import harness

    cell = harness.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
        print(f"{args.workload} needs {cell.entry['chips']} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device,
                           T_START, log=lambda s: print(s, flush=True))
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    result = harness.result_line(out, bool(args.trace), torch.cuda.get_device_name(device),
                                 cell.entry["chips"])
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
