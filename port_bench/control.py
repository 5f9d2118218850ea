#!/usr/bin/env python3
"""The readings that the cells' limits are set from, on a CUDA card.

    python3 port_bench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, in one process: the cell's set-up and a short timed window
of the program (as ``run.py`` runs it), then for the kept units two sets
of gaps, each number as ``run.py`` compares it:

- ``program``: the program's state after each unit against the plain
  reference's from the same state, in float32 with TF32 off, as the
  configuration states (the lower readings);
- ``control``: the reference itself put in the program's place with its
  matrix products in TF32, the nearest precision below the configuration's
  (float32 with TF32 off), against the same float32 reference (the upper
  readings).  cuBLAS takes no TF32 path for these small batched products
  (the flag alone moved nothing on the H100), so ``tf32_products`` rounds
  every float32 operand of a product to TF32's 10-bit mantissa, as the
  tensor cores read it, and sums in float32.

One JSON line per seed.  The benchmark's own runs never run this."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def to_tf32(t):
    """A float32 tensor rounded to TF32 (10-bit mantissa, to nearest);
    anything else as it is."""
    import torch

    if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
        return t
    bits = (t.contiguous().view(torch.int32) + 0x1000) & -0x2000
    return torch.where(torch.isfinite(t), bits.view(torch.float32), t)


@contextlib.contextmanager
def tf32_products():
    """Every matrix product (``@``, ``matmul``, ``bmm``, ``einsum``) on
    TF32-rounded float32 operands, and the cuBLAS TF32 flags on."""
    import torch

    saved = {(torch.Tensor, "__matmul__"): torch.Tensor.__matmul__,
             (torch.Tensor, "__rmatmul__"): torch.Tensor.__rmatmul__,
             (torch.Tensor, "matmul"): torch.Tensor.matmul,
             (torch, "matmul"): torch.matmul, (torch, "bmm"): torch.bmm,
             (torch, "einsum"): torch.einsum}
    wrap = lambda fn: lambda *a, **kw: fn(*(to_tf32(x) for x in a), **kw)
    einsum = saved[(torch, "einsum")]
    try:
        for (owner, name), fn in saved.items():
            setattr(owner, name, wrap(fn))
        torch.einsum = lambda eq, *ops: einsum(eq, *(to_tf32(x) for x in ops))
        torch.backends.cuda.matmul.allow_tf32 = True
        yield
    finally:
        for (owner, name), fn in saved.items():
            setattr(owner, name, fn)
        torch.backends.cuda.matmul.allow_tf32 = False


def control_gaps(cell, inp, start, kept, device) -> dict:
    """The reference with TF32 products in the program's place against the
    float32 reference from the program's kept states, number by number as
    the comparison reads them."""
    import torch

    from port_bench.lib import tree

    torch.backends.cuda.matmul.allow_tf32 = False
    ref = cell.stack.reference(cell.cfg, cell.wl, inp, device)
    with tf32_products():
        low = cell.stack.reference(cell.cfg, cell.wl, inp, device)
    gaps = {"start": tree.max_gap(low.start, ref.start)}
    with torch.no_grad():
        for kind, before, _ in kept:
            with tf32_products():
                got = low.units[kind](tree.transplant(before, low.start))
            want = ref.units[kind](tree.transplant(before, ref.start))
            for k, v in cell.stack.compare(got, want).items():
                gaps[k] = max(gaps.get(k, 0.0), v)
    return gaps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench.lib import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        w = harness.window_run(args.workload, seed, args.seconds, False, device, t0,
                               log=lambda s: print(s, file=sys.stderr, flush=True))
        program = harness.reference_gaps(w.cell, w.inp, w.start, w.kept, device)
        control = control_gaps(w.cell, w.inp, w.start, w.kept, device)
        print(json.dumps({"workload": args.workload, "seed": seed, "units": len(w.kept),
                          "program": program, "control": control,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
