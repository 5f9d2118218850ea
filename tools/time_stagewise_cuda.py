#!/usr/bin/env python3
"""Time the port's stagewise CUDA kernels on one card, and split their time.

    python3 tools/time_stagewise_cuda.py [--slots 2 3 4]

From the root of a checkout, on a machine with a CUDA card and nvcc.
Imports the PyTorch port only.  For each depth of the sweeps' cp.async
pipeline (``kSlots`` in ``quad_periodic_mpc_tpu_torch/csrc/stagewise_body.cuh``;
each depth other than the source's is built from a copy under
``build/slots<n>/``), in the order given and then reversed, it times with
CUDA events (10 calls after one warm-up):

- fused_stagewise_solve_stream at B = 128, h = 128, ADMM-50 (the h = 128
  line's shape);
- fused_stagewise_solve_srb at B = 2048 / 1024 / 256, h = 10 / 16 / 64,
  ADMM-30 / 40 / 50 (the main path's and two walking lines' shapes) and at
  B = 1, h = 10, ADMM-30;

and checks that every depth gives bit-identical outputs (the arithmetic
does not depend on it).  Then, at the source's depth, the same kernels with
0, 1 and 10 ADMM iterations: the time at 0 is the backward Riccati alone,
and the slope is the cost of one iteration (2h dependent stage steps).
Prints one line per measurement, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_stagewise_cuda: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import quad_periodic_mpc_tpu_torch  # noqa: F401  (sets the f32 policy)
    from quad_periodic_mpc_tpu_torch.ops.cuda import build
    from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel as SK
    from quad_periodic_mpc_tpu_torch.testing import kernel_cases as KC

    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, nargs="*", default=[])
    args = ap.parse_args()

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    source = build.CSRC
    pattern = re.compile(r"constexpr int kSlots = (\d+);")
    own = int(pattern.search((source / "stagewise_body.cuh").read_text()).group(1))
    trees = {own: source}
    for n in args.slots:
        if n not in trees:
            tree = REPO / "build" / f"slots{n}" / "csrc"
            shutil.rmtree(tree, ignore_errors=True)
            shutil.copytree(source, tree)
            body = tree / "stagewise_body.cuh"
            body.write_text(pattern.sub(f"constexpr int kSlots = {n};", body.read_text()))
            trees[n] = tree

    def use(n):
        build.CSRC = trees[n]
        build._libs.clear()

    def time_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    cases = {}
    a, kw = KC.solve_case(128, 128, seed=210, device=dev, iters=50)
    cases["stream B=128 h=128"] = (SK.fused_stagewise_solve_stream, a, kw)
    for B, h, iters in ((2048, 10, 30), (1024, 16, 40), (256, 64, 50), (1, 10, 30)):
        a, kw = KC.stagewise_case(B, h, seed=100, device=dev, iters=iters)
        cases[f"srb B={B} h={h}"] = (SK.fused_stagewise_solve_srb, a, kw)

    first = {}
    order = list(trees) if len(trees) == 1 else [*trees, *reversed(trees)]
    for n in order:
        use(n)
        for name, (fn, a, kw) in cases.items():
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(out, first.setdefault(name, out)))
            print(f"[slots {n}] {name} ADMM-{kw['iters']}: {time_ms(lambda: fn(*a, **kw)):.4f} ms "
                  f"per call, outputs identical to the first depth's: {same} on {card}")
            if not same:
                return 1
    use(own)
    for name, (fn, a, kw) in cases.items():
        times = [time_ms(lambda: fn(*a, **dict(kw, iters=it))) for it in (0, 1, 10)]
        print(f"[split] {name}: ADMM-0 (Riccati alone) {times[0]:.4f} ms, ADMM-1 "
              f"{times[1]:.4f} ms, ADMM-10 {times[2]:.4f} ms: "
              f"{(times[2] - times[0]) / 10:.4f} ms per ADMM iteration on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
