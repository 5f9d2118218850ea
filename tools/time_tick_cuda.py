#!/usr/bin/env python3
"""Time the port's torque-tick CUDA kernels on one card, and split their time.

    python3 tools/time_tick_cuda.py [--baseline DIR]

From the root of a checkout, on a machine with a CUDA card and nvcc.
Imports the PyTorch port only.  Builds ``wbc.cu``, ``plant.cu`` and
``kinematics.cu`` (printing what ptxas -v says of each: registers, stack
frame, spills, shared memory), then times, on seeded inputs
(``testing/kernel_cases``):

- fused_wbc at B = 256 and B = 1 with 0, 1 and 15 PDIP iterations: the
  time at 0 is the KinWBC and WBIC cascades plus the QP set-up and the
  torques, and the slope is one PDIP iteration;
- fused_substeps at B = 256 and B = 1 with 1 and 10 substeps: the
  intercept is the load and store, the slope one substep;
- fused_model_eval at B = 256 and B = 1.

Each time is the device's: one long sleep kernel backs the stream up, a
warm-up call and then 10 calls are queued behind it, and CUDA events
around the 10 read their time per call, so the host's issue of the calls
(longer than a short kernel) is not counted.  fused_substeps' call also
launches the clock's one-element add (``state.t + dt * substeps``), a few
microseconds that the slope does not see.

For each version it also prints the WBC's (15 PDIP iterations) and the
plant's (10 substeps) largest errors against their plain versions at
B = 256 and 1, and fails where one exceeds the card tests' tolerance
(``KC.WBC_TOL``, ``KC.PLANT_TOL``) or a contact flag differs.

``--baseline DIR`` names another version's ``csrc`` tree (for example the
parent commit's, unpacked with ``git archive``); its kernels are built and
timed on the same inputs before and after this checkout's (baseline,
checkout, checkout, baseline), so that the two are compared within one
call.  Prints one line per measurement, with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCES = ("wbc.cu", "plant.cu", "kinematics.cu")
REPS = 10
SLEEP_CYCLES = 200_000_000          # ~0.1 s at the H100's clock: longer than the calls' issue


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_tick_cuda: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import quad_periodic_mpc_tpu_torch  # noqa: F401  (sets the f32 policy)
    from quad_periodic_mpc_tpu_torch.config import PDIPConfig
    from quad_periodic_mpc_tpu_torch.control.wbc import WBCGains
    from quad_periodic_mpc_tpu_torch.models import floating_base as fb
    from quad_periodic_mpc_tpu_torch.ops.cuda import build
    from quad_periodic_mpc_tpu_torch.ops.cuda import kinematics_kernel as KK
    from quad_periodic_mpc_tpu_torch.ops.cuda import plant_kernel as PK
    from quad_periodic_mpc_tpu_torch.ops.cuda import wbc_kernel as WK
    from quad_periodic_mpc_tpu_torch.sim.articulated_sim import ContactParams
    from quad_periodic_mpc_tpu_torch.testing import kernel_cases as KC

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another version's csrc tree, timed before and after this one's")
    args = ap.parse_args()

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    trees = {"checkout": build.CSRC}
    if args.baseline is not None:
        trees = {"baseline": args.baseline.resolve(), **trees}
    order = list(trees) if len(trees) == 1 else [*trees, *reversed(trees)]

    def use(tree: str) -> None:
        build.CSRC = trees[tree]
        build._libs.clear()
        build.BUILD_LOGS.clear()
        for src in SOURCES:
            build.load(src)
            for line in build.BUILD_LOGS.get(src, "").splitlines():
                if any(k in line for k in ("registers", "spill", "stack", "smem")):
                    print(f"[ptxas] {tree} {src}: {line.strip()}")

    def device_ms(fn) -> float:
        """ms per call on the device, the calls queued behind a sleep."""
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(SLEEP_CYCLES)
        fn()
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / REPS

    mc = fb.build_a1_constants("float32", str(dev))
    gains, params = WBCGains(), ContactParams()
    cases = {}          # (kernel, B) -> {setting: fn}
    for B in (256, 1):
        wargs = KC.wbc_kernel_args(*KC.wbc_state_and_input(B, device=dev))
        cases["fused_wbc", B] = {
            f"PDIP-{it}": (lambda a=wargs, it=it:
                           WK.fused_wbc(*a, gains, PDIPConfig(iterations=it)))
            for it in (0, 1, 15)}
        plant, tau, cache, Jc, pf = KC.plant_case(B, device=dev)
        cases["fused_substeps", B] = {
            f"substeps-{n}": (lambda c=(plant, tau, cache, Jc, pf), n=n:
                              PK.fused_substeps(c[0], c[1], 2e-4, params, c[2], c[3], c[4], n))
            for n in (1, 10)}
        st = KC.model_states(B, seed=4, device=dev)
        cases["fused_model_eval", B] = {"": lambda st=st: KK.fused_model_eval(st, mc)}

    maxdiff = lambda a, b: float((a - b).abs().max())
    wanted = {}         # (kernel, B) -> the plain version's outputs

    def errors(tree: str) -> bool:
        ok = True
        for B in (256, 1):
            wargs = KC.wbc_kernel_args(*KC.wbc_state_and_input(B, device=dev))
            got = WK.fused_wbc(*wargs, gains, KC.WBC_PDIP)
            if ("wbc", B) not in wanted:
                wanted["wbc", B] = WK.fused_wbc_reference(*wargs, gains, KC.WBC_PDIP)
            want = wanted["wbc", B]
            errs = {n: maxdiff(g, w) for n, g, w in zip(KC.WBC_TOL, got, want)}
            ok &= all(errs[n] < KC.WBC_TOL[n] for n in errs)
            print(f"[error] {tree} fused_wbc B={B} PDIP-15: " + ", ".join(
                f"max|d{n}|={e:.3g} (tol {KC.WBC_TOL[n]})" for n, e in errs.items()))
            case = KC.plant_case(B, device=dev)
            run = lambda fn: fn(case[0], case[1], 2e-4, params, *case[2:], 10)
            pb, pf_b = run(PK.fused_substeps)
            if ("plant", B) not in wanted:
                wanted["plant", B] = run(PK.fused_substeps_reference)
            pa, pf_a = wanted["plant", B]
            errs = {f: maxdiff(getattr(pb.fb, f), getattr(pa.fb, f))
                    for f in ("pos", "quat", "v_body", "q", "qd")}
            errs["p_foot"] = maxdiff(pf_b, pf_a)
            errs["anchor"] = maxdiff(pb.anchor, pa.anchor)
            same = bool(torch.equal(pb.in_contact, pa.in_contact))
            ok &= same and all(errs[n] < KC.PLANT_TOL[n] for n in errs)
            print(f"[error] {tree} fused_substeps B={B} substeps-10: " + ", ".join(
                f"max|d{n}|={e:.3g} (tol {KC.PLANT_TOL[n]})" for n, e in errs.items())
                + f", contact flags equal: {same}")
        return ok

    ok = True
    for tree in order:
        use(tree)
        ok &= errors(tree)
        for (name, B), fns in cases.items():
            t = {k: device_ms(fn) for k, fn in fns.items()}
            for k, ms in t.items():
                print(f"[time] {tree} {name} B={B} {k}: {ms:.4f} ms per call on the device "
                      f"on {card}")
            if name == "fused_wbc":
                print(f"[split] {tree} fused_wbc B={B}: cascades + QP set-up + torques "
                      f"{t['PDIP-0']:.4f} ms, one PDIP iteration "
                      f"{(t['PDIP-15'] - t['PDIP-0']) / 15:.4f} ms (PDIP-1 - PDIP-0: "
                      f"{t['PDIP-1'] - t['PDIP-0']:.4f} ms) on {card}")
            elif name == "fused_substeps":
                slope = (t["substeps-10"] - t["substeps-1"]) / 9
                print(f"[split] {tree} fused_substeps B={B}: load and store (with the "
                      f"clock's add) {t['substeps-1'] - slope:.4f} ms, one substep "
                      f"{slope:.4f} ms on {card}")
    if not ok:
        print("time_tick_cuda: a kernel disagrees with its plain version", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
