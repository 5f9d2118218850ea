#!/usr/bin/env python3
"""Time the port's per-tick CUDA kernels on one card, and split their time.

    python3 tools/time_tick_cuda.py [--baseline DIR]

From the root of a checkout, on a machine with a CUDA card and nvcc.
Imports the PyTorch port only.  Builds ``wbc.cu``, ``plant.cu``,
``kinematics.cu`` and ``kf.cu`` (printing what ptxas -v says of each:
registers, stack frame, spills, shared memory, and, from
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, each kernel's resident
blocks per SM), then times, on seeded inputs (``testing/kernel_cases``):

- fused_wbc at B = 256 and B = 1 with 0, 1 and 15 PDIP iterations: the
  time at 0 is the KinWBC and WBIC cascades plus the QP set-up and the
  torques, and the slope is one PDIP iteration;
- fused_substeps at B = 256 and B = 1 with 1 and 10 substeps: the
  intercept is the load and store, the slope one substep;
- fused_model_eval at B = 256 and B = 1;
- fused_kf_innovate at B = 2048, 1585, 1584 and 1 (1584 and 1585 sit on
  either side of the first design's one-wave limit, 12 blocks on each of
  132 SMs).

Each time is the device's: one long sleep kernel backs the stream up, a
warm-up call and then 10 calls are queued behind it, and CUDA events
around the 10 read their time per call, so the host's issue of the calls
(longer than a short kernel) is not counted.  fused_substeps' call also
launches the clock's one-element add (``state.t + dt * substeps``), a few
microseconds that the slope does not see.

The split of fused_model_eval (B = 256 and 1) and fused_kf_innovate
(B = 2048 and 1) into phases comes from stripped copies of the source,
written under ``build/split/``: each copy deletes one more phase (the
lines from a phase's first line to the line that follows it, found by the
patterns in ``CUTS``), and a phase's time is the difference between two
successive copies.  The copies' outputs are meaningless; only their times
are read.  A source that matches none of a kernel's pattern lists gets no
split.

For each version it also prints the largest errors of all four kernels
against their plain versions (the WBC at 15 PDIP iterations, the plant at
10 substeps, the model evaluation at B = 256 and 1, the KF at every batch
above), and fails where one exceeds the card tests' tolerance
(``KC.WBC_TOL``, ``KC.PLANT_TOL``, ``KC.MODEL_TOL``, ``KC.KF_TOL``) or a
contact flag differs.

``--baseline DIR`` names another version's ``csrc`` tree (for example the
parent commit's, unpacked with ``git archive``); its kernels are built and
timed on the same inputs before and after this checkout's (baseline,
checkout, checkout, baseline), so that the two are compared within one
call.  It then prints, for each output of fused_model_eval and
fused_kf_innovate, the largest |checkout - baseline| on the same seeded
inputs: 0 where every sum kept its order.  Prints one line per
measurement, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCES = ("wbc.cu", "plant.cu", "kinematics.cu", "kf.cu")
KERNELS = {"wbc.cu": ("wbc_kernel",), "plant.cu": ("plant_kernel",),
           "kinematics.cu": ("model_eval_kernel", "contact_kinematics_kernel"),
           "kf.cu": ("kf_kernel",)}
REPS = 10
SLEEP_CYCLES = 200_000_000          # ~0.1 s at the H100's clock: longer than the calls' issue
KF_BATCHES = (2048, 1585, 1584, 1)
SPLIT_BATCHES = {"fused_model_eval": (256, 1), "fused_kf_innovate": (2048, 1)}

# Phases cut from a copy of the source, one more per copy, last phase of the
# kernel first: (phase, first line's pattern, pattern of the line after the
# phase).  Each source has one list per design; the first list whose
# patterns all match is used.  What is left after the last cut is `REST`.
CUTS = {
    "kinematics.cu": [
        [   # three warps per instance
            ("SpdInv<18> (warp 1)", r"wl::SpdInv<ND>::run",
             r"for \(int e = lane; e < ND \* ND; e \+= 32\) Ainv_out"),
            ("phase 2: Coriolis | H assembly | gravity", r"// ---- phase 2", r"^\}$"),
            ("phase 1: legs' walks and feet | CRBA | gravity's walk", r"// ---- phase 1",
             r"^\}$"),
        ],
        [   # one warp per instance (the first design)
            ("gravity and Coriolis (lane 0)", r"^  if \(lane == 0\) \{$", r"^\}$"),
            ("SpdInv<18>", r"wl::SpdInv<ND>::run", r"for \(int e = lane; e < ND \* ND"),
            ("CRBA sweep and H assembly", r"// ---- CRBA sweep",
             r"for \(int e = lane; e < ND \* ND"),
        ],
    ],
    "kf.cu": [
        [   # two warps per instance
            ("the two refined solves, x' and P'", r"// ---- the two solves side by side",
             r"// ---- symmetrise"),
            ("S^{-1}", r"spd_inv28\(s\.S", r"// ---- symmetrise"),
        ],
        [   # one warp per instance (the first design)
            ("the two refined solves, x' and P'", r"// ---- S_ey = S\^\{-1\} ey",
             r"// ---- symmetrise"),
            ("SpdInv<28>", r"wl::SpdInv<NY>::run", r"// ---- symmetrise"),
        ],
    ],
}
REST = {"kinematics.cu": "the rest (tree walk or phase 0, loads, stores, launch)",
        "kf.cu": "predict, innovation, symmetrise and stores"}
SPLIT_SOURCE = {"fused_model_eval": "kinematics.cu", "fused_kf_innovate": "kf.cu"}

PROBE = """
extern "C" int occupancy_probe_{k}(int* out) {{
  cudaFuncAttributes a;
  int err = (int)cudaFuncGetAttributes(&a, {k});
  if (err) return err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 4, {k}, a.maxThreadsPerBlock, 0);
}}
"""


def cut_copies(tree: Path, src: str) -> tuple[list[str], list[str]] | None:
    """The source's text with 1, 2, ... phases deleted, and the phases'
    names; None where no pattern list matches."""
    text = (tree / src).read_text()
    for cuts in CUTS.get(src, []):
        lines, copies = text.splitlines(keepends=True), []
        for _, first, after in cuts:
            i = next((n for n, ln in enumerate(lines) if re.search(first, ln)), None)
            if i is None:
                break
            j = next((n for n in range(i + 1, len(lines)) if re.search(after, lines[n])), None)
            if j is None:
                break
            lines = lines[:i] + lines[j:]
            copies.append("".join(lines))
        if len(copies) == len(cuts):
            return copies, [name for name, _, _ in cuts]
    return None


def nvcc_build(nvcc: str, flags: list[str], directory: Path, src: str) -> Path:
    out = directory / f"lib{Path(src).stem}.so"
    proc = subprocess.run([nvcc, *flags, "-o", str(out), str(directory / src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {directory / src}:\n{proc.stderr}")
    return out


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
    from quad_periodic_mpc_tpu_torch.ops.cuda import kf_kernel as FK
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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    trees = {"checkout": build.CSRC}
    if args.baseline is not None:
        trees = {"baseline": args.baseline.resolve(), **trees}
    order = list(trees) if len(trees) == 1 else [*trees, *reversed(trees)]

    # the stripped copies and the occupancy probes, all built at once
    jobs, splits, probes = [], {}, {}
    for tree, csrc in trees.items():
        for src in SOURCES:
            base = REPO / "build" / "split" / tree / Path(src).stem
            shutil.rmtree(base, ignore_errors=True)
            variants = {"probe": (csrc / src).read_text()
                        + "".join(PROBE.format(k=k) for k in KERNELS[src])}
            cut = cut_copies(csrc, src)
            if cut is not None:
                variants.update({f"cut{i + 1}": text for i, text in enumerate(cut[0])})
                splits[tree, src] = cut[1]
            for name, text in variants.items():
                directory = base / name
                directory.mkdir(parents=True)
                for header in csrc.glob("*.cuh"):
                    shutil.copy(header, directory)
                (directory / src).write_text(text)
                jobs.append((tree, src, name, directory))
    nvcc, flags = build._nvcc(), [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        built = list(pool.map(lambda j: nvcc_build(nvcc, flags, j[3], j[1]), jobs))
    variant_libs = {}
    for (tree, src, name, _), lib in zip(jobs, built):
        if name == "probe":
            probes[tree, src] = ctypes.CDLL(str(lib))
        else:
            variant_libs[tree, src, name] = str(lib)

    for tree in trees:
        for src in SOURCES:
            for k in KERNELS[src]:
                fn = getattr(probes[tree, src], f"occupancy_probe_{k}")
                fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
                out = (ctypes.c_int * 5)()
                err = fn(out)
                if err:
                    raise RuntimeError(f"occupancy probe of {k} ({tree}): cudaError_t {err}")
                regs, smem, local, threads, blocks = out
                print(f"[occupancy] {tree} {k}: {threads} threads a block, {regs} registers, "
                      f"{smem} B static shared memory, {local} B local memory; {blocks} "
                      f"resident blocks per SM, {blocks * sms} on the card's {sms} SMs")

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
    model_st, kf_args = {}, {}
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
        model_st[B] = KC.model_states(B, seed=4, device=dev)
        cases["fused_model_eval", B] = {"": lambda st=model_st[B]: KK.fused_model_eval(st, mc)}
    for B in KF_BATCHES:
        kf_args[B] = KC.kf_case(B, seed=10, device=dev)
        cases["fused_kf_innovate", B] = {
            "": lambda a=kf_args[B]: FK.fused_kf_innovate(*a, dt=KC.KF_DT)}

    maxdiff = lambda a, b: float((a - b).abs().max())
    wanted = {}         # (kernel, B) -> the plain version's outputs
    outputs = {}        # tree -> {(kernel, B): {output: tensor}}
    eye = torch.eye(18, device=dev)

    def errors(tree: str) -> bool:
        ok, mine = True, outputs.setdefault(tree, {})
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
            A, Ainv, G, C, info = KK.fused_model_eval(model_st[B], mc)
            if ("model", B) not in wanted:
                wanted["model", B] = KK.model_eval_reference(model_st[B], mc)
            A_r, _, G_r, C_r, info_r = wanted["model", B]
            errs = {"A": maxdiff(A, A_r), "G": maxdiff(G, G_r), "C": maxdiff(C, C_r),
                    "Jc": maxdiff(info.Jc, info_r.Jc), "p_foot": maxdiff(info.p_foot, info_r.p_foot),
                    "Jcdqd": maxdiff(info.Jcdqd, info_r.Jcdqd), "AinvA-I": maxdiff(Ainv @ A, eye)}
            ok &= all(errs[n] < KC.MODEL_TOL[n] for n in errs)
            print(f"[error] {tree} fused_model_eval B={B}: " + ", ".join(
                f"max|d{n}|={e:.3g} (tol {KC.MODEL_TOL[n]})" for n, e in errs.items()))
            mine["fused_model_eval", B] = {"A": A, "Ainv": Ainv, "G": G, "C": C, "Jc": info.Jc,
                                           "Jcdqd": info.Jcdqd, "p_foot": info.p_foot}
        for B in KF_BATCHES:
            got = FK.fused_kf_innovate(*kf_args[B], dt=KC.KF_DT)
            if ("kf", B) not in wanted:
                wanted["kf", B] = FK.fused_kf_innovate_reference(*kf_args[B], dt=KC.KF_DT)
            errs = {n: maxdiff(g, w) for n, g, w in zip("xP", got, wanted["kf", B])}
            ok &= all(errs[n] < KC.KF_TOL[n] for n in errs)
            print(f"[error] {tree} fused_kf_innovate B={B}: " + ", ".join(
                f"max|d{n}|={e:.3g} (tol {KC.KF_TOL[n]})" for n, e in errs.items()))
            mine["fused_kf_innovate", B] = dict(zip(("x'", "P'"), got))
        return ok

    def split(tree: str, name: str, B: int, whole: float) -> None:
        src = SPLIT_SOURCE[name]
        if (tree, src) not in splits:
            print(f"[split] {tree} {name}: no pattern list matches {src}; no split")
            return
        fn, times = cases[name, B][""], [whole]
        for i in range(len(splits[tree, src])):
            build._libs[src] = ctypes.CDLL(variant_libs[tree, src, f"cut{i + 1}"])
            times.append(device_ms(fn))
        build._libs[src] = ctypes.CDLL(str(build.library_path(src)))
        parts = [f"{phase} {times[i] - times[i + 1]:.4f}"
                 for i, phase in enumerate(splits[tree, src])]
        print(f"[split] {tree} {name} B={B}: " + ", ".join(parts)
              + f", {REST[src]} {times[-1]:.4f} ms (whole {whole:.4f}) on {card}")

    ok = True
    for tree in order:
        use(tree)
        ok &= errors(tree)
        for (name, B), fns in cases.items():
            t = {k: device_ms(fn) for k, fn in fns.items()}
            for k, ms in t.items():
                print(f"[time] {tree} {name} B={B}{' ' + k if k else ''}: {ms:.4f} ms per call "
                      f"on the device on {card}")
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
            elif B in SPLIT_BATCHES.get(name, ()):
                split(tree, name, B, t[""])
    if "baseline" in outputs:
        for key, outs in outputs["checkout"].items():
            base = outputs["baseline"][key]
            print(f"[baseline] {key[0]} B={key[1]}: max|checkout - baseline| " + ", ".join(
                f"{n} {maxdiff(o, base[n]):.3g}" for n, o in outs.items()) + "; bit for bit: "
                + str(all(torch.equal(o, base[n]) for n, o in outs.items())))
    if not ok:
        print("time_tick_cuda: a kernel disagrees with its plain version", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
