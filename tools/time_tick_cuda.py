#!/usr/bin/env python3
"""Time the port's per-tick CUDA kernels and its ADMM and SRB-dump kernels
on one card, and split their time.

    python3 tools/time_tick_cuda.py [--baseline DIR] [--admm-columns F32,BF16 ...]

From the root of a checkout, on a machine with a CUDA card and nvcc.
Imports the PyTorch port only.  Builds ``wbc.cu``, ``plant.cu``,
``kinematics.cu``, ``kf.cu``, ``admm.cu`` and ``stagewise_srb.cu``
(printing what ptxas -v says of each kernel: registers, stack frame,
spills, shared memory, and, from
``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at the block size and
dynamic shared memory of its launch, its resident blocks per SM; for
``admm_kernel`` the resident f32 and bf16 instantiations at h = 10), then
times, on seeded inputs (``testing/kernel_cases``):

- fused_wbc at B = 256 and B = 1 with 0, 1 and 15 PDIP iterations: the
  time at 0 is the KinWBC and WBIC cascades plus the QP set-up and the
  torques, and the slope is one PDIP iteration;
- fused_substeps at B = 256 and B = 1 with 1 and 10 substeps: the
  intercept is the load and store, the slope one substep;
- fused_model_eval at B = 256 and B = 1;
- fused_kf_innovate at B = 2048, 1585, 1584 and 1 (1584 and 1585 sit on
  either side of the first design's one-wave limit, 12 blocks on each of
  132 SMs);
- fused_admm_iterations (``ADMM_CASES``, warm starts) with K^-1 stored in
  f32 and in bf16: at B = 2048, h = 10 with 0, 1 and 30 iterations (the
  time at 0 is the K^-1 load, the first rhs and the stores; the slope from
  1 to 30 is one iteration), at B = 1, h = 10, and with 30 iterations at
  the first design's and this design's largest resident horizons (f32
  h = 19 and 22, bf16 27 and 30, B = 2048) and just past each (h = 20 and
  23, 28 and 31, B = 256);
- srb_build_dump at B = 2048 and B = 1.

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

For each version it also prints the largest errors of all six kernels
against their plain versions (the WBC at 15 PDIP iterations, the plant at
10 substeps, the model evaluation at B = 256 and 1, the KF at every batch
above, the ADMM at every shape above with 30 iterations, the dump at both
batches), and fails where one exceeds the card tests' tolerance
(``KC.WBC_TOL``, ``KC.PLANT_TOL``, ``KC.MODEL_TOL``, ``KC.KF_TOL``,
``KC.admm_tol(h)``, the dump's 1e-6) or a contact flag differs.  An ADMM
shape that misses ``KC.admm_tol(h)`` fails, unless ``KC.admm_f64_gated(B,
h)`` says that the first design's kernel lies past it there too (h > 28,
or h >= 22 at hundreds of instances): such a shape is held to the float64
plain version instead, no farther from it than ``KC.ADMM_F64_FACTOR``
times the float32 plain version; in the checkout's first pass each such
shape is held so on ``F64_SEEDS`` more seeds too, with every seed's
distances and the largest ratio of the kernel's to the plain version's
printed: the margin the factor leaves.

``--baseline DIR`` names another version's ``csrc`` tree (for example the
parent commit's, unpacked with ``git archive``); its kernels are built and
timed on the same inputs before and after this checkout's (baseline,
checkout, checkout, baseline), so that the two are compared within one
call.  It then prints, for each output of fused_model_eval,
fused_kf_innovate, fused_admm_iterations and srb_build_dump at every batch
and shape above, the largest |checkout - baseline| on the same seeded
inputs and whether every bit is equal: 0 where every sum kept its order.

``--admm-columns F32,BF16`` (repeatable) writes a copy of this checkout's
``admm.cu`` under ``build/split/`` with that many columns of K^-1 in a
thread's registers (``kJF32``, ``kJBf16``; multiples of 8), builds it,
prints its ptxas lines and occupancy, and in the checkout's first pass
times it at every ADMM shape above (30 iterations; at B = 2048, h = 10
also 0 and 1) beside the checkout, with whether its outputs equal the
checkout's bit for bit.  Prints one line per measurement, with the card's
name and power limit.
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
SOURCES = ("wbc.cu", "plant.cu", "kinematics.cu", "kf.cu", "admm.cu", "stagewise_srb.cu")
# (label, kernel expression, threads a block (0: the kernel's most), dynamic
# shared memory in bytes (a C expression)) for the occupancy probes; admm.cu
# has one list per design, the first whose template signature is found.
KERNELS = {"wbc.cu": [("wbc_kernel", "wbc_kernel", "0", "0")],
           "plant.cu": [("plant_kernel", "plant_kernel", "0", "0")],
           "kinematics.cu": [("model_eval_kernel", "model_eval_kernel", "0", "0"),
                             ("contact_kinematics_kernel", "contact_kinematics_kernel", "0",
                              "0")],
           "kf.cu": [("kf_kernel", "kf_kernel", "0", "0")],
           "stagewise_srb.cu": [("srb_build_dump_kernel", "srb_build_dump_kernel", "128", "0")]}
ADMM_PROBES = [
    (r"template <bool BF16, int J, int T, int MAXW>", [   # K^-1 in registers first
        ("admm_kernel<f32 resident> at h=10", "admm_kernel<false, kJF32, 1, kSmallWarps>",
         "32 * warps_for(120, 1)", "4 * shared_words(120, kJF32, false, true)"),
        ("admm_kernel<bf16 resident> at h=10", "admm_kernel<true, kJBf16, 1, kSmallWarps>",
         "32 * warps_for(120, 1)", "4 * shared_words(120, kJBf16, true, true)")]),
    (r"template <bool BF16, bool RESIDENT>", [                  # the first design
        ("admm_kernel<f32 resident> at h=10", "admm_kernel<false, true>", "128",
         "4 * (vector_floats(120, 200) + 120 * 120)"),
        ("admm_kernel<bf16 resident> at h=10", "admm_kernel<true, true>", "128",
         "4 * vector_floats(120, 200) + 2 * 120 * 120")]),
]
# fused_admm_iterations: (B, h, K^-1 storage, iteration counts).  h = 10 is
# the condensed trot's; 19 / 27 the first design's largest resident
# horizons (f32 / bf16), 22 / 30 this design's, 20 / 28 and 23 / 31 just
# past each.
ADMM_CASES = [(2048, 10, "f32", (0, 1, 30)), (2048, 10, "bf16", (0, 1, 30)),
              (1, 10, "f32", (30,)), (1, 10, "bf16", (30,)),
              (2048, 19, "f32", (30,)), (2048, 27, "bf16", (30,)),
              (2048, 22, "f32", (30,)), (2048, 30, "bf16", (30,)),
              (256, 20, "f32", (30,)), (256, 28, "bf16", (30,)),
              (256, 23, "f32", (30,)), (256, 31, "bf16", (30,))]
ADMM_ITERS = 30
F64_SEEDS = 8                       # more seeds for each shape held to float64
DUMP_BATCHES = (2048, 1)
DUMP_TOL = 1e-6                     # the card tests' (same entries in exact f32)
REPS = 10
COLUMNS = r"constexpr int kJF32 = \d+, kJBf16 = \d+;"   # admm.cu's register columns
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
extern "C" int occupancy_probe_{i}(int* out) {{
  auto kern = {k};
  cudaFuncAttributes a;
  int err = (int)cudaFuncGetAttributes(&a, kern);
  if (err) return err;
  const int threads = {threads} ? {threads} : a.maxThreadsPerBlock, smem = {smem};
  if (smem > 48 * 1024) {{
    err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
  }}
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = threads;
  out[5] = smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 4, kern, threads, smem);
}}
"""


def probes_of(tree: Path, src: str) -> list:
    """The occupancy probes of ``src`` in ``tree`` (admm.cu's by design)."""
    if src != "admm.cu":
        return KERNELS[src]
    text = (tree / src).read_text()
    return next((p for sig, p in ADMM_PROBES if sig in text), [])


def columns_copy(text: str, spec: str) -> tuple[str, str]:
    """admm.cu's text with F32,BF16 register columns, and the copy's name."""
    f32, bf16 = (int(v) for v in spec.split(","))
    if f32 % 8 or bf16 % 8:
        raise ValueError(f"--admm-columns {spec}: columns must be multiples of 8")
    patched, count = re.subn(COLUMNS, f"constexpr int kJF32 = {f32}, kJBf16 = {bf16};", text)
    if count != 1:
        raise ValueError("admm.cu has no line of register columns to patch")
    return patched, f"J{f32},{bf16}"


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


def nvcc_build(nvcc: str, flags: list[str], directory: Path, src: str) -> tuple[Path, str]:
    """The library and nvcc's output (ptxas -v where the flags ask for it)."""
    out = directory / f"lib{Path(src).stem}.so"
    proc = subprocess.run([nvcc, *flags, "-o", str(out), str(directory / src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {directory / src}:\n{proc.stderr}")
    return out, proc.stdout + proc.stderr


def ptxas_lines(log: str) -> list[str]:
    """ptxas -v's lines on registers, stack, spills and shared memory, each
    kernel's block headed by its (mangled) name."""
    keys = ("Compiling entry function", "registers", "spill", "stack", "smem")
    return [ln.strip() for ln in log.splitlines() if any(k in ln for k in keys)]


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
    from quad_periodic_mpc_tpu_torch.ops.cuda import admm_kernel as AK
    from quad_periodic_mpc_tpu_torch.ops.cuda import build
    from quad_periodic_mpc_tpu_torch.ops.cuda import kf_kernel as FK
    from quad_periodic_mpc_tpu_torch.ops.cuda import kinematics_kernel as KK
    from quad_periodic_mpc_tpu_torch.ops.cuda import plant_kernel as PK
    from quad_periodic_mpc_tpu_torch.ops.cuda import stagewise_kernel as SK
    from quad_periodic_mpc_tpu_torch.ops.cuda import wbc_kernel as WK
    from quad_periodic_mpc_tpu_torch.sim.articulated_sim import ContactParams
    from quad_periodic_mpc_tpu_torch.testing import kernel_cases as KC

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another version's csrc tree, timed before and after this one's")
    ap.add_argument("--admm-columns", action="append", default=[], metavar="F32,BF16",
                    help="also time a copy of this checkout's admm.cu with these register "
                         "columns of K^-1, e.g. 96,120")
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
    admm_variants = {}      # name -> admm.cu's text with other register columns
    for spec in args.admm_columns:
        text, name = columns_copy((build.CSRC / "admm.cu").read_text(), spec)
        admm_variants[name] = text

    # the stripped copies, the occupancy probes and the admm.cu variants,
    # all built at once: (tree, source, name, directory)
    jobs, splits, probes, probe_lists = [], {}, {}, {}
    for tree, csrc in trees.items():
        for src in SOURCES:
            base = REPO / "build" / "split" / tree / Path(src).stem
            shutil.rmtree(base, ignore_errors=True)
            probe_lists[tree, src] = probes_of(csrc, src)
            probes_text = "".join(PROBE.format(i=i, k=k, threads=t, smem=m)
                                  for i, (_, k, t, m) in enumerate(probe_lists[tree, src]))
            variants = {"probe": (csrc / src).read_text() + probes_text}
            cut = cut_copies(csrc, src)
            if cut is not None:
                variants.update({f"cut{i + 1}": text for i, text in enumerate(cut[0])})
                splits[tree, src] = cut[1]
            if tree == "checkout" and src == "admm.cu":
                variants.update({f"variant-{name}": text + probes_text
                                 for name, text in admm_variants.items()})
            for name, text in variants.items():
                directory = base / name
                directory.mkdir(parents=True)
                for header in csrc.glob("*.cuh"):
                    shutil.copy(header, directory)
                (directory / src).write_text(text)
                jobs.append((tree, src, name, directory))
    nvcc, flags = build._nvcc(), [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        built = list(pool.map(
            lambda j: nvcc_build(nvcc, flags + (["-Xptxas", "-v"] if "variant-" in j[2] else []),
                                 j[3], j[1]), jobs))
    variant_libs = {}
    for (tree, src, name, _), (lib, log) in zip(jobs, built):
        if name == "probe":
            probes[tree, src] = ctypes.CDLL(str(lib))
        else:
            variant_libs[tree, src, name] = str(lib)
        if name.startswith("variant-"):
            for line in ptxas_lines(log):
                print(f"[ptxas] {name[8:]}: {line}")

    def occupancy(tree: str, src: str, lib: ctypes.CDLL, tag: str) -> None:
        for i, (label, _, _, _) in enumerate(probe_lists[tree, src]):
            fn = getattr(lib, f"occupancy_probe_{i}")
            fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
            out = (ctypes.c_int * 6)()
            err = fn(out)
            if err:
                raise RuntimeError(f"occupancy probe of {label} ({tag}): cudaError_t {err}")
            regs, smem, local, threads, blocks, dyn = out
            print(f"[occupancy] {tag} {label}: {threads} threads a block, {regs} registers, "
                  f"{smem} B static and {dyn} B dynamic shared memory, {local} B local "
                  f"memory; {blocks} resident blocks per SM, {blocks * sms} on the card's "
                  f"{sms} SMs")

    for tree in trees:
        for src in SOURCES:
            occupancy(tree, src, probes[tree, src], tree)
    for name in admm_variants:
        occupancy("checkout", "admm.cu",
                  ctypes.CDLL(variant_libs["checkout", "admm.cu", f"variant-{name}"]), name)

    def use(tree: str) -> None:
        build.CSRC = trees[tree]
        build._libs.clear()
        build.BUILD_LOGS.clear()
        for src in SOURCES:
            build.load(src)
            for line in ptxas_lines(build.BUILD_LOGS.get(src, "")):
                print(f"[ptxas] {tree} {src}: {line}")

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
    admm_args, dump_args = {}, {}
    for B, h, kind, counts in ADMM_CASES:
        a = admm_args[B, h, kind] = KC.admm_case(B, h, seed=h + B, device=dev, warm=True)
        cases["fused_admm_iterations", f"{B} h={h} {kind}"] = {
            f"ADMM-{it}": (lambda a=a, it=it, bf=kind == "bf16":
                           AK.fused_admm_iterations(*a, iters=it, kinv_bf16=bf))
            for it in counts}
    for B in DUMP_BATCHES:
        a = dump_args[B] = KC.srb_dump_case(B, seed=220 + B, device=dev)[0]
        cases["srb_build_dump", B] = {"": lambda a=a: SK.srb_build_dump(*a)}

    maxdiff = lambda a, b: float((a - b).abs().max())
    bits = lambda a, b: torch.equal(a.view(torch.int32), b.view(torch.int32))
    wanted = {}         # (kernel, B) -> the plain version's outputs
    outputs = {}        # tree -> {(kernel, B): {output: tensor}}
    eye = torch.eye(18, device=dev)

    def f64_far(got, plain, exact) -> dict:
        """Each output's largest |kernel - float64| and |plain - float64|."""
        return {n: (maxdiff(g.double(), e), maxdiff(w.double(), e))
                for n, g, w, e in zip("xzy", got, plain, exact)}

    def f64_margin(seeds: int) -> bool:
        """The ADMM shapes gated against float64, each on `seeds` more
        seeds: every seed's distances and the largest ratio of the
        kernel's to the plain version's."""
        ok = True
        for B, h, kind in admm_args:
            if not KC.admm_f64_gated(B, h):
                continue
            bf, worst = kind == "bf16", dict.fromkeys("xzy", 0.0)
            for seed in range(h + B + 1, h + B + 1 + seeds):
                a = KC.admm_case(B, h, seed=seed, device=dev, warm=True)
                run = lambda fn, args: fn(*args, iters=ADMM_ITERS, kinv_bf16=bf)
                far = f64_far(run(AK.fused_admm_iterations, a),
                              run(AK.fused_admm_iterations_reference, a),
                              run(AK.fused_admm_iterations_reference, [t.double() for t in a]))
                ok &= all(k <= KC.ADMM_F64_FACTOR * pl for k, pl in far.values())
                for n, (k, pl) in far.items():
                    worst[n] = max(worst[n], k / pl if pl else 0.0 if k == 0 else float("inf"))
                print(f"[float64] fused_admm_iterations B={B} h={h} {kind} ADMM-{ADMM_ITERS} "
                      f"seed {seed}: |kernel - float64| / |plain version - float64| "
                      + ", ".join(f"{n} {k:.3g} / {pl:.3g}" for n, (k, pl) in far.items()))
            print(f"[float64] fused_admm_iterations B={B} h={h} {kind}: the largest ratio over "
                  f"{seeds} seeds " + ", ".join(f"{n} {r:.3f}" for n, r in worst.items())
                  + f" (gate {KC.ADMM_F64_FACTOR}) on {card}")
        return ok

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
        for (B, h, kind), a in admm_args.items():
            bf = kind == "bf16"
            got = AK.fused_admm_iterations(*a, iters=ADMM_ITERS, kinv_bf16=bf)
            if ("admm", B, h, kind) not in wanted:
                wanted["admm", B, h, kind] = AK.fused_admm_iterations_reference(
                    *a, iters=ADMM_ITERS, kinv_bf16=bf)
            errs = {n: maxdiff(g, w) for n, g, w in zip("xzy", got, wanted["admm", B, h, kind])}
            tol = KC.admm_tol(h)
            where = "resident" if AK.kinv_resident(12 * h, 20 * h, bf) else "streamed"
            print(f"[error] {tree} fused_admm_iterations B={B} h={h} {kind} ADMM-{ADMM_ITERS} "
                  f"(K^-1 {where}): " + ", ".join(
                      f"max|d{n}|={e:.3g} (tol {tol[n]:.3g})" for n, e in errs.items()))
            within = all(errs[n] < tol[n] for n in errs)
            if not within and KC.admm_f64_gated(B, h):
                # the first design lies past admm_tol here too: as accurate
                # as the plain version
                if ("admm64", B, h, kind) not in wanted:
                    wanted["admm64", B, h, kind] = AK.fused_admm_iterations_reference(
                        *(t.double() for t in a), iters=ADMM_ITERS, kinv_bf16=bf)
                far = f64_far(got, wanted["admm", B, h, kind], wanted["admm64", B, h, kind])
                within = all(k <= KC.ADMM_F64_FACTOR * pl for k, pl in far.values())
                print(f"[error] {tree} fused_admm_iterations B={B} h={h} {kind}: past admm_tol, "
                      f"so against float64 (kernel / plain version, gate "
                      f"{KC.ADMM_F64_FACTOR}x the plain version's): " + ", ".join(
                          f"{n} {k:.3g} / {pl:.3g}" for n, (k, pl) in far.items()))
            ok &= within
            mine["fused_admm_iterations", f"{B} h={h} {kind} ADMM-{ADMM_ITERS}"] = dict(
                zip("xzy", got))
        for B, a in dump_args.items():
            got = SK.srb_build_dump(*a)
            errs = {n: maxdiff(g, w) for n, g, w in zip(("Ad", "Bd", "c"), got,
                                                          SK.srb_assemble(*a))}
            ok &= all(e <= DUMP_TOL for e in errs.values())
            print(f"[error] {tree} srb_build_dump B={B}: " + ", ".join(
                f"max|d{n}|={e:.3g} (tol {DUMP_TOL})" for n, e in errs.items()))
            mine["srb_build_dump", B] = dict(zip(("Ad", "Bd", "c"), got))
        return ok

    def variants() -> None:
        """The admm.cu variants at every ADMM shape, each against the
        checkout as built."""
        mine = outputs["checkout"]
        for name in admm_variants:
            build._libs["admm.cu"] = ctypes.CDLL(variant_libs["checkout", "admm.cu",
                                                              f"variant-{name}"])
            for (B, h, kind), a in admm_args.items():
                bf = kind == "bf16"
                run = lambda it: AK.fused_admm_iterations(*a, iters=it, kinv_bf16=bf)
                same = all(bits(o, mine["fused_admm_iterations",
                                         f"{B} h={h} {kind} ADMM-{ADMM_ITERS}"][n])
                           for n, o in zip("xzy", run(ADMM_ITERS)))
                counts = (0, 1, ADMM_ITERS) if (B, h) == (2048, 10) else (ADMM_ITERS,)
                t = {it: device_ms(lambda: run(it)) for it in counts}
                split = "" if len(t) == 1 else (
                    f" (ADMM-0 {t[0]:.4f} ms, one iteration "
                    f"{(t[ADMM_ITERS] - t[1]) / (ADMM_ITERS - 1):.4f} ms)")
                print(f"[variant] {name} fused_admm_iterations "
                      f"B={B} h={h} {kind} ADMM-{ADMM_ITERS}: {t[ADMM_ITERS]:.4f} ms per call "
                      f"on the device{split}, outputs equal to the checkout's bit for bit: "
                      f"{same} on {card}")
        build._libs["admm.cu"] = ctypes.CDLL(str(build.library_path("admm.cu")))

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

    ok, margin_done = True, False
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
            elif name == "fused_admm_iterations" and "ADMM-0" in t:
                slope = (t[f"ADMM-{ADMM_ITERS}"] - t["ADMM-1"]) / (ADMM_ITERS - 1)
                print(f"[split] {tree} fused_admm_iterations B={B}: K^-1 load, first rhs and "
                      f"stores (ADMM-0) {t['ADMM-0']:.4f} ms, the first iteration "
                      f"{t['ADMM-1'] - t['ADMM-0']:.4f} ms, one iteration of the rest "
                      f"{slope:.4f} ms on {card}")
            elif B in SPLIT_BATCHES.get(name, ()):
                split(tree, name, B, t[""])
        if tree == "checkout" and admm_variants:
            variants()
            admm_variants.clear()       # once, in the first pass
        if tree == "checkout" and not margin_done:
            ok &= f64_margin(F64_SEEDS)
            margin_done = True
    if "baseline" in outputs:
        for key, outs in outputs["checkout"].items():
            base = outputs["baseline"][key]
            print(f"[baseline] {key[0]} B={key[1]}: max|checkout - baseline| " + ", ".join(
                f"{n} {maxdiff(o, base[n]):.3g}" for n, o in outs.items()) + "; bit for bit: "
                + str(all(bits(o, base[n]) for n, o in outs.items())))
    if not ok:
        print("time_tick_cuda: a kernel disagrees with its plain version", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
