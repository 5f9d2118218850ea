"""One run of one cell: set-up, an optional profiled window, the timed
window, the comparison with the plain reference, and the result line.

Everything that belongs to one cell, configuration or per-layer metric is
data or a file of its own, found by name: ``BENCHMARK.json`` names the
cell's configuration and metrics, ``workloads/<cell>.json`` its entry,
window mode, traffic parameters and limits, ``configs/<config>.json`` the
configuration and its ``stack`` (``stacks/<stack>.py``), and each
per-layer metric is ``metrics/<metric>.py`` with ``read(ctx)``."""

from __future__ import annotations

import concurrent.futures
import importlib
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

from port_bench.lib import trace, tree

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "quad_periodic_mpc_tpu")
NON_FINITE = 1e30             # a gap that is not finite is reported as this
SYNC_EVERY = 8                # units queued back to back between two synchronizes


class CellError(RuntimeError):
    pass


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT, listed: bool = True) -> SimpleNamespace:
    """The cell's entry in BENCHMARK.json, its workload and configuration
    files and its stack module.  ``listed=False`` (tests only) also takes a
    workload file that BENCHMARK.json does not list, with no metrics."""
    bench = load_json(root / "BENCHMARK.json")
    wl = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None and listed:
        raise CellError(f"BENCHMARK.json has no workload {name!r}")
    entry = entry or {k: wl[k] for k in ("name", "config", "traffic", "chips")}
    for key in ("config", "traffic", "chips"):
        if wl[key] != entry[key]:
            raise CellError(f"{name}: {key} {wl[key]!r} in its file, {entry[key]!r} in "
                            "BENCHMARK.json")
    cfg_file = next((c["file"] for c in bench["configs"] if c["name"] == wl["config"]),
                    f"port_bench/configs/{wl['config']}.json")
    cfg = load_json(root / cfg_file)
    stack = importlib.import_module(f"port_bench.stacks.{cfg['stack']}")
    reports = lambda m: name in m.get("workloads", [name])
    return SimpleNamespace(
        name=name, bench=bench, entry=entry, wl=wl, cfg=cfg, stack=stack,
        end_to_end=[m for m in bench["end_to_end"] if reports(m)],
        per_layer=[m for m in bench["per_layer"] if reports(m)])


def load_metric(name: str):
    """metrics/<name>.py, loaded from its file (a name may hold dots)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "port_bench.metrics._" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_kernels(sources) -> None:
    """The cell's hand-written kernels, built at once (nvcc into the
    checkout's build/kernels; a later run finds them built)."""
    from quad_periodic_mpc_tpu_torch.ops.cuda import build

    with concurrent.futures.ThreadPoolExecutor(max(1, len(sources))) as pool:
        list(pool.map(build.build, sources))
    for src in sources:
        build.load(src)


def card_line(device) -> str:
    """The card's name and power limit (nvidia-smi), or its name alone."""
    import subprocess

    import torch

    if device.type != "cuda":
        return "no card"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
        return out.strip().splitlines()[device.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launch_counts() -> dict:
    from quad_periodic_mpc_tpu_torch.runtime import graphs

    return graphs.launch_counts()


def profile_window(prog, carry, tick: int, units: int, device, log):
    """``units`` units back to back under torch.profiler (CPU and CUDA
    activities): (carry, tick, device rows, host rows, wall s).  The trace
    can drop launches: a window whose hand-written launches differ from
    the wrappers' counters is profiled again, twice at most."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        before = _launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(units):
                carry = prog.units[prog.schedule(tick)](carry)
                tick += 1
            _sync(device)
            wall = time.perf_counter() - t0
        counted = {k: n - before[k] for k, n in _launch_counts().items() if n != before[k]}
        rows, host = trace.collect(prof)
        seen = trace.hand_written_counts(rows)
        log(f"[trace] window {attempt + 1}: {len(rows)} device rows over {units} units, "
            f"hand-written launches traced {seen}, counted {counted}")
        if seen == counted:
            break
    return carry, tick, rows, host, wall


class Samples:
    """The units kept for the comparison: (kind, state before, state after)."""

    def __init__(self, fractions, kinds, seconds):
        self.wanted = [(f * seconds, kinds[j % len(kinds)]) for j, f in enumerate(fractions)]
        self.kept = []

    def due(self, elapsed: float, kind: str) -> bool:
        return bool(self.wanted) and elapsed >= self.wanted[0][0] and kind == self.wanted[0][1]

    def run(self, unit, kind, carry, device):
        before = tree.clone(carry)
        carry = unit(carry)
        _sync(device)
        self.kept.append((kind, before, tree.clone(carry)))
        self.wanted.pop(0)
        return carry


class Marks:
    """CUDA events around the work queued in a timed window, in a traced run
    on a card: a pair around each block of units queued back to back, or
    around each tick.  ``busy_s`` sums the device's time inside the pairs:
    the window's time in which the card had queued work."""

    def __init__(self, on: bool):
        self.on, self.pairs, self._open = on, [], None

    def _event(self):
        import torch

        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def start(self) -> None:
        if self.on:
            self._open = self._event()

    def end(self) -> None:
        if self.on and self._open is not None:
            self.pairs.append((self._open, self._event()))
            self._open = None

    def busy_s(self):
        if not self.pairs:
            return None
        return sum(a.elapsed_time(b) for a, b in self.pairs) / 1e3


class Failures:
    """Instance-units that failed in the window: at each check, the
    instances failed (the stack's ``failed(carry)``) times the units since
    the last check.  The count stays on the device until ``total``.  A
    fallen or non-finite instance stays so until its episode restarts, and
    a check comes before every restart and at the window's end."""

    def __init__(self, stack, tick: int):
        self.stack, self.tick, self.count = stack, tick, None

    def check(self, carry, tick: int) -> None:
        n = self.stack.failed(carry).sum() * (tick - self.tick)
        self.count = n if self.count is None else self.count + n
        self.tick = tick

    def total(self) -> int:
        return 0 if self.count is None else int(self.count)


class Episodes:
    """Robots that start again from the start state every ``ticks`` control
    ticks (a period of 13 ticks is one unit of a back-to-back window), or never."""

    def __init__(self, start, ticks, ticks_per_unit):
        self.start, self.units = start, (None if ticks is None else ticks // ticks_per_unit)

    def carry(self, carry, tick: int, failures: Failures):
        if self.units is not None and tick % self.units == 0:
            failures.check(carry, tick)
            return self.start
        return carry


def drive_periods(prog, carry, tick, seconds, samples, device, episodes, failures, marks):
    """Units back to back for ``seconds``: each unit queued as soon as the
    host can (a closed loop on the device: each takes the state the last
    one left), a synchronize every ``SYNC_EVERY`` units, after a check for
    failures, the window ending at the first synchronize past ``seconds``.
    Returns (carry, tick, units, window s, {})."""
    n = 0
    t0 = time.perf_counter()
    while True:
        if n % SYNC_EVERY == 0:
            marks.start()
        carry = episodes.carry(carry, tick, failures)
        kind = prog.schedule(tick)
        if samples.due(time.perf_counter() - t0, kind):
            carry = samples.run(prog.units[kind], kind, carry, device)
        else:
            carry = prog.units[kind](carry)
        tick += 1
        n += 1
        if n % SYNC_EVERY == 0:
            marks.end()
            failures.check(carry, tick)
            _sync(device)
            if time.perf_counter() - t0 >= seconds:
                break
    return carry, tick, n, time.perf_counter() - t0, {}


def drive_paced_ticks(prog, carry, tick, seconds, samples, device, episodes, failures, marks,
                      period_s):
    """Ticks due every ``period_s`` from the window's start for ``seconds``:
    a tick starts at its due time or when the previous one ends, whichever
    is later, and ends in a synchronize.  Returns (carry, tick, ticks,
    window s, {"latency": [...], "service": {kind: [...]}})."""
    latency, service = [], {k: [] for k in prog.units}
    t0 = time.perf_counter()
    i, end = 0, t0
    while True:
        due = t0 + i * period_s
        if due >= t0 + seconds:
            break
        carry = episodes.carry(carry, tick, failures)
        now = time.perf_counter()
        while now < due:
            now = time.perf_counter()
        kind = prog.schedule(tick)
        marks.start()
        if samples.due(now - t0, kind):
            carry = samples.run(prog.units[kind], kind, carry, device)
        else:
            carry = prog.units[kind](carry)
        marks.end()
        _sync(device)
        end = time.perf_counter()
        latency.append(end - due)
        service[kind].append(end - now)
        tick += 1
        i += 1
    return carry, tick, i, end - t0, {"latency": latency, "service": service}


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between the closest ranks (numpy's
    default)."""
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def window_run(name: str, seed: int, seconds: float, traced: bool, device, t_start: float,
               instances=None, hook=None, log=print) -> SimpleNamespace:
    """Set-up, the timed window, and the profiled window when ``traced``.
    ``instances`` shrinks the batch, ``hook(prog) -> prog`` wraps the
    program's units and a workload BENCHMARK.json does not list is taken
    (all three for tests only)."""
    import torch

    marks = {"torch": time.perf_counter()}
    cell = load_cell(name, listed=instances is None)
    wl, cfg, stack = cell.wl, cell.cfg, cell.stack
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        marks["context"] = time.perf_counter()
        build_kernels(stack.SOURCES)
        marks["kernels"] = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(device)
    inp = stack.draw_inputs(cfg, wl, seed, device, instances)
    prog = stack.program(cfg, wl, inp, device)
    marks["program"] = time.perf_counter()
    if hook is not None:
        prog = hook(prog)
    samples = Samples(inp["samples"], sorted(prog.units), seconds)

    # set-up: the cell's own shapes warmed up, the graphs captured; the
    # first unit (from the start) is kept for the comparison
    start = tree.clone(prog.start)
    episode_ticks = wl["params"].get("episode_ticks")
    episodes = Episodes(tree.clone(prog.start) if episode_ticks else None, episode_ticks,
                        prog.ticks_per_unit)
    first_kind = prog.schedule(0)
    carry = prog.units[first_kind](prog.start)
    _sync(device)
    marks["first unit"] = time.perf_counter()
    kept = [(first_kind, start, tree.clone(carry))]
    tick = 1
    for _ in range(wl["warmup_units"] - 1):
        carry = prog.units[prog.schedule(tick)](carry)
        tick += 1
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"[setup] {name}: {prog.instances} instances, {tick} warm-up units, "
        f"set-up {setup_s:.3f} s (s from the start: " + ", ".join(
            f"{k} {v - t_start:.3f}" for k, v in marks.items()) + ")")

    mode = wl["window"]
    failures, marks = Failures(stack, tick), Marks(traced and device.type == "cuda")
    if mode == "back_to_back":
        carry, tick, n, window_s, extra = drive_periods(
            prog, carry, tick, seconds, samples, device, episodes, failures, marks)
    elif mode == "paced_ticks":
        carry, tick, n, window_s, extra = drive_paced_ticks(
            prog, carry, tick, seconds, samples, device, episodes, failures, marks,
            wl["params"]["tick_period_ms"] / 1e3)
    else:
        raise CellError(f"{name}: unknown window mode {mode!r}")
    failures.check(carry, tick)
    n_failed = failures.total()
    # the profiled window after the timed one: a profiler session slows the
    # host's launches for the rest of the process
    prof = None
    if traced:
        log(f"[card] {card_line(device)} (the rooflines' peaks assume 700 W)")
        carry, tick, rows, host, wall = profile_window(prog, carry, tick, wl["profile_units"],
                                                       device, log)
        prof = SimpleNamespace(rows=rows, host=host, wall_s=wall, units=wl["profile_units"])

    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    attempted = n * prog.instances
    quantities = {"setup_s": setup_s}
    if mode == "back_to_back":
        quantities["solves_per_s"] = attempted / window_s
    else:
        lat_ms = [1e3 * v for v in extra["latency"]]
        quantities["tick_p99_ms"] = percentile(lat_ms, 99)
        quantities["tick_mean_ms"] = statistics.fmean(lat_ms)
    log(f"[window] {n} units in {window_s:.4f} s, {attempted} attempted, "
        f"{n_failed} failed; " + ", ".join(
            f"{k} {v:.6g}" for k, v in quantities.items()))
    ctx = None
    if traced:
        ctx = SimpleNamespace(cfg=cfg, instances=prog.instances, rows=prof.rows,
                              profiled_units=prof.units, window_s=window_s,
                              queued_s=marks.busy_s(), service_s=extra.get("service", {}))
    # the program's state is freed before the reference runs
    del prog, carry
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return SimpleNamespace(cell=cell, inp=inp, start=start, kept=kept + samples.kept,
                           quantities=quantities, attempted=attempted, failed=n_failed,
                           peak=int(peak), prof=prof, ctx=ctx)


def run_cell(name: str, seed: int, seconds: float, traced: bool, device, t_start: float,
             instances=None, hook=None, log=print) -> dict:
    """One run; returns the result's parts."""
    w = window_run(name, seed, seconds, traced, device, t_start, instances, hook, log)
    cell = w.cell
    metrics = {}
    if not traced:
        for m in cell.end_to_end:
            q = "setup_s" if m["name"] == "setup_s" else cell.wl["end_to_end"][m["name"]]
            metrics[m["name"]] = {"value": w.quantities[q], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            value = load_metric(m["name"]).read(w.ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = compare(cell, w.inp, w.start, w.kept, device, log)
    # the configurations' guarantee: no instance falls, every state stays finite
    checks["failed"] = {"value": float(w.failed), "limit": 0.0}
    out = {"attempted": w.attempted, "failed": w.failed, "metrics": metrics,
           "memory_peak_bytes": w.peak, "checks": checks}
    if traced:
        out["busy_s"] = trace.busy_us(w.prof.rows) / 1e6
        out["window_s"] = w.prof.wall_s
        out["breakdown"] = {"device_ops": trace.top_ops(w.prof.rows),
                            "idle_gaps": trace.idle_gaps(w.prof.rows, w.prof.host)}
    return out


def reference_gaps(cell, inp, start, kept, device, tf32: bool = False):
    """{number: reading}: the largest gap over the kept units of the
    program's state after each unit to the reference's from the same
    state before it, and the program's start to the reference's own.
    ``tf32``: the reference computed with TF32 on (the control's side)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    ref = cell.stack.reference(cell.cfg, cell.wl, inp, device)
    gaps = {"start": tree.max_gap(start, ref.start)}
    with torch.no_grad():
        for kind, before, after in kept:
            want = ref.units[kind](tree.transplant(before, ref.start))
            for k, v in cell.stack.compare(after, want).items():
                gaps[k] = max(gaps.get(k, 0.0), v)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return gaps


def compare(cell, inp, start, kept, device, log) -> dict:
    """{number: {"value", "limit"}}: the numbers the cell's file gives a
    limit, each against it."""
    t0 = time.perf_counter()
    gaps = reference_gaps(cell, inp, start, kept, device)
    checks = {}
    for k, limit in cell.wl["limits"].items():
        v = gaps[k] if math.isfinite(gaps[k]) else NON_FINITE
        checks[k] = {"value": v, "limit": limit}
    log(f"[compare] {len(kept)} units against the reference in "
        f"{time.perf_counter() - t0:.2f} s")
    return checks


def result_line(out: dict, traced: bool, kind: str, count: int) -> dict:
    """The contract's result object, ``checks`` last."""
    device = {"platform": "gpu", "kind": kind, "count": count,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    if traced:
        device.update(busy_s=out["busy_s"], window_s=out["window_s"])
    result = {"correct": correct(out["checks"]), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"], "device": device}
    if traced:
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    return result


def correct(checks: dict) -> bool:
    return bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
