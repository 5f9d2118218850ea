"""The profiler's trace as plain rows, and the arithmetic on them.

A row is ``(name, start_us, end_us)``.  ``collect`` turns a
``torch.profiler.profile`` into device rows (every kernel, copy and set
the card ran) and host rows (every host-side event: operators and the
CUDA runtime's calls).  The rest works on rows only, so that it can be
held to made-up rows in a test."""

from __future__ import annotations

import bisect
import re

# the port's hand-written kernels: the device symbol of each, by the name
# its wrapper's launch counter uses (runtime/graphs.launch_counts)
HAND_WRITTEN = {
    "fused_stagewise_solve_srb": "stagewise_srb_kernel",
    "fused_stagewise_solve": "stagewise_solve_kernel",
    "fused_stagewise_solve_stream": "stagewise_stream_kernel",
    "srb_build_dump": "srb_build_dump_kernel",
    "fused_model_eval": "model_eval_kernel",
    "fused_contact_kinematics": "contact_kinematics_kernel",
    "fused_wbc": "wbc_kernel",
    "fused_substeps": "plant_kernel",
    "fused_kf_innovate": "kf_kernel",
    "fused_admm_iterations": "admm_kernel",
}


SCAN = 512          # host events looked back through for the one running at a gap


def symbol_pattern(symbol: str) -> re.Pattern:
    return re.compile(rf"(?<![A-Za-z0-9_]){re.escape(symbol)}(?![A-Za-z0-9_])")


_PATTERNS = {k: symbol_pattern(s) for k, s in HAND_WRITTEN.items()}


def kernel_of(name: str) -> str | None:
    """The counter name of the hand-written kernel a device row is, or None."""
    for k, pat in _PATTERNS.items():
        if pat.search(name):
            return k
    return None


def collect(prof) -> tuple[list, list]:
    """(device rows, host rows) of a finished ``torch.profiler.profile``,
    each sorted by start."""
    import torch

    device, host = [], []
    for e in prof.events():
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device.append(row)
        elif e.device_type == torch.autograd.DeviceType.CPU:
            host.append(row)
    return sorted(device, key=lambda r: r[1]), sorted(host, key=lambda r: r[1])


def busy_us(rows: list) -> float:
    """The length of the union of the rows' intervals: the time in which
    some operation ran on the device."""
    total, end = 0.0, None
    for _, s, e in sorted(rows, key=lambda r: r[1]):
        if end is None or s >= end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def by_name(rows: list) -> dict:
    """name -> [launches, device us]."""
    out: dict = {}
    for name, s, e in rows:
        acc = out.setdefault(name, [0, 0.0])
        acc[0] += 1
        acc[1] += e - s
    return out


def hand_written_counts(rows: list) -> dict:
    """Launches of each hand-written kernel among the rows, by counter name."""
    out: dict = {}
    for name, _, _ in rows:
        k = kernel_of(name)
        if k is not None:
            out[k] = out.get(k, 0) + 1
    return out


def kernel_us(rows: list, counter_name: str) -> tuple[int, float]:
    """(launches, device us) of one hand-written kernel."""
    pat = _PATTERNS[counter_name]
    hits = [e - s for name, s, e in rows if pat.search(name)]
    return len(hits), sum(hits)


def other_us(rows: list) -> float:
    """Device us in everything that is not a hand-written kernel."""
    return sum(e - s for name, s, e in rows if kernel_of(name) is None)


def top_ops(rows: list, n: int = 10) -> list:
    """[[name, seconds], ...]: the device operations that took most time."""
    ranked = sorted(by_name(rows).items(), key=lambda kv: -kv[1][1])[:n]
    return [[name[:200], us / 1e6] for name, (_, us) in ranked]


def idle_gaps(device: list, host: list, n: int = 10) -> list:
    """[[host event, seconds], ...]: the device's idle gaps between its
    first and last row, each named by the innermost host event that was
    running when it began, summed by that name, largest first."""
    gaps, end = [], None
    for _, s, e in sorted(device, key=lambda r: r[1]):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    host = sorted(host, key=lambda r: r[1])
    starts = [r[1] for r in host]
    by: dict = {}
    for g0, g1 in gaps:
        name = "(no host event)"
        # the latest-starting host event that still runs at g0
        i = bisect.bisect_right(starts, g0) - 1
        for hname, s, e in reversed(host[max(0, i - SCAN):i + 1]):
            if e >= g0:
                name = hname
                break
        by[name] = by.get(name, 0.0) + (g1 - g0)
    ranked = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:200], us / 1e6] for name, us in ranked]
