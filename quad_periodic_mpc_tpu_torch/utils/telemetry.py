"""Observability hub, the Debug-class analog (counterpart of
``quad_periodic_mpc_tpu/utils/telemetry.py``; src/common/debug/debug.cpp).

The reference publishes per-tick ROS topics (/all_legs_info, /body_info,
LogData, RViz markers) and prints ad-hoc timers
(ConvexMPCLocomotion.cpp:588-598).  Here:

- ``Telemetry``: a snapshot of per-tick controller observables as tensors,
  stacked along a leading time axis for a rollout's record;
- ``Timers``: wall-clock stage accounting, fenced by ``sync``;
- ``jsonl_dump``: a LogData-style stream of JSON lines.

A tree here is a tensor (or array, or number), a NamedTuple, tuple, list
or dict of trees, or None; its leaves are taken in field order, dict keys
sorted, None skipped, as JAX flattens a pytree.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, NamedTuple

import numpy as np
import torch


class Telemetry(NamedTuple):
    """Per-tick observable bundle (LogData.msg + BodyInfo/AllLegsInfo
    analog, unitree_legged_msgs/msg/LogData.msg:1-50)."""

    t: torch.Tensor              # (...,)
    pos: torch.Tensor            # (..., 3)
    rpy: torch.Tensor            # (..., 3)
    vel: torch.Tensor            # (..., 3)
    omega: torch.Tensor          # (..., 3)
    pos_des: torch.Tensor        # (..., 3)
    vel_des: torch.Tensor        # (..., 3)
    foot_forces: torch.Tensor    # (..., 4, 3)
    foot_pos: torch.Tensor       # (..., 4, 3)
    contact: torch.Tensor        # (..., 4)
    f_est: torch.Tensor          # (..., 6)
    est_freq: torch.Tensor       # (...,)
    est_amp: torch.Tensor        # (...,)


def leaves(tree: Any) -> list:
    """The leaves of a tree in JAX's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in leaves(v)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    return [tree]


def unflatten(template: Any, values: list) -> Any:
    """A tree shaped like ``template`` whose leaves are ``values`` in order."""
    it = iter(values)

    def build(t):
        if t is None:
            return None
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(template)


def to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def sync(x) -> float:
    """Device fence: waits for the card of the tree's first leaf when it is
    a CUDA tensor, and returns that leaf's sum as a host float."""
    first = leaves(x)[0]
    if isinstance(first, torch.Tensor):
        if first.is_cuda:
            torch.cuda.synchronize(first.device)
        return float(first.sum())
    return float(np.sum(first))


@dataclass
class Timers:
    """Named stage timers with p50/p99 summaries (the
    PeriodicTaskManager::printStatus / SHOW_MPC_SOLVE_TIME analog)."""

    records: dict = field(default_factory=dict)

    def time(self, name: str, fn, *args, reps: int = 1, **kw):
        out = fn(*args, **kw)
        sync(out)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args, **kw)
        sync(out)
        dt = (time.perf_counter() - t0) / reps
        self.records.setdefault(name, []).append(dt)
        return out

    def summary(self) -> dict:
        out = {}
        for name, xs in self.records.items():
            arr = np.asarray(xs) * 1e3
            out[name] = {
                "p50_ms": float(np.percentile(arr, 50)),
                "p99_ms": float(np.percentile(arr, 99)),
                "mean_ms": float(arr.mean()),
                "n": len(xs),
            }
        return out


def _jsonable(tree: Any) -> Any:
    """Leaves as nested lists, a NamedTuple or tuple as a list (as
    ``json.dumps`` writes them), dict keys sorted (as JAX's tree map
    rebuilds a dict)."""
    if isinstance(tree, dict):
        return {k: _jsonable(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return [_jsonable(v) for v in tree]
    if tree is None:
        return None
    return np.asarray(tree).tolist()


def jsonl_dump(path: str | Path, records: Any) -> int:
    """Append a tree of records with a leading time axis as JSON lines, one
    per time step; a NamedTuple's row is written as an object of its fields.
    Returns the number of lines."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = [to_numpy(x) for x in leaves(records)]
    n = arrays[0].shape[0]
    with path.open("a") as f:
        for i in range(n):
            row = unflatten(records, [x[i] for x in arrays])
            f.write(json.dumps(_jsonable(
                row._asdict() if hasattr(row, "_asdict") else row)) + "\n")
    return n
