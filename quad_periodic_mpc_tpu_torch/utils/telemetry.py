"""Observability hub, the Debug-class analog (counterpart of
``quad_periodic_mpc_tpu/utils/telemetry.py``; src/common/debug/debug.cpp).

The reference publishes per-tick ROS topics (/all_legs_info, /body_info,
LogData, RViz markers) and prints ad-hoc timers
(ConvexMPCLocomotion.cpp:588-598).  Here:

- ``Telemetry``: a snapshot of per-tick controller observables as tensors,
  stacked along a leading time axis for a rollout's record;
- ``span``: named spans at the port's layer boundaries, read through the
  profiler, the CUDA graphs' segment maps and the graphs' set-up records
  (below);
- ``jsonl_dump``: a LogData-style stream of JSON lines.

A tree here is a tensor (or array, or number), a NamedTuple, tuple, list
or dict of trees, or None; its leaves are taken in field order, dict keys
sorted, None skipped, as JAX flattens a pytree.

Spans.  ``with span("mpc.mpc_step"):`` (or ``@spanned(name)`` on a
function) marks a layer, named after its module.  Spans nest, and a span's
path is the names of the spans open around it and its own, joined by "/"
(``loop.control_tick/mpc.mpc_step/estimator.update``).  A span does one
or more of three things, and otherwise nothing but one flag check (it
reads no tensor, synchronizes nothing and allocates nothing):

- while a ``torch.profiler`` profile records, it opens a record
  function of its name (``_RecordFunctionFast``), so that its host rows
  lie on the profiler's clock with the device rows.  Not
  ``torch.autograd.profiler.record_function``: the profiler gives each of
  its ranges a device row of its own as well (a GPU user annotation over
  the range's kernels), which a reading of the device rows would take for
  an operation of the card;
- while ``runtime/graphs.Graphed`` captures a CUDA graph (``capturing``),
  it reads the graph's node count at its entry and its exit (libcuda's
  ``cuStreamGetCaptureInfo`` and ``cuGraphGetNodes``, through ctypes:
  ``graph_nodes``).  The capture turns these counts into the graph's
  segment map: a ``Segment`` (path, first node, nodes) for each run of
  nodes captured under one innermost span, in capture order, covering
  every node (path "" for nodes under no span).  A replay of a captured
  chain runs its nodes in that order, so a replay's device rows map onto
  the map by position (``attribute``);
- while a graph is set up (``setup``: its eager warm-up calls and its
  capture), it appends a ``SetupSpan`` (name, parent, host start and end,
  graph) to ``SETUP``, its end taken after a synchronize of the device
  (none inside a capture, where nothing runs).

While a profiler records, each replay of a graph appends a ``Replay`` (the
graph's segment map, and the copies into its buffers that went before it)
to ``REPLAYS``, a bounded log: a profiled window of n replays is its last n
entries.  Spans keep one stack for the process: open them on one thread.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import json
import time
import types
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


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

REPLAY_LOG = 4096                   # replays kept in REPLAYS


class SetupSpan(NamedTuple):
    """A span of a graph's set-up: host seconds (``time.perf_counter``)
    from its entry to its exit, the exit after the device finished (outside
    a capture); ``parent`` is the name of the span around it, or None."""

    name: str
    parent: str | None
    start: float
    end: float
    graph: str


class Segment(NamedTuple):
    """Nodes ``first`` to ``first + nodes - 1`` of a graph, captured under
    the innermost span ``path`` ("" under none)."""

    path: str
    first: int
    nodes: int


class Replay(NamedTuple):
    """One replay of a graph in a profiled window: its segment map, its
    node count, and the copies of the caller's state into the graph's
    buffers made before it (one device operation each)."""

    graph: str
    segments: tuple
    nodes: int
    copies: int


class Attributed(NamedTuple):
    """One replay's device time: ``us`` {span path: device us of its
    nodes}, and ``idle_us``, the time from its first node's start to its
    last node's end in which none of its nodes ran."""

    graph: str
    us: dict
    idle_us: float


SETUP: list = []
REPLAYS: collections.deque = collections.deque(maxlen=REPLAY_LOG)


class _Capture:
    """The node counts of a graph under capture, as spans open and close."""

    def __init__(self, stream: int, base: int):
        self.stream, self.base = stream, base
        self.segments: list = []
        self.nodes = 0

    def mark(self) -> None:
        """The nodes captured since the last mark belong to the path of the
        spans open now."""
        n = graph_nodes(self.stream)
        if n > self.nodes:
            path = "/".join(_STATE.stack[self.base:])
            if self.segments and self.segments[-1].path == path:
                last = self.segments.pop()
                self.segments.append(last._replace(nodes=last.nodes + n - self.nodes))
            else:
                self.segments.append(Segment(path, self.nodes, n - self.nodes))
            self.nodes = n


# stack: the names of the spans open, outermost first; setup: (graph,
# device) while a graph is set up; capture: a _Capture while one is
# captured; on: either of the two
_STATE = types.SimpleNamespace(stack=[], setup=None, capture=None, on=False)
_profiler = torch.autograd.profiler
_record = torch._C._profiler._RecordFunctionFast


def _refresh() -> None:
    _STATE.on = _STATE.setup is not None or _STATE.capture is not None


def _synchronize(device) -> None:
    """Wait for ``device`` (a CUDA one), also where the caller checks for
    synchronizing calls (``torch.cuda.set_sync_debug_mode``)."""
    if device.type != "cuda":
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        torch.cuda.synchronize(device)
    finally:
        torch.cuda.set_sync_debug_mode(mode)


class _Span:
    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name, self._rf, self._t0 = name, None, None

    def __enter__(self):
        if _STATE.capture is not None:
            _STATE.capture.mark()
        _STATE.stack.append(self.name)
        if _profiler._is_profiler_enabled:
            self._rf = _record(self.name)
            self._rf.__enter__()
        if _STATE.setup is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if _STATE.capture is not None:
            _STATE.capture.mark()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        if self._t0 is not None:
            graph, device = _STATE.setup
            if _STATE.capture is None:
                _synchronize(device)
            parent = _STATE.stack[-2] if len(_STATE.stack) > 1 else None
            SETUP.append(SetupSpan(self.name, parent, self._t0, time.perf_counter(), graph))
        _STATE.stack.pop()
        return False

    def replayed(self, graph: str, segments: tuple, nodes: int, copies: int) -> None:
        """Log a replay of ``graph`` made inside this span, while a
        profiler records."""
        if self._rf is not None:
            REPLAYS.append(Replay(graph, segments, nodes, copies))


class _Off:
    """A span with nothing in force."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def replayed(self, graph, segments, nodes, copies) -> None:
        pass


_OFF = _Off()


def span(name: str):
    """A span of the layer ``name`` (a context manager; see the module's
    note)."""
    if not (_STATE.on or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name)


def spanned(name: str):
    """Decorator: every call of the function is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return call
    return wrap


@contextlib.contextmanager
def setup(graph: str, device):
    """Within the block, graph ``graph`` on ``device`` is set up: spans
    keep ``SetupSpan`` records."""
    saved = _STATE.setup
    _STATE.setup = (graph, device)
    _refresh()
    try:
        yield
    finally:
        _STATE.setup = saved
        _refresh()


@contextlib.contextmanager
def capturing(stream: int):
    """Within the block, a CUDA graph is captured on ``stream`` (its
    handle): spans mark its node count.  Yields the recorder, whose
    ``segments`` (a list of ``Segment``) and ``nodes`` hold the graph's
    segment map when the block ends."""
    rec = _Capture(stream, len(_STATE.stack))
    _STATE.capture = rec
    _refresh()
    try:
        yield rec
        rec.mark()
    finally:
        _STATE.capture = None
        _refresh()


_LIBCUDA: dict = {}


def _libcuda() -> dict:
    """libcuda's capture-info and node-count calls (ctypes)."""
    if not _LIBCUDA:
        lib = ctypes.CDLL("libcuda.so.1")
        vp, out = ctypes.c_void_p, ctypes.POINTER
        for name, extra in (("cuStreamGetCaptureInfo_v3", 1), ("cuStreamGetCaptureInfo_v2", 0)):
            fn = getattr(lib, name, None)
            if fn is not None:
                # (stream, status, id, graph, dependencies, [edge data,] count)
                fn.argtypes = ([vp, out(ctypes.c_int), out(ctypes.c_uint64), out(vp), vp]
                               + [vp] * extra + [out(ctypes.c_size_t)])
                fn.restype = ctypes.c_int
                _LIBCUDA["info"], _LIBCUDA["extra"] = fn, extra
                break
        else:
            raise RuntimeError("libcuda.so.1 has no cuStreamGetCaptureInfo_v2 or _v3")
        lib.cuGraphGetNodes.argtypes = [vp, vp, out(ctypes.c_size_t)]
        lib.cuGraphGetNodes.restype = ctypes.c_int
        _LIBCUDA["nodes"] = lib.cuGraphGetNodes
    return _LIBCUDA


def graph_nodes(stream: int) -> int:
    """The node count of the graph under capture on ``stream`` (a
    ``cudaStream_t`` handle)."""
    d = _libcuda()
    status, graph, n = ctypes.c_int(0), ctypes.c_void_p(), ctypes.c_size_t(0)
    err = d["info"](stream, ctypes.byref(status), None, ctypes.byref(graph), None,
                    *([None] * d["extra"]), None)
    if err != 0 or status.value != 1:               # CU_STREAM_CAPTURE_STATUS_ACTIVE
        raise RuntimeError(f"cuStreamGetCaptureInfo: CUresult {err}, status {status.value}")
    err = d["nodes"](graph, None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes: CUresult {err}")
    return n.value


def _busy_us(rows: list) -> float:
    """The length of the union of the rows' intervals."""
    total, end = 0.0, None
    for _, s, e in sorted(rows, key=lambda r: r[1]):
        if end is None or s >= end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def attribute(rows: list, replays: list):
    """Device rows put down to span paths, replay by replay.

    ``rows``: the device rows ``(name, start us, end us)`` of a profiled
    window, in start order; ``replays``: the ``Replay`` entries logged for
    the window, in order.  Each replay's rows are its copies' rows, then
    one row a node in capture order.  Returns an ``Attributed`` for each
    replay, or None where the rows are not as many as the replays ran (the
    profiler drops rows at times): nothing is guessed."""
    if not replays or len(rows) != sum(r.copies + r.nodes for r in replays):
        return None
    out, i = [], 0
    for r in replays:
        i += r.copies
        nodes = rows[i:i + r.nodes]
        i += r.nodes
        us: dict = {}
        for seg in r.segments:
            part = nodes[seg.first:seg.first + seg.nodes]
            us[seg.path] = us.get(seg.path, 0.0) + sum(e - s for _, s, e in part)
        extent = max(e for _, _, e in nodes) - nodes[0][1] if nodes else 0.0
        out.append(Attributed(r.graph, us, extent - _busy_us(nodes)))
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
