"""CUDA graphs: the port's counterpart of the JAX package's jitted period
and tick.

JAX traces ``loop.rollout``'s period (its ``mpc_period``) and the
full-stack tick once and runs each as one compiled program.  The port runs
the same Python eagerly, one launch per PyTorch op (thousands a period),
and its host cannot issue them as fast as the card runs them.
``capture(step, *state)`` gives a callable that, after a few eager
warm-up calls, records one run of ``step`` in a CUDA graph and from then
on replays every launch of that run with one call.

``step(*state)`` takes the state as trees of tensors (the port's
NamedTuple states, walked by ``utils/telemetry.leaves`` / ``unflatten``)
and returns a tuple whose first ``len(state)`` entries are the new state,
in the same structure, shapes and dtypes, and whose further entries (if
any) are extra outputs, such as a period's trace.  The graph's state
lives in buffers of its own: the capture copies the new state back into
them as its last launches, so each replay advances the state in place and
a rollout of replays makes no host copy.

Rules the step must keep, which a capture enforces where it can:

- the same launches on every call: no Python branch on a tensor's value
  (a device-side select in its place), no host read (``.item()``,
  ``bool(t)``, boolean-mask indexing, ``nonzero``), no copy of host data
  to the card (constants through ``utils/consts.const``).  The first
  call runs the step eagerly under ``torch.cuda.set_sync_debug_mode(
  "error")``, so a synchronising call raises there, naming its line,
  before any capture;
- no write into its input state: the capture runs it on the graph's
  buffers and writes the new state back at the end;
- a value that changes between replays is a tensor read on the device
  (the tunables, the maps): ``.copy_()`` into it before a replay, and the
  replay reads it.  A Python value (a config field, a shape) is frozen
  into the graph; a change of it, or of a state's shape, needs a new
  capture.

The kernel wrappers count their launches in Python, which a replay does
not run.  The capture's change of the counts is taken back out (a capture
launches nothing) and every replay adds it again, so the counts say what
the card ran; the eager warm-up calls are real launches and stay counted.

Each graph has a name (``capture``'s ``name``, by default the step's
qualified name), under which its set-up is recorded.  The warm-up calls
and the capture are spans of ``utils/telemetry`` in set-up mode
(``graphs.warmup``, ``graphs.capture``), and the capture builds the
graph's segment map from the spans inside the step (``segments``), the
state's write-back being ``graphs.writeback``.  A replay is the span
``graphs.replay`` (the copy-in, the replay and the launch accounting),
which is in force only while a profiler records, and then logs the
replay (``telemetry.REPLAYS``).

On CPU tensors ``capture`` returns ``step`` itself: the caller chose the
CPU, as the kernel wrappers take their plain versions there.  On CUDA
tensors a capture that fails raises; nothing reruns the step eagerly.
"""

from __future__ import annotations

import torch

from quad_periodic_mpc_tpu_torch.ops.cuda import (
    admm_kernel, kf_kernel, kinematics_kernel, plant_kernel, stagewise_kernel, wbc_kernel,
)
from quad_periodic_mpc_tpu_torch.utils import telemetry
from quad_periodic_mpc_tpu_torch.utils.telemetry import leaves, unflatten

WARMUP = 2
# every kernel wrapper's launch count: a module's LAUNCHES is a dict by
# kernel name, or the one number of the kernel named here
_COUNTED = ((stagewise_kernel, None), (kinematics_kernel, None), (wbc_kernel, "fused_wbc"),
            (plant_kernel, "fused_substeps"), (kf_kernel, "fused_kf_innovate"),
            (admm_kernel, "fused_admm_iterations"))


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    counts = {}
    for mod, name in _COUNTED:
        counts.update(mod.LAUNCHES if name is None else {name: mod.LAUNCHES})
    return counts


def launch_delta(before: dict, after: dict) -> dict:
    """The counts that changed from ``before`` to ``after``, by kernel."""
    return {k: n - before[k] for k, n in after.items() if n != before[k]}


def add_launches(delta: dict, times: int = 1) -> None:
    """Add ``times`` x ``delta`` to the wrappers' counts."""
    for mod, name in _COUNTED:
        if name is None:
            for k in mod.LAUNCHES.keys() & delta.keys():
                mod.LAUNCHES[k] += times * delta[k]
        elif name in delta:
            mod.LAUNCHES += times * delta[name]


def reset_launches() -> None:
    """Every kernel wrapper's launch count set to 0."""
    add_launches(launch_counts(), -1)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class Graphed:
    """A step replayed from a CUDA graph (made by ``capture``).

    ``graphed(*state)`` runs the step on ``state``.  The first ``WARMUP``
    calls run it eagerly on a side stream (as ``torch.cuda.graphs`` asks),
    the first of them under ``torch.cuda.set_sync_debug_mode("error")``:
    they build and load the kernels, fill the constant cache and let the
    libraries set up their handles and plans, and their results are the
    step's own, so a rollout's first periods are these calls.  The next
    call captures the step in a graph over buffers of its own, and it and
    every later call replay it: each copies the caller's state into the
    buffers where the caller passes other storage (passing back what the
    last call returned copies nothing), replays the graph, adds the
    replayed launches to the wrappers' counts, and returns the step's
    outputs: the state as the graph's buffers, then the extra outputs.
    These are the same tensors on every replay: the next replay overwrites
    them, so clone what must outlive it.

    ``segments`` is the graph's segment map (``telemetry.Segment``s, in
    node order) and ``nodes`` its node count, from the capture on."""

    def __init__(self, step, static: tuple, pool, name: str | None = None):
        self._step, self.pool, self.name = step, pool, name or _qualname(step)
        self._state = static
        self._static = leaves(static)
        self._device = self._static[0].device
        self._calls = 0
        self.graph = None
        self.launches: dict = {}
        self.segments: tuple = ()
        self.nodes = 0
        self._out: tuple = ()

    def _check(self, given: list) -> None:
        if len(given) != len(self._static):
            raise ValueError(f"{len(given)} state tensors for {len(self._static)}")
        for i, (x, s) in enumerate(zip(given, self._static)):
            if x.shape != s.shape or x.dtype != s.dtype or x.device != s.device:
                raise ValueError(f"state tensor {i}: {x.dtype} {tuple(x.shape)} on {x.device} "
                                 f"for {s.dtype} {tuple(s.shape)} on {s.device}: a new "
                                 "shape needs a new capture")

    def _warm(self, state: tuple):
        current = torch.cuda.current_stream(self._device)
        side = torch.cuda.Stream(self._device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            if self._calls == 0:
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = self._step(*state)
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
            else:
                out = self._step(*state)
        current.wait_stream(side)
        return out

    def _capture(self) -> None:
        state, n = self._state, len(self._state)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            stream = torch.cuda.current_stream(self._device).cuda_stream
            with telemetry.capturing(stream) as nodes:
                out = self._step(*state)
                new = leaves(out[:n])
                self._check(new)
                with telemetry.span("graphs.writeback"):
                    # an output that is (a view of) a state buffer is copied
                    # out before the state is written back
                    held = {_storage(s) for s in self._static}
                    own = lambda x: x.clone() if _storage(x) in held else x
                    new = [x if x is s else own(x) for x, s in zip(new, self._static)]
                    extra = [own(x) for x in leaves(out[n:])]
                    for x, s in zip(new, self._static):
                        if x is not s:
                            s.copy_(x)
        self.launches = launch_delta(before, launch_counts())
        add_launches(self.launches, -1)
        self.graph = graph
        self.segments, self.nodes = tuple(nodes.segments), nodes.nodes
        self._out = (*state, *unflatten(tuple(out[n:]), extra))

    def __call__(self, *state):
        given = leaves(state)
        self._check(given)
        if self._calls < WARMUP:
            with telemetry.setup(self.name, self._device), telemetry.span("graphs.warmup"):
                out = self._warm(state)
            self._calls += 1
            return out
        if self.graph is None:
            with telemetry.setup(self.name, self._device), telemetry.span("graphs.capture"):
                self._capture()
        with telemetry.span("graphs.replay") as replay:
            copies = 0
            for x, s in zip(given, self._static):
                if x.data_ptr() != s.data_ptr():
                    s.copy_(x)
                    copies += 1
            self.graph.replay()
            add_launches(self.launches)
            replay.replayed(self.name, self.segments, self.nodes, copies)
        return self._out

    def also(self, step, name: str | None = None) -> "Graphed":
        """``step`` over this graph's state buffers and in its memory pool:
        graphs called in turn (the MPC tick and the plain tick) then hand
        each other the state with no copy.  Call them one at a time.
        ``name`` as ``capture``'s."""
        return Graphed(step, self._state, self.pool, name)


def _qualname(step) -> str:
    return getattr(step, "__qualname__", type(step).__qualname__)


def capture(step, *state, name: str | None = None):
    """``step`` (see the module's note) as a ``Graphed`` for CUDA tensors,
    which runs its first ``WARMUP`` calls eagerly and captures on the next;
    ``step`` itself for CPU tensors.  ``state`` gives the
    structure, shapes and dtypes of the graph's state buffers, which are
    its own; every call passes the state it runs on.  ``name`` names the
    graph in its set-up records and replay log (default: the step's
    qualified name)."""
    tensors = leaves(state)
    if not tensors or not all(isinstance(t, torch.Tensor) for t in tensors):
        raise TypeError("the state must be trees of tensors")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"the state lies on several devices: {sorted(map(str, devices))}")
    if tensors[0].device.type != "cuda":
        return step
    static = unflatten(state, [torch.empty_like(t, memory_format=torch.contiguous_format)
                               for t in tensors])
    return Graphed(step, tuple(static), torch.cuda.graph_pool_handle(), name)
