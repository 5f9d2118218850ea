"""Batch-global decisions over a split batch: the port's counterpart of the
global batch axis that XLA's partitioner sees.

The reference runs its sweep over a mesh, and its ranks, as one program
over the global batch, so a decision over the batch (the Newton-Schulz
inverses' trip count, escalated set and branch, ``ops/linalg.py``) is taken
over every instance however the batch is split.  Here a split batch is
rolled out as chunks, and the chunks of one batch form a *batch group*:

- ``LOCAL``: one chunk, the whole batch (the identity);
- ``Threads(n)``: the n entries of an in-process mesh, one thread each
  (``mesh.run_lockstep``), taking turns between exchanges;
- ``Ranks(n)``: the ranks of the default ``torch.distributed`` process
  group, with n threads inside each rank; the rank's first thread runs
  ``all_gather`` for the rank.

Global order is member after member (rank after rank, then thread after
thread), and row-major inside a member's flat batch.  A member offers the
global vector of a per-instance tensor with its offset in it (``gather``),
and a ``sum`` and an ``all`` of host numbers.  ``current()`` is the member of
the calling thread (``LOCAL`` outside ``joined``), so that the functions
between a rollout and ``linalg`` take no group parameter.

Every member runs the same program and so reaches the exchanges in the same
order.  Each exchange carries a tag (its call site) and a count, and a
mismatch raises ``GroupError`` in every member.  A member that raises or
leaves breaks the group, so that the others raise instead of waiting, and a
wait whose turn is held by a member that is not running (it never joined, or
its thread ended without leaving) breaks it after ``TIMEOUT_S``.  Decisions
are host values (the callers read them back already): threads exchange host
tensors, and ranks move them through the group's backend (NCCL on the card,
Gloo on the CPU).
"""

from __future__ import annotations

import threading

import torch
import torch.distributed as dist

# seconds a wait lets the turn stand still before it asks whether the
# member holding it is still running (a running member is never timed out:
# a stagewise chunk makes no exchange and may run for many minutes)
TIMEOUT_S = 60.0


class GroupError(RuntimeError):
    """A batch group broke: a member raised, left, held the turn without
    running, or reached another exchange than the others."""


class _Local:
    """The whole batch in one chunk: every decision over it alone."""

    def gather(self, tag: str, x: torch.Tensor) -> tuple[torch.Tensor, int]:
        return x, 0

    def sum(self, tag: str, value):
        return value

    def all(self, tag: str, flag: bool) -> bool:
        return bool(flag)


LOCAL = _Local()


class _Member:
    """Member ``index`` of a group, as the decisions see it."""

    def __init__(self, group: "Threads", index: int):
        self.group, self.index = group, index
        self._count = 0

    def _exchange(self, tag: str, payload) -> list:
        count, self._count = self._count, self._count + 1
        return self.group._exchange(self.index, tag, count, payload)

    def gather(self, tag: str, x: torch.Tensor) -> tuple[torch.Tensor, int]:
        """(the members' 1-D ``x`` concatenated in global order, on the host;
        this member's offset in it)."""
        parts = self._exchange(tag, x.reshape(-1).cpu())
        offset = sum(p.shape[0] for p in parts[: self.group.position(self.index)])
        return torch.cat(parts), offset

    def sum(self, tag: str, value):
        return sum(self._exchange(tag, value))

    def all(self, tag: str, flag: bool) -> bool:
        return all(self._exchange(tag, bool(flag)))


class Threads:
    """The ``size`` threads of one process as one batch group.  They take
    turns: member 0 runs until its next exchange or its end, then member 1,
    and so on; the exchange completes when all have arrived, and member 0
    goes on first.  One thread runs at a time, so the threads do not contend
    for the interpreter lock (which, with the thousands of small operations
    of a rollout, made free-running threads several times slower than one
    thread on the CPU), and a chunk's kernels queued on its stream run while
    the next chunk's thread issues its own.  A member that raises, leaves
    while others still exchange, or reaches another exchange breaks the
    group at once for every other; so does a member that holds the turn
    without running: its thread never joined, or ended without leaving
    (checked each ``TIMEOUT_S`` that the turn stands still)."""

    def __init__(self, size: int):
        self.size = size
        self._cond = threading.Condition()
        self._threads: list[threading.Thread | None] = [None] * size
        self._turn = self._moves = self._arrived = self._generation = self._left = 0
        self._broken: str | None = None
        # two sets of slots: a member writes exchange c + 2 only after every
        # member has arrived at exchange c + 1, so after all have read c
        self._slots: list[list] = [[None] * size, [None] * size]

    def member(self, index: int) -> _Member:
        return _Member(self, index)

    def position(self, index: int) -> int:
        """Member ``index``'s place in the global order."""
        return index

    def start(self, index: int) -> None:
        """Wait for the member's first turn."""
        with self._cond:
            self._threads[index] = threading.current_thread()
            self._wait_for(lambda: self._turn == index)

    def abort(self, why: str) -> None:
        with self._cond:
            if self._broken is None:
                self._broken = why
            self._cond.notify_all()

    def leave(self, index: int) -> None:
        """The member finished: the turn passes on, and an exchange still
        waiting, or to come, can never complete."""
        with self._cond:
            self._left += 1
            if self._arrived and self._broken is None:
                self._broken = "a member left while others still exchange"
            self._pass(index)

    def _exchange(self, index: int, tag: str, count: int, payload) -> list:
        """Deposit the member's part, pass the turn on, and return every
        member's part when all have arrived and the turn is back here."""
        slots = self._slots[count % 2]
        slots[index] = (tag, count, payload)
        with self._cond:
            if self._broken is None and self._left:
                self._broken = "a member left while others still exchange"
            if self._broken is not None:
                self._cond.notify_all()
                raise GroupError(self._broken)
            gen = self._generation
            self._arrived += 1
            if self._arrived == self.size:
                self._arrived, self._generation = 0, gen + 1
            self._pass(index)
            self._wait_for(lambda: self._generation != gen and self._turn == index)
        seen = {(t, c) for t, c, _ in slots}
        if seen != {(tag, count)}:
            raise GroupError(f"members at different exchanges: {sorted(seen)}")
        return [p for _, _, p in slots]

    def _pass(self, index: int) -> None:
        self._turn = (index + 1) % self.size
        self._moves += 1
        self._cond.notify_all()

    def _wait_for(self, ready) -> None:
        while not ready() and self._broken is None:
            moves = self._moves
            if not self._cond.wait(TIMEOUT_S) and self._moves == moves:
                holder = self._threads[self._turn]
                if holder is None or not holder.is_alive():
                    self._broken = f"member {self._turn} holds the turn and is not running"
                    self._cond.notify_all()
        if self._broken is not None and not ready():
            raise GroupError(self._broken)


def _device() -> torch.device:
    """The device the default process group's collectives take."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _tag_key(tag: str) -> int:
    """A number for a tag, the same in every process (str's hash is not),
    exact in float64."""
    key = 0
    for b in tag.encode():
        key = (key * 131 + b) % (1 << 40)
    return key


def _all_gather(x: torch.Tensor) -> torch.Tensor:
    """The ranks' ``x`` stacked in rank order, on the host."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    return torch.stack(parts).cpu()


class Ranks(Threads):
    """The ranks of the default process group, ``size`` threads in each (the
    same in every rank), as one batch group.  A rank's threads exchange
    first; its first thread then runs the rank's ``all_gather`` (each
    carries the exchange's tag and count) and hands the result to the
    others.  ``collectives`` counts the all_gathers this rank made."""

    def __init__(self, size: int = 1):
        if not dist.is_initialized():
            raise GroupError("Ranks: no torch.distributed process group")
        super().__init__(size)
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.collectives = 0
        self._result = None

    def position(self, index: int) -> int:
        return self.rank * self.size + index

    def _exchange(self, index: int, tag: str, count: int, payload) -> list:
        parts = super()._exchange(index, tag, count, payload)
        # thread 0 has the first turn after an exchange, and the others read
        # its result before they reach the next one
        if index == 0:
            self._result = self._across_ranks(tag, count, parts)
        return self._result

    def _across_ranks(self, tag: str, count: int, parts: list) -> list:
        """Every rank's thread parts, in global order: one all_gather of the
        parts' sizes (or host numbers) with the tag and count, and for
        tensors one of the values, padded to the longest rank's."""
        dev, n = _device(), self.size
        tensors = isinstance(parts[0], torch.Tensor)
        head = [p.shape[0] for p in parts] if tensors else [float(p) for p in parts]
        key = [_tag_key(tag), count]
        heads = _all_gather(torch.tensor(head + key, dtype=torch.float64, device=dev))
        self.collectives += 1
        if not bool((heads[:, n:] == torch.tensor(key, dtype=torch.float64)).all()):
            raise GroupError(f"ranks at different exchanges at {tag!r} #{count}: "
                             f"{heads[:, n:].tolist()}")
        if not tensors:
            kind = type(parts[0])
            return [kind(v) for v in heads[:, :n].reshape(-1).tolist()]
        sizes = heads[:, :n].long()
        flat = torch.cat(parts)
        buf = flat.new_zeros(int(sizes.sum(1).max()))
        buf[: flat.shape[0]] = flat
        values = _all_gather(buf.to(dev))
        self.collectives += 1
        return [v for r in range(self.world)
                for v in values[r, : int(sizes[r].sum())].split(sizes[r].tolist())]


_current = threading.local()


def current():
    """The calling thread's group member (``LOCAL`` outside ``joined``)."""
    return getattr(_current, "member", LOCAL)


class joined:
    """``with joined(group, i):`` the calling thread is member i of
    ``group`` from its first turn until the block ends: on a normal end it
    leaves the group, on a raise it breaks it, so that no other member
    waits for it."""

    def __init__(self, group: Threads, index: int):
        self.group, self.index = group, index

    def __enter__(self):
        self.group.start(self.index)
        self._outer = current()
        _current.member = self.group.member(self.index)
        return _current.member

    def __exit__(self, kind, err, tb):
        _current.member = self._outer
        if kind is None:
            self.group.leave(self.index)
        else:
            self.group.abort(f"member {self.index} raised {err!r}")
        return False
