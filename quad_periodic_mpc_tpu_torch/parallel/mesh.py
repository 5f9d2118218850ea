"""Device lists and batch splitting
(counterpart of ``quad_periodic_mpc_tpu/parallel/mesh.py``).

The reference shards the instance batch over a 1-D device mesh and lets
XLA's SPMD partitioner run one global program.  Here a ``Mesh`` is a list
of devices (the same device may appear more than once), ``shard_batch``
cuts the batch into one chunk per entry, ``run_lockstep`` runs the chunks at
once, one thread per entry on its entry's device and a stream of its own,
and ``gather`` puts the per-instance results back in global order.  The
threads form a ``batch_group``, through which the decisions that the
reference takes over its global batch (the Newton-Schulz inverses') are
taken over every chunk: a split run is the unsplit program.

Splitting a leaf changes what each chunk computes, so only the leaves whose
leading axis is the batch are split, the batch size being passed
explicitly; every other leaf (0-dim tensors, a gait table shared by the
batch, a map's resolution) is copied whole to each entry.  A shared leaf
whose leading axis happens to equal the batch goes through ``replicated``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, NamedTuple

import torch

from quad_periodic_mpc_tpu_torch.parallel import batch_group


class Mesh(NamedTuple):
    """A 1-D list of devices; chunk i of a split batch runs on devices[i]."""

    devices: tuple
    size: int


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh over the first n of ``devices`` (default: every CUDA device)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = tuple(torch.device(d) for d in devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("make_mesh: no device (no CUDA device, and none given)")
    return Mesh(devices=devs, size=len(devs))


def tree_map(fn, tree: Any) -> Any:
    """fn applied to every tensor of a tree of NamedTuples, tuples, lists and
    dicts; other leaves (None, Python numbers, strings) are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def _leaves(tree: Any) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def shard_batch(tree: Any, mesh: Mesh, batch: int) -> list:
    """One tree per mesh entry: each tensor whose leading axis has length
    ``batch`` is cut along it into mesh.size contiguous chunks (sizes differ
    by at most one, in order), every other leaf is copied whole; each chunk
    on its entry's device."""
    if batch < mesh.size:
        raise ValueError(f"shard_batch: a batch of {batch} cannot fill {mesh.size} devices")

    def piece(i):
        def place(x):
            if x.dim() > 0 and x.shape[0] == batch:
                x = torch.tensor_split(x, mesh.size)[i]
            return x.to(mesh.devices[i])
        return place

    return [tree_map(piece(i), tree) for i in range(mesh.size)]


def replicated(tree: Any, mesh: Mesh) -> list:
    """The same tree on each mesh entry's device."""
    return [tree_map(lambda x, d=d: x.to(d), tree) for d in mesh.devices]


def gather(chunks: list, device) -> Any:
    """Per-instance results of the chunks -> one tree on ``device``, each
    tensor concatenated along its leading axis in chunk (global) order."""
    device = torch.device(device)
    columns = [_leaves(c) for c in chunks]
    merged = iter([torch.cat([col[j].to(device) for col in columns])
                   for j in range(len(columns[0]))])
    return tree_map(lambda _: next(merged), chunks[0])


def round_up_batch(n: int, mesh: Mesh) -> int:
    """Pad a batch size to a multiple of the mesh size."""
    m = mesh.size
    return ((n + m - 1) // m) * m


def run_lockstep(fn: Callable, chunks: list, mesh: Mesh,
                 group: batch_group.Threads | None = None) -> list:
    """[fn(chunk) for each chunk], chunk i on mesh.devices[i], in lockstep:
    one thread per chunk, member i of ``group`` (default: a
    ``batch_group.Threads`` of the chunks; one chunk and no group runs in
    the calling thread), the threads taking turns between the group's
    exchanges.  On a CUDA entry the thread makes its device current and
    runs on a stream of its own, which first waits for the caller's stream
    and is synchronised before the thread ends.  A raise in any chunk breaks
    the group, so the others raise too; the first raise that is not the
    group's is re-raised here."""
    if len(chunks) != mesh.size:
        raise ValueError(f"run_lockstep: {len(chunks)} chunks for {mesh.size} entries")
    if group is None:
        if mesh.size == 1:
            return [fn(chunks[0])]
        group = batch_group.Threads(mesh.size)
    callers = {d: torch.cuda.current_stream(d) for d in set(mesh.devices) if d.type == "cuda"}
    results: list = [None] * mesh.size
    errors: list = [None] * mesh.size

    def work(i: int) -> None:
        device = mesh.devices[i]
        try:
            with batch_group.joined(group, i):
                if device.type != "cuda":
                    results[i] = fn(chunks[i])
                    return
                torch.cuda.set_device(device)
                stream = torch.cuda.Stream(device)
                stream.wait_stream(callers[device])
                with torch.cuda.stream(stream):
                    results[i] = fn(chunks[i])
            stream.synchronize()
        except BaseException as e:      # re-raised in the calling thread
            errors[i] = e

    threads = [threading.Thread(target=work, args=(i,), name=f"lockstep-{i}")
               for i in range(mesh.size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    raised = [e for e in errors if e is not None]
    if raised:
        first = [e for e in raised if not isinstance(e, batch_group.GroupError)]
        raise (first or raised)[0]
    return results
