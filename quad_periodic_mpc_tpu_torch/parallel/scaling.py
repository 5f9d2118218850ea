"""Scaling-efficiency harness and distributed bring-up
(counterpart of ``quad_periodic_mpc_tpu/parallel/scaling.py``).

Weak scaling: fix the per-device instance count, run the same batched step
on meshes of 1, 2, ..., N entries, and report throughput_k / (k *
throughput_1).  The chunks of a mesh run in lockstep (``mesh.run_lockstep``:
their threads take turns on the host, so the batch-global decisions are
the unsplit program's), and one process issues every chunk's work: on
one card ``measure_weak_scaling`` over a mesh gives about 1 / k.  It keeps
the reference's interface; the measurement across processes is
``parallel.dist_check --weak-scaling`` (rank 0 alone against all ranks at
once).
"""

from __future__ import annotations

import time
from typing import Callable

import torch
import torch.distributed as dist

from quad_periodic_mpc_tpu_torch.parallel import mesh as mesh_lib


def init_distributed(init_method: str | None = None, world_size: int | None = None,
                     rank: int | None = None, device="cuda") -> None:
    """``torch.distributed`` process group of this rank: NCCL for a CUDA
    device (made the current one first), Gloo for the CPU.  With no
    init_method the group reads torch's environment variables (MASTER_ADDR,
    WORLD_SIZE, RANK)."""
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {} if init_method is None else dict(
        init_method=init_method, world_size=world_size, rank=rank)
    dist.init_process_group(backend=backend, **kw)


def fence(mesh: mesh_lib.Mesh) -> None:
    """Wait for every CUDA device of the mesh (nothing to wait for on the CPU)."""
    for d in {d for d in mesh.devices if d.type == "cuda"}:
        torch.cuda.synchronize(d)


def measure_weak_scaling(
    make_inputs: Callable[[int], tuple],
    step: Callable,
    per_device: int,
    device_counts: list[int] | None = None,
    reps: int = 5,
    devices=None,
) -> dict:
    """Weak-scaling sweep over meshes of the first k of ``devices`` (default:
    every CUDA device).

    make_inputs(batch) -> tuple of batched inputs, split over the mesh by
    their leading axis; step(*inputs) runs on each chunk.  Returns
    {k: {"throughput": instances/s, "efficiency": r}}."""
    full = mesh_lib.make_mesh(devices=devices)
    device_counts = device_counts or [k for k in (1, 2, 4, 8, 16, 32) if k <= full.size]
    results, base = {}, None
    for k in device_counts:
        mesh = mesh_lib.make_mesh(k, full.devices)
        batch = per_device * k
        chunks = mesh_lib.shard_batch(make_inputs(batch), mesh, batch)

        def run():
            return mesh_lib.run_lockstep(lambda c: step(*c), chunks, mesh)

        run()
        fence(mesh)
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        fence(mesh)
        dt = (time.perf_counter() - t0) / reps
        thr = batch / dt
        if base is None:
            base = thr / k            # per-device throughput at the first count
        results[k] = {"throughput": thr, "efficiency": (thr / k) / base}
    return results
