"""Multi-process exercise of the sweep (counterpart of
``quad_periodic_mpc_tpu/parallel/dist_check.py``).

Runs one Monte-Carlo sweep rollout across ``torch.distributed`` ranks: each
rank builds the global scenarios, keeps its slice [rank B/N, (rank+1) B/N)
of the batch, splits that slice over ``--local-devices`` chunks, rolls them
out in lockstep (``mesh.run_lockstep``), and all-gathers the per-instance
tracking errors and final states.  Every rank then computes the mean, the
argmin and the checksum from the gathered tensors in global order, so the
ranks agree bit for bit.  The JSON line also carries the per-instance
errors (``vx_rms``, in global order), so that an argmin can be compared
under a tie rule.

The chunks of every rank form one ``batch_group.Ranks`` group, so the
batch-global decisions of the Newton-Schulz inverses (``ops/linalg.py``)
are taken over the whole batch, as the reference's one program over its
global arrays takes them.  They go through the default process group (NCCL
on the card, Gloo on the CPU): per MPC step of the condensed ADMM, one
gather of the B seed residuals (two all_gathers: the chunks' sizes with the
exchange's tag and count, then the values).  Their count goes to stderr.
Without a process group the chunks form a ``batch_group.Threads`` group.

One rank per process (NCCL on CUDA, Gloo on the CPU):

    python -m quad_periodic_mpc_tpu_torch.parallel.dist_check \\
        --init-method tcp://127.0.0.1:12356 --world-size 2 --rank 0 --device cpu

With no --init-method it runs as one process: the oracle the ranks are held
to.  Under a process group the all-gather runs even at world size 1.
--weak-scaling adds the time of one MPC step on rank 0 alone and on every
rank at once.  Prints one JSON line with the reduced metrics.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
import torch.distributed as dist

from quad_periodic_mpc_tpu_torch.config import (
    ADMMConfig, EstimatorConfig, LoopConfig, MPCConfig,
)
from quad_periodic_mpc_tpu_torch.control import loop as loop_mod
from quad_periodic_mpc_tpu_torch.control import mpc as mpc_mod
from quad_periodic_mpc_tpu_torch.parallel import batch_group
from quad_periodic_mpc_tpu_torch.parallel import mesh as mesh_lib
from quad_periodic_mpc_tpu_torch.parallel import sweep as sweep_lib
from quad_periodic_mpc_tpu_torch.parallel.scaling import fence, init_distributed
from quad_periodic_mpc_tpu_torch.sim import srb_sim

MPC_CFG = MPCConfig(horizon=5)
SOLVER = ADMMConfig(iterations=30)


def _inputs(spec, batch, dtype, device):
    """(plant, ctrl, cmd, gait, dist) of the spec's scenarios, walking at 0.3 m/s."""
    gait, iters, dist_p, _ = sweep_lib.build_scenarios(spec, dtype, device)
    plant = srb_sim.init_plant((batch,), body_height=0.29, dtype=dtype, device=device)
    ctrl = mpc_mod.init_state((batch,), srb_sim.observe(plant), dtype=dtype,
                              horizon=MPC_CFG.horizon)
    ctrl = ctrl._replace(iteration=iters)
    f = lambda v: torch.full((batch,), v, dtype=dtype, device=device)
    cmd = mpc_mod.Command(vx=f(0.3), vy=f(0.0), yaw_rate=f(0.0), body_height=f(0.29))
    return plant, ctrl, cmd, gait, dist_p


def _all_gather(x: torch.Tensor, world: int) -> torch.Tensor:
    """The ranks' tensors concatenated in rank order; the collective runs
    whenever a process group exists, a group of one rank included."""
    if not dist.is_initialized():
        return x
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x.contiguous())
    print(f"dist_check: all_gather of {tuple(x.shape)} over {world} rank(s), backend "
          f"{dist.get_backend()}", file=sys.stderr, flush=True)
    return torch.cat(parts)


def _weak_scaling(args, device, dtype, world: int, rank: int, reps: int = 3) -> dict:
    """Weak scaling across the ranks: one MPC step of 4 instances per local
    chunk on every rank (the chunks in lockstep), timed on rank 0 alone (its
    chunks their own batch group; the others wait at a barrier) and then on
    all ranks at once (one group over the ranks).  Keyed by the global chunk
    count; efficiency = throughput_N / (world * throughput_1)."""
    batch = 4 * args.local_devices
    spec = sweep_lib.SweepSpec(gait_names=("trotting",), phase_offsets=batch)
    plant, ctrl, cmd, gait, _ = _inputs(spec, batch, dtype, device)
    mesh = mesh_lib.make_mesh(devices=[device] * args.local_devices)
    chunks = mesh_lib.shard_batch((ctrl, srb_sim.observe(plant), cmd, gait, plant.t),
                                  mesh, batch)

    def step(chunk):
        return mpc_mod.mpc_step(*chunk, MPC_CFG, LoopConfig(), EstimatorConfig(), SOLVER)

    def run(across_ranks: bool) -> float:
        fence(mesh)
        t0 = time.perf_counter()
        for _ in range(reps):
            group = (batch_group.Ranks if across_ranks else batch_group.Threads)(mesh.size)
            mesh_lib.run_lockstep(step, chunks, mesh, group)
        fence(mesh)
        return (time.perf_counter() - t0) / reps

    run(False)                                  # warm-up
    grouped = dist.is_initialized()
    alone = torch.zeros(1, dtype=torch.float64, device=device)
    if grouped:
        dist.barrier()
    if rank == 0:
        alone[0] = run(False)
    if grouped:
        dist.broadcast(alone, 0)
    thr_1 = batch / float(alone[0])
    rec = {str(args.local_devices): {"throughput": thr_1, "efficiency": 1.0}}
    if world > 1:
        dist.barrier()
        together = torch.tensor([run(True)], dtype=torch.float64, device=device)
        dist.all_reduce(together, op=dist.ReduceOp.MAX)
        thr_n = world * batch / float(together[0])
        rec[str(world * args.local_devices)] = {"throughput": thr_n,
                                                "efficiency": thr_n / (world * thr_1)}
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--init-method", default="",
                    help="torch.distributed init method, e.g. tcp://127.0.0.1:12356; "
                         "empty: one process (the oracle)")
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--local-devices", type=int, default=4,
                    help="chunks this rank splits its slice of the batch into")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card rank %% count) or cpu")
    ap.add_argument("--weak-scaling", action="store_true",
                    help="also time one MPC step on rank 0 alone and on all ranks at once")
    args = ap.parse_args(argv)

    world, rank = (args.world_size, args.rank) if args.init_method else (1, 0)
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    B = args.batch
    if B % (world * args.local_devices) or B % 2:
        raise SystemExit(f"dist_check: --batch {B} must be even and a multiple of "
                         f"world size x local devices = {world * args.local_devices}")
    if args.init_method:
        init_distributed(args.init_method, world, rank, device)
    try:
        dtype = torch.float32
        spec = sweep_lib.SweepSpec(gait_names=("trotting", "bounding"), phase_offsets=B // 2)
        tree = _inputs(spec, B, dtype, device)
        n_local = B // world
        local = mesh_lib.shard_batch(tree, mesh_lib.make_mesh(devices=[device] * world), B)[rank]
        mesh = mesh_lib.make_mesh(devices=[device] * args.local_devices)

        def rollout(chunk):
            plant, ctrl, cmd, gait, dist_p = chunk
            _, trace = loop_mod.rollout(args.steps, plant, ctrl, cmd, gait, dist_p, MPC_CFG,
                                        LoopConfig(), EstimatorConfig(), SOLVER)
            vx_rms = torch.sqrt(torch.mean((trace.x[..., 9] - cmd.vx[..., None]) ** 2, -1))
            return vx_rms, trace.x[..., -1, :12]

        group = (batch_group.Ranks if args.init_method else batch_group.Threads)(mesh.size)
        per_chunk = mesh_lib.run_lockstep(rollout, mesh_lib.shard_batch(local, mesh, n_local),
                                          mesh, group)
        if args.init_method:
            print(f"dist_check: {group.collectives} decision collectives (all_gather) over "
                  f"{world} rank(s), backend {dist.get_backend()}", file=sys.stderr, flush=True)
        vx_rms, final = (_all_gather(t, world) for t in mesh_lib.gather(per_chunk, device))
        result = {
            "process_id": rank,
            "num_processes": world,
            "global_devices": world * args.local_devices,
            "local_devices": args.local_devices,
            "mean_vx_rms": float(torch.mean(vx_rms)),
            "best_instance": int(torch.argmin(vx_rms)),
            "checksum": float(torch.sum(final)),
            "vx_rms": vx_rms.tolist(),
        }
        if args.weak_scaling:
            result["weak_scaling"] = _weak_scaling(args, device, dtype, world, rank)
    finally:
        if args.init_method:
            dist.destroy_process_group()
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
