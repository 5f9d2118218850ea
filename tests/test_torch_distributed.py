"""Two ``torch.distributed`` ranks of the port's sweep (Gloo on the CPU),
the counterpart of tests/test_distributed.py: each rank rolls out its half
of a 16-instance sweep split over four local chunks, the per-instance
results are all-gathered, and both ranks reduce them in global order.  The
ranks must agree exactly, and with the single-process oracle per instance
within 1e-6: the ranks take the Newton-Schulz bucket's decisions over the
whole batch through Gloo, as the oracle's four chunks take them over
theirs, and the gap left is that of chunks of two instances against chunks
of four (tests/test_torch_parallel.py's SPLIT_ATOL); the oracle is held to
JAX's dist_check run as one process."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

from quad_periodic_mpc_tpu_torch.parallel import sweep as t_sweep

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 240
MODULE = "quad_periodic_mpc_tpu_torch.parallel.dist_check"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    # python -m from the repository's root finds the package; one intra-op thread
    return {**os.environ, "OMP_NUM_THREADS": "1"}


def _last_json(out: str) -> dict:
    return json.loads([line for line in out.splitlines() if line.startswith("{")][-1])


def _run(args):
    p = subprocess.run([sys.executable, "-m", MODULE, "--device", "cpu", *args],
                       capture_output=True, text=True, timeout=TIMEOUT, cwd=REPO, env=_env())
    assert p.returncode == 0, p.stderr[-3000:]
    return _last_json(p.stdout)


def _spawn_two(extra=(), stderr=None):
    """Both ranks' JSON; a rank that fails or hangs kills the other.  With
    ``stderr`` a list, the ranks' stderr is appended to it."""
    init = f"tcp://127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", MODULE, "--device", "cpu", "--init-method", init,
         "--world-size", "2", "--rank", str(r), *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO, env=_env())
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    if stderr is not None:
        stderr.extend(err for _, err in outs)
    return [_last_json(out) for out, _ in outs]


def test_two_process_split_sweep_matches_single_process():
    errs = []
    r0, r1 = _spawn_two(stderr=errs)
    # the decisions went through the process group: one gather (two
    # all_gathers) per MPC step, 4 steps
    for err in errs:
        assert "dist_check: 8 decision collectives (all_gather) over 2 rank(s), backend gloo" \
            in err, err[-3000:]
    assert r0["global_devices"] == 8 and r0["local_devices"] == 4
    assert (r0["process_id"], r1["process_id"]) == (0, 1)
    assert r0["num_processes"] == r1["num_processes"] == 2
    # both ranks reduce the same gathered tensors
    for k in ("mean_vx_rms", "best_instance", "checksum"):
        assert r0[k] == r1[k], k

    oracle = _run([])
    assert oracle["num_processes"] == 1 and oracle["global_devices"] == 4
    np.testing.assert_allclose(r0["mean_vx_rms"], oracle["mean_vx_rms"], rtol=1e-5)
    np.testing.assert_allclose(r0["checksum"], oracle["checksum"], rtol=1e-4)
    assert r0["vx_rms"] == r1["vx_rms"]
    np.testing.assert_allclose(r0["vx_rms"], oracle["vx_rms"], atol=1e-6, rtol=0)
    # the best instance, under the tie rule against the oracle's errors
    assert t_sweep.argmin_agrees(oracle["vx_rms"], oracle["best_instance"],
                                 r0["best_instance"], 1e-6, 0.0), (r0, oracle)


def test_two_process_weak_scaling_record():
    """One MPC step timed on rank 0 alone and on both Gloo ranks at once: the
    weak-scaling record across processes, the same on both ranks (CPU ranks
    share the cores, so the efficiency is only held positive)."""
    r0, r1 = _spawn_two(["--weak-scaling"])
    assert r0["global_devices"] == 8
    assert r0["weak_scaling"] == r1["weak_scaling"]
    ws = r0["weak_scaling"]
    assert set(ws) == {"4", "8"}
    assert ws["4"]["throughput"] > 0 and ws["4"]["efficiency"] == 1.0  # the base
    assert ws["8"]["throughput"] > 0 and ws["8"]["efficiency"] > 0


def test_single_process_matches_jax_dist_check():
    """The one-process oracle against JAX's dist_check run as one process on
    its four virtual CPU devices (float32, the same scenarios), with
    test_distributed.py's tolerances; JAX's best instance under the tie
    rule, on the port's per-instance errors (JAX prints none)."""
    p = subprocess.run([sys.executable, "-m", "quad_periodic_mpc_tpu.parallel.dist_check",
                        "--local-devices", "4"],
                       capture_output=True, text=True, timeout=TIMEOUT, cwd=REPO,
                       env={**_env(), "XLA_FLAGS": ""})   # not the 8 devices of tests/conftest.py
    assert p.returncode == 0, p.stderr[-3000:]
    ref = _last_json(p.stdout)
    oracle = _run([])
    assert ref["global_devices"] == oracle["global_devices"] == 4
    np.testing.assert_allclose(oracle["mean_vx_rms"], ref["mean_vx_rms"], rtol=1e-5)
    np.testing.assert_allclose(oracle["checksum"], ref["checksum"], rtol=1e-4)
    assert t_sweep.argmin_agrees(oracle["vx_rms"], ref["best_instance"],
                                 oracle["best_instance"], 5e-4, 1e-3), (oracle, ref)


def test_rejects_a_batch_the_ranks_cannot_split():
    p = subprocess.run([sys.executable, "-m", MODULE, "--device", "cpu", "--batch", "6"],
                       capture_output=True, text=True, timeout=TIMEOUT, cwd=REPO, env=_env())
    assert p.returncode != 0 and "--batch 6" in p.stderr
