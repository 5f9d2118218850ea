"""The port's native runtime (runtime/native_bridge.py): its own g++ build
of the JAX package's C++ source, then the ring, the periodic loop, UDP and
the safety filter through ctypes, mirroring tests/test_runtime_native.py.

The shared-memory name and the UDP ports differ from that file's (under
``-n 6 --dist loadfile`` the two files can run at once): the ports come
from a bind-to-0 probe.
"""

import filecmp
import os
import socket
import time

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

from quad_periodic_mpc_tpu.runtime import native_bridge as j_nb
from quad_periodic_mpc_tpu_torch.runtime import native_bridge as nb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING = f"/qpm_torch_test_ring_{os.getpid()}"


def free_udp_ports(n: int) -> list[int]:
    socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM) for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


@pytest.fixture(scope="module")
def built():
    return nb.build()


def test_build(built):
    assert built.exists()
    assert built.parent == nb.BUILD_DIR
    assert os.path.commonpath([str(built), REPO]) == REPO
    # the port's source is the JAX package's, byte for byte
    for name in ("qpm_runtime.cpp", "qpm_runtime.h"):
        assert filecmp.cmp(nb.NATIVE_DIR / name,
                           os.path.join(REPO, "quad_periodic_mpc_tpu", "runtime", "native", name),
                           shallow=False)


def test_ring_roundtrip(built):
    ring = nb.StateRing(RING, frame_bytes=64, slots=4, create=True)
    try:
        seq, _ = ring.read_latest()
        assert seq == 0
        for i in range(10):
            assert ring.write(bytes([i]) * 64) == i + 1
        seq, data = ring.read_latest()
        assert seq == 10
        assert data == bytes([9]) * 64
        # a second reader attaches to the same shm
        reader = nb.StateRing(RING, 64, 4, create=False)
        seq2, data2 = reader.read_latest()
        assert seq2 == 10 and data2 == data
        reader.close(unlink=False)
    finally:
        ring.close(unlink=True)


def test_periodic_loop_rate(built):
    loop = nb.PeriodicLoop(period_ns=2_000_000)   # 500 Hz, the control rate
    loop.start()
    time.sleep(0.25)
    loop.stop()
    iters = loop.iterations
    loop.destroy()
    # ~125 iterations in 0.25 s at 500 Hz; the reference test's margins
    assert 80 <= iters <= 170, iters


def test_udp_loopback(built):
    pa, pb = free_udp_ports(2)
    a = nb.UdpBridge(local_port=pa, remote_ip="127.0.0.1", remote_port=pb)
    b = nb.UdpBridge(local_port=pb, remote_ip="127.0.0.1", remote_port=pa)
    try:
        assert a.send(b"hello-robot") == 11
        time.sleep(0.01)
        assert b.recv_latest(64) == b"hello-robot"
        # newest-wins drain
        a.send(b"one")
        a.send(b"two")
        time.sleep(0.01)
        assert b.recv_latest(64) == b"two"
        assert b.recv_latest(64) is None
    finally:
        a.close()
        b.close()


def test_safety_clamp_and_power(built):
    tau = np.array([20.0, -20.0, 30.0] + [1.0] * 9)
    out, n = nb.clamp_torques(tau)
    assert n == 3
    np.testing.assert_allclose(out[:3], [17.0, -17.0, 26.0])
    assert tau[0] == 20.0                      # the caller's array is not written

    tau = np.full(12, 10.0)
    qd = np.full(12, 2.0)                      # power = 240 W
    out, applied = nb.power_protect(tau, qd, budget_watts=120.0)
    assert applied
    assert abs(sum(out * qd) - 120.0) < 1e-9


def test_position_limit_and_protect(built):
    q = np.tile([0.0, 0.5, -1.5], 4)            # a valid A1 pose
    q[1] = 5.0                                 # hip beyond 4.19
    q[2] = -3.0                                # knee beyond -2.70
    q[3] = -1.0                                # abad beyond -0.802
    out, n = nb.position_limit(q)
    assert n == 3
    assert abs(out[1] - 4.19) < 1e-12
    assert abs(out[2] + 2.70) < 1e-12
    assert abs(out[3] + 0.802) < 1e-12
    assert out[0] == 0.0 and out[5] == -1.5

    q_now = np.full(12, 0.5)
    q_cmd = np.full(12, 0.5)
    q_cmd[4] = 0.7                             # a 0.2 rad jump > 0.087
    q_cmd[5] = 0.45                            # within the limit
    out, n = nb.position_protect(q_cmd, q_now)
    assert n == 1
    assert abs(out[4] - (0.5 + 0.087)) < 1e-12
    assert out[5] == 0.45


def test_safety_functions_equal_jax(built, monkeypatch):
    """The four safety functions' outputs equal the JAX package's bindings'
    on seeded inputs.  JAX's bindings load the port's build of the same
    source (its own build runs make in the JAX package's directory, which
    tests/test_runtime_native.py may be doing at the same time)."""
    monkeypatch.setattr(j_nb, "_lib", None)
    monkeypatch.setattr(j_nb, "build", lambda force=False: built)
    rng = np.random.default_rng(9)
    for _ in range(20):
        tau, qd = rng.uniform(-40, 40, 12), rng.uniform(-20, 20, 12)
        q, q_now = rng.uniform(-3.5, 5.0, 12), rng.uniform(-3.0, 4.0, 12)
        budget, limit = rng.uniform(50, 2000), rng.uniform(0.01, 0.3)
        cases = [
            (nb.clamp_torques(tau), j_nb.clamp_torques(tau.copy())),
            (nb.clamp_torques(tau, (10.0, 12.0, 20.0)),
             j_nb.clamp_torques(tau.copy(), (10.0, 12.0, 20.0))),
            (nb.power_protect(tau, qd, budget), j_nb.power_protect(tau.copy(), qd, budget)),
            (nb.position_limit(q), j_nb.position_limit(q.copy())),
            (nb.position_protect(q, q_now, limit), j_nb.position_protect(q.copy(), q_now, limit)),
        ]
        for (a, na), (b, nb_) in cases:
            np.testing.assert_array_equal(a, b)
            assert na == nb_
    assert nb.A1_Q_MIN == j_nb.A1_Q_MIN and nb.A1_Q_MAX == j_nb.A1_Q_MAX
    assert (nb.STATE_BYTES, nb.CMD_BYTES) == (j_nb.STATE_BYTES, j_nb.CMD_BYTES)
