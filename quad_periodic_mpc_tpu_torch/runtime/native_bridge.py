"""ctypes bindings for the native host runtime (counterpart of
``quad_periodic_mpc_tpu/runtime/native_bridge.py``).

``native/qpm_runtime.{cpp,h}`` is the JAX package's source, byte for byte.
It is compiled on first use by ``g++`` (the flags of the JAX package's
Makefile, no other dependency) into ``build/native/`` at the repository
root, under a name that hashes the source and the flags, so an edited
source is rebuilt; nothing is compiled at import.  The packet layout
mirrors what the reference ships per 2 ms tick over the vendor UDP link
(LowCmd / LowState essentials: q, qd, tau per 12 joints + IMU).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = NATIVE_DIR.parents[2] / "build" / "native"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra"]
LD_FLAGS = ["-shared", "-pthread", "-lrt"]

LOW_STATE_DOUBLES = 12 * 2 + 10   # q, qd + quat(4) gyro(3) accel(3)
LOW_CMD_DOUBLES = 12 * 5          # q_des, qd_des, tau_ff, kp, kd
STATE_BYTES = LOW_STATE_DOUBLES * 8
CMD_BYTES = LOW_CMD_DOUBLES * 8

# A1 joint ranges (abad, hip, knee), unitree_legged_sdk a1_const.h /
# config/joint_limits_a1.yaml
A1_Q_MIN = (-0.802, -1.05, -2.70)
A1_Q_MAX = (0.802, 4.19, -0.916)


def library_path() -> Path:
    digest = hashlib.sha1(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    for name in ("qpm_runtime.cpp", "qpm_runtime.h"):
        digest.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libqpm_runtime_{digest.hexdigest()[:12]}.so"


def build(force: bool = False) -> Path:
    """Compile the library unless it exists; return its path.  Safe to
    call from several processes at once: each compiles to a private file
    and renames it into place."""
    out = library_path()
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, str(NATIVE_DIR / "qpm_runtime.cpp"), "-o", tmp, *LD_FLAGS],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on qpm_runtime.cpp:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


_D = ctypes.POINTER(ctypes.c_double)
_P = ctypes.c_void_p
# name -> (restype, argtypes)
_SIGNATURES = {
    "qpm_ring_open": (_P, [ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int]),
    "qpm_ring_close": (None, [_P, ctypes.c_int]),
    "qpm_ring_write": (ctypes.c_uint64, [_P, _P, ctypes.c_uint32]),
    "qpm_ring_read_latest": (ctypes.c_int64, [_P, _P, ctypes.c_uint32]),
    "qpm_loop_create": (_P, [ctypes.c_uint64, _P, _P]),
    "qpm_loop_start": (ctypes.c_int, [_P]),
    "qpm_loop_stop": (None, [_P]),
    "qpm_loop_destroy": (None, [_P]),
    "qpm_loop_iterations": (ctypes.c_uint64, [_P]),
    "qpm_loop_overruns": (ctypes.c_uint64, [_P]),
    "qpm_loop_max_jitter_ns": (ctypes.c_uint64, [_P]),
    "qpm_udp_open": (_P, [ctypes.c_char_p, ctypes.c_uint16, ctypes.c_char_p, ctypes.c_uint16]),
    "qpm_udp_close": (None, [_P]),
    "qpm_udp_send": (ctypes.c_int, [_P, _P, ctypes.c_uint32]),
    "qpm_udp_recv_latest": (ctypes.c_int, [_P, _P, ctypes.c_uint32]),
    "qpm_safety_clamp_torques": (ctypes.c_int, [_D, _D]),
    "qpm_safety_power_protect": (ctypes.c_int, [_D, _D, ctypes.c_double]),
    "qpm_safety_position_limit": (ctypes.c_int, [_D, _D, _D]),
    "qpm_safety_position_protect": (ctypes.c_int, [_D, _D, ctypes.c_double]),
}

_lib = None


def lib() -> ctypes.CDLL:
    """Build (if needed) and load the library, once per process."""
    global _lib
    if _lib is None:
        loaded = ctypes.CDLL(str(build()))
        for name, (res, args) in _SIGNATURES.items():
            fn = getattr(loaded, name)
            fn.restype, fn.argtypes = res, args
        _lib = loaded
    return _lib


class StateRing:
    """Seqlock shared-memory ring (single writer, many readers)."""

    def __init__(self, name: str, frame_bytes: int, slots: int = 8,
                 create: bool = True):
        self._lib = lib()
        self._frame_bytes = frame_bytes
        self._h = self._lib.qpm_ring_open(name.encode(), frame_bytes, slots, int(create))
        if not self._h:
            raise OSError(f"qpm_ring_open({name!r}) failed")
        self._created = create

    def write(self, data: bytes) -> int:
        return self._lib.qpm_ring_write(self._h, data, len(data))

    def read_latest(self) -> tuple[int, bytes]:
        buf = ctypes.create_string_buffer(self._frame_bytes)
        seq = self._lib.qpm_ring_read_latest(self._h, buf, self._frame_bytes)
        return seq, buf.raw

    def close(self, unlink: bool | None = None):
        if self._h:
            self._lib.qpm_ring_close(self._h, int(self._created if unlink is None else unlink))
            self._h = None


class PeriodicLoop:
    """Absolute-deadline periodic loop with jitter accounting."""

    def __init__(self, period_ns: int):
        self._lib = lib()
        self._h = self._lib.qpm_loop_create(period_ns, None, None)

    def start(self):
        self._lib.qpm_loop_start(self._h)

    def stop(self):
        self._lib.qpm_loop_stop(self._h)

    @property
    def iterations(self) -> int:
        return self._lib.qpm_loop_iterations(self._h)

    @property
    def overruns(self) -> int:
        return self._lib.qpm_loop_overruns(self._h)

    @property
    def max_jitter_ns(self) -> int:
        return self._lib.qpm_loop_max_jitter_ns(self._h)

    def destroy(self):
        if self._h:
            self._lib.qpm_loop_destroy(self._h)
            self._h = None


class UdpBridge:
    """Nonblocking UDP link (robot LowCmd / LowState packets)."""

    def __init__(self, local_port: int, remote_ip: str, remote_port: int,
                 local_ip: str | None = None):
        self._lib = lib()
        self._h = self._lib.qpm_udp_open(
            local_ip.encode() if local_ip else None, local_port,
            remote_ip.encode(), remote_port)
        if not self._h:
            raise OSError("qpm_udp_open failed")

    def send(self, data: bytes) -> int:
        return self._lib.qpm_udp_send(self._h, data, len(data))

    def recv_latest(self, nbytes: int) -> bytes | None:
        buf = ctypes.create_string_buffer(nbytes)
        n = self._lib.qpm_udp_recv_latest(self._h, buf, nbytes)
        return buf.raw[:n] if n > 0 else None

    def close(self):
        if self._h:
            self._lib.qpm_udp_close(self._h)
            self._h = None


def _vec(a, n: int) -> np.ndarray:
    """A fresh contiguous float64 copy of n entries (the native call
    writes into it)."""
    return np.array(a, dtype=np.float64).reshape(n)


def clamp_torques(tau, limits3=(17.0, 17.0, 26.0)) -> tuple:
    """Native torque clamp (be2r_cmpc_unitree.cpp:680-716 semantics).
    Returns (tau clamped, number clamped)."""
    arr, lim = _vec(tau, 12), _vec(limits3, 3)
    n = lib().qpm_safety_clamp_torques(arr.ctypes.data_as(_D), lim.ctypes.data_as(_D))
    return arr, n


def power_protect(tau, qd, budget_watts: float) -> tuple:
    """Scale the torques so that sum |tau_i qd_i| stays under the budget.
    Returns (tau, whether it scaled)."""
    arr, qd_arr = _vec(tau, 12), _vec(qd, 12)
    applied = lib().qpm_safety_power_protect(
        arr.ctypes.data_as(_D), qd_arr.ctypes.data_as(_D), budget_watts)
    return arr, bool(applied)


def position_limit(q, qmin3=A1_Q_MIN, qmax3=A1_Q_MAX) -> tuple:
    """Native joint-range clamp (Safety::PositionLimit analog,
    unitree_legged_sdk safety.h:18; applied at be2r_cmpc_unitree.cpp:486).
    Returns (q clamped, number clamped)."""
    arr, lo, hi = _vec(q, 12), _vec(qmin3, 3), _vec(qmax3, 3)
    n = lib().qpm_safety_position_limit(
        arr.ctypes.data_as(_D), lo.ctypes.data_as(_D), hi.ctypes.data_as(_D))
    return arr, n


def position_protect(q_cmd, q_now, limit_rad: float = 0.087) -> tuple:
    """Native command-vs-measured clamp (Safety::PositionProtect analog,
    safety.h:22; default 0.087 rad = 5 deg).  Returns (q_cmd clamped,
    number clamped)."""
    arr, now = _vec(q_cmd, 12), _vec(q_now, 12)
    n = lib().qpm_safety_position_protect(
        arr.ctypes.data_as(_D), now.ctypes.data_as(_D), limit_rad)
    return arr, n
