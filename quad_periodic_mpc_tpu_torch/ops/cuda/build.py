"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on first
use by ``nvcc`` into a shared library under ``build/kernels/`` at the
repository root (listed in ``.gitignore``), then loaded with ctypes.  The
library name carries a hash of the source, so an edited source is rebuilt.
Nothing is compiled at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]          # quad_periodic_mpc_tpu_torch/
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}      # source name -> nvcc's output (ptxas -v)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found; CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return nvcc


def library_path(source: str) -> Path:
    """The library's name hashes the source, the shared headers and the
    flags, so an edit to any of them rebuilds it."""
    src = CSRC / source
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{digest.hexdigest()[:12]}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library exists; return its path.
    Safe to call from several threads or processes at once: each compiles
    to a private file and renames it into place."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)],
            capture_output=True, text=True,
        )
        BUILD_LOGS[source] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``, once per process."""
    with _lock:
        if source not in _libs:
            _libs[source] = ctypes.CDLL(str(build(source)))
        return _libs[source]


def check(name: str, t, shape: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on
    ``device`` (what every kernel's C interface takes)."""
    import torch

    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def launch(source: str, fn_name: str, tensors, params, device) -> None:
    """Call ``fn_name(ptr..., params, stream)`` of ``csrc/<source>`` on the
    current stream of ``device``; raise on a non-zero cudaError_t.
    ``params`` is a ctypes.Structure passed by value."""
    import torch

    fn = getattr(load(source), fn_name)
    fn.argtypes = [ctypes.c_void_p] * len(tensors) + [type(params), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*(t.data_ptr() for t in tensors), params,
             torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} ({source}) failed: cudaError_t {err}")
