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
    src = CSRC / source
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
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
