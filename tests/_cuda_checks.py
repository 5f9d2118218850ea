"""Test helper: the kernels of ``_cuda_checks.cu`` beside this file, built
for the card by nvcc (with the port's flags, headers from its ``csrc``) or
for the CPU through ``_cuda_emulation``, and called on tensors of either.

    lib = _cuda_checks.load(torch.device("cuda", 0))
    _cuda_checks.call(lib, "div_rn_check", a, b, out, n=a.numel())
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().with_suffix(".cu")
_libs: dict[str, ctypes.CDLL] = {}


def load(device) -> ctypes.CDLL:
    """The checks library for ``device`` (cuda: nvcc; cpu: the emulation),
    built once per process."""
    import _cuda_emulation

    from quad_periodic_mpc_tpu_torch.ops.cuda import build as cuda_build

    if device.type not in _libs:
        if device.type == "cuda":
            out_dir = cuda_build.BUILD_DIR.parent / "checks"
            out_dir.mkdir(parents=True, exist_ok=True)
            out = out_dir / f"libcuda_checks_{os.getpid()}.so"
            proc = subprocess.run(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, f"-I{cuda_build.CSRC}",
                 "-o", str(out), str(SOURCE)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{proc.stderr}")
        else:
            out = _cuda_emulation.build(str(SOURCE))
        _libs[device.type] = ctypes.CDLL(str(out))
    return _libs[device.type]


def call(lib: ctypes.CDLL, name: str, *tensors, n: int) -> None:
    """``name(ptr..., n, stream)`` on the tensors' device; raise on an error."""
    import torch

    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * len(tensors) + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cuda = tensors[0].device.type == "cuda"
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream if cuda else 0
    err = fn(*(t.data_ptr() for t in tensors), n, stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError_t {err}")
    if cuda:
        torch.cuda.synchronize()
