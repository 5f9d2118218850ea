"""Test helper: run the port's CUDA kernels on the CPU, where there is no card.

Each ``quad_periodic_mpc_tpu_torch/csrc/*.cu`` is compiled by the host C++
compiler against the stand-in ``cuda_runtime.h`` beside this file: a launch
runs the grid's blocks one after another with each block's threads as
std::threads, ``__syncwarp()`` is a barrier over the calling thread's warp
and ``__syncthreads()`` one over the block, the warp-wide exchanges
(``__shfl_sync``, ``__shfl_xor_sync``, ``__all_sync``, ``__ballot_sync``)
go through a slot per lane between two warp barriers, a launch's dynamic shared memory is one
buffer per block, and the ``cp.async`` primitives
(``cuda_pipeline_primitives.h``) queue each thread's copies until it waits
for them.  ``float4`` is a 16-byte aligned struct and the dynamic shared
memory 16-byte aligned, so a kernel's 128-bit loads from it run as they
do on the card.  Inside
``emulated()`` the port's ``ops/cuda/build.load`` returns these libraries
and ``torch.cuda.device`` / ``current_stream`` do nothing, so a wrapper's
CUDA branch (its ``_*_cuda`` function) runs the kernel's own arithmetic on
CPU tensors.  This checks a kernel's logic, indexing and warp
synchronisation against its plain version without a card; it says nothing
about speed, and is slow (use a few instances).  It lives with the tests
so that the package itself ships no stand-in for torch.cuda.

    with _cuda_emulation.emulated():
        out = kinematics_kernel._model_eval_cuda(state_on_cpu, mc)
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import types
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_LAUNCH = re.compile(r"(\w+)<<<([^,]+),\s*([^,]+),\s*([^,]+),[^>]*>>>\(")
_DYNAMIC_SMEM = re.compile(r"extern\s+__shared__\s+(\w+)\s+(\w+)\[\];")
FLAGS = ["-std=c++17", "-O1", "-fno-strict-aliasing", "-fPIC", "-shared", "-pthread"]


def compiler() -> str | None:
    """The host C++ compiler, or None where there is none."""
    return shutil.which("g++") or shutil.which("c++")


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` for the CPU (cached by content) and return
    the library's path."""
    from quad_periodic_mpc_tpu_torch.ops.cuda import build as cuda_build

    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler for the CPU emulation")
    text = _LAUNCH.sub(r"EMU_LAUNCH(\2, \3, \4, \1, ", (cuda_build.CSRC / source).read_text())
    text = _DYNAMIC_SMEM.sub(r"\1* \2 = static_cast<\1*>(emu_dynamic_smem);", text)
    digest = hashlib.sha1(text.encode() + " ".join(FLAGS).encode())
    for part in [*sorted(cuda_build.CSRC.glob("*.cuh")), *sorted(_HERE.glob("*.[hc]*"))]:
        digest.update(part.read_bytes())
    out_dir = cuda_build.BUILD_DIR.parent / "emulated"
    out = out_dir / f"lib{Path(source).stem}_{digest.hexdigest()[:12]}.so"
    if out.exists():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        cpp = Path(tmp) / (Path(source).stem + ".cpp")
        cpp.write_text(text)
        lib = Path(tmp) / out.name
        proc = subprocess.run(
            [cxx, *FLAGS, f"-I{_HERE}", f"-I{cuda_build.CSRC}", "-o", str(lib), str(cpp),
             str(_HERE / "emu.cpp")], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {source}:\n{proc.stderr}")
        os.replace(lib, out)
    return out


@contextlib.contextmanager
def emulated():
    """Within the block, the kernel wrappers' CUDA branches run the
    CPU-compiled kernels on CPU tensors."""
    import torch

    from quad_periodic_mpc_tpu_torch.ops.cuda import build as cuda_build

    libs: dict[str, ctypes.CDLL] = {}

    def load(source: str) -> ctypes.CDLL:
        if source not in libs:
            libs[source] = ctypes.CDLL(str(build(source)))
        return libs[source]

    saved = (cuda_build.load, torch.cuda.device, torch.cuda.current_stream)
    cuda_build.load = load
    torch.cuda.device = lambda device: contextlib.nullcontext()
    torch.cuda.current_stream = lambda device=None: types.SimpleNamespace(cuda_stream=0)
    try:
        yield
    finally:
        cuda_build.load, torch.cuda.device, torch.cuda.current_stream = saved
