"""Device constants made once and reused.

``torch.tensor`` / ``torch.as_tensor`` of Python or numpy data on a CUDA
device is a synchronous copy from pageable host memory: it stalls the
host on every call, and a CUDA graph cannot capture it.  The controller's
constants (cost weights, sign patterns, hip offsets, the estimator's
filter band) go through ``const`` instead: the first call for a (value,
dtype, device) makes the tensor, with an asynchronous copy from pinned
memory on a card, and every later call returns the same tensor.  The
first run of a step (a graph's warm-up) fills the cache, so a capture
finds every constant made.

A cached constant is shared by every caller: nothing may write into it.
Nor may any read it before its copy is complete: the main thread's streams
are ordered before a lockstep thread's (``mesh.run_lockstep``), and a
lockstep thread, whose stream no other thread waits for, finishes its copy
before it shares the constant.
Values that a retune changes (``TunableParams``, maps) are tensors the
caller owns and are never routed through here.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

_cache: dict[tuple, torch.Tensor] = {}


def const(value, dtype=None, device=None) -> torch.Tensor:
    """``torch.as_tensor(value, dtype=dtype, device=device)``, cached for
    non-tensor values.  A tensor passes through as ``as_tensor`` passes it
    (converted only where its dtype or device differs)."""
    if isinstance(value, torch.Tensor):
        return torch.as_tensor(value, dtype=dtype, device=device)
    a = np.asarray(value)
    device = torch.device(device if device is not None else "cpu")
    key = (a.dtype.str, a.shape, a.tobytes(), dtype, device)
    t = _cache.get(key)
    if t is not None:
        return t
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"constant {a.tolist()!r} ({dtype}) first asked for during a CUDA graph "
            "capture: run the step once before capturing it")
    host = torch.as_tensor(value, dtype=dtype).clone()      # never numpy's memory
    if device.type != "cuda":
        return _cache.setdefault(key, host.to(device))
    t = host.pin_memory().to(device, non_blocking=True)
    if threading.current_thread() is not threading.main_thread():
        torch.cuda.current_stream(device).synchronize()
    return _cache.setdefault(key, t)
