"""Constants as tensors: ``torch.as_tensor`` of a Python or numpy value,
made once per (value, dtype, device).  The reference runs eagerly, so it
needs none of the program's graph-capture rules."""

from __future__ import annotations

import numpy as np
import torch

_cache: dict[tuple, torch.Tensor] = {}


def const(value, dtype=None, device=None) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return torch.as_tensor(value, dtype=dtype, device=device)
    a = np.asarray(value)
    key = (a.dtype.str, a.shape, a.tobytes(), dtype, str(device))
    if key not in _cache:
        _cache[key] = torch.as_tensor(value, dtype=dtype).clone().to(device)
    return _cache[key]
