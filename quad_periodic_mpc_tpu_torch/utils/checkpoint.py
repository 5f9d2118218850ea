"""Checkpoint and resume of controller state and sweep accumulators
(counterpart of ``quad_periodic_mpc_tpu/utils/checkpoint.py``).

The reference has no controller checkpointing (SURVEY.md section 5); for
long sweeps this module persists any tree of tensors (ControllerState,
EstimatorState, PlantState, ...) in the layout of the JAX package's npz
fallback: ``<path>.npz`` with one array ``leaf_{i}`` per leaf in flattening
order (NamedTuple fields in order, recursively; see ``telemetry.leaves``)
and ``<path>.json`` with ``{"n_leaves", "step"}``.  The JAX package reads
and writes that layout too when orbax is not importable; an orbax
checkpoint (a directory at ``<path>``) is not read here, since orbax needs
JAX.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from quad_periodic_mpc_tpu_torch.utils.telemetry import leaves, to_numpy, unflatten


def save(path: str | Path, tree: Any, step: int | None = None) -> None:
    """Write ``tree``'s leaves to ``<path>.npz`` and its metadata to
    ``<path>.json``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {f"leaf_{i}": to_numpy(x) for i, x in enumerate(leaves(tree))}
    np.savez(str(path) + ".npz", **arrays)
    meta = {"n_leaves": len(arrays), "step": step}
    Path(str(path) + ".json").write_text(json.dumps(meta))


def restore(path: str | Path, template: Any) -> Any:
    """A tree shaped like ``template`` with the leaves saved at ``path``:
    each tensor on the template leaf's device and dtype; a template leaf
    that is a Python number comes back as one of its type."""
    npz = Path(str(path) + ".npz")
    if not npz.exists():
        raise FileNotFoundError(
            f"{npz} not found (an orbax checkpoint directory is not readable "
            "without JAX)")
    like = leaves(template)
    with np.load(npz) as data:
        if len(data.files) != len(like):
            raise ValueError(
                f"{npz} holds {len(data.files)} leaves, the template {len(like)}")
        arrays = [data[f"leaf_{i}"] for i in range(len(like))]
    new = [
        torch.as_tensor(a, dtype=t.dtype, device=t.device) if isinstance(t, torch.Tensor)
        else type(t)(a.item())
        for a, t in zip(arrays, like)
    ]
    return unflatten(template, new)
