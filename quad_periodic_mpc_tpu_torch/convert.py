"""Carry state across from the reference package.

This system has no learned weights: what carries over between the JAX
package and this port is its state and configuration.  Each function here
takes one of the reference's state types (``ControllerState``,
``EstimatorState``, ``PlantState``, ``Command``,
``DisturbanceParams``, ``GaitParams``) with array leaves of any kind that
``numpy.asarray`` accepts, and builds the port's NamedTuple of tensors on
the given device, keeping each leaf's dtype.  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from quad_periodic_mpc_tpu_torch.control import mpc
from quad_periodic_mpc_tpu_torch.ops import estimator, gait
from quad_periodic_mpc_tpu_torch.sim import srb_sim


def tensor(a, device="cuda") -> torch.Tensor:
    """One array leaf -> tensor on ``device`` with the same dtype."""
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _named(cls, src, device, nested: dict | None = None):
    nested = nested or {}
    return cls(**{
        f: (nested[f](getattr(src, f), device) if f in nested
            else tensor(getattr(src, f), device))
        for f in cls._fields
    })


def estimator_state(src, device="cuda") -> estimator.EstimatorState:
    return _named(estimator.EstimatorState, src, device)


def controller_state(src, device="cuda") -> mpc.ControllerState:
    return _named(mpc.ControllerState, src, device, {"est": estimator_state})


def plant_state(src, device="cuda") -> srb_sim.PlantState:
    return _named(srb_sim.PlantState, src, device)


def command(src, device="cuda") -> mpc.Command:
    return _named(mpc.Command, src, device)


def disturbance(src, device="cuda") -> srb_sim.DisturbanceParams:
    return _named(srb_sim.DisturbanceParams, src, device)


def gait_params(src, device="cuda") -> gait.GaitParams:
    return _named(gait.GaitParams, src, device)


def to_numpy(value):
    """Port tensors (or NamedTuples of them, nested) -> numpy arrays."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*(to_numpy(v) for v in value))
    if isinstance(value, (tuple, list)):
        return type(value)(to_numpy(v) for v in value)
    return value

