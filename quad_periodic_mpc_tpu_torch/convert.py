"""Carry state across from the reference package.

This system has no learned weights: what carries over between the JAX
package and this port is its state and configuration.  Each function here
takes one of the reference's state types (``ControllerState``,
``EstimatorState``, ``PlantState``, ``Command``, ``DisturbanceParams``,
``GaitParams``, ``FBState``, ``ArtState``, ``ContactInfo``, ``WBCInput``,
``ModelConstants``, ``StagewiseProblem``, ``KFState``, the estimation
container's ``EstimatorState``, ``QPData``, ``ADMMState``,
``TunableParams``, ``WrenchDisturbance``, ``MixedGaitParams``,
``HeightMap``, ``StairsTerrain``) with array
leaves of any kind that ``numpy.asarray`` accepts, and builds the port's NamedTuple of tensors on the given device,
keeping each leaf's dtype (the tuple fields of ``ModelConstants``, a map's
``resolution`` and a staircase's ``tread`` and ``n_steps`` stay Python
values).  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from quad_periodic_mpc_tpu_torch import config
from quad_periodic_mpc_tpu_torch.control import mpc, wbc
from quad_periodic_mpc_tpu_torch.estimation import container, kf
from quad_periodic_mpc_tpu_torch.models import floating_base
from quad_periodic_mpc_tpu_torch.ops import estimator, gait, qp_admm, qp_stagewise
from quad_periodic_mpc_tpu_torch.sim import articulated_sim, srb_sim
from quad_periodic_mpc_tpu_torch.terrain import heightmap as hmap
from quad_periodic_mpc_tpu_torch.terrain import scenario


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


def wrench_disturbance(src, device="cuda") -> srb_sim.WrenchDisturbance:
    return _named(srb_sim.WrenchDisturbance, src, device)


def gait_params(src, device="cuda") -> gait.GaitParams:
    return _named(gait.GaitParams, src, device)


def mixed_gait_params(src, device="cuda") -> gait.MixedGaitParams:
    return _named(gait.MixedGaitParams, src, device)


def tunable_params(src, device="cuda") -> config.TunableParams:
    return _named(config.TunableParams, src, device)


def fb_state(src, device="cuda") -> floating_base.FBState:
    return _named(floating_base.FBState, src, device)


def art_state(src, device="cuda") -> articulated_sim.ArtState:
    return _named(articulated_sim.ArtState, src, device, {"fb": fb_state})


def contact_info(src, device="cuda") -> floating_base.ContactInfo:
    return _named(floating_base.ContactInfo, src, device)


def wbc_input(src, device="cuda") -> wbc.WBCInput:
    return _named(wbc.WBCInput, src, device)


def stagewise_problem(src, device="cuda") -> qp_stagewise.StagewiseProblem:
    """The reference's StagewiseProblem; ``c`` keeps its rank, (..., 13) or
    per step (..., h, 13)."""
    return _named(qp_stagewise.StagewiseProblem, src, device)


def kf_state(src, device="cuda") -> kf.KFState:
    return _named(kf.KFState, src, device)


def estimation_state(src, device="cuda") -> container.EstimatorState:
    """The estimation container's EstimatorState (``estimator_state`` is the
    periodic disturbance estimator's)."""
    return _named(container.EstimatorState, src, device, {"kf": kf_state})


def qp_data(src, device="cuda") -> qp_admm.QPData:
    return _named(qp_admm.QPData, src, device)


def admm_state(src, device="cuda") -> qp_admm.ADMMState:
    """The reference's ADMMState; a missing ``kinv`` stays None."""
    return _named(qp_admm.ADMMState, src, device,
                  {"kinv": lambda v, d: None if v is None else tensor(v, d)})


def model_constants(src, device="cuda") -> floating_base.ModelConstants:
    """The reference's ModelConstants: arrays become tensors on ``device``,
    the tuple fields (topology, static mirrors) are copied as they are."""
    return floating_base.ModelConstants(**{
        f: (tuple(getattr(src, f)) if isinstance(getattr(src, f), tuple)
            else tensor(getattr(src, f), device))
        for f in floating_base.ModelConstants._fields
    })


def heightmap(src, device="cuda") -> hmap.HeightMap:
    """The reference's HeightMap; ``resolution`` stays a Python float."""
    return hmap.HeightMap(
        elevation=tensor(src.elevation, device), variance=tensor(src.variance, device),
        traversability=tensor(src.traversability, device), center=tensor(src.center, device),
        resolution=float(src.resolution))


def stairs_terrain(src, device="cuda") -> scenario.StairsTerrain:
    """The reference's StairsTerrain; ``tread`` and ``n_steps`` stay Python
    numbers."""
    return scenario.StairsTerrain(
        edge_x=tensor(src.edge_x, device), riser=tensor(src.riser, device),
        tread=float(src.tread), n_steps=int(src.n_steps))


def to_numpy(value):
    """Port tensors (or NamedTuples of them, nested) -> numpy arrays."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*(to_numpy(v) for v in value))
    if isinstance(value, (tuple, list)):
        return type(value)(to_numpy(v) for v in value)
    return value

