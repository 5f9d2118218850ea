"""The swing update of one control tick: CUDA kernel and its wrapper.

Replaces no TPU kernel: the JAX package's ``control/mpc.py::swing_update``
is one XLA fusion, while the port's plain version,
``control/mpc.swing_update_plain``, dispatches ~300 PyTorch operations an
update (the gait's phases, the swing timers, the Raibert foothold, the
Bezier curve, the stance hold, the roll/pitch integral).  The kernel
computes the same update, one thread per instance; its source is
``quad_periodic_mpc_tpu_torch/csrc/swing_update.cu``.
``mpc.swing_update`` takes it (``mpc.swing_update_kernel``) for card
tensors, ``swing_update_plain`` for CPU tensors.

- ``launch``: the wrapper, one launch.  ``targets_only`` writes the
  Raibert targets alone; ``pf_target`` finishes the update from given
  targets (the two launches around the terrain tier's foothold hook).
  float32 and float64 each have a kernel, any other dtype raises.
- ``LAUNCHES``: launches made outside a graph capture since the count was
  last reset.  A capture launches nothing and a replay runs no Python, so
  a captured update's launches are not counted: the wrapper is not one of
  ``runtime/graphs._COUNTED``'s.
"""

from __future__ import annotations

import ctypes
import math

import torch

from quad_periodic_mpc_tpu_torch.ops.cuda import build

SOURCE = "swing_update.cu"
_ENTRY = {torch.float32: "swing_update_launch_f32", torch.float64: "swing_update_launch_f64"}
_FULL, _TARGETS, _FINISH = 0, 1, 2      # the kernel's modes

LAUNCHES = 0


_INPUTS = ("p", "v", "quat", "p_feet",
           "iteration", "x_vel_des", "y_vel_des", "wpd", "rpy_int", "first_swing", "str",
           "swing_p0", "swing_pf",
           "yaw_rate", "offsets", "durations", "n_segments",
           "swing_height_t", "bonus_swing_t", "p_rel_max_t",
           "pf_in")
_OUTPUTS = ("iteration_o", "wpd_o", "rpy_int_o", "rpy_comp_o", "first_swing_o", "str_o",
            "p0_o", "pf_o", "p_des_o", "v_des_o", "a_des_o", "contact_o", "swing_o",
            "pf_target_o")


class _Params(ctypes.Structure):
    _fields_ = ([("B", ctypes.c_int), ("mode", ctypes.c_int), ("iters_per_mpc", ctypes.c_int)]
                + [(n, ctypes.c_double) for n in (
                    "dt", "dt_mpc", "abad_link_length", "interleave_gain", "half_plus_bonus",
                    "swing_height", "p_rel_max")]
                + [("hip", ctypes.c_double * 12), ("side_sign", ctypes.c_double * 4),
                   ("interleave_y", ctypes.c_double * 4)]
                + [(n, build.Strided) for n in _INPUTS]
                + [(n, ctypes.c_void_p) for n in _OUTPUTS])


def launch(state, obs, cmd, gait, model, swing_cfg, loop, swing_height, tunable=None,
           pf_target=None, targets_only: bool = False) -> dict:
    """One swing update in one launch (``mpc.swing_update_plain``'s update).

    ``state`` / ``obs`` / ``cmd`` / ``gait`` are ``mpc.ControllerState``,
    ``Observation``, ``Command`` and ``gait.GaitParams``; each tensor
    broadcasts to the observation's batch (a gait or a command may be
    shared), all float tensors of one dtype, float32 or float64, on one
    card, ``iteration`` int32 and ``first_swing`` bool.  ``tunable``
    (``config.TunableParams``), where given, supplies ``swing_height``,
    ``bonus_swing`` and ``p_rel_max`` in place of ``swing_height`` and
    ``swing_cfg``'s, as the plain version takes them; each is a Python
    number or a tensor broadcast to (..., 4) and read on the device.
    ``targets_only``: return
    {"pf_target"} alone, the Raibert targets (..., 4, 3); ``pf_target``:
    take these targets in place of the Raibert targets.  Otherwise return
    the new state's fields and the outputs by name.  Nothing is read back
    to the host, so a graph can capture it."""
    global LAUNCHES
    device, dtype = obs.p.device, obs.p.dtype
    if dtype not in _ENTRY:
        raise TypeError(f"obs.p: expected float32 or float64, got {dtype}")
    lead = obs.p.shape[:-1]
    B = math.prod(lead)
    if B < 1:
        raise ValueError("need a batch of at least one instance")
    i32 = torch.int32
    ints = lambda t: t.to(i32) if isinstance(t, torch.Tensor) and not t.is_floating_point() else t
    keep, ins = [], {}

    def add(name, t, shape, dt=dtype):
        view, strided = build.rows(name, t, lead, shape, device, dt)
        keep.append(view)
        ins[name] = strided

    add("p", obs.p, (3,))
    add("v", obs.v, (3,))
    add("quat", obs.quat, (4,))
    add("p_feet", obs.p_feet, (4, 3))
    add("iteration", state.iteration, (), i32)
    add("x_vel_des", state.x_vel_des, ())
    add("y_vel_des", state.y_vel_des, ())
    add("wpd", state.world_position_desired, (3,))
    add("rpy_int", state.rpy_int, (2,))
    add("first_swing", state.first_swing, (4,), torch.bool)
    add("str", state.swing_time_remaining, (4,))
    add("swing_p0", state.swing_p0, (4, 3))
    add("swing_pf", state.swing_pf, (4, 3))
    add("yaw_rate", cmd.yaw_rate, ())
    add("offsets", ints(gait.offsets), (4,), i32)
    add("durations", ints(gait.durations), (4,), i32)
    add("n_segments", ints(gait.n_segments), (), i32)
    bonus_swing, p_rel_max = swing_cfg.bonus_swing, swing_cfg.p_rel_max
    if tunable is not None:
        swing_height, bonus_swing, p_rel_max = (
            tunable.swing_height, tunable.bonus_swing, tunable.p_rel_max)
    # a Python number is the kernel's scalar; a tensor is read per instance
    # and leg, broadcast to (..., 4) as the plain version broadcasts it
    scalars = {}
    for name, value in (("swing_height", swing_height), ("bonus_swing", bonus_swing),
                        ("p_rel_max", p_rel_max)):
        if isinstance(value, torch.Tensor):
            add(name + "_t", value, (4,))
            scalars[name] = 0.0
        else:
            ins[name + "_t"] = build.Strided(None, 0, 0)
            scalars[name] = float(value)
    ins["pf_in"] = build.Strided(None, 0, 0)
    if pf_target is not None:
        add("pf_in", pf_target, (4, 3))

    like = dict(dtype=dtype, device=device)
    if targets_only:
        outs = {"pf_target": torch.empty(B, 4, 3, **like)}
    else:
        outs = {"iteration": torch.empty(B, dtype=i32, device=device),
                "world_position_desired": torch.empty(B, 3, **like),
                "rpy_int": torch.empty(B, 2, **like), "rpy_comp": torch.empty(B, 2, **like),
                "first_swing": torch.empty(B, 4, dtype=torch.bool, device=device),
                "swing_time_remaining": torch.empty(B, 4, **like),
                "swing_p0": torch.empty(B, 4, 3, **like), "swing_pf": torch.empty(B, 4, 3, **like),
                "p_foot_des": torch.empty(B, 4, 3, **like),
                "v_foot_des": torch.empty(B, 4, 3, **like),
                "a_foot_des": torch.empty(B, 4, 3, **like),
                "contact_state": torch.empty(B, 4, dtype=torch.float32, device=device),
                "swing_state": torch.empty(B, 4, dtype=torch.float32, device=device)}
    ptr = lambda name: outs[name].data_ptr() if name in outs else None
    kp = _Params(
        B=B, mode=_TARGETS if targets_only else (_FULL if pf_target is None else _FINISH),
        iters_per_mpc=loop.iterations_between_mpc, dt=loop.dt, dt_mpc=loop.dt_mpc,
        abad_link_length=model.leg.abad_link_length,
        interleave_gain=swing_cfg.interleave_gain,
        half_plus_bonus=0.5 + scalars["bonus_swing"], swing_height=scalars["swing_height"],
        p_rel_max=scalars["p_rel_max"],
        hip=(ctypes.c_double * 12)(*(float(v) for v in model.hip_locations().reshape(-1))),
        side_sign=(ctypes.c_double * 4)(*(float(v) for v in model.side_signs())),
        interleave_y=(ctypes.c_double * 4)(*(float(v) for v in swing_cfg.interleave_y)),
        **ins,
        iteration_o=ptr("iteration"), wpd_o=ptr("world_position_desired"),
        rpy_int_o=ptr("rpy_int"), rpy_comp_o=ptr("rpy_comp"), first_swing_o=ptr("first_swing"),
        str_o=ptr("swing_time_remaining"), p0_o=ptr("swing_p0"), pf_o=ptr("swing_pf"),
        p_des_o=ptr("p_foot_des"), v_des_o=ptr("v_foot_des"), a_des_o=ptr("a_foot_des"),
        contact_o=ptr("contact_state"), swing_o=ptr("swing_state"),
        pf_target_o=ptr("pf_target"))
    with torch.cuda.device(device):
        build.launch(SOURCE, _ENTRY[dtype], [], kp, device)
    # (CPU tensors: the tests' emulation of the kernel, never captured)
    if device.type != "cuda" or not torch.cuda.is_current_stream_capturing():
        LAUNCHES += 1
    return {k: t.reshape(lead + t.shape[1:]) for k, t in outs.items()}
