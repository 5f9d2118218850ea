"""Safety checks as batched validity masks + clamps (counterpart of
``quad_periodic_mpc_tpu/control/safety.py``).

Rebuilds SafetyChecker (src/fsm/SafetyChecker.cpp) and the locomotion
safety guard (FSM_State_Locomotion.cpp:206-248) as pure functions: each
check returns (ok_mask, clamped_values), so a batch of instances carries
per-instance safety status that the FSM consumes (control/fsm.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from quad_periodic_mpc_tpu_torch.models.a1 import RobotModel


class SafetyResult(NamedTuple):
    safe_orientation: torch.Tensor   # (...,) bool (pre-check)
    safe_p_des: torch.Tensor         # (...,) bool (post-check)
    safe_force: torch.Tensor         # (...,) bool (post-check)
    p_des: torch.Tensor              # (..., 4, 3) clamped
    force_ff: torch.Tensor           # (..., 4, 3) clamped


def check_safe_orientation(rpy: torch.Tensor) -> torch.Tensor:
    """|roll|, |pitch| < 1.0 rad (SafetyChecker.cpp:21-36)."""
    return (torch.abs(rpy[..., 0]) < 1.0) & (torch.abs(rpy[..., 1]) < 1.0)


def clamp_p_des(p_des: torch.Tensor, model: RobotModel) -> tuple[torch.Tensor, torch.Tensor]:
    """Leg-frame desired-foot-position box (checkPDesFoot,
    SafetyChecker.cpp:43-115): |x|, |y| <= maxLegLength sin(60 deg),
    z in [-maxLegLength, -maxLegLength/4]."""
    max_len = model.leg.max_leg_length
    # sin(60 deg) of the angle rounded to the input's dtype, correctly
    # rounded (torch's float32 sin on the CPU is an ulp off here)
    angle = torch.tensor(1.0472, dtype=p_des.dtype).item()
    sin60 = torch.tensor(math.sin(angle), dtype=p_des.dtype, device=p_des.device)
    max_pdes = max_len * sin60
    clamped = torch.stack([
        torch.clamp(p_des[..., 0], -max_pdes, max_pdes),
        torch.clamp(p_des[..., 1], -max_pdes, max_pdes),
        torch.clamp(p_des[..., 2], -max_len, -max_len / 4.0),
    ], dim=-1)
    ok = torch.all(clamped == p_des, dim=-1).all(dim=-1)
    return clamped, ok


def clamp_force_ff(force_ff: torch.Tensor, limit: float = 350.0
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Feedforward-force box clamp at +-350 N per axis
    (checkForceFeedForward, SafetyChecker.cpp:121-190)."""
    clamped = torch.clamp(force_ff, -limit, limit)
    ok = torch.all(clamped == force_ff, dim=-1).all(dim=-1)
    return clamped, ok


def check_locomotion_safe(
    rpy: torch.Tensor,
    p_leg: torch.Tensor,
    v_leg: torch.Tensor,
    max_roll_deg: float = 40.0,
    max_pitch_deg: float = 40.0,
    max_leg_speed: float = 9.0,
) -> torch.Tensor:
    """locomotionSafe() (FSM_State_Locomotion.cpp:206-248): roll/pitch
    under 40 deg, feet below hips, |y| <= 0.18, leg speed < 9 m/s.
    Failing instances auto-transition to RecoveryStand in the FSM."""
    deg = math.pi / 180.0
    ok = ((torch.abs(rpy[..., 0]) <= max_roll_deg * deg)
          & (torch.abs(rpy[..., 1]) <= max_pitch_deg * deg))
    ok = ok & torch.all(p_leg[..., 2] <= 0.0, dim=-1)
    ok = ok & torch.all(torch.abs(p_leg[..., 1]) <= 0.18, dim=-1)
    speed = torch.linalg.vector_norm(v_leg, dim=-1)
    return ok & torch.all(speed <= max_leg_speed, dim=-1)


def run_checks(rpy: torch.Tensor, p_des: torch.Tensor, force_ff: torch.Tensor,
               model: RobotModel) -> SafetyResult:
    """Full pre+post check pass (ControlFSM::safetyPreCheck/PostCheck,
    ControlFSM.cpp:255-316)."""
    p_clamped, p_ok = clamp_p_des(p_des, model)
    f_clamped, f_ok = clamp_force_ff(force_ff)
    return SafetyResult(
        safe_orientation=check_safe_orientation(rpy),
        safe_p_des=p_ok,
        safe_force=f_ok,
        p_des=p_clamped,
        force_ff=f_clamped,
    )
