"""Batched control FSM (counterpart of
``quad_periodic_mpc_tpu/control/fsm.py``).

Rebuilds ControlFSM (src/fsm/ControlFSM.cpp) + the state set
(src/fsm/fsm_states/) as a batched integer-state machine: each instance
carries (state, operating_mode, transition counters); transitions are a
pure function of (requested state, safety masks).  Where the reference
dispatches to virtual FSM_State objects, behaviors are selected with masks:
every instance in a batch can be in a different state.

State numbering follows the dyn-param control values
(FSM_State.h:16-25): 0 PASSIVE, 1 STAND_UP, 3 BALANCE_STAND,
4 LOCOMOTION, 6 RECOVERY_STAND, 7 LAY_DOWN, 8 VISION, 9 BACKFLIP,
12 TESTING, 14 TESTING_CV.  Operating modes (ControlFSM.h):
0 NORMAL, 1 TRANSITIONING, 2 ESTOP, 3 EDAMP.  States, modes and the EDAMP
counter are int32; ``transition_done`` is bool.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# FSM states (dyn-param numbering, FSM_State.h:16-25)
PASSIVE = 0
STAND_UP = 1
BALANCE_STAND = 3
LOCOMOTION = 4
RECOVERY_STAND = 6
LAY_DOWN = 7
VISION = 8
BACKFLIP = 9
TESTING = 12
TESTING_CV = 14

# operating modes (ControlFSM.h OperatingMode)
NORMAL = 0
TRANSITIONING = 1
ESTOP = 2
EDAMP = 3

# EDAMP damping window before ESTOP (ControlFSM.cpp:106-133)
EDAMP_ITERATIONS = 1000


class FSMState(NamedTuple):
    state: torch.Tensor            # (...,) int32 current FSM state
    next_state: torch.Tensor       # (...,) int32 transition target
    mode: torch.Tensor             # (...,) int32 operating mode
    damp_iter: torch.Tensor        # (...,) int32 EDAMP counter
    transition_done: torch.Tensor  # (...,) bool


def init(batch: tuple = (), device="cuda") -> FSMState:
    z = lambda v: torch.full(batch, v, dtype=torch.int32, device=device)
    return FSMState(
        state=z(PASSIVE),
        next_state=z(PASSIVE),
        mode=z(NORMAL),
        damp_iter=z(0),
        transition_done=torch.ones(batch, dtype=torch.bool, device=device),
    )


# Legal direct transitions (getNextState routing, ControlFSM.cpp:318-380):
# a conservative approximation of the reference graph; everything routes
# through RECOVERY_STAND/STAND_UP except the direct pairs below.
_ALLOWED = {
    (PASSIVE, STAND_UP), (STAND_UP, PASSIVE),
    (STAND_UP, BALANCE_STAND), (BALANCE_STAND, STAND_UP),
    (STAND_UP, LOCOMOTION), (LOCOMOTION, STAND_UP),
    (BALANCE_STAND, LOCOMOTION), (LOCOMOTION, BALANCE_STAND),
    (STAND_UP, LAY_DOWN), (LAY_DOWN, PASSIVE), (LAY_DOWN, STAND_UP),
    (LOCOMOTION, RECOVERY_STAND), (BALANCE_STAND, RECOVERY_STAND),
    (RECOVERY_STAND, STAND_UP), (RECOVERY_STAND, BALANCE_STAND),
    (RECOVERY_STAND, LOCOMOTION),
    (STAND_UP, VISION), (VISION, STAND_UP), (VISION, RECOVERY_STAND),
    (STAND_UP, TESTING), (TESTING, STAND_UP), (TESTING, RECOVERY_STAND),
    (STAND_UP, TESTING_CV), (TESTING_CV, STAND_UP),
    (STAND_UP, BACKFLIP), (BACKFLIP, STAND_UP),
    (PASSIVE, RECOVERY_STAND),
}

# the legality graph as a table indexed [current, requested]
_N_STATES = TESTING_CV + 1
_TABLE_CACHE: dict = {}


def _allowed_table(device) -> torch.Tensor:
    key = str(device)
    if key not in _TABLE_CACHE:
        table = torch.eye(_N_STATES, dtype=torch.bool)
        for a, b in _ALLOWED:
            table[a, b] = True
        _TABLE_CACHE[key] = table.to(device)
    return _TABLE_CACHE[key]


def _allowed_mask(cur: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """cur == req, or (cur, req) a legal pair.  Indices outside the state
    numbering are legal only when equal, as in the reference's pairwise
    comparison."""
    inside = (cur >= 0) & (cur < _N_STATES) & (req >= 0) & (req < _N_STATES)
    table = _allowed_table(cur.device)
    c = torch.where(inside, cur, torch.zeros_like(cur)).long()
    r = torch.where(inside, req, torch.zeros_like(req)).long()
    return (cur == req) | (inside & table[c, r])


def step(
    fsm: FSMState,
    requested_state: torch.Tensor,
    safe_orientation: torch.Tensor,
    locomotion_safe: torch.Tensor,
    transition_complete: torch.Tensor | None = None,
) -> FSMState:
    """One FSM tick (runFSM, ControlFSM.cpp:99-200), batched.

    - pre-check failure in an active state -> EDAMP, then ESTOP after
      EDAMP_ITERATIONS (ControlFSM.cpp:106-133);
    - unsafe locomotion -> forced RECOVERY_STAND
      (FSM_State_Locomotion.cpp:88-96);
    - requested transitions gated by the legality graph.
    """
    if transition_complete is None:
        transition_complete = torch.ones_like(safe_orientation)

    active = (fsm.state != PASSIVE) & (fsm.state != LAY_DOWN)
    # EDAMP entry / progression
    enter_edamp = active & ~safe_orientation & (fsm.mode != ESTOP)
    damp_iter = torch.where(fsm.mode == EDAMP, fsm.damp_iter + 1,
                            torch.zeros_like(fsm.damp_iter))
    mode = torch.where(enter_edamp, EDAMP, fsm.mode)
    mode = torch.where((mode == EDAMP) & (damp_iter >= EDAMP_ITERATIONS), ESTOP, mode)

    # forced recovery from unsafe locomotion
    req = torch.where((fsm.state == LOCOMOTION) & ~locomotion_safe, RECOVERY_STAND,
                      requested_state.to(torch.int32))

    want = (req != fsm.state) & (mode == NORMAL)
    start = want & _allowed_mask(fsm.state, req)
    mode = torch.where(start, TRANSITIONING, mode)
    next_state = torch.where(start, req, fsm.next_state)

    finish = (mode == TRANSITIONING) & transition_complete
    state = torch.where(finish, next_state, fsm.state)
    mode = torch.where(finish, NORMAL, mode)

    # ESTOP/EDAMP drop to passive-like damping state
    state = torch.where(mode == ESTOP, PASSIVE, state)

    return FSMState(state=state, next_state=next_state, mode=mode, damp_iter=damp_iter,
                    transition_done=finish)
