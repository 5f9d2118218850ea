"""Phase-based gait scheduler, the GaitScheduler rebuild (counterpart of
``quad_periodic_mpc_tpu/ops/gait_scheduler.py``).

Rebuilds src/common/Controllers/GaitScheduler.{h,cpp}: a continuous-time
per-leg phase machine (distinct from the segment-counted OffsetDuration
gaits of ops/gait.py): each leg carries a phase variable in [0, 1),
advanced by dt / (periodTime / phaseScale); contact is scheduled while
phase <= switchingPhase.  Gait definitions are (periodTimeNominal,
switchingPhaseNominal, phaseOffset[4], phaseScale[4], enabled[4])
(createGait, GaitScheduler.cpp:306-480).

State is a tuple of tensors; ``step`` and ``step_full`` are pure and
batched, so fleets of schedulers step in lockstep.  ``jnp.mod`` is
``torch.remainder`` (the result takes the divisor's sign), and every
expression keeps the reference's order of operations, so that the contact
decision ``phase <= switching_phase`` falls the same way at a boundary.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# GaitType parameter table (createGait, GaitScheduler.cpp:306-460):
# name: (period_s, switching_phase, offsets[4], scale[4], enabled[4],
#        initial_phase); initial_phase is 0 for every case except PACE,
# which seeds a quarter period in (GaitScheduler.cpp:387).
GAIT_TABLE: dict[str, tuple] = {
    "stand":           (10.0, 1.0, (0.5, 0.5, 0.5, 0.5), (1, 1, 1, 1), (1, 1, 1, 1), 0.0),
    "stand_cycle":     (1.0, 1.0, (0.5, 0.5, 0.5, 0.5), (1, 1, 1, 1), (1, 1, 1, 1), 0.0),
    "static_walk":     (1.25, 0.8, (0.25, 0.0, 0.75, 0.5), (1, 1, 1, 1), (1, 1, 1, 1), 0.0),
    "amble":           (0.5, 0.625, (0.0, 0.5, 0.25, 0.75), (1, 1, 1, 1), (1, 1, 1, 1), 0.0),
    "trot_walk":       (0.5, 0.6, (0.0, 0.5, 0.5, 0.0), (1, 1, 1, 1), (1, 1, 1, 1), 0.0),
    "trot":            (0.5, 0.5, (0.0, 0.5, 0.5, 0.0), (1, 1, 1, 1), (1, 1, 1, 1), 0.0),
    "trot_run":        (0.4, 0.4, (0.0, 0.5, 0.5, 0.0), (1, 1, 1, 1), (1, 1, 1, 1), 0.0),
    "pace":            (0.35, 0.5, (0.0, 0.5, 0.0, 0.5), (1, 1, 1, 1), (1, 1, 1, 1), 0.25),
    "bound":           (0.4, 0.4, (0.0, 0.0, 0.5, 0.5), (1, 1, 1, 1), (1, 1, 1, 1), 0.0),
    "rotary_gallop":   (0.4, 0.2, (0.0, 0.8571, 0.3571, 0.5), (1, 1, 1, 1), (1, 1, 1, 1), 0.0),
    "traverse_gallop": (0.5, 0.2, (0.0, 0.8571, 0.3571, 0.5), (1, 1, 1, 1), (1, 1, 1, 1), 0.0),
    "pronk":           (0.5, 0.5, (0.0, 0.0, 0.0, 0.0), (1, 1, 1, 1), (1, 1, 1, 1), 0.0),
    "three_foot":      (0.4, 0.666, (0.0, 0.666, 0.0, 0.333), (0, 1, 1, 1), (0, 1, 1, 1), 0.0),
}


class SchedulerParams(NamedTuple):
    period: torch.Tensor           # (...,) seconds
    switching_phase: torch.Tensor  # (...,)
    phase_offset: torch.Tensor     # (..., 4)
    phase_scale: torch.Tensor      # (..., 4)
    enabled: torch.Tensor          # (..., 4)


class SchedulerState(NamedTuple):
    phase: torch.Tensor            # (..., 4) per-leg phase in [0, 1)
    contact_prev: torch.Tensor     # (..., 4)


class SchedulerOutput(NamedTuple):
    contact: torch.Tensor              # (..., 4) scheduled contact
    phase_stance: torch.Tensor         # (..., 4)
    phase_swing: torch.Tensor          # (..., 4)
    time_stance_remaining: torch.Tensor
    time_swing_remaining: torch.Tensor
    touchdown: torch.Tensor            # (..., 4) bool, scheduled TD this tick
    liftoff: torch.Tensor              # (..., 4) bool


def params(name: str, dtype=torch.float32, device="cuda") -> SchedulerParams:
    p, sw, off, sc, en, _ip = GAIT_TABLE[name]
    t = lambda v: torch.tensor(v, dtype=dtype, device=device)
    return SchedulerParams(period=t(p), switching_phase=t(sw), phase_offset=t(off),
                           phase_scale=t(sc), enabled=t(en))


def init(prm: SchedulerParams) -> SchedulerState:
    """Initial phases at the gait's offsets (initialization semantics of
    GaitScheduler::initialize + phaseOffset)."""
    ph = prm.phase_offset * prm.enabled
    return SchedulerState(
        phase=ph, contact_prev=(ph <= prm.switching_phase[..., None]).to(ph.dtype))


def _outputs(phase, sw, enabled, period, phase_scale, contact_prev) -> SchedulerOutput:
    """Contact and swing figures of the advanced phases (the second half of
    GaitScheduler::step); sw and period carry a trailing leg axis."""
    in_contact = (phase <= sw) & (enabled > 0)
    one = torch.ones_like(phase_scale)
    period_leg = period / torch.where(phase_scale > 0, phase_scale, one)
    zero = torch.zeros_like(phase)
    phase_stance = torch.where(in_contact, phase / sw, torch.ones_like(phase))
    phase_swing = torch.where(in_contact, zero, (phase - sw) / torch.clamp(1.0 - sw, min=1e-9))
    t_stance_rem = torch.where(in_contact, period_leg * (sw - phase), zero)
    t_swing_rem = torch.where(in_contact, zero, period_leg * (1.0 - phase))
    contact = in_contact.to(phase.dtype)
    return SchedulerOutput(
        contact=contact,
        phase_stance=phase_stance,
        phase_swing=phase_swing,
        time_stance_remaining=t_stance_rem,
        time_swing_remaining=t_swing_rem,
        touchdown=(contact > 0) & (contact_prev == 0),
        liftoff=(contact == 0) & (contact_prev > 0),
    )


def step(state: SchedulerState, prm: SchedulerParams, dt: float
         ) -> tuple[SchedulerState, SchedulerOutput]:
    """One scheduler tick (GaitScheduler::step, GaitScheduler.cpp:96-205)."""
    dt_a = torch.tensor(dt, dtype=state.phase.dtype, device=state.phase.device)
    dphase = prm.phase_scale * (dt_a / prm.period[..., None])
    phase = torch.remainder(state.phase + dphase, 1.0) * prm.enabled
    out = _outputs(phase, prm.switching_phase[..., None], prm.enabled, prm.period[..., None],
                   prm.phase_scale, state.contact_prev)
    return SchedulerState(phase=phase, contact_prev=out.contact), out


def early_contact_handle(
    gait_offsets_f: torch.Tensor,
    gait_durations_f: torch.Tensor,
    swing_state: torch.Tensor,
    phase: torch.Tensor,
    foot_sensor: torch.Tensor,
    n_segments: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Contact-adaptive gait reshaping (OffsetDurationGait::
    earlyContactHandle, Gait.cpp:282-302, active in the CMPC variant via
    Gait_contact.cpp:179): when a foot touches down in the last quarter of
    its swing, pull its stance window earlier: offset -= diff, duration
    += diff with diff = (offset - phase) mod 1.  Returns the updated
    (offsets_f, durations_f)."""
    late_swing_touch = (swing_state > 0.75) & (foot_sensor > 0)
    diff = gait_offsets_f - phase[..., None]
    diff = torch.where(diff < -0.001, diff + 1.0, diff)
    new_off = torch.where(late_swing_touch, gait_offsets_f - diff * 1.0001, gait_offsets_f)
    new_dur = torch.where(late_swing_touch, gait_durations_f + diff, gait_durations_f)
    return new_off, new_dur


# ---------------------------------------------------------------------------
# Full dynamic scheduler: the complete GaitScheduler state machine
# (createGait / modifyGait / calcAuxiliaryGaitData, GaitScheduler.cpp:206-560)
# with all 15 GaitTypes including CUSTOM and the computed-parameter
# TRANSITION_TO_STAND.  Gait type, override mode and user parameters are
# tensors, so mixed fleets of schedulers step in lockstep.
# ---------------------------------------------------------------------------

# GaitType enum order (GaitScheduler.h:16-33)
GAIT_IDS: dict[str, int] = {
    "stand": 0, "stand_cycle": 1, "static_walk": 2, "amble": 3,
    "trot_walk": 4, "trot": 5, "trot_run": 6, "pace": 7, "bound": 8,
    "rotary_gallop": 9, "traverse_gallop": 10, "pronk": 11,
    "three_foot": 12, "custom": 13, "transition_to_stand": 14,
}
STAND = 0
CUSTOM = 13
TRANSITION_TO_STAND = 14

# overrideable flag per type (GaitScheduler.cpp:314-475): STAND/STAND_CYCLE
# and TRANSITION_TO_STAND are not, every parameterized gait is.
_OVERRIDEABLE = (0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0)


class GaitData(NamedTuple):
    """The full mutable gait definition + phase state (GaitData struct,
    GaitScheduler.h:38-110), as batched tensors."""

    current_gait: torch.Tensor        # (...,) int32
    next_gait: torch.Tensor           # (...,) int32
    period_nominal: torch.Tensor      # (...,)
    switching_nominal: torch.Tensor   # (...,)
    phase_offset: torch.Tensor        # (..., 4)
    phase_scale: torch.Tensor         # (..., 4)
    enabled: torch.Tensor             # (..., 4)
    overrideable: torch.Tensor        # (...,)
    initial_phase: torch.Tensor       # (...,) reference phase variable
    period_natural: torch.Tensor      # (...,) mode-4 natural-gait store
    switching_natural: torch.Tensor   # (...,)
    phase: torch.Tensor               # (..., 4)
    contact_prev: torch.Tensor        # (..., 4)


_TABLES: dict = {}


def _stacked_table(dtype=torch.float32, device="cuda"):
    """(15, ...) parameter rows in GaitType order (cached per dtype and
    device).  The CUSTOM row is a placeholder (createGait keeps the running
    parameters for CUSTOM, GaitScheduler.cpp:450-453); the
    TRANSITION_TO_STAND row is computed from the running state, not the
    table (:455-476)."""
    key = (dtype, str(device))
    if key not in _TABLES:
        names = list(GAIT_IDS)[:13]
        rows = [GAIT_TABLE[n] for n in names] + [GAIT_TABLE["stand"]] * 2
        cols = (np.array([r[0] for r in rows]), np.array([r[1] for r in rows]),
                np.array([r[2] for r in rows]), np.array([r[3] for r in rows], float),
                np.array([r[4] for r in rows], float), np.array(_OVERRIDEABLE, float),
                np.array([r[5] for r in rows]))
        _TABLES[key] = tuple(torch.from_numpy(c).to(device=device, dtype=dtype) for c in cols)
    return _TABLES[key]


def gait_data_init(batch: tuple = (), gait: str = "stand", dtype=torch.float32,
                   device="cuda") -> GaitData:
    """initialize() semantics (GaitScheduler.cpp:75-89): start in STAND
    (or the named gait), zero phases, create the gait, store naturals."""
    batch = tuple(batch)
    gid = torch.full(batch, GAIT_IDS[gait], dtype=torch.int32, device=device)
    ones = lambda *s: torch.ones(batch + s, dtype=dtype, device=device)
    zeros = lambda *s: torch.zeros(batch + s, dtype=dtype, device=device)
    gd = GaitData(
        current_gait=torch.full(batch, -1, dtype=torch.int32, device=device),  # force create
        next_gait=gid,
        period_nominal=ones(),
        switching_nominal=ones(),
        phase_offset=zeros(4),
        phase_scale=ones(4),
        enabled=ones(4),
        overrideable=zeros(),
        initial_phase=zeros(),
        period_natural=ones(),
        switching_natural=ones(),
        phase=zeros(4),
        contact_prev=zeros(4),
    )
    gd = create_gait(gd, gid)
    return gd._replace(period_natural=gd.period_nominal,
                       switching_natural=gd.switching_nominal)


def create_gait(gd: GaitData, next_gait: torch.Tensor) -> GaitData:
    """createGait + calcAuxiliaryGaitData (GaitScheduler.cpp:278-575):
    load the parameter row for ``next_gait`` (table gaits), keep the
    running parameters for CUSTOM, or compute the TRANSITION_TO_STAND
    parameters from the current phases so each foot's time-to-cycle-end
    is preserved while the period stretches 3x (:455-476); then
    re-initialize the phase variables phase = initial_phase + offset."""
    period_t, sw_t, off_t, sc_t, en_t, ov_t, ip_t = _stacked_table(
        gd.period_nominal.dtype, gd.period_nominal.device)
    gid = next_gait.long()

    # table row (CUSTOM/TRANSITION rows are placeholders, masked below)
    period, sw, off, sc, en, ov = (period_t[gid], sw_t[gid], off_t[gid], sc_t[gid],
                                   en_t[gid], ov_t[gid])

    is_custom = next_gait == CUSTOM
    is_trans = next_gait == TRANSITION_TO_STAND
    cv, tv = is_custom[..., None], is_trans[..., None]

    # CUSTOM: keep running parameters (the reference leaves GaitData as is)
    period = torch.where(is_custom, gd.period_nominal, period)
    sw = torch.where(is_custom, gd.switching_nominal, sw)
    off = torch.where(cv, gd.phase_offset, off)
    sc = torch.where(cv, gd.phase_scale, sc)
    en = torch.where(cv, gd.enabled, en)
    ov = torch.where(is_custom, gd.overrideable, ov)

    # TRANSITION_TO_STAND (:455-476)
    p_old = gd.period_nominal
    p_new = 3.0 * p_old
    sw_trans = (p_new + p_old * (gd.switching_nominal - 1.0)) / p_new
    off_trans = (p_new[..., None] + p_old[..., None] * (gd.phase - 1.0)) / p_new[..., None]
    one, zero = torch.ones_like(sc), torch.zeros_like(ov)
    period = torch.where(is_trans, p_new, period)
    sw = torch.where(is_trans, sw_trans, sw)
    off = torch.where(tv, off_trans, off)
    sc = torch.where(tv, one, sc)
    en = torch.where(tv, one, en)
    ov = torch.where(is_trans, zero, ov)

    # every non-CUSTOM createGait case resets initialPhase to the table
    # value (0 but for PACE's quarter period, GaitScheduler.cpp:387); CUSTOM
    # keeps the running value, so switching to it mid-cycle does not snap
    # the phases back to the raw offsets.  TRANSITION_TO_STAND folds the
    # current phases into its offsets, so its initialPhase stays 0.
    ip = torch.where(is_custom, gd.initial_phase, ip_t[gid])
    phase = (ip[..., None] + off) * en
    return gd._replace(
        current_gait=next_gait.to(torch.int32), next_gait=next_gait.to(torch.int32),
        period_nominal=period, switching_nominal=sw,
        phase_offset=off, phase_scale=sc, enabled=en, overrideable=ov,
        initial_phase=ip, phase=phase,
    )


def modify_gait(
    gd: GaitData,
    override_mode: torch.Tensor,
    user_gait: torch.Tensor,
    user_period: torch.Tensor,
    user_switching: torch.Tensor,
) -> GaitData:
    """modifyGait (GaitScheduler.cpp:206-273), all 5 override modes as
    batched selects:

    0/3 follow next_gait set by control code (create on change);
    1   force the user-chosen gait, default settings;
    2   user gait + live period/switching override, gated by the
        gait's overrideable flag, phases re-seeded (calcAux);
    4   natural-gait modification: on change store the new nominals as
        'natural', otherwise restore them and re-seed phases each step.
    """
    mode = override_mode
    want_next = torch.where((mode == 1) | (mode == 2), user_gait,
                            gd.next_gait).to(torch.int32)
    do_create = want_next != gd.current_gait

    created = create_gait(gd, want_next)
    sel = lambda a, b: torch.where(do_create, a, b)
    selv = lambda a, b: torch.where(do_create[..., None], a, b)
    gd = GaitData(
        current_gait=sel(created.current_gait, gd.current_gait),
        next_gait=sel(created.next_gait, gd.next_gait),
        period_nominal=sel(created.period_nominal, gd.period_nominal),
        switching_nominal=sel(created.switching_nominal, gd.switching_nominal),
        phase_offset=selv(created.phase_offset, gd.phase_offset),
        phase_scale=selv(created.phase_scale, gd.phase_scale),
        enabled=selv(created.enabled, gd.enabled),
        overrideable=sel(created.overrideable, gd.overrideable),
        initial_phase=sel(created.initial_phase, gd.initial_phase),
        period_natural=gd.period_natural,
        switching_natural=gd.switching_natural,
        phase=selv(created.phase, gd.phase),
        contact_prev=gd.contact_prev,
    )

    # mode 2: live parameter override when the gait allows it (:230-252)
    differs = ((torch.abs(gd.period_nominal - user_period) > 1e-4)
               | (torch.abs(gd.switching_nominal - user_switching) > 1e-4))
    apply2 = (mode == 2) & differs & (gd.overrideable == 1)
    new_period = torch.where(apply2, user_period, gd.period_nominal)
    new_sw = torch.where(apply2, user_switching, gd.switching_nominal)

    # mode 4: store naturals on change, restore them otherwise (:254-271)
    store4 = (mode == 4) & do_create
    restore4 = (mode == 4) & ~do_create
    period_nat = torch.where(store4, gd.period_nominal, gd.period_natural)
    sw_nat = torch.where(store4, gd.switching_nominal, gd.switching_natural)
    new_period = torch.where(restore4, period_nat, new_period)
    new_sw = torch.where(restore4, sw_nat, new_sw)

    # calcAuxiliaryGaitData after a parameter change re-seeds the phases
    reseed = (apply2 | restore4)[..., None]
    phase = torch.where(reseed, (gd.initial_phase[..., None] + gd.phase_offset) * gd.enabled,
                        gd.phase)
    return gd._replace(period_nominal=new_period, switching_nominal=new_sw,
                       period_natural=period_nat, switching_natural=sw_nat, phase=phase)


def step_full(
    gd: GaitData,
    dt: float,
    override_mode=0,
    user_gait=STAND,
    user_period=0.5,
    user_switching=0.5,
) -> tuple[GaitData, SchedulerOutput]:
    """One full scheduler tick: modifyGait, reference-phase tracking,
    per-foot monotonic phase advance with the STAND freeze
    (GaitScheduler.cpp:95-205), contact/swing outputs.

    override_mode / user_* may be Python numbers or batched tensors (the
    dynamic_reconfigure analog is one more input)."""
    dtype, device = gd.period_nominal.dtype, gd.period_nominal.device
    batch = gd.period_nominal.shape

    def asb(v, dt_=dtype):
        return torch.as_tensor(v, dtype=dt_, device=device).expand(batch)

    gd = modify_gait(gd, asb(override_mode, torch.int32), asb(user_gait, torch.int32),
                     asb(user_period), asb(user_switching))

    in_stand = gd.current_gait == STAND
    dt_a = torch.tensor(dt, dtype=dtype, device=device)
    # reference phase only advances outside STAND (:101-105)
    ip = torch.where(in_stand, gd.initial_phase,
                     torch.remainder(gd.initial_phase + dt_a / gd.period_nominal, 1.0))
    dphase = torch.where(in_stand[..., None], torch.zeros_like(gd.phase_scale),
                         gd.phase_scale * (dt_a / gd.period_nominal[..., None]))
    phase = torch.remainder(gd.phase + dphase, 1.0) * gd.enabled
    out = _outputs(phase, gd.switching_nominal[..., None], gd.enabled,
                   gd.period_nominal[..., None], gd.phase_scale, gd.contact_prev)
    return gd._replace(initial_phase=ip, phase=phase, contact_prev=out.contact), out
