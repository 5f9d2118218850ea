"""QP container (counterpart of ``quad_periodic_mpc_tpu/ops/qp_admm.py``).
Only ``QPData`` is ported: the WBIC relaxation QP is handed to
``ops/qp_pdip.py`` in it.  The condensed ADMM solver is not ported yet
(ROADMAP.md Queue 1)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class QPData(NamedTuple):
    """One batched QP instance set (leading batch dims shared)."""

    P: torch.Tensor        # (..., n, n)
    q: torch.Tensor        # (..., n)
    F: torch.Tensor        # (c, a) constraint block (shared)
    l: torch.Tensor        # (..., m) lower bounds
    u: torch.Tensor        # (..., m) upper bounds
