"""Golden solves through the reference's own qpOASES (counterpart of
``quad_periodic_mpc_tpu/testing/golden.py``).

Loads the committed ``tools/golden/libqpoases_golden.so`` through ctypes:
the active-set solver the reference controller calls at
SolverMPC.cpp:955-982 (QProblem, Options::setToMPC, nWSR = 100), built by
``tools/golden/build.sh`` from the reference tree.  That tree is not part
of this repository, so nothing here builds the library; where it is
missing, ``available()`` is False and ``load()`` raises.

The reduced entry point also replicates the reference's swing-leg variable
elimination (SolverMPC.cpp:859-950): zero-bound z-rows mark their foot's 3
variables and 5 constraint rows for removal; the reduced QP is solved and
re-expanded with zeros.  numpy only; nothing is loaded at import.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_LIB = os.path.join(_REPO, "tools", "golden", "libqpoases_golden.so")

_lib = None


def available() -> bool:
    """True if the golden library loads."""
    try:
        return load() is not None
    except OSError:
        return False


def load(path: Optional[str] = None) -> ctypes.CDLL:
    """Load the golden qpOASES library (once per process)."""
    global _lib
    if _lib is not None:
        return _lib
    path = path or DEFAULT_LIB
    if not os.path.exists(path):
        raise OSError(
            f"golden qpOASES library not found at {path}: it is built from the "
            "reference tree by tools/golden/build.sh")
    lib = ctypes.CDLL(path)
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    for name in ("qpm_golden_solve", "qpm_golden_solve_reduced"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int, dp, dp, dp, dp, dp,
                       ctypes.c_int, dp, ip]
    _lib = lib
    return lib


def _as_c(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64))


def solve(H, g, A, lb, ub, nwsr: int = 100, reduced: bool = False):
    """Solve min 0.5 x'Hx + g'x  s.t. lb <= Ax <= ub with the reference's
    qpOASES, in float64 on the host (arrays or tensors).

    The assembled P / q already carry the reference's factor 2 (qH = 2(B'SB
    + aI), qg = 2 B'S(...), SolverMPC.cpp:806-814), and qpOASES minimizes
    0.5 x'Hx + g'x, exactly as the reference passes them.

    Returns (x, status, aux): aux is the nWSR used (full) or the reduced
    variable count (reduced); status 0 is SUCCESSFUL_RETURN."""
    lib = load()
    H, g, A = _as_c(H), _as_c(g), _as_c(A)
    lb, ub = _as_c(lb), _as_c(ub)
    n, m = g.shape[0], lb.shape[0]
    if not (H.shape == (n, n) and A.shape == (m, n) and ub.shape == (m,)):
        raise ValueError(f"golden.solve: H {H.shape}, A {A.shape}, ub {ub.shape} "
                         f"for n = {n}, m = {m}")
    x = np.zeros(n, dtype=np.float64)
    aux = ctypes.c_int(0)
    dp = ctypes.POINTER(ctypes.c_double)
    args = (n, m, H.ctypes.data_as(dp), g.ctypes.data_as(dp),
            A.ctypes.data_as(dp), lb.ctypes.data_as(dp),
            ub.ctypes.data_as(dp), nwsr, x.ctypes.data_as(dp),
            ctypes.byref(aux))
    fn = lib.qpm_golden_solve_reduced if reduced else lib.qpm_golden_solve
    status = fn(*args)
    return x, status, aux.value


def dense_constraint_matrix(F, horizon: int) -> np.ndarray:
    """The reference's fmat (SolverMPC.cpp:657-665): the (20h, 12h)
    block diagonal of the (5, 3) pyramid block, one block per (step, leg)."""
    F = _as_c(F)
    nb = horizon * 4
    A = np.zeros((nb * 5, nb * 3), dtype=np.float64)
    for i in range(nb):
        A[i * 5:(i + 1) * 5, i * 3:(i + 1) * 3] = F
    return A
