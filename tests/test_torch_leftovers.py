"""The last functions of already-ported modules against the JAX package:
the stagewise cross-check copies (``LQRGains``, ``lqr_factorize``,
``lqr_apply``, ``solve_blocked``), ``zoh_via_expm``, ``rotmat_to_rpy``,
``world_inertia``, ``sxform_inv_T`` and ``stance_command_from_mpc``.

Float64 at small batches; inputs made with numpy from a seed.  The JAX side
is jitted and runs its XLA paths.
"""

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from _torch_stagewise_cases import jax_problem, port
from quad_periodic_mpc_tpu.config import ADMMConfig as JADMM
from quad_periodic_mpc_tpu.control import leg_controller as j_leg
from quad_periodic_mpc_tpu.models import spatial as j_spatial
from quad_periodic_mpc_tpu.models import srb as j_srb
from quad_periodic_mpc_tpu.ops import discretize as j_disc
from quad_periodic_mpc_tpu.ops import qp_stagewise as j_qs
from quad_periodic_mpc_tpu.ops import rotations as j_rot
from quad_periodic_mpc_tpu_torch.config import ADMMConfig
from quad_periodic_mpc_tpu_torch.control import leg_controller as t_leg
from quad_periodic_mpc_tpu_torch.models import spatial as t_spatial
from quad_periodic_mpc_tpu_torch.models import srb as t_srb
from quad_periodic_mpc_tpu_torch.ops import discretize as t_disc
from quad_periodic_mpc_tpu_torch.ops import linalg as t_linalg
from quad_periodic_mpc_tpu_torch.ops import qp_stagewise as t_qs
from quad_periodic_mpc_tpu_torch.ops import rotations as t_rot
from quad_periodic_mpc_tpu_torch.ops.rotations import quat_to_rotmat

B, H = 3, 12
# float64 on both sides; JAX's factorization is an associative scan, the
# port's recursive doubling: the same operator composed in another order
# (measured 2.3e-13 on gains of order 6e2, 4e-16 of the largest entry)
GAINS_RTOL = 1e-12
# float64 x-updates and 60 ADMM iterations: the iterate inherits the gains'
# roundoff (measured 1.4e-12 on one x-update of size 3e3, 7e-13 on forces
# of ~100 N after 60 iterations)
SOLVE_ATOL = 1e-9


def _rng_rotations(seed, n):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return quat_to_rotmat(torch.from_numpy(q))


@pytest.fixture(scope="module")
def problems():
    """A float64 batch of trot problems with a time-invariant c: JAX's and
    the port's copy, and the ADMM penalty block G = rho F'F."""
    sw, _ = jax_problem(7, B, H, dtype=np.float64)
    rho = ADMMConfig().rho
    G = rho * (sw.F.T @ sw.F)
    return sw, port(sw), G, torch.from_numpy(np.array(G))


def test_lqr_factorize_matches_jax(problems):
    jsw, tsw, jG, tG = problems
    jg = jax.jit(j_qs.lqr_factorize)(jsw, jG)
    tg = t_qs.lqr_factorize(tsw, tG)
    assert isinstance(tg, t_qs.LQRGains) and tg._fields == jg._fields
    for name in jg._fields:
        a, b = getattr(tg, name).numpy(), np.asarray(getattr(jg, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=GAINS_RTOL, atol=GAINS_RTOL * np.abs(b).max(),
                                   err_msg=name)


def test_lqr_apply_matches_jax_and_the_sequential_oracle(problems):
    """One x-update from the gains: JAX's two associative scans against the
    port's doubling scans, and the port's against ``lqr_solve`` (the
    sequential backward Riccati and rollout)."""
    jsw, tsw, jG, tG = problems
    r_lin = np.random.default_rng(3).uniform(-5, 5, (B, H, 12))
    jU = jax.jit(lambda sw, G, r: j_qs.lqr_apply(j_qs.lqr_factorize(sw, G), sw, r))(
        jsw, jG, jnp.asarray(r_lin))
    tU = t_qs.lqr_apply(t_qs.lqr_factorize(tsw, tG), tsw, torch.from_numpy(r_lin))
    np.testing.assert_allclose(tU.numpy(), np.asarray(jU), atol=SOLVE_ATOL)
    oracle = t_qs.lqr_solve(tsw, tG, torch.from_numpy(r_lin))
    np.testing.assert_allclose(tU.numpy(), oracle.numpy(), atol=SOLVE_ATOL)


def test_solve_blocked_matches_packed_and_jax(problems):
    """The gate of tests/test_stagewise.py::test_packed_solve_matches_blocked
    (U and y within 2e-3 of the production solve), and JAX's solve_blocked
    on the same problem."""
    jsw, tsw, _, _ = problems
    cfg = ADMMConfig(iterations=60)
    U_b, info_b = t_qs.solve_blocked(tsw, cfg)
    U_p, info_p = t_qs.solve(tsw, cfg)
    np.testing.assert_allclose(U_p.numpy(), U_b.numpy(), atol=2e-3)
    np.testing.assert_allclose(info_p["y"].numpy(), info_b["y"].numpy(), atol=2e-3)
    jU, jinfo = jax.jit(lambda sw: j_qs.solve_blocked(sw, JADMM(iterations=60)))(jsw)
    np.testing.assert_allclose(U_b.numpy(), np.asarray(jU), atol=SOLVE_ATOL)
    for k in ("z", "y"):
        np.testing.assert_allclose(info_b[k].numpy(), np.asarray(jinfo[k]), atol=SOLVE_ATOL)


def test_ns_posspec_inverses():
    """JAX's two private inverses of I + C J (C, J PSD), batch-leading and
    lane-major, are the port's linalg.ns_posspec_inverse."""
    rng = np.random.default_rng(5)
    a, b = rng.normal(size=(2, 4, 13, 13))
    C = torch.from_numpy(a @ a.transpose(0, 2, 1) * 0.05)
    J = torch.from_numpy(b @ b.transpose(0, 2, 1) * 0.05)
    M = torch.eye(13, dtype=torch.float64) + C @ J
    got = t_linalg.ns_posspec_inverse(M, 30).numpy()
    np.testing.assert_allclose(got, torch.linalg.inv(M).numpy(), atol=1e-10)
    np.testing.assert_allclose(
        got, np.asarray(j_qs._ns_posspec_inverse(jnp.asarray(M.numpy()), 30)), atol=1e-12)
    lane = np.asarray(j_qs._pns_posspec_inverse(jnp.asarray(M.permute(1, 2, 0).numpy()), 30))
    np.testing.assert_allclose(got, lane.transpose(2, 0, 1), atol=1e-10)


def test_zoh_via_expm_matches_nilpotent_and_jax():
    """The gate of tests/test_dynamics_discretize.py::
    test_nilpotent_zoh_matches_expm (the generic expm path within 1e-9 of
    the closed form), and JAX's zoh_via_expm."""
    R = _rng_rotations(11, 2)
    r_feet = torch.from_numpy(np.random.default_rng(12).uniform(-0.3, 0.3, (2, 4, 3)))
    A, Bm, Qc = t_srb.ct_dynamics(R, r_feet, 12.0, (0.07, 0.26, 0.242), x_drag=0.15)
    dt = 0.026
    closed = t_disc.nilpotent_zoh(A, Bm, Qc, dt)
    generic = t_disc.zoh_via_expm(A, Bm, Qc, dt)
    jax_generic = jax.jit(j_disc.zoh_via_expm, static_argnums=3)(
        *(jnp.asarray(m.numpy()) for m in (A, Bm, Qc)), dt)
    for c, g, j in zip(closed, generic, jax_generic):
        np.testing.assert_allclose(g.numpy(), c.numpy(), atol=1e-9)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-12)


def test_rotmat_to_rpy_matches_jax_and_inverts():
    rng = np.random.default_rng(13)
    rpy = rng.uniform([-1.0, -1.4, -3.0], [1.0, 1.4, 3.0], (64, 3))
    R = t_rot.rpy_to_rotmat(torch.from_numpy(rpy))
    out = t_rot.rotmat_to_rpy(R)
    np.testing.assert_allclose(out.numpy(), rpy, atol=1e-12)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(j_rot.rotmat_to_rpy(jnp.asarray(R.numpy()))), atol=1e-15)


def test_world_inertia_and_sxform_inv_T_match_jax():
    R = _rng_rotations(14, 5)
    I_diag = torch.from_numpy(np.random.default_rng(15).uniform(0.05, 0.3, (5, 3)))
    np.testing.assert_allclose(
        t_srb.world_inertia(R, I_diag).numpy(),
        np.asarray(j_srb.world_inertia(jnp.asarray(R.numpy()), jnp.asarray(I_diag.numpy()))),
        atol=1e-15)
    r = torch.from_numpy(np.random.default_rng(16).uniform(-0.5, 0.5, (5, 3)))
    X = t_spatial.sxform(R, r)
    XT = t_spatial.sxform_inv_T(X)
    np.testing.assert_array_equal(
        XT.numpy(), np.asarray(j_spatial.sxform_inv_T(jnp.asarray(X.numpy()))))
    # X^{-T} is the inverse transpose
    np.testing.assert_allclose((XT @ X.transpose(-1, -2)).numpy(),
                               np.broadcast_to(np.eye(6), (5, 6, 6)), atol=1e-14)


def test_stance_command_from_mpc_matches_jax():
    rng = np.random.default_rng(17)
    f, R, kd = rng.normal(size=(4, 3)), rng.normal(size=(3, 3)), rng.normal(size=(4, 3, 3))
    out = t_leg.stance_command_from_mpc(torch.from_numpy(f), torch.from_numpy(R),
                                        torch.from_numpy(kd))
    ref = j_leg.stance_command_from_mpc(jnp.asarray(f), jnp.asarray(R), jnp.asarray(kd))
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
