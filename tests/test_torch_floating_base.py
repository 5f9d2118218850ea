"""The port's articulated model against the JAX package: spatial algebra, leg
kinematics, the floating-base functions, and the plain versions of the
fused model-evaluation and contact-kinematics kernels.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX side is its XLA path, which the JAX package's own kernel tests tie to
its Pallas kernels.  Tolerances are those of
tests/test_kinematics_kernel.py unless stated: f32 sums over the 13-body
tree in another order.
"""

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

import jax.numpy as jnp

from quad_periodic_mpc_tpu.models import floating_base as j_fb
from quad_periodic_mpc_tpu.models import leg_kinematics as j_lk
from quad_periodic_mpc_tpu.models import spatial as j_sp
from quad_periodic_mpc_tpu_torch import convert
from quad_periodic_mpc_tpu_torch.models import floating_base as t_fb
from quad_periodic_mpc_tpu_torch.models import leg_kinematics as t_lk
from quad_periodic_mpc_tpu_torch.models import spatial as t_sp
from quad_periodic_mpc_tpu_torch.ops.cuda import kinematics_kernel as TK
from quad_periodic_mpc_tpu_torch.testing import kernel_cases

MC_J = j_fb.build_a1_constants("float32")
MC_T = t_fb.build_a1_constants("float32", "cpu")
TOL = {"A": 1e-4, "G": 1e-3, "C": 2e-3, "Jc": 2e-5, "Jcdqd": 5e-4, "p_foot": 2e-5}


def _states(B, seed):
    """The same random states for both packages (numpy arrays)."""
    st = kernel_cases.model_states(B, seed=seed, device="cpu")
    arrays = {f: getattr(st, f).numpy() for f in t_fb.FBState._fields}
    return st, j_fb.FBState(**{f: jnp.asarray(a) for f, a in arrays.items()})


def close(tt, jj, atol):
    np.testing.assert_allclose(tt.detach().numpy(), np.asarray(jj), atol=atol, rtol=0)


def test_build_a1_constants_equal_reference():
    """Built from the same float64 numpy recipe: equal field by field."""
    for f in j_fb.ModelConstants._fields:
        want, got = getattr(MC_J, f), getattr(MC_T, f)
        if isinstance(want, tuple):
            assert got == want, f
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f)
            assert got.dtype == torch.float32


def test_model_constants_carried_across():
    mc = convert.model_constants(MC_J, "cpu")
    for f in t_fb.ModelConstants._fields:
        a, b = getattr(mc, f), getattr(MC_T, f)
        if isinstance(b, tuple):
            assert a == b, f
        else:
            assert torch.equal(a, b), f


@pytest.mark.parametrize("name,tol", [
    ("mass_matrix", TOL["A"]), ("generalized_gravity", TOL["G"]),
    ("generalized_coriolis", TOL["C"])])
def test_dynamics_terms_match(name, tol):
    st_t, st_j = _states(5, seed=4)
    close(getattr(t_fb, name)(st_t, MC_T), getattr(j_fb, name)(st_j, MC_J), tol)


def test_contact_jacobians_and_forward_kinematics_match():
    """Contact terms to the kernel-test tolerances; the link transforms and
    velocities of forward_kinematics to 1e-5 (O(1) entries, reordered
    3x3 and 6x6 products)."""
    st_t, st_j = _states(5, seed=2)
    got, want = t_fb.contact_jacobians(st_t, MC_T), j_fb.contact_jacobians(st_j, MC_J)
    for f in ("Jc", "Jcdqd", "p_foot"):
        close(getattr(got, f), getattr(want, f), TOL[f])
    kt, kj = t_fb.forward_kinematics(st_t, MC_T), j_fb.forward_kinematics(st_j, MC_J)
    for f in ("Xup", "Xa", "v", "c"):
        for a, b in zip(getattr(kt, f), getattr(kj, f)):
            close(a, b, 1e-5)


def test_model_eval_plain_version_matches_reference():
    """The fused model evaluation on CPU tensors (its plain version) against
    the JAX XLA functions; A^{-1} is held by |A^{-1} A - I| < 5e-3."""
    st_t, st_j = _states(5, seed=4)
    A, Ainv, G, C, info = TK.fused_model_eval(st_t, MC_T)
    close(A, j_fb.mass_matrix(st_j, MC_J), TOL["A"])
    close(G, j_fb.generalized_gravity(st_j, MC_J), TOL["G"])
    close(C, j_fb.generalized_coriolis(st_j, MC_J), TOL["C"])
    ref = j_fb.contact_jacobians(st_j, MC_J)
    for f in ("Jc", "Jcdqd", "p_foot"):
        close(getattr(info, f), getattr(ref, f), TOL[f])
    close(Ainv @ A, np.broadcast_to(np.eye(18), (5, 18, 18)), 5e-3)


def test_contact_kinematics_plain_version_matches_reference():
    st_t, st_j = _states(7, seed=2)
    got = TK.fused_contact_kinematics(st_t, MC_T)
    want = j_fb.contact_jacobians(st_j, MC_J)
    for f in ("Jc", "Jcdqd", "p_foot"):
        close(getattr(got, f), getattr(want, f), TOL[f])


def test_spatial_algebra_matches():
    """Elementwise f32 formulas: 1e-6 (cos/sin and reordered 3x3 products)."""
    rng = np.random.default_rng(9)
    R = np.asarray(j_sp.joint_rotation("x", jnp.asarray(rng.uniform(-1, 1, 4), jnp.float32)))
    r, a, b = (rng.normal(size=(4, n)).astype(np.float32) for n in (3, 6, 6))
    t = lambda x: torch.from_numpy(np.array(x))
    close(t_sp.sxform(t(R), t(r)), j_sp.sxform(jnp.asarray(R), jnp.asarray(r)), 1e-6)
    close(t_sp.motion_cross(t(a), t(b)), j_sp.motion_cross(jnp.asarray(a), jnp.asarray(b)), 1e-6)
    close(t_sp.force_cross(t(a), t(b)), j_sp.force_cross(jnp.asarray(a), jnp.asarray(b)), 1e-6)
    I_rot = np.diag([0.1, 0.2, 0.3]).astype(np.float32)
    close(t_sp.spatial_inertia(1.5, t(r), t(I_rot)),
          j_sp.spatial_inertia(1.5, jnp.asarray(r), jnp.asarray(I_rot)), 1e-6)
    qv = rng.uniform(-2, 2, 5).astype(np.float32)
    for axis in "xyz":
        close(t_sp.joint_rotation(axis, t(qv)), j_sp.joint_rotation(axis, jnp.asarray(qv)), 1e-6)
        close(t_sp.joint_motion_subspace(axis, device="cpu"),
              j_sp.joint_motion_subspace(axis, jnp.float32), 0.0)
    for rot in ("rot_x", "rot_y", "rot_z"):
        np.testing.assert_array_equal(getattr(t_sp, rot)(0.7), getattr(j_sp, rot)(0.7))


def test_leg_kinematics_match():
    """FK, Jacobian and foot velocity 1e-6; IK round trip and agreement
    1e-5 (atan2/arccos near the workspace edge)."""
    rng = np.random.default_rng(11)
    q = (np.array([0.0, 0.8, -1.6]) + rng.uniform(-0.3, 0.3, (4, 4, 3))).astype(np.float32)
    qd = rng.uniform(-2, 2, (4, 4, 3)).astype(np.float32)
    side = np.array([-1.0, 1.0, -1.0, 1.0], np.float32)
    gt, gj = t_lk.LegGeometry(0.0838, 0.2, 0.2), j_lk.LegGeometry(0.0838, 0.2, 0.2)
    t = lambda x: torch.from_numpy(x)
    qj, sj = jnp.asarray(q), jnp.asarray(side)
    close(t_lk.foot_position(t(q), gt, t(side)), j_lk.foot_position(qj, gj, sj), 1e-6)
    close(t_lk.leg_jacobian(t(q), gt, t(side)), j_lk.leg_jacobian(qj, gj, sj), 1e-6)
    close(t_lk.foot_velocity(t(q), t(qd), gt, t(side)),
          j_lk.foot_velocity(jnp.asarray(q), jnp.asarray(qd), gj, jnp.asarray(side)), 1e-6)
    p = t_lk.foot_position(t(q), gt, t(side))
    q_ik = t_lk.inverse_kinematics(p, gt, t(side))
    close(q_ik, j_lk.inverse_kinematics(jnp.asarray(p.numpy()), gj, jnp.asarray(side)), 1e-5)
    close(t_lk.foot_position(q_ik, gt, t(side)), p.numpy(), 1e-5)
