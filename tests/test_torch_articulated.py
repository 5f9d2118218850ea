"""The port's articulated plant against the JAX package: contact forces,
``step_fast``, ``step`` (with and without the tick cache and a base
force), ``init_on_ground``, and the plain version of the fused substep
kernel against the JAX Pallas kernel in interpret mode.

Inputs are made with numpy from a seed (the recipe of
tests/test_plant_kernel.py) and handed to both packages.
"""


import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from quad_periodic_mpc_tpu.models import floating_base as j_fb
from quad_periodic_mpc_tpu.ops.pallas import plant_kernel as j_pk
from quad_periodic_mpc_tpu.sim import articulated_sim as j_art
from quad_periodic_mpc_tpu_torch import convert
from quad_periodic_mpc_tpu_torch.models import floating_base as t_fb
from quad_periodic_mpc_tpu_torch.ops.cuda import plant_kernel as t_pk
from quad_periodic_mpc_tpu_torch.sim import articulated_sim as t_art
from quad_periodic_mpc_tpu_torch.testing import kernel_cases

MC_J = j_fb.build_a1_constants("float32")
MC_T = t_fb.build_a1_constants("float32", "cpu")
# the tolerances of test_fused_substeps_match_step_fast: stiff penalty
# contact amplifies f32 sums of qdd taken in another order
STATE_TOL = {"pos": 1e-5, "quat": 1e-6, "v_body": 5e-4, "q": 1e-5, "qd": 2e-3}


def _jax(x):
    """Port tensors (NamedTuples of them, nested) -> JAX arrays."""
    if isinstance(x, torch.Tensor):
        return jnp.asarray(x.numpy())
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_jax(v) for v in x))
    return tuple(_jax(v) for v in x)


def _j_art_state(plant):
    return j_art.ArtState(fb=j_fb.FBState(*_jax(tuple(plant.fb))), t=_jax(plant.t),
                          anchor=_jax(plant.anchor), in_contact=_jax(plant.in_contact))


def _close_state(got, want):
    for f, tol in STATE_TOL.items():
        np.testing.assert_allclose(getattr(got.fb, f).numpy(), np.asarray(getattr(want.fb, f)),
                                   atol=tol, rtol=0, err_msg=f)


def test_init_on_ground_matches():
    """The stand-pose FK height and the anchors under the feet: 1e-6."""
    got = t_art.init_on_ground((2,), penetration=3.8e-3, device="cpu")
    want = j_art.init_on_ground((2,), penetration=3.8e-3, dtype=jnp.float32)
    for f in t_fb.FBState._fields:
        np.testing.assert_allclose(getattr(got.fb, f).numpy(), np.asarray(getattr(want.fb, f)),
                                   atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.anchor.numpy(), np.asarray(want.anchor), atol=1e-6, rtol=0)
    back = convert.art_state(want, "cpu")
    assert torch.equal(back.fb.q, torch.tensor(np.asarray(want.fb.q)))


def test_contact_forces_match():
    """Penetrating, sliding and airborne feet: forces to 1e-3 N (stiffness
    8000 N/m times f32 positions), anchors to 1e-6 m."""
    plant, tau, cache, Jc, pf = kernel_cases.plant_case(4, seed=1, device="cpu",
                                                        penetration=6e-3)
    rng = np.random.default_rng(2)
    pf = pf + torch.from_numpy(rng.uniform(-4e-3, 4e-3, pf.shape).astype(np.float32))
    anchor = plant.anchor + torch.from_numpy(rng.uniform(-0.01, 0.01, (4, 4, 2)).astype(np.float32))
    qdot = torch.cat([plant.fb.v_body, plant.fb.qd], -1)
    info_t = t_fb.ContactInfo(Jc=Jc, Jcdqd=None, p_foot=pf)
    info_j = j_fb.ContactInfo(Jc=_jax(Jc), Jcdqd=None, p_foot=_jax(pf))
    f_t, a_t = t_art.contact_forces(info_t, qdot, anchor, t_art.ContactParams())
    f_j, a_j = j_art.contact_forces(info_j, _jax(qdot), _jax(anchor), j_art.ContactParams(),
                                    jnp.float32)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=1e-3, rtol=0)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=1e-6, rtol=0)
    assert (f_t[..., 2] > 0).any() and (f_t[..., 2] == 0).any()


def test_step_fast_matches():
    plant, tau, cache, Jc, pf = kernel_cases.plant_case(3, device="cpu")
    params = t_art.ContactParams()
    s_t, pf_t, f_t = t_art.step_fast(plant, tau, 2e-4, params, cache, Jc, pf)
    s_j, pf_j, f_j = j_art.step_fast(_j_art_state(plant), _jax(tau), 2e-4,
                                     j_art.ContactParams(), _jax(cache), _jax(Jc), _jax(pf))
    _close_state(s_t, s_j)
    np.testing.assert_allclose(pf_t.numpy(), np.asarray(pf_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=1e-3, rtol=0)


@pytest.mark.parametrize("cached", [False, True])
def test_step_matches(cached):
    """One 1 ms step from the exact model (Schur-inverse solve) or the tick
    cache, with a world force on the base."""
    plant, tau, cache, Jc, pf = kernel_cases.plant_case(3, device="cpu")
    f_ext = torch.tensor([[5.0, -3.0, 0.0]] * 3)
    s_t, f_t = t_art.step(plant, tau, MC_T, dt=1e-3, f_ext_base=f_ext,
                          cache=cache if cached else None)
    s_j, f_j = j_art.step(_j_art_state(plant), _jax(tau), MC_J, dt=1e-3,
                          f_ext_base=_jax(f_ext), cache=_jax(cache) if cached else None)
    _close_state(s_t, s_j)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=1e-3, rtol=0)


def test_model_cache_matches():
    """(A^{-1}, G, C): rtol 1e-4 on A^{-1} (entries up to ~300, Schur
    recursion in another order), G 1e-3, C 2e-3."""
    plant = kernel_cases.plant_case(3, device="cpu")[0]
    got = t_art.model_cache(plant, MC_T)
    want = j_art.model_cache(_j_art_state(plant), MC_J)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=2e-3, rtol=0)


def test_substep_kernel_plain_version_matches_jax_kernel():
    """fused_substeps on CPU tensors (10 chained step_fast substeps) against
    the JAX Pallas kernel in interpret mode, at B = 3, with the tolerances
    of test_fused_substeps_match_step_fast; p_foot and anchors 1e-5."""
    plant, tau, cache, Jc, pf = kernel_cases.plant_case(3, device="cpu")
    params = t_art.ContactParams()
    s_t, pf_t = t_pk.fused_substeps(plant, tau, 2e-4, params, cache, Jc, pf, 10)
    s_j, pf_j = jax.jit(lambda p, t, c, J, f: j_pk.fused_substeps(
        p, t, 2e-4, j_art.ContactParams(), c, J, f, 10, interpret=True))(
        _j_art_state(plant), _jax(tau), _jax(cache), _jax(Jc), _jax(pf))
    _close_state(s_t, s_j)
    np.testing.assert_allclose(pf_t.numpy(), np.asarray(pf_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(s_t.anchor.numpy(), np.asarray(s_j.anchor), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(s_t.in_contact.numpy(), np.asarray(s_j.in_contact))
    np.testing.assert_allclose(s_t.t.numpy(), np.asarray(s_j.t), atol=1e-7, rtol=0)
