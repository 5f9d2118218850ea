"""The reference figures behind chip_smoke.py's phase-17 gates, on the CPU.

    python tools/slice8_reference.py [--package jax|torch|both] [--batch 8]
        [--ticks 1500]

Runs the torque-level force stand (the reference's capstone,
tests/test_articulated_sim.py:57-125, with the safety post-check and the
FSM fed each tick: the port's ``control/force_stand.py``, and the same loop
written here on the JAX package) at B instances in float32 under the
kernel convention of chip_smoke's phase 17a: one model evaluation a tick
(``art.model_cache`` + contact Jacobians), ten ``art.step_fast`` substeps
of 1e-4 s.  ``Package(..., exact=True)`` runs the capstone's own
convention instead, ``art.step`` every substep, in both packages (the
port's ``force_stand.command`` with the substeps written here).  Instance i
holds a CoM height of z0 + chip_smoke.stand_offsets(B)[i] (instance 0: z0);
the inputs are chip_smoke's.  Prints per instance the final
body height and its error to the target, quat[0], the largest |v_body| of
the final state, the final FSM state and mode, and whether every safety
mask held on every tick; then the VBL figures of phase 17b on the final
states (``balance_vbl.solve`` at the target pose, a seeded quarter on three
legs): the summed forces and the largest |P| of the CARE (the port only:
the reference's solve does not return P).

JAX runs on the CPU with 64-bit mode off (float32, as on the TPU), its tick
jitted (its XLA path).  ~20 s for JAX and ~3 min for the port at B = 8.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# phase 17's inputs, defined in chip_smoke.py (which imports nothing of JAX)
from chip_smoke import STAND_TICKS, stand_offsets, vbl_inputs  # noqa: E402
from chip_smoke import stand_request as request  # noqa: E402


class Package:
    """The force stand in one package, numpy at the edges."""

    def __init__(self, name: str, dtype: str = "float32", exact: bool = False):
        self.name, self.dtype, self.exact = name, dtype, exact
        if name == "jax":
            import jax

            jax.config.update("jax_platforms", "cpu")
            self._tick = jax.jit(self._jax_tick)
        else:
            self._tick = self._torch_tick

    # -- the port's side -------------------------------------------------------
    def _torch_tick(self, plant, f, req, stand, mc):
        from quad_periodic_mpc_tpu_torch.control import force_stand
        from quad_periodic_mpc_tpu_torch.models import floating_base as fb
        from quad_periodic_mpc_tpu_torch.sim import articulated_sim as art

        if not self.exact:
            return force_stand.tick(plant, f, req, stand, mc)
        f2, record = force_stand.command(plant, f, req, stand, fb.contact_jacobians(plant.fb, mc))
        for _ in range(10):
            plant = art.step(plant, record.tau, mc, dt=1e-4)[0]
        return plant, f2, record

    # -- the JAX package's side ---------------------------------------------
    def _jax_tick(self, plant, f, req, com, footholds):
        import jax
        import jax.numpy as jnp

        from quad_periodic_mpc_tpu.control import balance, fsm, safety
        from quad_periodic_mpc_tpu.control import leg_controller as lc
        from quad_periodic_mpc_tpu.models import floating_base as fb
        from quad_periodic_mpc_tpu.models.a1 import A1
        from quad_periodic_mpc_tpu.ops.rotations import quat_to_rotmat, quat_to_rpy
        from quad_periodic_mpc_tpu.sim import articulated_sim as art

        dtype = plant.fb.pos.dtype
        MC = fb.build_a1_constants(self.dtype)
        P = fb.A1ModelParams()
        m_tot = P.body_mass + 4 * (P.abad_mass + P.hip_mass + P.knee_mass + 3 * P.rotor_mass)
        cfg = balance.BalanceSettings(mass=m_tot, max_force=260.0)
        s = plant.fb
        batch = s.pos.shape[:-1]
        info = fb.contact_jacobians(s, MC)
        R = quat_to_rotmat(s.quat)
        rpy = quat_to_rpy(s.quat)
        v_world = jnp.einsum("...ij,...j->...i", R, s.v_body[..., 3:6])
        omega_world = jnp.einsum("...ij,...j->...i", R, s.v_body[..., 0:3])
        z3 = jnp.zeros_like(v_world)
        cmd = balance.BalanceCommand(p_des=com, v_des=z3, a_des=z3,
                                     R_des=jnp.broadcast_to(jnp.eye(3, dtype=dtype), R.shape),
                                     omega_des=z3)
        force = balance.solve(s.pos, v_world, R, omega_world, rpy[..., 2],
                              info.p_foot - s.pos[..., None, :],
                              jnp.ones(batch + (4,), dtype), cmd, cfg)
        q = s.q.reshape(batch + (4, 3))
        data = lc.update_data(q, s.qd.reshape(batch + (4, 3)), A1)
        hips = jnp.asarray(A1.hip_locations(), dtype)
        f_body = jnp.einsum("...ji,...kj->...ki", R, force)
        p_des_leg = jnp.einsum("...ji,...kj->...ki", R, footholds - s.pos[..., None, :]) - hips
        v_des_leg = jnp.broadcast_to(
            jnp.einsum("...ji,...j->...i", R, -v_world)[..., None, :], q.shape)
        checks = safety.run_checks(rpy, p_des_leg, -f_body, A1)
        loco = safety.check_locomotion_safe(rpy, data.p, data.v)
        f2 = fsm.step(f, req, checks.safe_orientation, loco)
        leg_cmd = lc.LegCommand.zeros(batch, dtype)._replace(
            force_ff=checks.force_ff, p_des=checks.p_des, v_des=v_des_leg, q_des=data.q,
            qd_des=jnp.zeros_like(q), kp_cartesian=jnp.full_like(q, 300.0),
            kd_cartesian=jnp.full_like(q, 8.0), kd_joint=jnp.full_like(q, 1.0))
        tau = lc.torque_output(cmd=leg_cmd, data=data, model=A1, flip_signs=False)
        if self.exact:
            def sub(st, _):
                return art.step(st, tau, MC, dt=1e-4)[0], None

            plant, _ = jax.lax.scan(sub, plant, None, length=10)
        else:
            cache = art.model_cache(plant, MC)

            def sub(carry, _):
                st, pf = carry
                st, pf, _ = art.step_fast(st, tau, 1e-4, art.ContactParams(), cache, info.Jc, pf)
                return (st, pf), None

            (plant, _), _ = jax.lax.scan(sub, (plant, info.p_foot), None, length=10)
        masks = (checks.safe_orientation, loco, checks.safe_p_des, checks.safe_force)
        return plant, f2, masks

    # -- shared run loop -------------------------------------------------------
    def start(self, B: int):
        """(plant, fsm, com, footholds) of the stand at B instances."""
        d = stand_offsets(B)
        if self.name == "jax":
            import jax.numpy as jnp

            from quad_periodic_mpc_tpu.control import fsm
            from quad_periodic_mpc_tpu.models import floating_base as fb
            from quad_periodic_mpc_tpu.sim import articulated_sim as art

            dtype = jnp.dtype(self.dtype)
            plant = art.init_on_ground((B,), penetration=3.8e-3, dtype=dtype)
            z = plant.fb.pos[..., 2] + jnp.asarray(d, dtype)
            com = jnp.stack([jnp.zeros_like(z), jnp.zeros_like(z), z], -1)
            feet = fb.contact_jacobians(plant.fb, fb.build_a1_constants(self.dtype)).p_foot
            return plant, fsm.init((B,)), com, feet
        import torch

        from quad_periodic_mpc_tpu_torch.control import force_stand, fsm
        from quad_periodic_mpc_tpu_torch.sim import articulated_sim as art

        dtype = getattr(torch, self.dtype)
        self.mc = art.mc_cache(dtype, "cpu")
        plant = art.init_on_ground((B,), penetration=3.8e-3, dtype=dtype, device="cpu")
        st = force_stand.target(plant, self.mc, torch.from_numpy(d).to(dtype))
        return plant, fsm.init((B,), device="cpu"), st.com, st.footholds

    def run(self, B: int, ticks: int, trace_every: int = 0) -> dict:
        """The stand for ``ticks`` ticks; returns numpy figures (and a trace
        of the body state every ``trace_every`` ticks)."""
        plant, f, com, feet = self.start(B)
        masks_ok, states, trace = np.ones(B, bool), [], []
        for k in range(ticks):
            if self.name == "jax":
                import jax.numpy as jnp

                req = jnp.full((B,), request(k), jnp.int32)
                plant, f, masks = self._tick(plant, f, req, com, feet)
            else:
                import torch

                from quad_periodic_mpc_tpu_torch.control.force_stand import StandTarget

                req = torch.full((B,), request(k), dtype=torch.int32)
                plant, f, masks = self._tick(plant, f, req, StandTarget(com, feet), self.mc)
            masks_ok &= np.all([np.asarray(m) for m in masks[:4]], axis=0)
            states.append(np.asarray(f.state))
            if trace_every and (k + 1) % trace_every == 0:
                trace.append(fb_numpy(plant))
        s = fb_numpy(plant)
        return dict(z=s["pos"][:, 2], z_err=s["pos"][:, 2] - np.asarray(com)[:, 2],
                    quat0=s["quat"][:, 0], vmax=np.abs(s["v_body"]).max(-1),
                    state=np.asarray(f.state), mode=np.asarray(f.mode), masks_ok=masks_ok,
                    fsm_trace=np.stack(states), final=s, com=np.asarray(com),
                    trace=trace)


def fb_numpy(plant) -> dict:
    return {k: np.asarray(getattr(plant.fb, k)) for k in ("pos", "quat", "v_body", "q", "qd")}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "torch", "both"), default="jax")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ticks", type=int, default=STAND_TICKS)
    args = ap.parse_args()
    for name in (("jax", "torch") if args.package == "both" else (args.package,)):
        p = Package(name)
        t0 = time.perf_counter()
        r = p.run(args.batch, args.ticks)
        print(f"[{name}] force stand, B = {args.batch}, {args.ticks} ticks, float32, "
              f"kernel convention  [{time.perf_counter() - t0:.0f} s]")
        for i in range(args.batch):
            print(f"[{name}]   instance {i}: z {r['z'][i]:.7f} (err {r['z_err'][i]:+.7f}), "
                  f"quat[0] {r['quat0'][i]:.7f}, max|v_body| {r['vmax'][i]:.7f}, "
                  f"fsm state {r['state'][i]} mode {r['mode'][i]}, masks held "
                  f"{bool(r['masks_ok'][i])}")
        print(f"[{name}] REF " + repr([[round(float(r[k][i]), 7) for k in ("z", "quat0", "vmax")]
                                        for i in range(args.batch)]))
        vbl_figures(name, vbl_inputs(r["com"], stand_feet_rel(p, r)))


def stand_feet_rel(p: Package, r: dict) -> np.ndarray:
    """The final feet relative to the target CoM, from the final state."""
    final = r["final"]
    if p.name == "jax":
        import jax.numpy as jnp

        from quad_periodic_mpc_tpu.models import floating_base as fb

        st = fb.FBState(**{k: jnp.asarray(v) for k, v in final.items()})
        feet = np.asarray(fb.contact_jacobians(st, fb.build_a1_constants(p.dtype)).p_foot)
    else:
        import torch

        from quad_periodic_mpc_tpu_torch.models import floating_base as fb

        st = fb.FBState(**{k: torch.from_numpy(v) for k, v in final.items()})
        feet = fb.contact_jacobians(st, p.mc).p_foot.numpy()
    return feet - r["com"][:, None, :]


def vbl_figures(name: str, inp: dict) -> None:
    if name == "jax":
        import jax.numpy as jnp

        from quad_periodic_mpc_tpu.control import balance_vbl as vbl

        F = np.asarray(vbl.solve(**{k: jnp.asarray(v, jnp.float32) for k, v in inp.items()}))
        pmax = float("nan")
    else:
        import torch

        from quad_periodic_mpc_tpu_torch.control import balance_vbl as vbl

        on = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in inp.items()}
        F, pmax = vbl.solve(**on).numpy(), float(vbl.variation_lqr(**on).P.abs().max())
    sums = F.sum(-2)
    for i in range(F.shape[0]):
        print(f"[{name}]   VBL instance {i} (contact {inp['contact'][i].astype(int).tolist()}): "
              f"sum F {sums[i, 0]:+.5f} {sums[i, 1]:+.5f} {sums[i, 2]:.5f}")
    print(f"[{name}]   VBL largest |P| {pmax:.6g}")


if __name__ == "__main__":
    main()
