"""The reference figures behind chip_smoke.py's phase-18 gates, on the CPU.

    python tools/slice9_reference.py [--package jax|torch|both]

In float32 (JAX with its 64-bit mode off, as its CLI runs on a TPU; the
port on the CPU with the kernels' plain versions):

1. ``parity --horizon 10 --problems 5``'s rows (ADMM-200 against PDIP-40 on
   the fixture QPs of seeds 0-4): each row's largest force gap and the ADMM
   answer's primal and dual residuals;
2. on the three scenes of tests/test_golden_qpoases.py (h = 10 with seeds 3
   and 11, h = 16 with seed 5): the largest |x - x_qpOASES| of ADMM-400,
   PDIP-40 and the stagewise ADMM-400 against the reference's qpOASES
   (the reduced solve, float64 on the host), and the largest excess over
   the golden test's gate |x - x_qpOASES| <= atol + rtol |x_qpOASES|
   (atol 2e-3, 3e-3 for the stagewise solve; rtol 1e-3), <= 0 where the
   gate holds.

chip_smoke.py's ``PARITY_REF`` and ``GOLDEN_XLA_GAP`` are the JAX figures.
JAX's solves are jitted (its XLA paths).  ~30 s.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from quad_periodic_mpc_tpu_torch.tools.parity_table import GOLDEN_ATOL, GOLDEN_RTOL  # noqa: E402
from quad_periodic_mpc_tpu_torch.testing import golden  # noqa: E402
from quad_periodic_mpc_tpu_torch.testing.fixtures import GOLDEN_SCENES, HIPS  # noqa: E402


def gaps(x, x_gold, atol: float) -> dict:
    err = np.abs(np.asarray(x, np.float64).reshape(-1) - x_gold)
    return {"max_abs": float(err.max()),
            "excess": float((err - (atol + GOLDEN_RTOL * np.abs(x_gold))).max())}


def gold(P, q, F, l, u, horizon):
    x, status, _ = golden.solve(P, q, golden.dense_constraint_matrix(F, horizon), l, u,
                                reduced=True)
    assert status == 0, f"qpOASES status {status}"
    return x


def jax_figures() -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from quad_periodic_mpc_tpu.config import ADMMConfig, MPCConfig, PDIPConfig
    from quad_periodic_mpc_tpu.ops import constraints as con
    from quad_periodic_mpc_tpu.ops import gait as gait_ops
    from quad_periodic_mpc_tpu.ops import problem, qp_admm, qp_pdip, qp_stagewise
    from quad_periodic_mpc_tpu.ops.rotations import rpy_to_quat
    from quad_periodic_mpc_tpu.testing.fixtures import make_mpc_qp

    pdip = jax.jit(lambda qp: qp_pdip.solve(qp, PDIPConfig(iterations=40))[0])
    admm200 = jax.jit(lambda qp: qp_admm.solve(qp, ADMMConfig(iterations=200)))
    admm400 = jax.jit(lambda qp: qp_admm.solve(qp, ADMMConfig(iterations=400))[0])
    stage400 = jax.jit(lambda sw: qp_stagewise.solve(sw, ADMMConfig(iterations=400))[0])

    rows = []
    for seed in range(5):
        qp, _, _ = make_mpc_qp(horizon=10, seed=seed)
        x_ref = pdip(qp)
        x, st = admm200(qp)
        res = qp_admm.kkt_residuals(qp, x, st.z, st.y)
        rows.append({"seed": seed, "admm_vs_pdip_max": float(jnp.max(jnp.abs(x - x_ref))),
                     "primal": float(res["primal"]), "dual": float(res["dual"])})

    scenes = []
    for sc in GOLDEN_SCENES:
        h, seed = sc["horizon"], sc["seed"]
        qp, cfg, _ = make_mpc_qp(horizon=h, seed=seed)
        table = gait_ops.mpc_table(gait_ops.preset("trotting"),
                                   jnp.asarray(sc["segment"], jnp.int32), h)
        l, u = con.bounds(table, cfg.f_max, cfg.big_number)
        qp = qp._replace(l=jnp.reshape(l, (h * 20,)), u=jnp.reshape(u, (h * 20,)))
        x_gold = gold(*(np.asarray(a) for a in (qp.P, qp.q, qp.F, qp.l, qp.u)), h)
        rng = np.random.default_rng(seed)
        rpy = rng.uniform(-0.1, 0.1, (3,))
        r_feet = HIPS + rng.uniform(-0.03, 0.03, (4, 3))
        obs = problem.RobotObs(
            p=jnp.asarray(np.array([0, 0, 0.26]), jnp.float32),
            v=jnp.asarray(rng.uniform(-0.3, 0.3, (3,)), jnp.float32),
            quat=rpy_to_quat(jnp.asarray(rpy, jnp.float32)),
            omega=jnp.asarray(rng.uniform(-0.2, 0.2, (3,)), jnp.float32),
            r_feet=jnp.asarray(r_feet, jnp.float32))
        xref = np.zeros((h, 13), np.float32)
        xref[:, 5] = 0.26
        sw, _, _ = problem.build_stagewise(obs, jnp.asarray(xref), jnp.asarray(table, jnp.float32),
                                           MPCConfig(horizon=h))
        scenes.append({
            **sc,
            "admm400": gaps(admm400(qp), x_gold, GOLDEN_ATOL["admm"]),
            "pdip40": gaps(pdip(qp), x_gold, GOLDEN_ATOL["pdip"]),
            "stagewise400": gaps(stage400(sw), x_gold, GOLDEN_ATOL["stagewise"]),
        })
    return {"parity": {"horizon": 10, "worst_force_diff_N":
                       max(r["admm_vs_pdip_max"] for r in rows), "rows": rows},
            "golden": scenes}


def torch_figures() -> dict:
    import torch

    torch.set_num_threads(1)
    from quad_periodic_mpc_tpu_torch.cli import parity_report
    from quad_periodic_mpc_tpu_torch.config import ADMMConfig, PDIPConfig
    from quad_periodic_mpc_tpu_torch.ops import qp_admm, qp_pdip, qp_stagewise
    from quad_periodic_mpc_tpu_torch.testing.fixtures import (
        golden_scene, golden_stagewise_scene,
    )

    cpu = torch.device("cpu")
    scenes = []
    for sc in GOLDEN_SCENES:
        qp, _, _ = golden_scene(**sc, device=cpu)
        x_gold = gold(qp.P, qp.q, qp.F, qp.l, qp.u, sc["horizon"])
        sw = golden_stagewise_scene(**sc, device=cpu)
        scenes.append({
            **sc,
            "admm400": gaps(qp_admm.solve(qp, ADMMConfig(iterations=400, backend="pallas"))[0],
                            x_gold, GOLDEN_ATOL["admm"]),
            "pdip40": gaps(qp_pdip.solve(qp, PDIPConfig(iterations=40))[0], x_gold,
                           GOLDEN_ATOL["pdip"]),
            "stagewise400": gaps(
                qp_stagewise.solve(sw, ADMMConfig(iterations=400, backend="pallas"))[0],
                x_gold, GOLDEN_ATOL["stagewise"]),
        })
    return {"parity": parity_report(10, 5, 200, cpu), "golden": scenes}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=["jax", "torch", "both"], default="jax")
    args = ap.parse_args()
    for name, fn in (("jax", jax_figures), ("torch", torch_figures)):
        if args.package in (name, "both"):
            print(f"[{name}] " + json.dumps(fn()), flush=True)


if __name__ == "__main__":
    main()
