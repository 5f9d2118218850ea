"""The reference figures behind chip_smoke.py's phase 20, on the CPU.

    python tools/slice12_reference.py [--part parity|ab|both]
        [--est-window 400 [128 ...]] [--phase-offsets 4]

Runs the JAX package's two evidence tools unedited, imported by path, on
the CPU with JAX's 64-bit mode off (float32, as the tools run):

- ``--part parity``: tools/parity_table.py over its 15 scenes x 6 solver
  settings against the reference's qpOASES.  Prints the tool's own table
  and walking-sequence split, then ``[parity] <json>``: one entry per scene
  (its name and every gap the tool measured, the walking scenes' applied
  first-step gap and objective excess included), then ``[envelope]
  <json>``: per scene and setting, the largest gap over DRAWS more solves
  of the same QP with P and q (the stagewise problem's Ad, Bd and c) each
  entry scaled by 1 + u 2^-22, u uniform in [-1, 1] (a few float32
  roundings, as two builds of the QP differ), against the same qpOASES
  answer.  A float32 IPM near its barrier's end moves by tens of percent
  under such a change (PDIP-40 on the h = 10 f_est scene: 0.027 N, and up
  to 0.270 N over the draws), so one solve's gap is one draw of a spread.  The walking scenes'
  production cell (the carried warm solve) has no draws;
- ``--part ab``: tools/estimator_ab.py at each window given (72 instances
  at 4 phase offsets).  Prints the tool's table, then ``[ab <window>]
  <json>``: its rows as the tool writes them.

chip_smoke.py's ``EVIDENCE_GAPS`` and ``EVIDENCE_AB`` are these figures.
The draws' solves are jitted (JAX's XLA path; the production setting's
kernel in interpret mode at a batch of 1).  The tools' compile-cache
settings are dropped, so nothing is written outside the checkout.  ~5 min
for the table and its draws; the A/B ~4 min at window 400, ~1.5 at 128.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def jax_tool(name: str):
    """The JAX package's ``tools/<name>.py`` as a module, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_main(mod, argv: list[str]) -> str:
    """``mod.main()`` with ``argv``; returns what it wrote to stderr."""
    import jax

    update = jax.config.update
    saved = sys.argv
    err = io.StringIO()
    # the tools point JAX's compile cache at a directory outside the checkout
    jax.config.update = lambda name, value: None if "cache" in name else update(name, value)
    sys.argv = [f"{mod.__name__}.py", *argv]
    try:
        with contextlib.redirect_stderr(err):
            mod.main()
    finally:
        sys.argv = saved
        jax.config.update = update
    return err.getvalue()


def parity_figures(pt) -> list[dict]:
    """Every scene's gaps, through the tool's own main (which prints the table)."""
    measured = []
    gaps_for_scene = pt.gaps_for_scene

    def record(scene):
        gaps = gaps_for_scene(scene)
        measured.append({"scene": pt.scene_name(scene), **gaps})
        return gaps

    pt.gaps_for_scene = record
    run_main(pt, [])
    return measured


DRAWS = 16
ROUNDING = 2.0 ** -22


def jax_settings(pt) -> dict:
    """The table's solver settings as jitted functions of a QP (the
    stagewise one of a StagewiseProblem)."""
    import jax

    from quad_periodic_mpc_tpu.config import ADMMConfig, PDIPConfig
    from quad_periodic_mpc_tpu.ops import qp_admm, qp_pdip, qp_stagewise

    def warm6(qp, cfg=ADMMConfig(iterations=30)):
        warm = None
        for _ in range(6):
            x, warm = qp_admm.solve(qp, cfg, warm=warm)
        return x

    def production(qp):
        # pt.production_warm_x6 under jit (it returns numpy): batched (1,)
        qp_b = qp_admm.QPData(P=qp.P[None], q=qp.q[None], F=qp.F, l=qp.l[None], u=qp.u[None])
        return warm6(qp_b, ADMMConfig(iterations=30, backend="pallas"))[0]

    return {
        "ADMM-400 cold": jax.jit(lambda qp: qp_admm.solve(qp, ADMMConfig(iterations=400))[0]),
        "ADMM-30 warm x6": jax.jit(warm6),
        "production warm x6": jax.jit(production),
        "PDIP-40": jax.jit(lambda qp: qp_pdip.solve(qp, PDIPConfig(iterations=40))[0]),
        "PDIP-40 spd": jax.jit(
            lambda qp: qp_pdip.solve(qp, PDIPConfig(iterations=40, kkt="spd"))[0]),
        "stagewise ADMM-400": jax.jit(
            lambda sw: qp_stagewise.solve(sw, ADMMConfig(iterations=400))[0]),
    }


def scene_envelope(pt, scene, settings: dict, seed: int = 12) -> dict:
    """The largest gap over DRAWS rounding-level perturbations of one
    scene's QP, for each of ``settings`` (``_settings``'s, or some of them)
    the scene has (a walking scene's production cell never)."""
    import jax.numpy as jnp
    import numpy as np

    from quad_periodic_mpc_tpu.testing import golden

    if scene.get("walking"):
        qp, _, cfg = pt.walking_scene(scene["horizon"], scene["steps"],
                                      gait=scene.get("gait", "trotting"),
                                      vx=scene.get("vx", 0.3))
        sw = None
    else:
        qp, sw, cfg = pt.scene_problems(**scene)
    x_gold, status, _ = golden.solve(
        np.asarray(qp.P, np.float64), np.asarray(qp.q, np.float64),
        golden.dense_constraint_matrix(np.asarray(qp.F), cfg.horizon),
        np.asarray(qp.l, np.float64), np.asarray(qp.u, np.float64), reduced=True, nwsr=500)
    assert status == 0, f"qpOASES status {status}"
    rng = np.random.default_rng(seed)

    def rounded(a, symmetric=False):
        a = np.asarray(a, np.float64)
        u = rng.uniform(-1.0, 1.0, a.shape)
        if symmetric:
            u = np.triu(u) + np.triu(u, 1).T
        return jnp.asarray(a * (1.0 + u * ROUNDING), jnp.float32)

    worst = {}
    for _ in range(DRAWS):
        draws = {"condensed": qp._replace(P=rounded(qp.P, symmetric=True), q=rounded(qp.q))}
        if sw is not None:
            draws["stagewise"] = sw._replace(Ad=rounded(sw.Ad), Bd=rounded(sw.Bd),
                                             c=rounded(sw.c))
        for name, solve in settings.items():
            kind = "stagewise" if name.startswith("stagewise") else "condensed"
            if kind not in draws or (sw is None and name == "production warm x6"):
                continue
            x = np.asarray(solve(draws[kind]), np.float64).reshape(-1)
            worst[name] = max(worst.get(name, 0.0), float(np.abs(x - x_gold).max()))
    return worst


def envelope(pt) -> list[dict]:
    """``scene_envelope`` of every scene, every setting."""
    settings = jax_settings(pt)
    return [{"scene": pt.scene_name(sc), **scene_envelope(pt, sc, settings)}
            for sc in pt.SCENES]


def ab_rows(window: int, phase_offsets: int) -> list[dict]:
    """The A/B's rows at one window, through the tool's own main."""
    ab = jax_tool("estimator_ab")
    err = run_main(ab, ["--cpu", "--est-window", str(window),
                        "--phase-offsets", str(phase_offsets)])
    return [json.loads(line) for line in err.splitlines() if line.startswith("{")]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=["parity", "ab", "both"], default="both")
    ap.add_argument("--est-window", type=int, nargs="+", default=[400])
    ap.add_argument("--phase-offsets", type=int, default=4)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    if args.part in ("parity", "both"):
        pt = jax_tool("parity_table")
        print("[parity] " + json.dumps(parity_figures(pt)), flush=True)
        print("[envelope] " + json.dumps(envelope(pt)), flush=True)
    if args.part in ("ab", "both"):
        for w in args.est_window:
            print(f"[ab {w}] " + json.dumps(ab_rows(w, args.phase_offsets)), flush=True)


if __name__ == "__main__":
    main()
