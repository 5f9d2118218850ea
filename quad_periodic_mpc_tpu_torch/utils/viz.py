"""Geometric debug markers, the RViz marker hub rebuilt headless
(counterpart of ``quad_periodic_mpc_tpu/utils/viz.py``).

The reference's Debug class publishes a fixed marker set
(debug.cpp:285-520 + publishers :27-38):

- /visual/last_p_stance           SPHERE_LIST, last stance footholds
- /visual/swing_pf                SPHERE_LIST, swing final targets
- /visual/estimated_stance_plane  CUBE, LS stance plane (pitch/height)
- /visual/leg{0..3}/force         ARROW per leg, reaction force
- /visual/local_body_height       ARROW, body-to-plane height

Here the same scene is a list of typed array markers that serialize to
JSONL beside the telemetry stream and render standalone to SVG.  Marker
colors and scales mirror the reference's.  The module is numpy only; every
array argument may be a tensor (on any device), taken to the host at entry.
"""

from __future__ import annotations

import json
from typing import NamedTuple

import numpy as np


def _np(a) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class Marker(NamedTuple):
    """One marker: `kind` in {spheres, arrows, cube, line}; points is
    (n, 3) for spheres/line, (n, 2, 3) [start, end] for arrows, and the
    cube is (center(3), size(3), pitch) packed as (3, 3)."""

    name: str
    kind: str
    points: np.ndarray
    color: tuple          # rgba, matching debug.cpp's marker.color
    scale: float


def scene(
    p_body,
    p_feet,
    contact_state,
    swing_pf=None,
    forces=None,
    x_ref_positions=None,
    plane_coeffs=None,
    force_scale: float = 1.0 / 120.0,
) -> list[Marker]:
    """Build the reference marker set from one control tick's arrays
    (single instance — index the batch before calling).

    plane_coeffs: (a, b, c) of the LS stance plane z = a + b x + c y
    (the estimated_stance_plane CUBE, debug.cpp:373-435).
    """
    p_body = _np(p_body)
    p_feet = _np(p_feet)
    contact = _np(contact_state) > 0
    out = []

    stance_pts = p_feet[contact] if contact.any() else np.zeros((0, 3))
    out.append(Marker(
        "last_p_stance", "spheres", stance_pts,
        (0.0, 1.0, 1.0, 1.0), 0.05,           # cyan, 0.05 (debug.cpp:306-311)
    ))
    if swing_pf is not None:
        sw = _np(swing_pf)[~contact] if (~contact).any() else np.zeros((0, 3))
        out.append(Marker(
            "swing_pf", "spheres", sw,
            (0.0, 1.0, 0.0, 1.0), 0.025,       # green, 0.025 (:352-357)
        ))
    if forces is not None:
        f = _np(forces)
        arrows = np.stack([p_feet, p_feet + f * force_scale], axis=1)
        out.append(Marker(
            "leg_forces", "arrows", arrows,
            (1.0, 0.0, 0.0, 1.0), 0.01,        # red arrows (:437-476)
        ))
    if x_ref_positions is not None:
        out.append(Marker(
            "des_trajectory", "line", _np(x_ref_positions),
            (1.0, 1.0, 0.0, 1.0), 0.01,
        ))
    if plane_coeffs is not None:
        a, b, c = (float(v) for v in _np(plane_coeffs))
        center = np.array([p_body[0], p_body[1],
                           a + b * p_body[0] + c * p_body[1]])
        out.append(Marker(
            "estimated_stance_plane", "cube",
            np.stack([center, np.array([0.4, 0.3, 0.001]),
                      np.array([b, c, 0.0])]),
            (0.5, 0.5, 1.0, 0.5), 1.0,
        ))
    return out


def to_jsonl(markers: list[Marker], fh) -> None:
    """One JSON line per marker (the /visual/* topic analog)."""
    for m in markers:
        fh.write(json.dumps({
            "name": m.name, "kind": m.kind,
            "points": _np(m.points).tolist(),
            "color": list(m.color), "scale": m.scale,
        }) + "\n")


def _proj(pts: np.ndarray, view: str) -> np.ndarray:
    axes = {"xy": (0, 1), "xz": (0, 2), "yz": (1, 2)}[view]
    return pts[..., list(axes)]


def render_svg(
    markers: list[Marker],
    path: str,
    view: str = "xz",
    size: int = 640,
    pad: float = 0.1,
) -> None:
    """Standalone SVG rendering of a marker scene (no plotting deps)."""
    pts = []
    for m in markers:
        p = np.asarray(m.points, float)
        if m.kind == "cube":
            pts.append(p[0:1])
        elif p.size:
            pts.append(p.reshape(-1, 3))
    allp = _proj(np.concatenate(pts) if pts else np.zeros((1, 3)), view)
    lo = allp.min(0) - pad
    hi = allp.max(0) + pad
    span = np.maximum(hi - lo, 1e-6)
    s = size / span.max()

    def sx(v):
        return (v - lo[0]) * s

    def sy(v):  # flip y for SVG
        return size - (v - lo[1]) * s

    el = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" '
          f'height="{size}" viewBox="0 0 {size} {size}">',
          f'<rect width="{size}" height="{size}" fill="white"/>']
    for m in markers:
        r, g, b, a = m.color
        col = f"rgb({int(r*255)},{int(g*255)},{int(b*255)})"
        p = np.asarray(m.points, float)
        if m.kind == "spheres" and p.size:
            for q in _proj(p, view):
                el.append(
                    f'<circle cx="{sx(q[0]):.1f}" cy="{sy(q[1]):.1f}" '
                    f'r="{max(2.0, m.scale * s):.1f}" fill="{col}" '
                    f'fill-opacity="{a}"/>'
                )
        elif m.kind == "arrows" and p.size:
            for seg in p:
                q = _proj(seg, view)
                el.append(
                    f'<line x1="{sx(q[0,0]):.1f}" y1="{sy(q[0,1]):.1f}" '
                    f'x2="{sx(q[1,0]):.1f}" y2="{sy(q[1,1]):.1f}" '
                    f'stroke="{col}" stroke-width="2"/>'
                )
        elif m.kind == "line" and p.size:
            q = _proj(p, view)
            d = " ".join(f"{sx(v[0]):.1f},{sy(v[1]):.1f}" for v in q)
            el.append(
                f'<polyline points="{d}" fill="none" stroke="{col}" '
                'stroke-width="1.5"/>'
            )
        elif m.kind == "cube":
            q = _proj(p[0:1], view)[0]
            w = p[1][0] * s
            h = max(p[1][2] * s, 2.0)
            el.append(
                f'<rect x="{sx(q[0]) - w/2:.1f}" y="{sy(q[1]) - h/2:.1f}" '
                f'width="{w:.1f}" height="{h:.1f}" fill="{col}" '
                f'fill-opacity="{a}"/>'
            )
    el.append("</svg>")
    with open(path, "w") as fh:
        fh.write("\n".join(el))


def trace_scene(trace_x, step: int, p_feet, contact, forces=None):
    """Convenience: scene at one MPC step of a RolloutTrace plus the
    trajectory line of body positions up to that step."""
    x = _np(trace_x)
    return scene(
        p_body=x[step, 3:6],
        p_feet=p_feet,
        contact_state=contact,
        forces=forces,
        x_ref_positions=x[: step + 1, 3:6],
    )
