"""The port's marker hub (utils/viz.py) against the JAX package's: the same
markers (names, kinds, points, colors, scales), JSON lines and SVG text for
the same inputs, given to the port as tensors."""

import io
import os
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

from quad_periodic_mpc_tpu.utils import viz as j_viz
from quad_periodic_mpc_tpu_torch.utils import viz as t_viz


def _inputs():
    """tests/test_viz.py::_example_scene's inputs."""
    p_feet = np.array([[0.18, -0.13, 0.0], [0.18, 0.13, 0.0],
                       [-0.18, -0.13, 0.0], [-0.18, 0.13, 0.05]])
    return dict(
        p_body=np.array([0.0, 0.0, 0.29]),
        p_feet=p_feet,
        contact_state=np.array([1.0, 1.0, 1.0, 0.0]),
        swing_pf=p_feet + np.array([0.08, 0.0, 0.0]),
        forces=np.array([[0, 0, 40.0]] * 4),
        x_ref_positions=np.array([[0, 0, 0.29], [0.1, 0, 0.29]]),
        plane_coeffs=(0.0, 0.1, 0.0),
    )


def _tensors(kw):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in kw.items()}


def _assert_same_markers(port, ref):
    assert [m.name for m in port] == [m.name for m in ref]
    for a, b in zip(port, ref):
        assert (a.kind, a.color, a.scale) == (b.kind, b.color, b.scale), a.name
        assert isinstance(a.points, np.ndarray)
        np.testing.assert_array_equal(a.points, b.points, err_msg=a.name)


def test_scene_markers_equal_jax():
    _assert_same_markers(t_viz.scene(**_tensors(_inputs())), j_viz.scene(**_inputs()))


@pytest.mark.parametrize("contact", [[1.0, 1.0, 1.0, 1.0], [0.0, 0.0, 0.0, 0.0]])
def test_scene_all_stance_or_all_swing_equal_jax(contact):
    """The empty sphere lists (every foot in stance, or none)."""
    kw = dict(_inputs(), contact_state=np.array(contact))
    _assert_same_markers(t_viz.scene(**_tensors(kw)), j_viz.scene(**kw))


def test_to_jsonl_equal_jax():
    a, b = io.StringIO(), io.StringIO()
    t_viz.to_jsonl(t_viz.scene(**_tensors(_inputs())), a)
    j_viz.to_jsonl(j_viz.scene(**_inputs()), b)
    assert a.getvalue() == b.getvalue()


@pytest.mark.parametrize("view", ["xz", "xy", "yz"])
def test_render_svg_text_equal_jax(tmp_path, view):
    port, ref = os.path.join(tmp_path, "port.svg"), os.path.join(tmp_path, "jax.svg")
    t_viz.render_svg(t_viz.scene(**_tensors(_inputs())), port, view=view)
    j_viz.render_svg(j_viz.scene(**_inputs()), ref, view=view)
    text = open(port).read()
    assert text == open(ref).read()
    root = ET.fromstring(text)
    assert root.tag.endswith("svg")
    # tests/test_viz.py::test_render_svg's counts
    assert text.count("<circle") == 4 and text.count("<line") == 4
    assert text.count("<polyline") == 1 and text.count("<rect") == 2


def test_trace_scene_equal_jax():
    rng = np.random.default_rng(3)
    trace_x = rng.uniform(-0.5, 0.5, (12, 13))
    p_feet, contact, forces = rng.uniform(-0.3, 0.3, (4, 3)), np.array([1, 0, 0, 1]), \
        rng.uniform(0, 80, (4, 3))
    port = t_viz.trace_scene(torch.as_tensor(trace_x), 7, torch.as_tensor(p_feet),
                             torch.as_tensor(contact), torch.as_tensor(forces))
    _assert_same_markers(port, j_viz.trace_scene(trace_x, 7, p_feet, contact, forces))
