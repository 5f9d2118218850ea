"""The elevation-mapping tick's input and output stages of the port against
the JAX package: the InputSourceManager's validation (the gates of
tests/test_input_sources.py, the reference's InputSourcesTest matrix), the
sensor models and InputSource.process (sensor model -> depth cutoff ->
fusion), the postprocessing filters (tests/test_terrain_postprocess.py) and
the footstep planner (tests/test_footstep_planner.py).

Tolerances as in tests/test_torch_terrain.py: indices, masks, the min/max
scatters and planned paths equal; float64 to 1e-12 and float32 to 2e-6,
relative to the value or, where a sum cancels, to its operands' size.
"""

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from quad_periodic_mpc_tpu.terrain import footstep_planner as j_fp
from quad_periodic_mpc_tpu.terrain import heightmap as j_hm
from quad_periodic_mpc_tpu.terrain import input_sources as j_is
from quad_periodic_mpc_tpu.terrain import postprocess as j_pp
from quad_periodic_mpc_tpu.terrain import sensor as j_sensor
from quad_periodic_mpc_tpu_torch import convert
from quad_periodic_mpc_tpu_torch.terrain import footstep_planner as fp
from quad_periodic_mpc_tpu_torch.terrain import heightmap as hmap
from quad_periodic_mpc_tpu_torch.terrain import postprocess as pp
from quad_periodic_mpc_tpu_torch.terrain import sensor
from quad_periodic_mpc_tpu_torch.terrain.input_sources import (
    SENSOR_PROCESSORS, InputSourceManager)

CPU = "cpu"
F64 = torch.float64
RTOL = {np.float32: 2e-6, np.float64: 1e-12}


def T(a, dtype=np.float32):
    return torch.from_numpy(np.array(a, dtype))


def J(a, dtype=np.float32):
    return jnp.asarray(np.asarray(a, dtype))


def close(t, j, scale=0.0, atol=0.0):
    """Within RTOL of the value, or of `scale` (the operands' size)."""
    t = t.detach().numpy()
    j = np.asarray(j)
    assert t.shape == j.shape and t.dtype == j.dtype, (t.shape, j.shape, t.dtype, j.dtype)
    rtol = RTOL[t.dtype.type]
    np.testing.assert_allclose(t, j, rtol=rtol, atol=max(atol, rtol * scale))


def equal(t, j):
    np.testing.assert_array_equal(t.detach().numpy(), np.asarray(j))


def maps(rng, batch=(), size=24, res=0.05, dtype=np.float32, seen=0.7):
    """The same random map in both packages."""
    shape = batch + (size, size)
    elev = rng.normal(0.0, 0.1, shape)
    var = np.where(rng.random(shape) < seen, 10 ** rng.uniform(-5, -2, shape), 1e4)
    jm = j_hm.HeightMap(J(elev, dtype), J(var, dtype), J(rng.random(shape), dtype),
                        J(rng.uniform(-0.2, 0.2, batch + (2,)), dtype), res)
    return jm, convert.heightmap(jm, CPU)


def _valid(topic="/lidar/depth/points", proc="perfect", **over):
    cfg = {"type": "pointcloud", "topic": topic, "queue_size": 1, "publish_on_update": True,
           "sensor_processor": {"type": proc}}
    cfg.update(over)
    return cfg


def _configure(config):
    mgr = InputSourceManager()
    return mgr.configure(config), mgr


# ---- the reference's gtest matrix (InputSourcesTest.cpp) -------------------

def test_single_input_valid():
    ok, mgr = _configure({"standard_single_input": _valid()})
    assert ok and mgr.number_of_sources() == 1


def test_multiple_inputs_valid():
    ok, mgr = _configure({
        "input_1": _valid("/lidar_1/depth/points"),
        "input_2": _valid("/image/depth/image_rect_raw", type="depthimage",
                          publish_on_update=False),
        "input_3": _valid("/lidar_2/depth/points", queue_size=5),
    })
    assert ok and mgr.number_of_sources() == 3


@pytest.mark.parametrize("missing", [
    "type", "topic", "queue_size", "publish_on_update", "sensor_processor"])
def test_missing_member_rejected(missing):
    cfg = _valid()
    del cfg[missing]
    ok, mgr = _configure({"bad": cfg})
    assert not ok and mgr.number_of_sources() == 0


def test_subscribing_same_topic_twice_keeps_first():
    ok, mgr = _configure({"input_1": _valid("/lidar/points", queue_size=1),
                          "input_2": _valid("/lidar/points", queue_size=7)})
    assert not ok and mgr.number_of_sources() == 1 and mgr.sources[0].queue_size == 1


def test_configuration_not_given():
    ok, mgr = _configure(None)
    assert not ok and mgr.number_of_sources() == 0


def test_configuration_empty_sources_succeeds():
    ok, mgr = _configure([])
    assert ok and mgr.number_of_sources() == 0


def test_configuration_wrong_type_and_not_a_struct():
    for bad in ([_valid()], "nope", 3):
        ok, mgr = _configure(bad)
        assert not ok and mgr.number_of_sources() == 0


def test_queue_size_is_string_rejected():
    ok, mgr = _configure({"bad": _valid(queue_size="1")})
    assert not ok and mgr.number_of_sources() == 0


def test_negative_queue_size_rejected():
    ok, mgr = _configure({"bad": _valid(queue_size=-1)})
    assert not ok and mgr.number_of_sources() == 0


def test_unknown_sensor_processor_rejected():
    ok, mgr = _configure({"bad": _valid(proc="sonar_proc")})
    assert not ok and mgr.number_of_sources() == 0


def test_unknown_message_type_fails_registration():
    ok, mgr = _configure({"unknown_input": _valid(type="sonar")})
    assert ok and mgr.number_of_sources() == 1
    assert not mgr.register_callbacks({"pointcloud": lambda *a: None})


def test_registration_routes_by_type():
    ok, mgr = _configure({"input_1": _valid("/lidar_1/depth/points"),
                          "input_2": _valid("/lidar_2/depth/points")})
    assert ok
    assert mgr.register_callbacks({"pointcloud": lambda *a: None})
    assert [s.topic for s, _ in mgr.routing] == mgr.topics()
    empty = InputSourceManager()
    empty.configure([])
    assert empty.register_callbacks({})


def test_configure_twice_detects_cross_call_duplicates():
    mgr = InputSourceManager()
    assert mgr.configure({"a": _valid("/points")})
    assert not mgr.configure({"b": _valid("/points")})
    assert mgr.number_of_sources() == 1


def test_failed_registration_clears_previous_routing():
    mgr = InputSourceManager()
    assert mgr.routing == []
    mgr.configure({"a": _valid("/points")})
    assert mgr.register_callbacks({"pointcloud": lambda *a: None})
    assert len(mgr.routing) == 1
    assert not mgr.register_callbacks({"other": lambda *a: None})
    assert mgr.routing == []


def test_validation_matches_reference_on_every_fixture():
    """Every configuration above, and bad sensor-processor parameters,
    through both managers: the same success, the same sources (fields and
    processor types) and the same error messages."""
    configs = [
        {"a": _valid()}, None, [], [_valid()], "nope", 3,
        {"a": _valid("/x"), "b": _valid("/x", queue_size=7)},
        {"a": _valid(queue_size=True)}, {"a": _valid(queue_size="1")},
        {"a": _valid(queue_size=-1)}, {"a": _valid(proc="sonar_proc")},
        {"a": {**_valid(), "sensor_processor": {"type": "stereo", "p_9": 1.0}}},
        {"a": {**_valid(), "sensor_processor": {"type": "laser", "min_radius": 0.02}}},
        {"a": "not a mapping"}, {"a": _valid(publish_on_update=1)},
    ] + [{"bad": {k: v for k, v in _valid().items() if k != m}}
         for m in ("type", "topic", "queue_size", "publish_on_update", "sensor_processor")]
    assert sorted(SENSOR_PROCESSORS) == sorted(j_is.SENSOR_PROCESSORS)
    for cfg in configs:
        t_mgr, j_mgr = InputSourceManager(), j_is.InputSourceManager()
        assert t_mgr.configure(cfg) == j_mgr.configure(cfg), cfg
        assert t_mgr.errors == j_mgr.errors, cfg
        assert ([(s.name, s.type, s.topic, s.queue_size, s.publish_on_update,
                  type(s.processor).__name__, vars(s.processor)) for s in t_mgr.sources]
                == [(s.name, s.type, s.topic, s.queue_size, s.publish_on_update,
                     type(s.processor).__name__, vars(s.processor)) for s in j_mgr.sources])


# ---- stereo variance model ---------------------------------------------

def test_stereo_variance_matches_scalar_reference():
    m = sensor.StereoModel(p_1=0.1, p_2=0.002, p_3=0.5, p_4=320.0, p_5=0.001,
                           lateral_factor=0.01, depth_to_disparity_factor=100.0, v_center=240.0)
    pixel_ij = torch.tensor([[200.0, 300.0], [240.0, 320.0]])
    pts = torch.tensor([[0.3, -0.1, 1.5], [0.0, 0.2, 2.5]])
    var = m.sensor_variance(pts, pixel_ij=pixel_ij).numpy()
    f = 100.0
    for k in range(2):
        x, y, z = pts.numpy()[k]
        dp = f / z
        i, j = pixel_ij.numpy()[k]
        vn = (f / dp ** 2) ** 2 * ((0.001 * dp + 0.002) * np.sqrt(
            (0.5 * dp + 320.0 - j) ** 2 + (240.0 - i) ** 2) + 0.1)
        vl = (0.01 * np.sqrt(x * x + y * y + z * z)) ** 2
        np.testing.assert_allclose(var[k], [vl, vl, vn], rtol=1e-5)
    mask = sensor.StereoModel(cutoff_min_depth=1.0, cutoff_max_depth=2.0).depth_mask(pts)
    assert mask.tolist() == [True, False]


# ---- end-to-end: sources fused through the manager ----------------------

def test_multi_source_fusion_updates_map():
    ok, mgr = _configure({"lidar": _valid("/lidar/points", proc="laser"),
                          "cam": _valid("/cam/points", proc="structured_light")})
    assert ok
    hm = hmap.create(size=20, resolution=0.1, device=CPU)
    eye, zero = torch.eye(3), torch.zeros(3)
    pts = torch.stack([torch.linspace(-0.5, 0.5, 16), torch.zeros(16), torch.full((16,), 0.1)],
                      dim=-1)
    for s in mgr.sources:
        hm = s.process(hm, pts, eye, eye, zero, zero)
    fused = hm.variance < 1e3
    assert int(fused.sum()) >= 8
    np.testing.assert_allclose(hm.elevation[fused].numpy(), 0.1, atol=1e-3)


def test_depth_cutoff_excludes_points_from_fusion():
    ok, mgr = _configure({"cam": {
        "type": "pointcloud", "topic": "/cam/points", "queue_size": 1, "publish_on_update": True,
        "sensor_processor": {"type": "stereo", "p_1": 0.01, "lateral_factor": 0.01,
                             "depth_to_disparity_factor": 100.0, "cutoff_min_depth": 0.5,
                             "cutoff_max_depth": 2.0}}})
    assert ok
    hm = hmap.create(size=20, resolution=0.1, device=CPU)
    eye, zero = torch.eye(3), torch.zeros(3)
    pts = torch.tensor([[0.05, 0.05, 1.0], [0.049, 0.049, 5.0]])
    hm2 = mgr.sources[0].process(hm, pts, eye, eye, zero, zero)
    i, j = hmap.world_to_index(hm, pts[:1, :2])[0].tolist()
    assert abs(float(hm2.elevation[i, j]) - 1.0) < 1e-3
    hm3 = mgr.sources[0].process(hm2, pts, eye, eye, zero, zero, mahalanobis_threshold=2.0)
    assert abs(float(hm3.elevation[i, j]) - 1.0) < 1e-3


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_process_matches_jax(dtype):
    """InputSource.process of a stereo source with a depth cutoff, pixel
    coordinates, a rotation covariance and the multi-height gate, into a
    pre-fused map, against the reference's."""
    cfg = {"cam": {**_valid("/cam/points"), "sensor_processor": {
        "type": "stereo", "p_1": 0.05, "p_2": 0.002, "p_3": 0.5, "p_4": 64.0, "p_5": 0.001,
        "lateral_factor": 0.01, "depth_to_disparity_factor": 40.0, "v_center": 64.0,
        "cutoff_min_depth": 0.3, "cutoff_max_depth": 1.6}}}
    (t_ok, t_mgr), j_mgr = _configure(cfg), j_is.InputSourceManager()
    assert t_ok and j_mgr.configure(cfg)
    rng = np.random.default_rng(20)
    jm, tm = maps(rng, (), 24, 0.05, dtype, seen=0.8)
    n = 400
    pts = np.concatenate([rng.uniform(-0.4, 0.4, (n, 2)), rng.uniform(0.2, 2.0, (n, 1))], -1)
    pix = rng.uniform(0, 128, (n, 2))
    R_base_sensor = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    R_map_base = np.eye(3)
    args = (R_map_base, R_base_sensor, [0.25, 0.0, 0.1], [0.0, 0.0, 0.3])
    cov = np.diag([1e-4, 2e-4, 5e-5])
    j_process = jax.jit(lambda m, *a, pixel_ij: j_mgr.sources[0].process(
        m, *a, pixel_ij=pixel_ij, mahalanobis_threshold=2.5))
    jo = j_process(jm._replace(resolution=J(0.05, dtype)), J(pts, dtype),
                   *(J(a, dtype) for a in args), J(cov, dtype), pixel_ij=J(pix, dtype))
    to = t_mgr.sources[0].process(tm, T(pts, dtype), *(T(a, dtype) for a in args), T(cov, dtype),
                                  pixel_ij=T(pix, dtype), mahalanobis_threshold=2.5)
    close(to.elevation, jo.elevation, scale=2.0)
    close(to.variance, jo.variance)
    assert (np.asarray(jo.variance) != np.asarray(jm.variance)).any()


# ---- the sensor models ---------------------------------------------------

def _models():
    return [
        (sensor.StructuredLightModel(normal_d=0.01, normal_e=2.0),
         j_sensor.StructuredLightModel(normal_d=0.01, normal_e=2.0)),
        (sensor.LaserModel(), j_sensor.LaserModel()),
        (sensor.PerfectModel(), j_sensor.PerfectModel()),
        (sensor.StereoModel(p_1=0.1, p_2=0.002, p_3=0.5, p_4=320.0, p_5=0.001,
                            lateral_factor=0.01, depth_to_disparity_factor=100.0),
         j_sensor.StereoModel(p_1=0.1, p_2=0.002, p_3=0.5, p_4=320.0, p_5=0.001,
                              lateral_factor=0.01, depth_to_disparity_factor=100.0)),
    ]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sensor_models_and_process_points_match_jax(dtype):
    rng = np.random.default_rng(10)
    pts = np.concatenate([rng.uniform(-1, 1, (2, 50, 2)), rng.uniform(0.3, 3, (2, 50, 1))], -1)
    pix = rng.uniform(0, 480, (2, 50, 2))
    ang = rng.uniform(-0.5, 0.5, (2, 3))
    Rm = np.stack([_rot(a) for a in ang])
    Rs = _rot(np.array([0.0, 0.6, 0.1]))
    cov = rng.normal(0, 0.02, (2, 3, 3))
    cov = cov @ np.swapaxes(cov, -1, -2)
    args = lambda f, g: (f(Rm, dtype), f(Rs, dtype), f([0.2, 0.0, 0.1], dtype),
                         f([[0.5, 0.2, 0.3], [-0.1, 0.0, 0.35]], dtype))
    for tmod, jmod in _models():
        pix_kw = isinstance(tmod, sensor.StereoModel)
        close(tmod.sensor_variance(T(pts, dtype), **({"pixel_ij": T(pix, dtype)} if pix_kw else {})),
              jmod.sensor_variance(J(pts, dtype), **({"pixel_ij": J(pix, dtype)} if pix_kw else {})))
        for rc in (None, cov):
            for pixel in ((None, None), (T(pix, dtype), J(pix, dtype))) if pix_kw else ((None, None),):
                to = sensor.process_points(
                    T(pts, dtype), tmod, *args(T, None),
                    rotation_covariance=None if rc is None else T(rc, dtype), pixel_ij=pixel[0])
                jo = j_sensor.process_points(
                    J(pts, dtype), jmod, *args(J, None),
                    rotation_covariance=None if rc is None else J(rc, dtype), pixel_ij=pixel[1])
                close(to[0], jo[0], atol=1e-15)
                close(to[1], jo[1], atol=1e-15)
    m = sensor.StereoModel(cutoff_min_depth=1.0, cutoff_max_depth=2.0)
    equal(m.depth_mask(T(pts, dtype)),
          j_sensor.StereoModel(cutoff_min_depth=1.0, cutoff_max_depth=2.0).depth_mask(J(pts, dtype)))


def _rot(rpy):
    r, p, y = rpy
    Rx = np.array([[1, 0, 0], [0, np.cos(r), -np.sin(r)], [0, np.sin(r), np.cos(r)]])
    Ry = np.array([[np.cos(p), 0, np.sin(p)], [0, 1, 0], [-np.sin(p), 0, np.cos(p)]])
    Rz = np.array([[np.cos(y), -np.sin(y), 0], [np.sin(y), np.cos(y), 0], [0, 0, 1]])
    return Rz @ Ry @ Rx



# ---- postprocessing (tests/test_terrain_postprocess.py) --------------------

def test_median_removes_salt_noise():
    rng = np.random.default_rng(0)
    z = np.zeros((16, 16), np.float32)
    z.flat[rng.choice(256, 8, replace=False)] = 5.0
    assert float(pp.median_filter(T(z), 3).abs().max()) < 1e-6


def test_median_preserves_step_edge():
    z = np.zeros((12, 12), np.float32)
    z[:, 6:] = 0.1
    assert np.allclose(pp.median_filter(T(z), 3).numpy(), z, atol=1e-7)


def test_inpaint_fills_hole_smoothly():
    z = np.zeros((16, 16), np.float32)
    z[:, 8:] = 0.2
    valid = np.ones((16, 16), bool)
    valid[6:10, 6:10] = False
    z[6:10, 6:10] = 99.0
    out = pp.inpaint(T(z), torch.from_numpy(valid), iters=8).numpy()
    hole = out[6:10, 6:10]
    assert np.all(hole >= -1e-6) and np.all(hole <= 0.2 + 1e-6)
    assert np.allclose(out[valid], z[valid])


def test_postprocess_pipeline_batched():
    z = torch.zeros((2, 16, 16))
    var = torch.ones((2, 16, 16))
    var[:, 5, 5] = 1e4
    z[:, 5, 5] = 50.0
    hm = hmap.HeightMap(z, var, torch.ones((2, 16, 16)), torch.zeros((2, 2)), 0.03)
    out = pp.postprocess(hm)
    assert out.elevation.shape == (2, 16, 16)
    assert float(out.elevation.abs().max()) < 1e-3
    assert float(out.variance[0, 5, 5]) == 100.0


def test_postprocess_filters_match_jax():
    """median at k = 3 and 5 (odd counts) and k = 2 and 4 (even: the mean of
    the two middle values), a NaN window, box_smooth, inpaint and the
    pipeline on a batched map, in float32."""
    dtype = np.float32
    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, (2, 14, 13))
    x[0, 3, 4] = np.nan
    for k in (2, 3, 4, 5):
        equal(pp.median_filter(T(x, dtype), k), j_pp.median_filter(J(x, dtype), k))
        close(pp.box_smooth(T(x, dtype), k), j_pp.box_smooth(J(x, dtype), k),
              scale=np.nanmax(np.abs(x)))
    x[0, 3, 4] = 0.0
    valid = rng.random((2, 14, 13)) < 0.6
    close(pp.inpaint(T(x, dtype), torch.from_numpy(valid), 6),
          j_pp.inpaint(J(x, dtype), jnp.asarray(valid), 6), scale=np.abs(x).max())
    jm, tm = maps(rng, (2,), 16, 0.03, dtype, seen=0.5)
    jo, to = j_pp.postprocess(jm, inpaint_iters=5), pp.postprocess(tm, inpaint_iters=5)
    close(to.elevation, jo.elevation, scale=float(np.abs(jm.elevation).max()))
    equal(to.variance, jo.variance)


# ---- footstep planner (tests/test_footstep_planner.py) ---------------------

def _flat_map(H=20, W=20, res=0.02):
    return hmap.HeightMap(torch.zeros((H, W)), torch.ones((H, W)), torch.ones((H, W)),
                          torch.zeros(2), res)


def test_flat_ground_straight_path():
    p = fp.plan(_flat_map(), torch.tensor([10, 18]))
    assert float(p.value[10, 18]) == 0.0 and float(p.value[10, 17]) > 0.0
    path = fp.extract_path(p, torch.tensor([10, 2]), n_steps=16).numpy()
    assert np.array_equal(path[-1], [10, 18])
    vals = p.value.numpy()[tuple(path.T)]
    assert np.all(np.diff(vals) <= 1e-6)


def test_wall_with_gap_routes_through_gap():
    trav = np.ones((20, 20), np.float32)
    trav[:, 10] = 0.0
    trav[9:12, 10] = 1.0
    hm = _flat_map()._replace(traversability=T(trav))
    path = fp.extract_path(fp.plan(hm, torch.tensor([2, 18])), torch.tensor([17, 2]),
                           n_steps=40).numpy()
    crossing_rows = path[path[:, 1] == 10][:, 0]
    assert len(crossing_rows) > 0
    assert np.all((crossing_rows >= 9) & (crossing_rows <= 11))
    assert np.all(trav[tuple(path.T)] > 0.0)


def test_slope_penalty_prefers_flat_route():
    elev = np.zeros((16, 16), np.float32)
    elev[7:9, 4:12] = 0.5
    hm = _flat_map(16, 16)._replace(elevation=T(elev))
    p = fp.plan(hm, torch.tensor([8, 14]), slope_weight=50.0)
    path = fp.extract_path(p, torch.tensor([8, 1]), n_steps=30).numpy()
    in_bump = path[(path[:, 1] >= 4) & (path[:, 1] <= 11)]
    assert np.all((in_bump[:, 0] <= 5) | (in_bump[:, 0] >= 10))


def test_batched_maps():
    hm = hmap.HeightMap(torch.zeros((3, 20, 20)), torch.ones((3, 20, 20)),
                        torch.ones((3, 20, 20)), torch.zeros((3, 2)), 0.02)
    p = fp.plan(hm, torch.tensor([5, 5]).repeat(3, 1), sweeps=20)
    assert p.value.shape == (3, 20, 20)
    assert np.allclose(p.value[:, 5, 5].numpy(), 0.0)


def test_planner_matches_jax():
    """cell_costs and the value iteration (adds and mins in the same order:
    equal in float32) and the greedy paths (equal), on random terrain with
    blocked cells; and a tie: two neighbours share the least value, and both
    packages step to the first in _OFFS order."""
    dtype = np.float32
    rng = np.random.default_rng(12)
    jm, tm = maps(rng, (2,), 18, 0.04, dtype)
    goal = np.array([[3, 15], [16, 2]])
    for kw in (dict(), dict(slope_weight=5.0, traversability_min=0.2)):
        jp, tp = j_fp.plan(jm, jnp.asarray(goal), **kw), fp.plan(tm, torch.from_numpy(goal), **kw)
        equal(tp.step_cost, jp.step_cost)
        equal(tp.value, jp.value)
        start = np.array([[15, 1], [0, 17]])
        equal(fp.extract_path(tp, torch.from_numpy(start), 25),
              j_fp.extract_path(jp, jnp.asarray(start), 25))
    trav = np.ones((2, 18, 18), dtype)
    trav[:, 9, 1] = 0.0               # block the straight step: (8, 1) and (10, 1) tie
    flat = (j_hm.HeightMap(J(np.zeros((2, 18, 18))), J(np.ones((2, 18, 18))), J(trav),
                           J(np.zeros((2, 2))), 0.04))
    goal = np.array([[9, 17], [9, 17]])
    jp, tp = j_fp.plan(flat, jnp.asarray(goal)), fp.plan(convert.heightmap(flat, CPU),
                                                         torch.from_numpy(goal))
    v = tp.value.numpy()
    assert (v[:, 8, 1] == v[:, 10, 1]).all() and (v[:, 8, 1] < v[:, 9, 0]).all()
    start = np.array([[9, 0], [9, 0]])
    step = fp.next_step(tp, torch.from_numpy(start))
    equal(step, j_fp.next_step(jp, jnp.asarray(start)))
    assert step.tolist() == [[8, 1], [8, 1]]


