"""The port's terrain modules against the JAX package: the elevation map
(heightmap), the analytic scenarios, the map-aware foothold functions of
cmpc_variant and the stairs swing curve.  The gates of tests/test_terrain.py
(but its gait-scheduler tests) run on the port, and seeded inputs go through
both packages (the sensor models, postprocessing and the footstep planner:
tests/test_torch_input_sources.py).

Tolerances: integer indices, gathers, the spiral order, planned paths and
the min/max scatters are held equal; float64 values to 1e-12 and float32
values to 2e-6, relative to the value or, where a sum cancels, to the size
of its operands (a few ulp: sums in another order, erf of another library).
The JAX functions run eagerly (as its own tests call them) or jitted with
the resolution a traced argument, so that every division is a true
division, as in the port; every square root is correctly rounded in both.
"""

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from quad_periodic_mpc_tpu.control import cmpc_variant as j_cv
from quad_periodic_mpc_tpu.ops import swing as j_swing
from quad_periodic_mpc_tpu.terrain import heightmap as j_hm
from quad_periodic_mpc_tpu.terrain import scenario as j_scn
from quad_periodic_mpc_tpu_torch import convert
from quad_periodic_mpc_tpu_torch.control import cmpc_variant as cv
from quad_periodic_mpc_tpu_torch.ops import swing as t_swing
from quad_periodic_mpc_tpu_torch.terrain import heightmap as hmap
from quad_periodic_mpc_tpu_torch.terrain import scenario
from quad_periodic_mpc_tpu_torch.terrain import sensor

CPU = "cpu"
F32, F64 = torch.float32, torch.float64
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


def jit_map(fn, res, **kw):
    """fn(map, *args, **kw) jitted with the map's arrays as arguments and its
    resolution static (its tests' seeded points lie off the cell edges: under
    jit XLA divides by the resolution as a product with its reciprocal)."""
    return jax.jit(lambda e, v, t, c, *a: fn(j_hm.HeightMap(e, v, t, c, res), *a, **kw))


def traced_res(jm, dtype=np.float32):
    """The reference map with its resolution a traced scalar under jit: a true
    division there, as eagerly and in the port."""
    return jm._replace(resolution=J(jm.resolution, dtype))


def maps(rng, batch=(), size=24, res=0.05, dtype=np.float32, seen=0.7):
    """The same random map in both packages: elevation, variance (a share
    of cells unseen at 1e4), traversability, center."""
    shape = batch + (size, size)
    elev = rng.normal(0.0, 0.1, shape)
    var = np.where(rng.random(shape) < seen, 10 ** rng.uniform(-5, -2, shape), 1e4)
    trav = rng.random(shape)
    center = rng.uniform(-0.2, 0.2, batch + (2,))
    jm = j_hm.HeightMap(J(elev, dtype), J(var, dtype), J(trav, dtype), J(center, dtype), res)
    return jm, convert.heightmap(jm, CPU)


# ---- the gates of tests/test_terrain.py, on the port ----------------------

def test_fuse_points_kalman():
    hm = hmap.create(size=16, resolution=0.05, init_variance=100.0, dtype=F64, device=CPU)
    pt = torch.tensor([[0.1, 0.1, 0.5], [0.1, 0.1, 0.7]], dtype=F64)
    hm2 = hmap.fuse_points(hm, pt, torch.tensor([0.01, 0.01], dtype=F64))
    idx = hmap.world_to_index(hm, pt[0:1, 0:2])[0]
    assert abs(float(hm2.elevation[idx[0], idx[1]]) - 0.6) < 1e-3
    assert abs(float(hm2.variance[idx[0], idx[1]]) - 0.005) < 1e-3
    assert float(hm2.variance[0, 0]) == 100.0


def test_fuse_convergence():
    hm = hmap.create(size=8, resolution=0.1, init_variance=1e4, dtype=F64, device=CPU)
    for _ in range(20):
        hm = hmap.fuse_points(hm, torch.tensor([[0.0, 0.0, 0.25]], dtype=F64),
                              torch.tensor([0.02], dtype=F64))
        hm = hmap.predict(hm, 1e-5)
    idx = hmap.world_to_index(hm, torch.zeros(2, dtype=F64))
    assert abs(float(hm.elevation[idx[0], idx[1]]) - 0.25) < 1e-3


def test_select_foothold_snaps_to_traversable():
    hm = hmap.create(size=32, resolution=0.02, dtype=F64, device=CPU)
    hm = hm._replace(elevation=torch.full((32, 32), 0.12, dtype=F64))
    pf = torch.zeros(3, dtype=F64)
    idx = hmap.world_to_index(hm, pf[0:2])
    trav = torch.ones((32, 32), dtype=F64)
    trav[idx[0], idx[1]] = 0.0
    hm = hm._replace(traversability=trav)
    out = hmap.select_foothold(hm, pf)
    assert abs(float(out[2]) - 0.12) < 1e-9
    assert abs(float(out[0]) - pf[0]) <= 0.02 + 1e-9
    assert abs(float(out[1]) - pf[1]) <= 0.02 + 1e-9
    out_idx = hmap.world_to_index(hm, out[0:2])
    assert float(hm.traversability[out_idx[0], out_idx[1]]) > 0.8


def test_select_foothold_batched():
    hm = hmap.create(size=32, resolution=0.02, batch=(3,), dtype=F64, device=CPU)
    pf = torch.tensor([[0.05, 0.0, 0.0], [0.0, 0.05, 0.0], [0.0, 0.0, 0.0]], dtype=F64)
    out = hmap.select_foothold(hm, pf)
    assert out.shape == (3, 3)
    np.testing.assert_allclose(out[..., 2].numpy(), 0.0, atol=1e-9)


def test_sensor_processor_pipeline():
    model = sensor.StructuredLightModel()
    n = 32
    xs = np.linspace(-0.3, 0.3, n)
    pts = torch.from_numpy(np.stack([xs, np.zeros(n), np.full(n, 0.5)], axis=-1))
    R_down = torch.tensor([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]], dtype=F64)
    eye, zero = torch.eye(3, dtype=F64), torch.zeros(3, dtype=F64)
    p_map, var = sensor.process_points(pts, model, R_map_base=eye, R_base_sensor=R_down,
                                       t_base_sensor=torch.tensor([0.0, 0.0, 0.5], dtype=F64),
                                       t_map_base=zero)
    np.testing.assert_allclose(p_map[:, 2].numpy(), 0.0, atol=1e-6)
    assert (var > 0).all()
    far_pts = pts.clone()
    far_pts[:, 2] = 2.0
    far = sensor.process_points(far_pts, model, R_map_base=eye, R_base_sensor=R_down,
                                t_base_sensor=torch.tensor([0.0, 0.0, 2.0], dtype=F64),
                                t_map_base=zero)[1]
    assert float(far.mean()) > float(var.mean())
    hm = hmap.create(size=32, resolution=0.04, dtype=F64, device=CPU)
    hm = hmap.fuse_points(hm, p_map, var + 1e-6)
    idx = hmap.world_to_index(hm, torch.zeros(2, dtype=F64))
    assert abs(float(hm.elevation[idx[0], idx[1]])) < 1e-3


def test_move_keeps_world_anchored_data():
    # float64, as the reference test's point runs (its literals are float64
    # under jax_enable_x64); in float32 0.30 - 0.25 rounds up to a whole cell
    hm = hmap.create(size=32, resolution=0.05, dtype=F64, device=CPU)
    pt = torch.tensor([[0.30, -0.10, 0.12]], dtype=F64)
    hm = hmap.fuse_points(hm, pt, torch.tensor([1e-4], dtype=F64))
    z_before = float(hmap.sample(hm.elevation, hmap.world_to_index(hm, pt[:, 0:2])[None, 0])[0])
    assert abs(z_before - 0.12) < 1e-3
    hm2 = hmap.move(hm, torch.tensor([0.25, 0.15], dtype=F64))
    c = hm2.center.numpy() / 0.05
    np.testing.assert_allclose(c, np.round(c), atol=1e-6)
    z_after = float(hmap.sample(hm2.elevation, hmap.world_to_index(hm2, pt[:, 0:2])[None, 0])[0])
    assert abs(z_after - 0.12) < 1e-3
    assert float(hm2.variance.max()) > 1e3


def test_mahalanobis_gate_higher_replaces_lower_inflates():
    hm = hmap.create(size=16, resolution=0.05, device=CPU)
    hm = hmap.fuse_points(hm, torch.tensor([[0.0, 0.0, 0.10]]), torch.tensor([1e-6]))
    idx = tuple(hmap.world_to_index(hm, torch.zeros(2)).tolist())
    hm_hi = hmap.fuse_points(hm, torch.tensor([[0.0, 0.0, 0.50]]), torch.tensor([1e-4]),
                             mahalanobis_threshold=2.5)
    assert abs(float(hm_hi.elevation[idx]) - 0.50) < 1e-6
    hm_lo = hmap.fuse_points(hm, torch.tensor([[0.0, 0.0, -0.50]]), torch.tensor([1e-4]),
                             mahalanobis_threshold=2.5, multi_height_noise=1e-3)
    assert abs(float(hm_lo.elevation[idx]) - 0.10) < 1e-6
    assert float(hm_lo.variance[idx]) > float(hm.variance[idx]) + 0.5e-3


def test_visibility_cleanup_removes_ghost():
    hm = hmap.create(size=32, resolution=0.05, device=CPU)
    hm = hmap.fuse_points(hm, torch.tensor([[0.30, 0.0, 0.60]]), torch.tensor([1e-6]))
    hm2 = hmap.visibility_cleanup(hm, torch.tensor([[0.60, 0.0, 0.0]]), torch.tensor([1e-4]),
                                  torch.tensor([0.0, 0.0, 0.40]))
    idx = tuple(hmap.world_to_index(hm, torch.tensor([0.30, 0.0])).tolist())
    assert float(hm2.variance[idx]) > 1e3
    far = tuple(hmap.world_to_index(hm, torch.tensor([-0.5, -0.5])).tolist())
    assert float(hm2.variance[far]) == float(hm.variance[far])


def test_traversability_flags_slope_and_roughness():
    hm = hmap.create(size=32, resolution=0.05, device=CPU)
    e = torch.zeros((32, 32))
    e[:, 16:] = 0.3
    hm = hmap.compute_traversability(hm._replace(elevation=e, variance=torch.full((32, 32), 1e-4)))
    t = hm.traversability.numpy()
    assert t[5, 16] < 0.2 and t[5, 5] > 0.95 and t[5, 28] > 0.95


def test_motion_update_grows_variance_by_pose_cov():
    hm = hmap.create(size=8, resolution=0.05, device=CPU)
    hm = hm._replace(variance=torch.full((8, 8), 0.01))
    hm2 = hmap.motion_update(hm, torch.diag(torch.tensor([0.0, 0.0, 4e-4])), torch.eye(3))
    np.testing.assert_allclose(hm2.variance.numpy(), 0.01 + 4e-4, rtol=1e-5)


WECDF_CASES = {
    "trivial_two_points": ([0.0, 1.0], [1.0, 1.0], [(-0.1, 0.0), (0.0, 0.0), (0.25, 0.25),
                           (0.5, 0.5), (2 / 3, 2 / 3), (0.95, 0.95), (1.0, 1.0), (1.1, 1.0)]),
    "linear_equally_spaced": ([0.0, 10 / 3, 20 / 3, 10.0], [1.0] * 4, [
        (0.0, 0.0), (0.25, 2.5), (0.5, 5.0), (2 / 3, 20 / 3), (0.95, 9.5), (1.1, 10.0)]),
    "single_value_duplicates": ([3.0] * 3, [1.0] * 3,
                                [(0.0, 3.0), (0.25, 3.0), (0.5, 3.0), (1.0, 3.0), (2.0, 3.0)]),
    "synthetic_duplicate_merge": ([1.0] * 10 + [2.0], [1.0] * 11, [(0.05, 1.05), (0.95, 1.95)]),
    "zero_weight_entries_ignored": ([5.0, 0.0, 1.0, 9.0], [0.0, 1.0, 1.0, 0.0], [(0.5, 0.5)]),
}


@pytest.mark.parametrize("case", sorted(WECDF_CASES))
def test_wecdf_quantile_reference_cases(case):
    """The reference's gtest numeric cases (elevation_mapping/test/
    WeightedEmpiricalCumulativeDistributionFunctionTest.cpp)."""
    v, w, pairs = WECDF_CASES[case]
    for q, want in pairs:
        got = float(hmap.wecdf_quantile(torch.tensor(v, dtype=F64), torch.tensor(w, dtype=F64), q))
        assert abs(got - want) < 1e-12, (q, got, want)


def test_wecdf_quantile_batched():
    v = torch.tensor([[0.0, 1.0, 0.5], [2.0, 4.0, 3.0]], dtype=F64)
    out = hmap.wecdf_quantile(v, torch.ones((2, 3), dtype=F64), 0.5).numpy()
    assert abs(out[0] - 0.5) < 1e-12 and abs(out[1] - 3.0) < 1e-12


def test_fuse_area_bounds():
    hm = hmap.create(size=16, resolution=0.03, dtype=F64, init_variance=1e4, device=CPU)
    elev, var = hm.elevation.clone(), hm.variance.clone()
    elev[4:12, 4:12] = 0.1
    var[4:12, 4:12] = 1e-4
    mean, lower, upper = (a.numpy() for a in hmap.fuse_area(
        hm._replace(elevation=elev, variance=var), radius_cells=2, sigma=0.05))
    assert np.allclose(mean[6:10, 6:10], 0.1, atol=1e-6)
    assert np.allclose(lower[6:10, 6:10], 0.1 - 2e-2, atol=1e-3)
    assert np.allclose(upper[6:10, 6:10], 0.1 + 2e-2, atol=1e-3)
    assert abs(mean[0, 0]) < 1e-9
    assert abs(lower[0, 0] + 200.0) < 1e-6 and abs(upper[0, 0] - 200.0) < 1e-6


# ---- the heightmap against JAX ------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_world_to_index_and_sample_match_on_cell_boundaries(dtype):
    """Indices equal (not close) on seeded points, on points placed exactly
    on cell boundaries (center + k res) and one ulp to either side."""
    rng = np.random.default_rng(0)
    for res, size in ((0.03, 32), (0.02, 33)):
        jm, tm = maps(rng, (), size, res, dtype)
        k = np.arange(-size // 2 - 2, size // 2 + 3)
        c = np.asarray(jm.center).astype(dtype)
        on = np.stack(np.meshgrid(k, k[::-1]), -1).reshape(-1, 2).astype(dtype) * dtype(res) + c
        pts = np.concatenate([on, np.nextafter(on, dtype(np.inf)), np.nextafter(on, dtype(-np.inf)),
                              rng.uniform(-0.8, 0.8, (500, 2)).astype(dtype)])
        ji = j_hm.world_to_index(jm, J(pts, dtype))
        ti = hmap.world_to_index(tm, T(pts, dtype))
        equal(ti, ji)
        equal(hmap.sample(tm.elevation, ti), j_hm.sample(jm.elevation, ji))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("maha", [0.0, 2.0])
def test_fuse_points_matches_jax(dtype, maha):
    """Fusion, the multi-height variance bumps and the replacing scatter-max /
    scatter-min, with a validity mask: points crowd a few cells, some far
    above and some far below the map."""
    rng = np.random.default_rng(1)
    jm, tm = maps(rng, (), 16, 0.05, dtype)
    n = 300
    xy = rng.uniform(-0.15, 0.15, (n, 2))
    z = rng.normal(0.0, 0.05, n) + rng.choice([0.0, 0.5, -0.5], n, p=[0.6, 0.2, 0.2])
    pts = np.concatenate([xy, z[:, None]], -1)
    var = 10 ** rng.uniform(-5, -3, n)
    mask = rng.random(n) < 0.9
    kw = dict(mahalanobis_threshold=maha, multi_height_noise=1e-4)
    j_fuse = jax.jit(j_hm.fuse_points, static_argnames=tuple(kw))
    jo = j_fuse(traced_res(jm, dtype), J(pts, dtype), J(var, dtype), valid_mask=jnp.asarray(mask),
                **kw)
    to = hmap.fuse_points(tm, T(pts, dtype), T(var, dtype), valid_mask=torch.from_numpy(mask), **kw)
    close(to.elevation, jo.elevation, scale=np.abs(z).max())
    close(to.variance, jo.variance)
    if maha > 0:
        # the replaced cells took the scatter-max height exactly
        replaced = np.asarray(jo.elevation) > np.asarray(jm.elevation) + 0.3
        assert replaced.any()
        equal(to.elevation[torch.from_numpy(replaced)], np.asarray(jo.elevation)[replaced])
        equal(to.variance[torch.from_numpy(replaced)], np.asarray(jo.variance)[replaced])


def test_batched_maps_match_jax_vmap_over_maps():
    """A (B, H, W) map reads its points (B, n, 3) as the reference vmapped
    over maps."""
    rng = np.random.default_rng(2)
    jm, tm = maps(rng, (3,), 16, 0.05)
    pts = np.concatenate([rng.uniform(-0.3, 0.3, (3, 200, 2)), rng.normal(0, 0.1, (3, 200, 1))], -1)
    var = 10 ** rng.uniform(-5, -3, (3, 200))
    sensor_pos = np.array([[0.0, 0.0, 0.5], [0.1, -0.1, 0.4], [-0.2, 0.0, 0.6]])
    jf = jax.vmap(jit_map(j_hm.fuse_points, 0.05, mahalanobis_threshold=2.0))
    jo = jf(*jm[:4], J(pts), J(var))
    to = hmap.fuse_points(tm, T(pts), T(var), mahalanobis_threshold=2.0)
    close(to.elevation, jo.elevation)
    close(to.variance, jo.variance)
    jv = jax.vmap(jit_map(j_hm.visibility_cleanup, 0.05, ray_samples=7))
    jo2 = jv(*jo[:4], J(pts), J(var), J(sensor_pos))
    to2 = hmap.visibility_cleanup(to, T(pts), T(var), T(sensor_pos), ray_samples=7)
    close(to2.elevation, jo2.elevation)
    close(to2.variance, jo2.variance)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_visibility_cleanup_matches_jax(dtype):
    """The ray samples' scatter-min and the ghost reset: held equal on a map
    whose tall cells some rays pass below."""
    rng = np.random.default_rng(3)
    jm, tm = maps(rng, (), 24, 0.05, dtype, seen=0.9)
    tall = np.asarray(jm.elevation) + np.where(rng.random((24, 24)) < 0.2, 0.6, 0.0)
    jm = jm._replace(elevation=J(tall, dtype))
    tm = tm._replace(elevation=T(tall, dtype))
    pts = np.concatenate([rng.uniform(-0.6, 0.6, (400, 2)), rng.normal(0, 0.05, (400, 1))], -1)
    var = 10 ** rng.uniform(-5, -3, 400)
    s = np.array([0.05, -0.02, 0.45])
    jo = jax.jit(j_hm.visibility_cleanup)(traced_res(jm, dtype), J(pts, dtype), J(var, dtype),
                                          J(s, dtype))
    to = hmap.visibility_cleanup(tm, T(pts, dtype), T(var, dtype), T(s, dtype))
    assert (np.asarray(jo.variance) != np.asarray(jm.variance)).any()
    equal(to.elevation, jo.elevation)
    equal(to.variance, jo.variance)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_wecdf_quantile_matches_jax(dtype):
    """Random values with duplicate runs and zero weights, every quantile of
    fuse_area and the clamped ends."""
    rng = np.random.default_rng(4)
    v = rng.choice(rng.normal(0, 1, 12), (64, 25))
    w = np.where(rng.random((64, 25)) < 0.2, 0.0, rng.random((64, 25)))
    w[0] = 0.0
    v[1] = 0.3
    jq = jax.jit(j_hm.wecdf_quantile)      # q traced: one program for every q
    for q in (-0.5, 0.0, 0.01, 0.3, 0.5, 0.99, 1.0, 1.5):
        close(hmap.wecdf_quantile(T(v, dtype), T(w, dtype), q),
              jq(J(v, dtype), J(w, dtype), J(q, dtype)), scale=np.abs(v).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fuse_area_matches_jax(dtype):
    rng = np.random.default_rng(5)
    jm, tm = maps(rng, (2,), 20, 0.03, dtype, seen=0.6)
    for r, sigma in ((2, 0.05), (1, 0.02)):
        for a, b in zip(hmap.fuse_area(tm, radius_cells=r, sigma=sigma),
                        jit_map(j_hm.fuse_area, 0.03, radius_cells=r, sigma=sigma)(*jm[:4])):
            close(a, b, scale=float(np.abs(jm.elevation).max()) + 2.0)


def test_move_matches_jax_and_rounds_half_to_even():
    """Shifts of whole, half (exact in binary at res 0.5) and fractional
    cells; the half-cell ones round to even in both."""
    rng = np.random.default_rng(6)
    jm, tm = maps(rng, (6,), 12, 0.5)
    c = np.asarray(jm.center)
    new = c + np.array([[0.25, -0.25], [0.75, 1.25], [-0.75, 0.0], [1.0, -2.0], [0.3, 0.8],
                        [7.0, 0.0]]).astype(np.float32)
    jo, to = jax.jit(j_hm.move)(traced_res(jm), J(new)), hmap.move(tm, T(new))
    for f in ("elevation", "variance", "traversability", "center"):
        equal(getattr(to, f), getattr(jo, f))
    shift = np.round((new - c) / 0.5)
    assert (shift[0] == 0).all() and shift[1].tolist() == [2.0, 2.0]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_predict_motion_update_traversability_match(dtype):
    rng = np.random.default_rng(7)
    jm, tm = maps(rng, (2,), 16, 0.05, dtype)
    cov = rng.normal(0, 0.01, (2, 3, 3))
    cov = cov @ np.swapaxes(cov, -1, -2)
    ang = rng.uniform(-1, 1, 2)
    R = np.zeros((2, 3, 3))
    R[:, 0, 0] = R[:, 1, 1] = np.cos(ang)
    R[:, 0, 1], R[:, 1, 0], R[:, 2, 2] = -np.sin(ang), np.sin(ang), 1.0
    close(hmap.predict(tm, 1e-4).variance, j_hm.predict(jm, 1e-4).variance)
    close(hmap.motion_update(tm, T(cov, dtype), T(R, dtype), 2.0).variance,
          j_hm.motion_update(jm, J(cov, dtype), J(R, dtype), 2.0).variance)
    # elementwise operations in the same order: equal
    equal(hmap.compute_traversability(tm, 0.5, 0.04).traversability,
          j_hm.compute_traversability(jm, 0.5, 0.04).traversability)


def test_spiral_offsets_equal():
    for r in (1, 2, 4, 7):
        np.testing.assert_array_equal(hmap.spiral_offsets(r), j_hm.spiral_offsets(r))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_select_foothold_matches_jax(dtype):
    """Targets on boundaries and across the map, a map where every
    candidate fails (the fallback), and ties of the first valid cell in
    spiral order: equal cells, equal xy, equal z."""
    rng = np.random.default_rng(8)
    jm, tm = maps(rng, (), 32, 0.03, dtype)
    pf = np.concatenate([rng.uniform(-0.5, 0.5, (40, 2)), np.zeros((40, 1))], -1)
    pf[:8, :2] = np.round(pf[:8, :2] / 0.03) * 0.03
    # the reference's targets carry the map's batch axes: vmap over targets
    j_sel = lambda m, p, **kw: jax.vmap(lambda q: j_hm.select_foothold(m, q, **kw))(p)
    for kw in (dict(), dict(keep_xy_if_unmoved=True, foot_offset=0.02, traversability_min=0.3,
                            search_radius_m=0.07)):
        equal(hmap.select_foothold(tm, T(pf, dtype), **kw), j_sel(jm, J(pf, dtype), **kw))
    blocked = (jm._replace(traversability=jnp.zeros_like(jm.traversability)),
               tm._replace(traversability=torch.zeros_like(tm.traversability)))
    out = hmap.select_foothold(blocked[1], T(pf, dtype))
    equal(out, j_sel(blocked[0], J(pf, dtype)))
    np.testing.assert_array_equal(out[:, :2].numpy(), pf[:, :2].astype(dtype))
    # every candidate valid: the spiral's first, the target's own cell, whose
    # exact xy is kept
    ones = tm._replace(traversability=torch.ones_like(tm.traversability))
    out = hmap.select_foothold(ones, T(pf, dtype), keep_xy_if_unmoved=True)
    equal(out[:, :2], pf[:, :2].astype(dtype))


# ---- scenarios ------------------------------------------------------------

def test_stairs_and_build_map_match_jax():
    jt = j_scn.StairsTerrain(edge_x=J([0.3, 0.5, 1e6]), riser=J([0.05, 0.10, 0.0]),
                             tread=0.25, n_steps=3)
    tt = convert.stairs_terrain(jt, CPU)
    assert tt.tread == 0.25 and tt.n_steps == 3 and isinstance(tt.n_steps, int)
    xy = np.random.default_rng(9).uniform(-1, 3, (3, 4, 2))
    xy[0, 0, 0] = 0.3      # on the first riser
    equal(scenario.ground_z(tt, T(xy)), j_scn.ground_z(jt, J(xy)))
    for size, res in ((33, 0.05),):
        jm = j_scn.build_map(jt, size=size, resolution=res, center_xy=J([[0, 0], [0.1, 0.2],
                                                                         [-0.3, 0.0]]))
        tm = scenario.build_map(tt, size=size, resolution=res, center_xy=T([[0, 0], [0.1, 0.2],
                                                                           [-0.3, 0.0]]))
        for f in ("elevation", "variance", "traversability", "center"):
            equal(getattr(tm, f), getattr(jm, f))
    one = scenario.StairsTerrain.single_step(0.3, 0.08, batch=(2,), device=CPU)
    ref = j_scn.StairsTerrain.single_step(0.3, 0.08, batch=(2,))
    for a, b in zip(one, ref):
        equal(a, b) if isinstance(a, torch.Tensor) else (a == b) or pytest.fail(f"{a} != {b}")
    flat = scenario.StairsTerrain.flat((2,), device=CPU)
    equal(scenario.ground_z(flat, T(xy[:2])), np.zeros((2, 4), np.float32))


def test_build_map_noise_from_generator():
    """noise_std > 0 draws from the caller's torch.Generator: the same seed
    gives the same map, another seed another; the noise has the stated
    spread."""
    terr = scenario.StairsTerrain.single_step(0.3, 0.08, device=CPU)
    draw = lambda seed: scenario.build_map(
        terr, size=64, noise_std=0.01,
        generator=torch.Generator().manual_seed(seed)).elevation
    a, b, c = draw(0), draw(0), draw(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    clean = scenario.build_map(terr, size=64).elevation
    assert abs(float((a - clean).std()) - 0.01) < 1e-3


# ---- cmpc_variant, stairs swing ------------------------------------------

def test_cmpc_variant_matches_jax():
    """terrain_foothold and foothold_update on a batch of stairs maps (the
    legs as the reference's vmap), and pitch_reference, in float32."""
    dtype = np.float32
    rng = np.random.default_rng(13)
    jt = j_scn.StairsTerrain(edge_x=J([0.1, 0.25], dtype), riser=J([0.3, 0.06], dtype),
                             tread=10.0, n_steps=1)
    jm = j_scn.build_map(jt, size=32, resolution=0.03, dtype=jnp.dtype(dtype))
    tm = convert.heightmap(jm, CPU)
    pf = np.concatenate([rng.uniform(-0.3, 0.6, (2, 4, 2)), np.zeros((2, 4, 1))], -1)
    p0 = np.concatenate([rng.uniform(-0.3, 0.6, (2, 4, 2)), rng.uniform(0, 0.3, (2, 4, 1))], -1)
    pf[0, 0, 0] = 0.1       # on the riser's edge cells
    equal(cv.terrain_foothold(tm, T(pf, dtype), foot_offset=0.01),
          jit_map(j_cv.terrain_foothold, 0.03, foot_offset=0.01)(*jm[:4], J(pf, dtype)))
    for kw in (dict(), dict(max_step_height=0.05, traversability_min=0.5)):
        close(cv.foothold_update(tm, T(pf, dtype), T(p0, dtype), **kw),
              jit_map(j_cv.foothold_update, 0.03, **kw)(*jm[:4], J(pf, dtype), J(p0, dtype)))
    feet = rng.normal(0, 0.1, (3, 4, 3)) + np.array([0.0, 0.0, -0.28])
    args = (rng.normal(0, 0.1, 3), rng.normal(0, 0.1, (3, 3)), feet, np.array([0.3, -0.2, 0.0]))
    j_pitch = jax.jit(j_cv.pitch_reference, static_argnums=(4, 5))
    for standing in (False, True):
        close(cv.pitch_reference(*(T(a, dtype) for a in args), 1.5, standing),
              j_pitch(*(J(a, dtype) for a in args), 1.5, standing), atol=1e-6)


def test_evaluate_stairs_matches_jax():
    rng = np.random.default_rng(14)
    p0, pf = rng.normal(0, 0.2, (2, 4, 3)), rng.normal(0, 0.2, (2, 4, 3))
    ph = np.linspace(0, 1, 8)[:, None].repeat(4, 1)
    st = rng.uniform(0.1, 0.3, (8, 4))
    p0, pf = p0[:1].repeat(8, 0), pf[:1].repeat(8, 0)
    for h in (0.08, 0.15):
        to = t_swing.evaluate_stairs(T(p0, np.float64), T(pf, np.float64), h,
                                     T(ph, np.float64), T(st, np.float64))
        jo = j_swing.evaluate_stairs(J(p0, np.float64), J(pf, np.float64), h,
                                     J(ph, np.float64), J(st, np.float64))
        for a, b in zip(to, jo):
            close(a, b, atol=1e-12)
    # x/y hold at p0 through the swing
    np.testing.assert_array_equal(to.p[..., :2].numpy(), p0[..., :2])
