"""The port's intensity path of the 3D frontend (plain twins of kernels K18,
K19 and K11's intensity rows) against the JAX package: the twin of
tests/test_intensity_3d.py.

Points are kept off cell borders (at least a tenth of a cell away): the
JAX programs may multiply by the reciprocal of the resolution where the
port divides, which moves a point on a border to the other cell."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cartographer_tpu.ops.grid_3d import (
    Grid3D as JGrid3D,
    IntensityGrid3D as JIntensityGrid3D,
    insert_intensities as j_insert_intensities,
    insert_range_data_3d as j_insert_range_data,
)
from cartographer_tpu.ops.interp import interp_trilinear as j_interp_trilinear
from cartographer_tpu.ops.paged_grid_3d import (
    PagedIntensityGrid3D as JPagedIntensityGrid3D,
    PagedIntensitySubmapGrid3D as JPagedIntensity,
    _insert_intensity_paged as j_insert_intensity_paged,
    crop_dense_intensity as j_crop_dense_intensity,
)
from cartographer_tpu.ops.scan_matcher_3d import (
    GaussNewtonMatcherParams3D as JParams,
    gauss_newton_match_3d as j_match,
    se3_retract as j_retract,
)
from cartographer_tpu.transform import quaternion as jquat
from cartographer_tpu.transform.rigid import Rigid3 as JRigid3
from cartographer_tpu_torch.interop import (
    grid3d_from_numpy,
    intensity_grid3d_from_numpy,
    paged_intensity_grid_from_numpy,
)
from cartographer_tpu_torch.ops import in_order_scatter
from cartographer_tpu_torch.ops.paged_grid_3d import (
    PagedIntensityGrid3D,
    PagedIntensitySubmapGrid3D,
    crop_dense_intensity,
    crop_dense_intensity_plain,
    insert_intensity_paged,
)
from cartographer_tpu_torch.ops.scan_matcher_3d import (
    GaussNewtonMatcherParams3D,
    gauss_newton_match_3d,
    residuals_and_jacobian_3d,
)
from cartographer_tpu_torch.transform.rigid import Rigid3

torch.set_num_threads(1)

RES = 0.1
POOL = dict(page_size=8, max_pages=2048, num_blocks=16)  # a 12.8 m cube


def _t(a):
    return torch.from_numpy(np.array(a))


def _off_border_points(rng, n, half_extent):
    """Points in a cube of `half_extent` around the origin, each at least a
    tenth of a cell from its cell's faces (the grids' origins sit on cell
    faces of this lattice)."""
    cells = rng.randint(-int(half_extent / RES), int(half_extent / RES), (n, 3))
    return ((cells + rng.uniform(0.1, 0.9, (n, 3))) * RES).astype(np.float32)


def _pools_equal(jpaged, paged):
    jg, g = jpaged.grid, paged.grid
    assert paged._slots == jpaged._slots
    np.testing.assert_array_equal(g.page_table.numpy(), np.asarray(jg.page_table))
    np.testing.assert_array_equal(g.counts.numpy(), np.asarray(jg.counts))
    np.testing.assert_allclose(g.sums.numpy(), np.asarray(jg.sums), rtol=1e-5, atol=0)


def test_paged_intensity_insert_matches_jax():
    """K18's twin and the host allocation against _insert_intensity_paged
    over three scans: the same slots and table, the counts exact, the sums
    within 1e-5 (their order of addition may differ)."""
    rng = np.random.RandomState(0)
    center = np.float32([0.05, -0.15, 0.25])
    jpaged = JPagedIntensity(RES, center, **POOL)
    paged = PagedIntensitySubmapGrid3D(RES, center, "cpu", **POOL)
    for _ in range(3):
        pts = _off_border_points(rng, 600, 7.5)  # some beyond the 12.8 m table
        intens = (rng.rand(600) * 60.0).astype(np.float32)
        intens[::50] = np.nan  # drops out, as above the threshold
        mask = rng.rand(600) > 0.1
        jpaged.insert(pts, intens, mask, 40.0)
        paged.insert(pts, intens, mask, 40.0)
        _pools_equal(jpaged, paged)
    assert paged.num_allocated > 20 and float(paged.grid.counts.max()) >= 1


def test_paged_intensity_insert_on_device_tensors():
    """insert_intensity_paged (the entry point the submaps call) takes the
    threshold itself: only masked returns at or below it, on blocks that
    have a page, add anything."""
    rng = np.random.RandomState(1)
    pts = _off_border_points(rng, 200, 3.0)
    intens = np.where(rng.rand(200) > 0.5, 45.0, 10.0).astype(np.float32)
    intens[0] = 40.0  # at the threshold: kept
    mask = np.ones(200, bool)
    mask[1] = False
    paged = PagedIntensitySubmapGrid3D(RES, np.zeros(3), "cpu", **POOL)
    paged.insert(pts, np.zeros(200, np.float32), mask, 40.0)  # allocates every block
    before = paged.grid.counts.sum()
    insert_intensity_paged(paged.grid, _t(pts), _t(intens), _t(mask), 40.0)
    kept = mask & (intens <= 40.0)
    assert float(paged.grid.counts.sum() - before) == kept.sum()
    np.testing.assert_allclose(float(paged.grid.sums.sum()), intens[kept].sum(), rtol=1e-5)


@pytest.mark.parametrize("center,size", [((0.04, 0.02, -0.03), 48), ((5.03, -6.13, 0.27), 40),
                                         ((0.33, 0.71, -0.26), 24)])
def test_intensity_crop_matches_jax(center, size):
    """K19's twin against crop_dense_intensity, exactly, including windows
    that reach beyond the page table (centers off cell borders)."""
    rng = np.random.RandomState(2)
    jpaged = JPagedIntensity(RES, np.zeros(3, np.float32), **POOL)
    pts = _off_border_points(rng, 800, 6.0)
    intens = (rng.rand(800) * 40.0).astype(np.float32)
    jpaged.insert(pts, intens, np.ones(800, bool), 40.0)
    g = jpaged.grid
    paged = paged_intensity_grid_from_numpy(
        np.asarray(g.sums), np.asarray(g.counts), np.asarray(g.page_table), np.asarray(g.origin),
        g.resolution, g.page_size, jpaged._slots, "cpu")
    ref = j_crop_dense_intensity(g, jnp.asarray(center, jnp.float32), size)
    got = crop_dense_intensity(paged.grid, np.float32(center), size)
    np.testing.assert_array_equal(got.sums.numpy(), np.asarray(ref.sums))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(ref.counts))
    np.testing.assert_array_equal(got.origin.numpy(), np.asarray(ref.origin))
    plain = crop_dense_intensity_plain(paged.grid, _t(np.float32(center)), size)
    assert torch.equal(plain.sums, got.sums) and torch.equal(plain.counts, got.counts)
    assert float(got.counts.sum()) > 0


def test_paged_crop_matches_dense_insert():
    """The paged pool's crop equals the JAX package's dense
    insert_intensities over the same window (test_intensity_3d.py's
    test_paged_intensity_matches_dense)."""
    rng = np.random.RandomState(0)
    pts = _off_border_points(rng, 400, 3.0)
    intens = (rng.rand(400) * 60.0).astype(np.float32)
    mask = rng.rand(400) > 0.1
    paged = PagedIntensitySubmapGrid3D(RES, np.zeros(3, np.float32), "cpu", page_size=16,
                                       max_pages=128, num_blocks=32)
    dense = JIntensityGrid3D.create(96, RES, np.zeros(3))
    for shift in (0.0, 0.05):
        moved = (pts + np.float32(shift)).astype(np.float32)
        paged.insert(moved, intens, mask, 40.0)
        dense = j_insert_intensities(dense, jnp.asarray(moved), jnp.asarray(intens),
                                     jnp.asarray(mask), 40.0)
    crop = paged.crop_dense(np.zeros(3, np.float32), 96)
    np.testing.assert_allclose(crop.origin.numpy(), np.asarray(dense.origin), atol=1e-5)
    np.testing.assert_allclose(crop.sums.numpy(), np.asarray(dense.sums), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(crop.counts.numpy(), np.asarray(dense.counts))
    assert float(crop.counts.max()) > 0


# ---------------------------------------------------------------- the matcher


def _corridor_grids(seed=4, size=64):
    """Occupancy and intensity grids (0.1 m) of two walls at y = +-1.5 m
    whose intensity varies along x, built with the JAX package's dense
    inserters."""
    rng = np.random.RandomState(seed)
    grid = JGrid3D.create(size, RES, np.zeros(3))
    igrid = JIntensityGrid3D.create(size, RES, np.zeros(3))
    for _ in range(4):
        x = (rng.rand(3000) - 0.5) * 5.0
        world = np.stack([x, np.where(rng.rand(3000) > 0.5, 1.5, -1.5) + 0.013,
                          rng.rand(3000) * 2.0 - 1.0], -1).astype(np.float32)
        intens = (15.0 + 12.0 * np.sin(world[:, 0] * np.pi)).astype(np.float32)
        grid = j_insert_range_data(grid, jnp.zeros(3), jnp.asarray(world),
                                   jnp.ones(3000, bool))
        igrid = j_insert_intensities(igrid, jnp.asarray(world), jnp.asarray(intens),
                                     jnp.ones(3000, bool), 40.0)
    return grid, igrid


def _port_grids(grid, igrid):
    return (grid3d_from_numpy(np.asarray(grid.log_odds), np.asarray(grid.known),
                              np.asarray(grid.origin), grid.resolution, "cpu"),
            intensity_grid3d_from_numpy(np.asarray(igrid.sums), np.asarray(igrid.counts),
                                        np.asarray(igrid.origin), igrid.resolution, "cpu"))


def _quat(aa):
    return np.asarray(jquat.from_axis_angle(jnp.asarray(aa, jnp.float32)))


def _j_intensity_residuals(igrid, points, mask, intensities, pose, params):
    """The intensity rows of the JAX package's gauss_newton_match_3d
    (its residual_fn, ops/scan_matcher_3d.py l.93-109), as written there."""
    world = pose.apply(points)
    coords = (world - igrid.origin) / igrid.resolution
    pred = j_interp_trilinear(igrid.average(), coords)
    m = mask & (intensities <= params.intensity_threshold)
    n = jnp.maximum(jnp.sum(m.astype(jnp.float32)), 1.0)
    r = pred - intensities
    scale = params.intensity_huber_scale
    arg = scale * (jnp.abs(r) - scale)
    outlier = arg > 0
    soft = jnp.where(outlier, jnp.sqrt(jnp.where(outlier, arg, 1.0)), 0.0)
    r = jnp.sign(r) * jnp.minimum(jnp.abs(r), scale + soft)
    return jnp.where(m, (params.intensity_weight / jnp.sqrt(n)) * r, 0.0)


def test_intensity_rows_and_jacobian_match_jax():
    """The residual rows and their analytic Jacobian against jax.jacfwd of
    the JAX rows, with residuals on every branch of the soft clip: 0, inside
    the scale, between one and two scales, beyond two, and above the
    threshold."""
    grid, igrid = _corridor_grids()
    rng = np.random.RandomState(5)
    n = 120
    pts = np.stack([(rng.rand(n) - 0.5) * 4.0, np.where(rng.rand(n) > 0.5, 1.45, -1.45),
                    rng.rand(n) - 0.5], -1).astype(np.float32)
    t = np.float32([0.03, -0.02, 0.01])
    q = _quat([0.01, -0.02, 0.03])
    pose = JRigid3(jnp.asarray(t), jnp.asarray(q))
    jparams = JParams(intensity_weight=0.5)
    pred = np.asarray(j_interp_trilinear(
        igrid.average(), (pose.apply(jnp.asarray(pts)) - igrid.origin) / igrid.resolution))
    offsets = np.tile(np.float32([0.0, 0.1, -0.2, 0.45, -0.5, 2.0, -3.0, 7.0]), n // 8)
    intens = (pred - offsets).astype(np.float32)
    intens[::15] = 45.0  # above the threshold: no row
    mask = rng.rand(n) > 0.1
    r_true = pred - intens
    assert (r_true == 0).any() and ((np.abs(r_true) > 0.3) & (np.abs(r_true) < 0.6)).any()

    def local(delta):
        p = j_retract(pose, delta)
        return _j_intensity_residuals(igrid, jnp.asarray(pts), jnp.asarray(mask),
                                      jnp.asarray(intens), p, jparams)

    ref_r = np.asarray(local(jnp.zeros(6)))
    ref_j = np.asarray(jax.jacfwd(local)(jnp.zeros(6, jnp.float32)))
    pgrid, pigrid = _port_grids(grid, igrid)
    params = GaussNewtonMatcherParams3D(intensity_weight=0.5)
    x = _t(np.concatenate([t, q]))
    r, jac = residuals_and_jacobian_3d(pgrid, pgrid, _t(pts), _t(mask), _t(pts[:1]),
                                       torch.zeros(1, dtype=torch.bool), x, x[0:3], x[3:7],
                                       params, pigrid, _t(intens))
    rows = slice(n + 1, 2 * n + 1)  # after the high and the low occupancy rows
    np.testing.assert_allclose(r[rows].numpy(), ref_r, atol=1e-4, rtol=0)
    np.testing.assert_allclose(jac[rows].numpy(), ref_j, atol=1e-4, rtol=0)
    assert np.abs(ref_j).max() > 1e-2  # the rows are live
    # Without the intensity grid, or with a zero weight, there are no rows.
    for grid_arg, w in ((None, 0.5), (pigrid, 0.0)):
        r0, _ = residuals_and_jacobian_3d(
            pgrid, pgrid, _t(pts), _t(mask), _t(pts[:1]), torch.zeros(1, dtype=torch.bool), x,
            x[0:3], x[3:7], GaussNewtonMatcherParams3D(intensity_weight=w), grid_arg,
            _t(intens))
        assert r0.shape[0] == n + 1 + 6


@pytest.mark.parametrize("yaw_only", [False, True])
def test_match_with_intensities_matches_jax(yaw_only):
    _intensity_match(yaw_only, False)


@pytest.mark.parametrize("yaw_only", [False, True])
def test_match_with_intensities_nonmonotonic_matches_jax(yaw_only):
    """The intensity rows with non-monotonic steps (the best pose kept
    beside the accepted one), as K11 runs them."""
    _intensity_match(yaw_only, True)


def _intensity_match(yaw_only, nonmonotonic):
    grid, igrid = _corridor_grids()
    rng = np.random.RandomState(6)
    n = 300
    x = (rng.rand(n) - 0.5) * 4.0
    world = np.stack([x, np.where(rng.rand(n) > 0.5, 1.5, -1.5) + 0.013,
                      rng.rand(n) * 2.0 - 1.0], -1).astype(np.float32)
    intens = (15.0 + 12.0 * np.sin(world[:, 0] * np.pi)).astype(np.float32)
    intens[::25] = 50.0
    scan = world - np.float32([0.2, 0.0, 0.0])
    t0 = np.float32([0.02, 0.01, 0.0])
    q0 = _quat([0.0, 0.0, 0.01] if yaw_only else [0.004, -0.003, 0.01])
    kw = dict(occupied_space_weight_1=0.0, intensity_weight=0.5, translation_weight=0.0,
              rotation_weight=10.0, num_iterations=10, only_optimize_yaw=yaw_only,
              use_nonmonotonic_steps=nonmonotonic)
    ref, ref_cost = j_match(grid, grid, jnp.asarray(scan), jnp.ones(n, bool),
                            jnp.asarray(scan[:1]), jnp.zeros(1, bool),
                            JRigid3(jnp.asarray(t0), jnp.asarray(q0)), JParams(**kw),
                            intensity_grid=igrid, high_intensities=jnp.asarray(intens))
    pgrid, pigrid = _port_grids(grid, igrid)
    pose, cost = gauss_newton_match_3d(
        pgrid, pgrid, _t(scan), torch.ones(n, dtype=torch.bool), _t(scan[:1]),
        torch.zeros(1, dtype=torch.bool), Rigid3(_t(t0), _t(q0)),
        GaussNewtonMatcherParams3D(**kw), intensity_grid=pigrid, high_intensities=_t(intens))
    np.testing.assert_allclose(pose.translation.numpy(), np.asarray(ref.translation),
                               atol=1e-4, rtol=0)
    dq = jquat.multiply(jquat.conjugate(ref.rotation), jnp.asarray(pose.rotation.numpy()))
    assert float(jquat.get_angle(dq)) < 1e-4
    np.testing.assert_allclose(float(cost), float(ref_cost), rtol=1e-4)
    assert abs(float(pose.translation[0]) - 0.02) > 0.05  # it moved along the corridor


@pytest.mark.parametrize("use_intensity", [False, True])
def test_intensity_residual_pins_corridor_translation(use_intensity):
    """In a corridor whose geometry cannot pin the along-corridor offset,
    the intensity rows recover it and the occupancy rows alone do not
    (test_intensity_3d.py's test of the same name, on the port)."""
    rng = np.random.RandomState(1)
    grid = JGrid3D.create(160, RES, np.zeros(3))
    igrid = JIntensityGrid3D.create(160, RES, np.zeros(3))

    def corridor(n, span):
        x = (rng.rand(n) - 0.5) * 2 * span
        world = np.stack([x, np.where(rng.rand(n) > 0.5, 2.0, -2.0),
                          0.2 + rng.rand(n) * 1.8], -1).astype(np.float32)
        return world, (15.0 + 12.0 * np.sin(world[:, 0] * np.pi)).astype(np.float32)

    for _ in range(5):
        world, intens = corridor(6000, 7.0)
        grid = j_insert_range_data(grid, jnp.asarray([0.0, 0.0, 1.0], jnp.float32),
                                   jnp.asarray(world), jnp.ones(len(world), bool))
        igrid = j_insert_intensities(igrid, jnp.asarray(world), jnp.asarray(intens),
                                     jnp.ones(len(world), bool), 40.0)
    world, intens = corridor(2000, 5.0)
    scan = world - np.float32([0.5, 0.0, 0.0])
    pgrid, pigrid = _port_grids(grid, igrid)
    params = GaussNewtonMatcherParams3D(
        occupied_space_weight_0=1.0, occupied_space_weight_1=0.0,
        intensity_weight=0.5 if use_intensity else 0.0, translation_weight=0.0,
        rotation_weight=10.0, num_iterations=30)
    pose, _ = gauss_newton_match_3d(
        pgrid, pgrid, _t(scan), torch.ones(len(scan), dtype=torch.bool), _t(scan[:1]),
        torch.zeros(1, dtype=torch.bool), Rigid3(torch.zeros(3), _t(np.float32([1, 0, 0, 0]))),
        params, intensity_grid=pigrid if use_intensity else None, high_intensities=_t(intens))
    err_x = abs(float(pose.translation[0]) - 0.5)
    if use_intensity:
        assert err_x < 0.12, err_x
    else:
        assert err_x > 0.25, err_x


def test_submap_intensity_grid_is_the_high_window():
    """A finished submap's intensity crop shares the high grid's window,
    and the matching windows around a pose are the same cells."""
    from cartographer_tpu_torch.core.config import SubmapsOptions3D, TpuOptions3D
    from cartographer_tpu_torch.mapping.submap_3d import ActiveSubmaps3D

    tpu = dataclasses.replace(TpuOptions3D(), page_size=8, max_pages=512, num_blocks=32,
                              high_grid_size=48, low_grid_size=16)
    subs = dataclasses.replace(SubmapsOptions3D(), num_range_data=2)
    active = ActiveSubmaps3D(subs, tpu, "cpu", 8, use_intensities=True)
    rng = np.random.RandomState(7)
    finished = []
    for i in range(4):
        pts = _off_border_points(rng, 300, 2.0)
        intens = (rng.rand(300) * 50.0).astype(np.float32)
        finished += active.insert_range_data(np.float32([0.01 * i, 0, 0]), pts,
                                             np.ones(300, bool), np.ones(8), 0.0,
                                             rotated_histogram=np.ones(8), intensities=intens)
    high, low, inten = active.matching_grids_at(np.float32([0.2, 0.1, 0.0]))
    assert torch.equal(high.origin, inten.origin) and inten.sums.shape == high.log_odds.shape
    assert float(inten.counts.sum()) > 0
    f = finished[0]
    assert f.intensity_paged is not None and f.intensity_grid is not None
    assert torch.equal(f.intensity_grid.origin, f.high_grid.origin)
    assert f.intensity_paged.grid.max_pages < 512  # compacted


@pytest.mark.parametrize("case", ["one_cell", "last_cell", "empty_mask"])
def test_paged_intensity_insert_cases_match_jax(case):
    """K18's twin against _insert_intensity_paged on a pool of 64 pages of
    8^3 with random old sums and counts: every return in one cell (one run
    of 700), the pool's last cell among returns that add nothing (JAX adds
    0.0 there for each of them), and an empty mask; pools equal bit for
    bit."""
    rng = np.random.RandomState(len(case))
    P, B, nb = 64, 8, 8
    blocks = rng.choice(nb ** 3, P, replace=False)
    table = np.full(nb ** 3, -1, np.int32)
    table[blocks] = np.arange(P, dtype=np.int32)
    table = table.reshape(nb, nb, nb)
    sums = rng.uniform(0, 500, (P, B, B, B)).astype(np.float32)
    counts = rng.randint(0, 20, (P, B, B, B)).astype(np.float32)
    origin = np.float32([-3.2, -3.1, -3.3])
    n = 700
    cell = {"one_cell": rng.randint(P * B ** 3), "last_cell": P * B ** 3 - 1,
            "empty_mask": rng.randint(P * B ** 3)}[case]
    page, off = divmod(cell, B ** 3)
    world = (np.array(np.unravel_index(blocks[page], (nb,) * 3)) * B
             + np.array(np.unravel_index(off, (B,) * 3)) + 0.5)
    pts = np.repeat((origin + world * RES)[None], n, 0).astype(np.float32)
    intens = (rng.rand(n) * 40.0).astype(np.float32)
    mask = np.ones(n, bool)
    drop = rng.randint(0, 5, n) if case == "last_cell" else np.zeros(n, int)
    # Masked out, above the threshold, NaN, beyond the table.
    mask[drop == 1] = False
    intens[drop == 2] = 45.0
    intens[drop == 3] = np.nan
    pts[drop == 4] += np.float32(10.0)
    if case == "empty_mask":
        mask[:] = False
    jgrid = JPagedIntensityGrid3D(jnp.asarray(sums), jnp.asarray(counts), jnp.asarray(table),
                                  jnp.asarray(origin), RES, B)
    jgrid = j_insert_intensity_paged(jgrid, jnp.asarray(pts), jnp.asarray(intens),
                                     jnp.asarray(mask & (intens <= 40.0)))
    grid = PagedIntensityGrid3D(_t(sums), _t(counts), _t(table), _t(origin), RES, B)
    insert_intensity_paged(grid, _t(pts), _t(intens), _t(mask), 40.0)
    np.testing.assert_array_equal(grid.sums.numpy(), np.asarray(jgrid.sums))
    np.testing.assert_array_equal(grid.counts.numpy(), np.asarray(jgrid.counts))
    added = float(grid.counts.numpy().reshape(-1)[cell] - counts.reshape(-1)[cell])
    assert added == int((mask & (intens <= 40.0) & (drop == 0)).sum())
    assert (added == n) == (case == "one_cell") and (added == 0) == (case == "empty_mask")


def test_in_order_scatter_host_choices():
    """The radix passes the host asks of K18 and K30 for the pools and
    windows the port uses, and the launches a call makes about the one-block
    and the cluster capacities."""
    from cartographer_tpu_torch.core.config import TpuOptions3D

    tpu = TpuOptions3D()
    assert tpu.max_pages * tpu.page_size ** 3 == 2 ** 23
    assert in_order_scatter.radix_passes(tpu.max_pages * tpu.page_size ** 3) == 3
    assert in_order_scatter.radix_passes(tpu.high_grid_size ** 3) == 3  # K30's 256^3
    assert in_order_scatter.radix_passes(POOL["max_pages"] * POOL["page_size"] ** 3) == 3
    assert in_order_scatter.radix_passes(64 * 8 ** 3) == 2
    for cells, passes in [(1, 1), (2, 1), (256, 1), (257, 2), (2 ** 16, 2), (2 ** 16 + 1, 3),
                          (2 ** 24, 3), (2 ** 24 + 1, 4), (2 ** 32 - 2, 4)]:
        assert in_order_scatter.radix_passes(cells) == passes
        assert (cells - 1) >> (8 * passes) == 0
    with pytest.raises(ValueError):
        in_order_scatter.radix_passes(0)
    tile, chunk = in_order_scatter.TILE, in_order_scatter.CHUNK
    assert (tile, chunk) == (8192, 131072)
    for n, launches in [(0, 0), (1, 1), (4096, 1), (tile - 1, 1), (tile, 1), (tile + 1, 1),
                        (32768, 1), (chunk, 1), (chunk + 1, 2), (3 * chunk, 3)]:
        assert in_order_scatter.launches(n) == launches
