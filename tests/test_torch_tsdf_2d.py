"""The port's TSDF module (plain twins of kernels K20-K22 and the TSDF forms
of K3, K5 and K6) against the JAX package's `ops/tsdf_2d.py`, and the twins
of the JAX package's own TSDF tests (tests/test_tsdf_2d.py)."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cartographer_tpu.ops import tsdf_2d as J
from cartographer_tpu.ops.bnb_2d import build_precomputation_pyramid as j_pyramid
from cartographer_tpu.ops.correlative_2d import CorrelativeSearchParams as JCorrParams
from cartographer_tpu.ops.correlative_2d import real_time_correlative_match as j_corr
from cartographer_tpu.ops.scan_matcher_2d import GaussNewtonMatcherParams2D as JGnParams
from cartographer_tpu.ops.scan_matcher_2d import gauss_newton_match_2d as j_gn_match
from cartographer_tpu.sensor import PointCloud as JPointCloud
from cartographer_tpu.sensor.point_cloud import RangeData as JRangeData
from cartographer_tpu.transform.rigid import Rigid2 as JRigid2
from cartographer_tpu_torch.interop import tsdf_grid2d_from_numpy, tsdf_grid2d_to_numpy
from cartographer_tpu_torch.ops import bnb_2d, correlative_2d, scan_matcher_2d, tsdf_2d
from cartographer_tpu_torch.ops.gauss_newton import lm_solve
from cartographer_tpu_torch.ops.tsdf_2d import (
    TsdfGrid2D,
    TsdfInserterParams,
    estimate_normals_2d,
    insert_into_slots_tsdf,
    insert_range_data_tsdf,
    tsdf_residuals_and_jacobian,
)
from cartographer_tpu_torch.sensor.point_cloud import PointCloud, RangeData
from cartographer_tpu_torch.transform.rigid import Rigid2

SIZE, RES = 256, 0.05

# The suite runs several test processes at once; PyTorch's CPU thread pool in
# each would contend for the cores and slow every process many times over.
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def wall_scan(n=60, x=2.013):
    """Vertical wall seen from the origin."""
    ys = np.linspace(-1.5, 1.5, n)
    return np.stack([np.full(n, x), ys], -1).astype(np.float32)


def make_rd(pts, capacity=128, origin=(0.0, 0.0)):
    """Port RangeData of `pts` padded to `capacity`: padding points are the
    sensor origin, as a zero point transformed with the scan."""
    origin = np.float32(origin)
    p = np.tile(origin, (capacity, 1))
    p[:len(pts)] = pts
    mask = np.arange(capacity) < len(pts)
    none = PointCloud(torch.zeros(capacity, 2), torch.zeros(capacity, dtype=torch.bool),
                      torch.zeros(capacity))
    return RangeData(_t(origin), PointCloud(_t(p), _t(mask), torch.zeros(capacity)), none)


def jax_rd(rd: RangeData):
    cap = rd.returns.capacity
    return JRangeData(jnp.asarray(rd.origin.numpy()),
                      JPointCloud(jnp.asarray(rd.returns.points.numpy()),
                                  jnp.asarray(rd.returns.mask.numpy()), jnp.zeros(cap)),
                      JPointCloud.empty(cap, 2))


def _room_scan(rng, n, origin=(0.0, 0.0)):
    """Returns of a 10 m x 8 m room (walls off the cell borders) seen from
    `origin`, in the room frame."""
    a = np.sort(rng.uniform(-np.pi, np.pi, n))
    d = np.stack([np.cos(a), np.sin(a)], -1)
    o = np.asarray(origin, np.float64)
    tx = np.where(d[:, 0] > 0, (5.013 - o[0]) / d[:, 0], (-4.987 - o[0]) / d[:, 0])
    ty = np.where(d[:, 1] > 0, (4.013 - o[1]) / d[:, 1], (-3.987 - o[1]) / d[:, 1])
    r = np.minimum(np.abs(tx), np.abs(ty)) + rng.normal(0, 0.003, n)
    return (o + r[:, None] * d).astype(np.float32)


def _eigen_gap_ok(pts, mask, origin):
    """Points whose neighbourhood's covariance has clearly separate
    eigenvalues: there both packages' normals are defined to a sign."""
    rel = pts - origin
    order = np.argsort(np.where(mask, np.arctan2(rel[:, 1], rel[:, 0]), np.inf), kind="stable")
    sp = pts[order].astype(np.float64)
    n = len(pts)
    nb = sp[np.clip(np.arange(n)[:, None] + np.arange(-2, 3), 0, n - 1)]
    c = nb - nb.mean(1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", c, c)
    ev = np.linalg.eigvalsh(cov)
    ok_sorted = (ev[:, 1] - ev[:, 0]) > 1e-3 * np.maximum(ev[:, 1], 1e-12)
    ok = np.zeros(n, bool)
    ok[order] = ok_sorted
    return ok & mask


@pytest.fixture(scope="module")
def room_grids():
    """A TSDF grid built by three JAX insertions of room scans, and its
    copy in the port."""
    rng = np.random.RandomState(0)
    grid = J.TsdfGrid2D.create(SIZE, RES, jnp.zeros(2))
    for k in range(3):
        origin = (0.02 * k, -0.013 * k)
        rd = make_rd(_room_scan(rng, 300, origin), 384, origin)
        grid = J.insert_range_data_tsdf(grid, jax_rd(rd))
    port = tsdf_grid2d_from_numpy(np.asarray(grid.tsd), np.asarray(grid.weight),
                                  np.asarray(grid.origin), grid.resolution,
                                  grid.truncation_distance, grid.max_weight, "cpu")
    return grid, port


# ---------------------------------------------------------------- twins of tests/test_tsdf_2d.py


def test_wall_normals_face_origin():
    pts = _t(wall_scan())
    normals = estimate_normals_2d(pts, torch.ones(60, dtype=torch.bool), torch.zeros(2)).numpy()
    assert np.all(normals[5:-5, 0] < -0.9)


def _cell(grid, x, y):
    return tuple(np.floor((np.array([x, y]) - grid.origin.numpy()) / RES).astype(int))


def test_signed_distance_profile():
    grid = insert_range_data_tsdf(TsdfGrid2D.create(128, RES, np.zeros(2), "cpu"),
                                  make_rd(wall_scan()))
    tsd, weight = grid.tsd.numpy(), grid.weight.numpy()
    assert abs(tsd[_cell(grid, 2.013, 0.0)]) < 0.07
    assert tsd[_cell(grid, 1.85, 0.0)] > 0.05
    assert tsd[_cell(grid, 2.18, 0.0)] < -0.05
    assert weight[_cell(grid, 0.5, 0.0)] == 0


def test_weight_saturates():
    grid = TsdfGrid2D.create(64, RES, np.zeros(2), "cpu", max_weight=10.0)
    rd = make_rd(wall_scan(x=1.013))
    for _ in range(30):
        grid = insert_range_data_tsdf(grid, rd)
    assert float(grid.weight.max()) <= 10.0 + 1e-6


def test_correspondence_score_peaks_at_surface():
    grid = insert_range_data_tsdf(TsdfGrid2D.create(128, RES, np.zeros(2), "cpu"),
                                  make_rd(wall_scan()))
    score = grid.correspondence_score().numpy()
    assert score[_cell(grid, 2.013, 0.0)] > score[_cell(grid, 1.86, 0.0)]
    assert score[_cell(grid, 2.013, 0.0)] > 0.7


def _two_walls():
    return np.concatenate([wall_scan(), np.stack(
        [np.linspace(-1.5, 1.5, 60), np.full(60, 2.013)], -1)]).astype(np.float32)


def test_gauss_newton_refines_on_tsdf():
    grid = TsdfGrid2D.create(128, RES, np.zeros(2), "cpu")
    pts = _two_walls()
    rd = make_rd(pts, capacity=256)
    for _ in range(3):
        grid = insert_range_data_tsdf(grid, rd)
    mask = torch.zeros(256, dtype=torch.bool)
    mask[:120] = True
    cloud = rd.returns.points

    def residual_and_jacobian(x):
        return tsdf_residuals_and_jacobian(grid, cloud, mask, x, 1.0)

    pose, _, _ = lm_solve(residual_and_jacobian, torch.tensor([0.04, -0.03, 0.0]),
                          num_iterations=15)
    assert np.linalg.norm(pose.numpy()[:2]) < 0.02, pose


# ---------------------------------------------------------------- per-function parity


@pytest.mark.parametrize("n,capacity", [(300, 300), (300, 384), (200, 512)])
def test_normals_match_jax(n, capacity):
    """The padding (capacity above the valid count) takes part in the last
    valid points' windows, as in JAX; compared where the eigen-gap is clear
    (tolerance 1e-5)."""
    rng = np.random.RandomState(n + capacity)
    origin = np.float32([0.031, -0.017])
    rd = make_rd(_room_scan(rng, n, origin), capacity, origin)
    pts, mask = rd.returns.points.numpy(), rd.returns.mask.numpy()
    ref = np.asarray(J.estimate_normals_2d(jnp.asarray(pts), jnp.asarray(mask),
                                           jnp.asarray(origin)))
    got = estimate_normals_2d(rd.returns.points, rd.returns.mask, rd.origin).numpy()
    ok = _eigen_gap_ok(pts, mask, origin)
    assert ok.sum() > 0.8 * n
    np.testing.assert_allclose(got[ok], ref[ok], atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


@pytest.mark.parametrize("exponent,project", [(0, True), (2, True), (0, False)])
def test_insert_matches_jax(exponent, project):
    """Two insertions of room scans into one grid, the second off the first
    one's origin (tolerance: tsd and weight 1e-5; the unit of the ulp-level
    differences is the running average's division)."""
    rng = np.random.RandomState(7)
    jgrid = J.TsdfGrid2D.create(SIZE, RES, jnp.asarray([0.0, 0.0]))
    grid = TsdfGrid2D.create(SIZE, RES, np.zeros(2), "cpu")
    for origin in ((0.0, 0.0), (0.11, -0.07)):
        rd = make_rd(_room_scan(rng, 280, origin), 320, origin)
        jgrid = J.insert_range_data_tsdf(jgrid, jax_rd(rd), update_weight_range_exponent=exponent,
                                         project_to_normal=project)
        grid = insert_range_data_tsdf(grid, rd, update_weight_range_exponent=exponent,
                                      project_to_normal=project)
    tsd, weight, _, _, _, _ = tsdf_grid2d_to_numpy(grid)
    assert (weight > 0).sum() > 1000
    np.testing.assert_array_equal(weight > 0, np.asarray(jgrid.weight) > 0)
    np.testing.assert_allclose(weight, np.asarray(jgrid.weight), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tsd, np.asarray(jgrid.tsd), atol=1e-5, rtol=0)


def test_two_slot_insert_with_active_mask():
    """The batched insert of the active submaps: slot 1 inactive keeps its
    contents; do_insert False leaves both; each active slot equals a JAX
    insertion into its own grid (tolerance 1e-5)."""
    rng = np.random.RandomState(9)
    origins = np.float32([[-6.4, -6.4], [-6.1, -6.3]])
    rd = make_rd(_room_scan(rng, 250), 256)
    batch = TsdfGrid2D(torch.zeros(2, SIZE, SIZE), torch.zeros(2, SIZE, SIZE), _t(origins), RES)
    insert_into_slots_tsdf(batch, rd, _t(np.array([True, False])), torch.tensor(True),
                           TsdfInserterParams())
    assert float(batch.weight[1].abs().max()) == 0.0
    before = batch.clone()
    insert_into_slots_tsdf(batch, rd, _t(np.array([True, True])), torch.tensor(False),
                           TsdfInserterParams())
    assert torch.equal(batch.tsd, before.tsd) and torch.equal(batch.weight, before.weight)
    insert_into_slots_tsdf(batch, rd, _t(np.array([True, True])), torch.tensor(True),
                           TsdfInserterParams())
    jr = jax_rd(rd)
    for slot, times in ((0, 2), (1, 1)):
        jg = J.TsdfGrid2D(jnp.zeros((SIZE, SIZE)), jnp.zeros((SIZE, SIZE)),
                          jnp.asarray(origins[slot]), RES, 0.3, 10.0)
        for _ in range(times):
            jg = J.insert_range_data_tsdf(jg, jr)
        np.testing.assert_allclose(batch.weight[slot].numpy(), np.asarray(jg.weight), atol=1e-5)
        np.testing.assert_allclose(batch.tsd[slot].numpy(), np.asarray(jg.tsd), atol=1e-5)


def test_correspondence_score_matches_jax(room_grids):
    jgrid, grid = room_grids
    np.testing.assert_array_equal(grid.correspondence_score().numpy(),
                                  np.asarray(jgrid.correspondence_score()))
    np.testing.assert_array_equal(grid.known.numpy(), np.asarray(jgrid.known))
    assert grid.known_bounds_numpy() == jgrid.known_bounds_numpy()


@pytest.mark.parametrize("offset", [(0.03, -0.02, 0.01), (-0.04, 0.03, -0.015)])
def test_tsdf_lm_matches_jax(room_grids, offset):
    """K22's twin against gauss_newton_match_tsdf (tolerance 1e-4 on the
    pose, 1e-4 relative on the cost)."""
    jgrid, grid = room_grids
    pts = _room_scan(np.random.RandomState(11), 256)
    mask = np.ones(256, bool)
    init = np.asarray(offset, np.float32)
    gn = dict(occupied_space_weight=1.0, translation_weight=10.0, rotation_weight=40.0)
    ref_pose, ref_cost = J.gauss_newton_match_tsdf(
        jgrid, jnp.asarray(pts), jnp.asarray(mask), JRigid2.from_vector(jnp.asarray(init)),
        JGnParams(**gn), target_translation=jnp.zeros(2))
    pose, cost = tsdf_2d.gauss_newton_match_tsdf(
        grid, _t(pts), _t(mask), Rigid2.from_vector(_t(init)),
        scan_matcher_2d.GaussNewtonMatcherParams2D(**gn), target_translation=torch.zeros(2))
    np.testing.assert_allclose(pose.to_vector().numpy(), np.asarray(ref_pose.to_vector()),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(cost), float(ref_cost), rtol=1e-4)


def test_tsdf_residual_jacobian_matches_jax(room_grids):
    """The analytic Jacobian against jax.jacfwd of tsdf_residuals: J^T r
    (tolerance 1e-4 relative)."""
    import jax

    jgrid, grid = room_grids
    pts = _room_scan(np.random.RandomState(12), 200)
    mask = np.ones(200, bool)
    pose = np.float32([0.02, -0.01, 0.01])

    def res(x):
        return J.tsdf_residuals(jgrid, jnp.asarray(pts), jnp.asarray(mask), x, 1.0)

    jr = res(jnp.asarray(pose))
    ref = np.asarray(jax.jacfwd(res)(jnp.asarray(pose)).T @ jr)
    r, jac = tsdf_residuals_and_jacobian(grid, _t(pts), _t(mask), _t(pose), 1.0)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-6, rtol=0)
    np.testing.assert_allclose((jac.T @ r).numpy(), ref, rtol=1e-4, atol=1e-9)


def test_loop_closure_refine_on_score_surface_matches_jax(room_grids):
    """K3's TSDF form: the probability-grid LM on the score surface, as the
    JAX loop-closure refine runs it on a TSDF grid (tolerance 1e-4)."""
    jgrid, grid = room_grids
    pts = _room_scan(np.random.RandomState(13), 128)
    mask = np.ones(128, bool)
    init = np.float32([0.04, -0.03, 0.02])
    ref_pose, ref_cost = j_gn_match(jgrid, jnp.asarray(pts), jnp.asarray(mask),
                                    JRigid2.from_vector(jnp.asarray(init)), JGnParams())
    pose, cost = scan_matcher_2d.gauss_newton_match_2d(
        grid, _t(pts), _t(mask), Rigid2.from_vector(_t(init)),
        scan_matcher_2d.GaussNewtonMatcherParams2D())
    np.testing.assert_allclose(pose.to_vector().numpy(), np.asarray(ref_pose.to_vector()),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(cost), float(ref_cost), rtol=1e-4)


@pytest.mark.parametrize("pose", [(0.06, -0.04, 0.02), (-0.1, 0.05, -0.03)])
def test_correlative_search_on_score_surface_matches_jax(room_grids, pose):
    """K5's TSDF form against the JAX gather form on a TSDF grid (score
    1e-6, pose 1e-6: the argmax is the same candidate)."""
    jgrid, grid = room_grids
    pts = np.zeros((320, 2), np.float32)
    pts[:300] = _room_scan(np.random.RandomState(14), 300)
    mask = np.arange(320) < 300
    base = dict(linear_search_window=0.15, angular_search_window=math.radians(8.0),
                translation_delta_cost_weight=0.1, rotation_delta_cost_weight=0.1,
                max_scan_range=12.0)
    init = np.float32(pose)
    jscore, jpose = j_corr(jgrid, jnp.asarray(pts), jnp.asarray(mask),
                           JRigid2(jnp.asarray(init[:2]), jnp.asarray(init[2])),
                           JCorrParams(**base), method="gather")
    score, tpose = correlative_2d.real_time_correlative_match(
        grid, _t(pts), _t(mask), _t(init), correlative_2d.CorrelativeSearchParams(**base))
    assert abs(float(score) - float(jscore)) <= 1e-6
    np.testing.assert_allclose(tpose.numpy(), np.asarray(jpose.to_vector()), atol=1e-6, rtol=0)


def test_pyramid_on_score_surface_matches_jax(room_grids):
    """K6's TSDF form: the pyramid of the score surface, UNKNOWN padding
    (exact)."""
    jgrid, grid = room_grids
    ref = np.asarray(j_pyramid(jgrid.probability(), 5))
    got = bnb_2d.build_precomputation_pyramid(grid, 5).numpy()
    np.testing.assert_array_equal(got, ref)


def test_grid_interop_round_trip(room_grids):
    jgrid, grid = room_grids
    tsd, weight, origin, res, trunc, max_w = tsdf_grid2d_to_numpy(grid)
    assert np.array_equal(tsd, np.asarray(jgrid.tsd)) and res == jgrid.resolution
    assert (trunc, max_w) == (jgrid.truncation_distance, jgrid.max_weight)
    back = tsdf_grid2d_from_numpy(tsd, weight, origin, res, trunc, max_w, "cpu")
    assert dataclasses.asdict(back).keys() == dataclasses.asdict(grid).keys()
    assert torch.equal(back.weight, grid.weight)
