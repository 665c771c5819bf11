"""The port's real-time correlative matcher (plain twin of kernel K5)
against the JAX package's gather form, on a grid built by the JAX package
and carried across."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cartographer_tpu.ops.correlative_2d import (
    CorrelativeSearchParams as JParams,
    _candidate_geometry,
    _scores_gather,
    real_time_correlative_match as j_match,
)
from cartographer_tpu.ops.grid_2d import Grid2D as JGrid2D, insert_range_data as j_insert
from cartographer_tpu.sensor.point_cloud import PointCloud as JPointCloud, RangeData as JRangeData
from cartographer_tpu.transform.rigid import Rigid2 as JRigid2
from cartographer_tpu_torch.interop import grid2d_from_numpy
from cartographer_tpu_torch.ops.correlative_2d import (
    CorrelativeSearchParams,
    real_time_correlative_match,
    scores_plain,
    tree_sum,
)

SIZE, RES = 256, 0.05


def _room_scan(rng, n=300):
    side = rng.randint(4, size=n)
    u = rng.uniform(-1, 1, n)
    x = np.select([side == 0, side == 1], [5.013, -4.987], 5.0 * u)
    y = np.select([side == 2, side == 3], [4.013, -3.987], 4.0 * u)
    return np.stack([x, y], -1).astype(np.float32)


@pytest.fixture(scope="module")
def grids():
    rng = np.random.RandomState(0)
    grid = JGrid2D.create(SIZE, RES, jnp.zeros(2))
    for _ in range(3):
        rd = JRangeData(jnp.zeros(2), JPointCloud.from_numpy(_room_scan(rng), 512),
                        JPointCloud.empty(512, 2))
        grid = j_insert(grid, rd, ray_samples=128, method="scatter")
    port = grid2d_from_numpy(np.asarray(grid.log_odds), np.asarray(grid.known),
                             np.asarray(grid.origin), grid.resolution, "cpu")
    return grid, port


def _scan(seed, n, capacity):
    rng = np.random.RandomState(seed)
    pts = np.zeros((capacity, 2), np.float32)
    pts[:n] = _room_scan(rng, n)
    mask = np.arange(capacity) < n
    return pts, mask


def _params(**kw):
    base = dict(linear_search_window=0.15, angular_search_window=math.radians(10.0),
                translation_delta_cost_weight=0.1, rotation_delta_cost_weight=0.1,
                max_scan_range=12.0)
    base.update(kw)
    return JParams(**base), CorrelativeSearchParams(**base)


@pytest.mark.parametrize("seed,n,capacity,pose", [
    (1, 300, 512, (0.07, -0.04, 0.03)),
    (2, 180, 300, (-0.11, 0.06, -0.05)),
    (3, 64, 64, (0.0, 0.0, 0.0)),
])
def test_scores_and_argmax_match_jax(grids, seed, n, capacity, pose):
    jgrid, grid = grids
    pts, mask = _scan(seed, n, capacity)
    jparams, params = _params()
    init = np.float32(pose)
    jinit = JRigid2(jnp.asarray(init[:2]), jnp.asarray(init[2]))
    deltas, valid, cells = _candidate_geometry(jgrid, jnp.asarray(pts), jnp.asarray(mask),
                                               jinit, jparams)
    jraw = np.asarray(_scores_gather(jgrid, jgrid.probability(), cells, jnp.asarray(mask),
                                     jparams.num_linear(RES)))
    scores, tdeltas = scores_plain(grid, torch.from_numpy(pts), torch.from_numpy(mask),
                                   torch.from_numpy(init), params)
    np.testing.assert_allclose(tdeltas.numpy(), np.asarray(deltas), rtol=0, atol=1e-7)
    s = scores.numpy()
    assert np.array_equal(np.isfinite(s), np.broadcast_to(np.asarray(valid)[:, None, None],
                                                          s.shape))
    # The raw means (before the prior) against JAX's gather form.
    assert np.isfinite(jraw).all()
    jscore, jpose = j_match(jgrid, jnp.asarray(pts), jnp.asarray(mask), jinit, jparams,
                            method="gather")
    score, tpose = real_time_correlative_match(grid, torch.from_numpy(pts),
                                               torch.from_numpy(mask), torch.from_numpy(init),
                                               params)
    assert abs(float(score) - float(jscore)) <= 1e-6
    np.testing.assert_allclose(tpose.numpy(), np.asarray(jpose.to_vector()), rtol=0, atol=1e-6)


def test_prior_weighted_scores_match_jax(grids):
    jgrid, grid = grids
    pts, mask = _scan(4, 250, 256)
    jparams, params = _params(angular_search_window=math.radians(4.0))
    init = np.float32([0.02, 0.05, 0.01])
    jinit = JRigid2(jnp.asarray(init[:2]), jnp.asarray(init[2]))
    deltas, valid, cells = _candidate_geometry(jgrid, jnp.asarray(pts), jnp.asarray(mask),
                                               jinit, jparams)
    nl = jparams.num_linear(RES)
    raw = np.asarray(_scores_gather(jgrid, jgrid.probability(), cells, jnp.asarray(mask), nl))
    dxy = np.abs(np.arange(-nl, nl + 1, dtype=np.float32)) * np.float32(RES)
    dist = np.sqrt(dxy[:, None] ** 2 + dxy[None, :] ** 2)
    q = dist[None] * np.float32(0.1) + np.abs(np.asarray(deltas))[:, None, None] * np.float32(0.1)
    expected = np.where(np.asarray(valid)[:, None, None], raw * np.exp(-(q * q)), -np.inf)
    scores, _ = scores_plain(grid, torch.from_numpy(pts), torch.from_numpy(mask),
                             torch.from_numpy(init), params)
    np.testing.assert_allclose(scores.numpy(), expected, rtol=0, atol=2e-6)


def test_tree_sum_order():
    v = torch.tensor([1e8, 1.0, -1e8, 1.0], dtype=torch.float32)
    # ((1e8 + -1e8) + (1 + 1)): the halving tree pairs k with k + n/2.
    assert float(tree_sum(v)) == 2.0


@pytest.mark.parametrize("max_scan_range,inside", [(12.0, "few"), (2.0, "all")])
def test_invalid_angles_score_minus_inf_at_both_extremes(grids, max_scan_range, inside):
    """The twin scores an angle -inf exactly where JAX's angle_valid is
    false. With max_scan_range 12 m the scan's 5 m reach takes a coarser
    step, so the window ends inside the angle grid on both sides (the
    kernel's score blocks for those angles read no point); with 2 m every
    angle is inside."""
    jgrid, grid = grids
    pts, mask = _scan(5, 300, 512)
    jparams, params = _params(max_scan_range=max_scan_range)
    init = np.float32([0.04, -0.03, 0.02])
    jinit = JRigid2(jnp.asarray(init[:2]), jnp.asarray(init[2]))
    _, valid, _ = _candidate_geometry(jgrid, jnp.asarray(pts), jnp.asarray(mask), jinit,
                                      jparams)
    valid = np.asarray(valid)
    scores, _ = scores_plain(grid, torch.from_numpy(pts), torch.from_numpy(mask),
                             torch.from_numpy(init), params)
    s = scores.numpy()
    assert np.array_equal(np.isfinite(s), np.broadcast_to(valid[:, None, None], s.shape))
    assert np.array_equal(np.isneginf(s), ~np.isfinite(s))
    half = (len(valid) - 1) // 2
    if inside == "few":
        # The edge on both sides: valid through some angle, invalid beyond.
        for side in (valid[:half + 1][::-1], valid[half:]):
            edge = int(np.argmin(side))
            assert 0 < edge and not side[edge:].any() and side[:edge].all()
    else:
        assert valid.all()
