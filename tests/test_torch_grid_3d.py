"""The port's dense 3D insert (the plain twin of kernel K25) against the JAX
package's `ops/grid_3d.py:insert_range_data_3d`, on the CPU.

The clouds and the grid origins keep off cell borders: XLA may multiply by
the reciprocal of the resolution where the port divides. XLA's float32 log
puts the default hit increment (p = 0.55) one ulp from the port's, so the
exact comparisons take hit probabilities whose increments coincide, and the
defaults are held to one ulp of the increment."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cartographer_tpu.ops.grid_3d import (
    Grid3D as JGrid3D,
    _flat_index as j_flat_index,
    insert_range_data_3d as j_insert,
)
from cartographer_tpu.ops.probability import probability_to_log_odds as j_log_odds
from cartographer_tpu_torch.ops.grid_3d import Grid3D, _flat_index, insert_range_data_3d
from cartographer_tpu_torch.ops.probability import probability_to_log_odds

torch.set_num_threads(1)

CENTER = np.float32([0.113, -0.071, 0.037])


def _same_increment(p):
    return np.float32(j_log_odds(jnp.float32(p))) == np.float32(probability_to_log_odds(p))


HIT = next(h for h in (0.56, 0.57, 0.58, 0.59, 0.61, 0.62) if _same_increment(h))
assert _same_increment(0.49)
EXACT = dict(hit_probability=HIT, miss_probability=0.49)


def _off_borders(pts, origin, resolution, margin=1e-3):
    frac = np.mod((pts.astype(np.float64) - origin) / resolution, 1.0)
    return ((frac > margin) & (frac < 1 - margin)).all(axis=1)


def _rays(rng, n, sensor, size, resolution):
    """Returns around `sensor` in every direction (all eight octants), some
    beyond the grid."""
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (sensor + d * rng.uniform(0.3, 0.6 * size * resolution, (n, 1))).astype(np.float32)
    return pts, rng.rand(n) < 0.9


def _both(size, resolution, inserts, free_space, n=600, seed=0, probabilities=EXACT):
    rng = np.random.RandomState(seed)
    jgrid = JGrid3D.create(size, resolution, CENTER)
    grid = Grid3D.create(size, resolution, CENTER, "cpu")
    origin = np.asarray(jgrid.origin, np.float64)
    for k in range(inserts):
        sensor = (CENTER + np.float32([0.031 + 0.31 * k, 0.047 - 0.17 * k, -0.019 + 0.05 * k])
                  ).astype(np.float32)  # the grid's center lies on a cell corner
        pts, mask = _rays(rng, n, sensor, size, resolution)
        keep = _off_borders(pts, origin, resolution) & _off_borders(sensor[None], origin,
                                                                     resolution)[0]
        pts, mask = pts[keep], mask[keep]
        octants = {tuple(o) for o in (pts[mask] > sensor).astype(int)}
        assert len(octants) == 8
        jgrid = j_insert(jgrid, jnp.asarray(sensor), jnp.asarray(pts), jnp.asarray(mask),
                         num_free_space_voxels=free_space, **probabilities)
        grid = insert_range_data_3d(grid, torch.from_numpy(sensor), torch.from_numpy(pts),
                                    torch.from_numpy(mask), num_free_space_voxels=free_space,
                                    **probabilities)
    return grid, jgrid


@pytest.mark.parametrize("free_space", [0, 2])
@pytest.mark.parametrize("inserts", [1, 4])
def test_insert_matches_jax(free_space, inserts):
    """Log-odds and known exactly equal to JAX's, rays in all eight octants."""
    grid, jgrid = _both(32, 0.25, inserts, free_space)
    np.testing.assert_array_equal(grid.known.numpy(), np.asarray(jgrid.known))
    np.testing.assert_array_equal(grid.log_odds.numpy(), np.asarray(jgrid.log_odds))
    assert grid.known.sum() > 200
    if free_space:  # misses lower some cells below zero
        assert (grid.log_odds < 0).any() and (grid.log_odds > 0).any()


def test_default_probabilities_agree_to_an_ulp_of_the_increment():
    grid, jgrid = _both(32, 0.25, 4, 2, probabilities={})
    np.testing.assert_array_equal(grid.known.numpy(), np.asarray(jgrid.known))
    np.testing.assert_allclose(grid.log_odds.numpy(), np.asarray(jgrid.log_odds), atol=1e-6,
                               rtol=0)


def test_hit_beats_miss():
    """A cell that one ray hits and another ray passes through gets the hit
    only, as in JAX."""
    sensor = np.float32([0.05, 0.05, 0.05])
    pts = np.float32([[1.05, 0.05, 0.05],    # hit at cell +4 along x
                      [1.55, 0.05, 0.05]])   # passes that cell among its last two
    mask = np.ones(2, bool)
    jgrid = j_insert(JGrid3D.create(16, 0.25, np.zeros(3, np.float32)), jnp.asarray(sensor),
                     jnp.asarray(pts), jnp.asarray(mask), **EXACT)
    grid = insert_range_data_3d(Grid3D.create(16, 0.25, np.zeros(3, np.float32), "cpu"),
                                torch.from_numpy(sensor), torch.from_numpy(pts),
                                torch.from_numpy(mask), **EXACT)
    np.testing.assert_array_equal(grid.log_odds.numpy(), np.asarray(jgrid.log_odds))
    np.testing.assert_array_equal(grid.known.numpy(), np.asarray(jgrid.known))
    hit_cell = grid.world_to_cell(torch.from_numpy(pts[0]))
    assert float(grid.log_odds[tuple(hit_cell.tolist())]) > 0


def test_floor_division_of_negative_deltas():
    """A ray with negative deltas: its miss samples are floored toward -inf,
    as JAX's `//` (C's truncation would move them by one cell)."""
    sensor = np.float32([0.05, 0.05, 0.05])
    pts = np.float32([[-1.45, -0.7, -0.2]])
    mask = np.ones(1, bool)
    jgrid = j_insert(JGrid3D.create(32, 0.25, np.zeros(3, np.float32)), jnp.asarray(sensor),
                     jnp.asarray(pts), jnp.asarray(mask))
    grid = insert_range_data_3d(Grid3D.create(32, 0.25, np.zeros(3, np.float32), "cpu"),
                                torch.from_numpy(sensor), torch.from_numpy(pts),
                                torch.from_numpy(mask))
    np.testing.assert_array_equal(grid.known.numpy(), np.asarray(jgrid.known))
    assert int(grid.known.sum()) == 3  # one hit, two misses


def test_flat_index_matches_jax():
    rng = np.random.RandomState(2)
    cells = rng.randint(-3, 12, (200, 3)).astype(np.int32)
    valid = rng.rand(200) < 0.8
    np.testing.assert_array_equal(
        _flat_index(torch.from_numpy(cells), torch.from_numpy(valid), 10).numpy(),
        np.asarray(j_flat_index(jnp.asarray(cells), jnp.asarray(valid), 10)))


def test_masked_and_empty_clouds_change_nothing():
    grid = Grid3D.create(16, 0.25, CENTER, "cpu")
    pts = torch.from_numpy(np.float32([[0.5, 0.5, 0.5], [1.0, -0.5, 0.2]]))
    out = insert_range_data_3d(grid, torch.from_numpy(CENTER), pts, torch.zeros(2, dtype=bool))
    assert torch.equal(out.log_odds, grid.log_odds) and not out.known.any()
