"""The plain twins of kernels K30 (dense intensity insert) and K31 (edge
voxel filter) against the JAX package's `ops/grid_3d.py:insert_intensities`
and `sensor/voxel_filter.py:voxel_filter_edge`, on the CPU.

K30's sums and counts are equal bit for bit: both add each cell's returns in
input order. K31's masks are equal exactly. The clouds keep off cell borders
(K30) and voxel half-cell borders (K31): XLA may multiply by the reciprocal
of the resolution where the port divides."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cartographer_tpu.ops.grid_3d import (
    IntensityGrid3D as JIntensityGrid3D,
    insert_intensities as j_insert_intensities,
)
from cartographer_tpu.sensor.point_cloud import PointCloud as JPointCloud
from cartographer_tpu.sensor.voxel_filter import voxel_filter_edge as j_voxel_filter_edge
from cartographer_tpu_torch.ops.grid_3d import (
    IntensityGrid3D,
    insert_intensities,
    insert_intensities_plain,
)
from cartographer_tpu_torch.sensor.point_cloud import PointCloud
from cartographer_tpu_torch.sensor.voxel_filter import (
    voxel_filter_edge,
    voxel_filter_edge_mask,
    voxel_filter_edge_plain,
)

torch.set_num_threads(1)

CENTER = np.float32([0.113, -0.071, 0.037])


def _off_borders(pts, origin, resolution, shift=0.0, margin=1e-3):
    frac = np.mod((pts.astype(np.float64) - origin) / resolution + shift, 1.0)
    return ((frac > margin) & (frac < 1 - margin)).all(axis=1)


# ---------------------------------------------------------------- K30


@pytest.mark.parametrize("n,seed", [(400, 0), (1500, 1), (3000, 2)])
def test_insert_intensities_matches_jax(n, seed):
    """Two inserts into a 64^3 grid, some intensities above the threshold,
    some returns outside the cube, many returns per cell: sums and counts
    equal to JAX's bit for bit."""
    size, resolution, threshold = 64, 0.1, 40.0
    rng = np.random.RandomState(seed)
    jgrid = JIntensityGrid3D.create(size, resolution, CENTER)
    grid = IntensityGrid3D.create(size, resolution, CENTER, "cpu")
    origin = np.asarray(jgrid.origin, np.float64)
    np.testing.assert_array_equal(grid.origin.numpy(), np.asarray(jgrid.origin))
    for k in range(2):
        # A few dense clusters (many returns per cell) and a spread beyond
        # the 6.4 m cube.
        centers = rng.uniform(-2.5, 2.5, (8, 3))
        pts = np.concatenate([
            centers[rng.randint(0, 8, n // 2)] + rng.normal(0, 0.04, (n // 2, 3)),
            rng.uniform(-4.5, 4.5, (n - n // 2, 3))]).astype(np.float32) + CENTER
        pts = pts[_off_borders(pts, origin, resolution)]
        intens = rng.uniform(0, 60, len(pts)).astype(np.float32)
        mask = rng.rand(len(pts)) < 0.9
        jgrid = j_insert_intensities(jgrid, jnp.asarray(pts), jnp.asarray(intens),
                                     jnp.asarray(mask), threshold)
        grid = insert_intensities(grid, torch.from_numpy(pts), torch.from_numpy(intens),
                                  torch.from_numpy(mask), threshold)
        assert (intens > threshold).any() and (np.abs(pts - CENTER) > 3.2).any(axis=1).any()
    np.testing.assert_array_equal(grid.sums.numpy(), np.asarray(jgrid.sums))
    np.testing.assert_array_equal(grid.counts.numpy(), np.asarray(jgrid.counts))
    assert grid.counts.max() > 5  # runs of many returns were added in order


def test_insert_intensities_masked_and_empty_change_nothing():
    grid = IntensityGrid3D.create(16, 0.2, CENTER, "cpu")
    pts = torch.zeros((5, 3)) + torch.from_numpy(CENTER)
    insert_intensities_plain(grid, pts, torch.ones(5), torch.zeros(5, dtype=torch.bool), 10.0)
    insert_intensities_plain(grid, pts[:0], torch.ones(0), torch.zeros(0, dtype=torch.bool),
                             10.0)
    assert float(grid.sums.abs().sum()) == 0.0 and float(grid.counts.sum()) == 0.0


# ---------------------------------------------------------------- K31


def _edge_pair(pts, mask, resolution, ratio):
    zeros = np.zeros(len(pts), np.float32)
    ref = j_voxel_filter_edge(JPointCloud(jnp.asarray(pts), jnp.asarray(mask),
                                          jnp.asarray(zeros)), resolution, ratio)
    port = voxel_filter_edge(PointCloud(torch.from_numpy(pts), torch.from_numpy(mask),
                                        torch.from_numpy(zeros)), resolution, ratio)
    return port.mask.numpy(), np.asarray(ref.mask)


def test_edge_filter_keeps_sparse_voxels():
    """The JAX test's case: 90 points in one voxel, 3 isolated points."""
    bulk = np.random.RandomState(0).uniform(0, 0.05, (90, 3))
    edges = np.array([[5.0, 0, 0], [0, 5.0, 0], [0, 0, 5.0]])
    pts = np.zeros((128, 3), np.float32)
    pts[:93] = np.concatenate([bulk, edges])
    mask = np.arange(128) < 93
    port, ref = _edge_pair(pts, mask, 0.3, 0.5)
    np.testing.assert_array_equal(port, ref)
    assert port.sum() == 3 and np.all(np.linalg.norm(pts[port], axis=1) > 4)


@pytest.mark.parametrize("dim,n,resolution,ratio", [
    (2, 1081, 0.3, 0.5), (3, 4096, 0.3, 0.5), (3, 2000, 0.45, 0.3), (2, 700, 0.5, 0.9)])
def test_edge_filter_matches_jax(dim, n, resolution, ratio):
    """Clustered clouds with masked points, some masked points piled into
    one voxel (they must not count toward the largest population)."""
    rng = np.random.RandomState(dim * 100 + n)
    centers = rng.uniform(-6, 6, (20, dim))
    pts = np.concatenate([centers[rng.randint(0, 20, n // 2)]
                          + rng.normal(0, 0.2, (n // 2, dim)),
                          rng.uniform(-8, 8, (n - n // 2, dim))]).astype(np.float32)
    mask = rng.rand(n) < 0.85
    pile = rng.choice(n, 60, replace=False)
    pts[pile] = np.float32(0.01)
    mask[pile] = False
    keep_off = _off_borders(pts, 0.0, resolution, shift=0.5)
    pts, mask = pts[keep_off], mask[keep_off]
    port, ref = _edge_pair(pts, mask, resolution, ratio)
    np.testing.assert_array_equal(port, ref)
    assert 0 < port.sum() < mask.sum()


def test_edge_filter_all_masked_and_empty():
    pts = np.random.RandomState(3).uniform(-1, 1, (50, 3)).astype(np.float32)
    port, ref = _edge_pair(pts, np.zeros(50, bool), 0.3, 0.5)
    np.testing.assert_array_equal(port, ref)
    assert not port.any()
    empty = voxel_filter_edge_mask(torch.zeros((0, 2)), torch.zeros(0, dtype=torch.bool), 0.3)
    assert empty.shape == (0,)
    assert voxel_filter_edge_plain(torch.from_numpy(pts), torch.ones(50, dtype=torch.bool),
                                   0.3, 0.5).dtype == torch.bool
