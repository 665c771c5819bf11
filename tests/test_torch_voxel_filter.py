"""The port's voxel filters (plain twin of kernel K2) against the JAX
package: with the JAX permutation injected the keep-masks are equal
exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cartographer_tpu.sensor.point_cloud import PointCloud as JPointCloud
from cartographer_tpu.sensor.voxel_filter import (
    adaptive_voxel_filter as j_adaptive,
    voxel_filter_mask as j_voxel_filter_mask,
)
from cartographer_tpu_torch.sensor.point_cloud import PointCloud
from cartographer_tpu_torch.sensor.voxel_filter import adaptive_voxel_filter, voxel_filter_mask


def _perm(seed, n):
    key = jax.random.PRNGKey(seed)
    return key, torch.from_numpy(np.array(jax.random.permutation(key, n), np.int32))


def _cloud(rng, n, dim, extent, valid_fraction=0.9):
    pts = rng.uniform(-extent, extent, (n, dim)).astype(np.float32)
    mask = rng.rand(n) < valid_fraction
    return pts, mask


@pytest.mark.parametrize("dim,resolution", [(2, 0.05), (3, 0.025), (2, 0.7)])
def test_voxel_filter_mask_exact(dim, resolution):
    rng = np.random.RandomState(dim)
    pts, mask = _cloud(rng, 512, dim, 1.5)
    key, perm = _perm(3, 512)
    ref = np.asarray(j_voxel_filter_mask(jnp.asarray(pts), jnp.asarray(mask), resolution, key))
    port = voxel_filter_mask(torch.from_numpy(pts), torch.from_numpy(mask), resolution, perm)
    np.testing.assert_array_equal(port.numpy(), ref)
    assert 0 < ref.sum() <= mask.sum()


def _adaptive_pair(pts, mask, max_length, min_num_points, max_range, seed=5):
    key, perm = _perm(seed, pts.shape[0])
    zeros = np.zeros(pts.shape[0], np.float32)
    ref = j_adaptive(JPointCloud(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(zeros)),
                     max_length, min_num_points, max_range, key)
    port = adaptive_voxel_filter(
        PointCloud(torch.from_numpy(pts), torch.from_numpy(mask), torch.from_numpy(zeros)),
        max_length, min_num_points, max_range, perm)
    return port.mask.numpy(), np.asarray(ref.mask)


@pytest.mark.parametrize("max_length,min_num_points", [(0.5, 200), (0.9, 100), (2.0, 60)])
def test_adaptive_voxel_filter_exact(max_length, min_num_points):
    rng = np.random.RandomState(7)
    pts, mask = _cloud(rng, 512, 2, 6.0)
    port, ref = _adaptive_pair(pts, mask, max_length, min_num_points, 5.0)
    np.testing.assert_array_equal(port, ref)
    assert ref.sum() >= min_num_points


@pytest.mark.parametrize("case", ["empty", "few_points", "no_length_good_enough"])
def test_adaptive_voxel_filter_edge_cases(case):
    rng = np.random.RandomState(11)
    pts, mask = _cloud(rng, 256, 2, 4.0)
    if case == "empty":
        mask[:] = False
    elif case == "few_points":
        mask[:] = False
        mask[:40] = True  # <= min_num_points survive: all kept
    else:
        pts = (0.001 * pts).astype(np.float32)  # one tiny cluster: never 100 voxels
    port, ref = _adaptive_pair(pts, mask, 0.5, 100, 50.0)
    np.testing.assert_array_equal(port, ref)
    if case == "few_points":
        np.testing.assert_array_equal(port, mask)


def test_adaptive_filters_of_a_3d_scan_exact():
    """The shapes the 3D frontend gives the filter: 4096 points with 3D
    keys, the voxel filter and then both adaptive searches on its output."""
    rng = np.random.RandomState(13)
    n = 4096
    # Walls of a hall seen from inside: most points far, some near.
    pts = rng.uniform(-1.0, 1.0, (n, 3))
    pts /= np.abs(pts).max(axis=1, keepdims=True)
    pts = (pts * np.float32([14.0, 9.0, 1.5])).astype(np.float32)
    mask = rng.rand(n) < 0.95
    key, perm = _perm(17, n)
    ref = np.asarray(j_voxel_filter_mask(jnp.asarray(pts), jnp.asarray(mask), 0.15, key))
    keep = voxel_filter_mask(torch.from_numpy(pts), torch.from_numpy(mask), 0.15, perm)
    np.testing.assert_array_equal(keep.numpy(), ref)
    zeros = np.zeros(n, np.float32)
    for max_length, min_num_points, max_range in ((2.0, 150, 15.0), (4.0, 200, 60.0)):
        jref = j_adaptive(JPointCloud(jnp.asarray(pts), jnp.asarray(ref), jnp.asarray(zeros)),
                          max_length, min_num_points, max_range, key)
        port = adaptive_voxel_filter(
            PointCloud(torch.from_numpy(pts), keep, torch.from_numpy(zeros)), max_length,
            min_num_points, max_range, perm)
        np.testing.assert_array_equal(port.mask.numpy(), np.asarray(jref.mask))
        assert min_num_points <= int(port.mask.sum()) < 2 * min_num_points + 100
