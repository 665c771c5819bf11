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
from cartographer_tpu_torch.sensor.voxel_filter import (
    adaptive_voxel_filter,
    voxel_filter_mask,
    voxel_filter_masks,
)


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


def _branch_cloud(rng, n, case):
    """A 2D cloud and an adaptive filter (max_length, min_num_points,
    max_range) whose search takes the branch `case` (the kernel's phases:
    none at all, phase A alone, A and the bisection tree, A alone)."""
    pts = rng.uniform(-8.0, 8.0, (n, 2)).astype(np.float32)
    mask = rng.rand(n) < 0.9
    if case == "few":  # num_base <= min_num_points
        mask &= rng.rand(n) < 0.15
        return pts, mask, (0.5, int(mask.sum()) + 3, 50.0)
    if case == "first_ok_0":
        return pts, mask, (0.4, 120, 50.0)
    if case == "bisect":  # 1 <= first_ok <= 6
        return pts, mask, (8.0, 120, 50.0)
    return (1e-3 * pts).astype(np.float32), mask, (0.5, 120, 50.0)  # no length enough


def _first_ok(pts, mask, max_length, min_num_points, max_range):
    base = mask & (np.linalg.norm(pts, axis=1) <= max_range)
    if base.sum() <= min_num_points:
        return None
    for k in range(7):
        length = np.float32(max_length) / np.float32(2.0 ** k)
        idx = np.floor(pts[base] / length + np.float32(0.5))
        if len(np.unique(idx, axis=0)) >= min_num_points:
            return k
    return -1


@pytest.mark.parametrize("case", ["few", "first_ok_0", "bisect", "none"])
def test_adaptive_voxel_filter_branches_exact(case):
    """The port's plain adaptive filter against JAX in each branch of the
    kernel's search."""
    rng = np.random.RandomState(23)
    pts, mask, (max_length, min_num_points, max_range) = _branch_cloud(rng, 512, case)
    first_ok = _first_ok(pts, mask, max_length, min_num_points, max_range)
    assert {"few": first_ok is None, "first_ok_0": first_ok == 0,
            "bisect": first_ok is not None and 1 <= first_ok <= 6,
            "none": first_ok == -1}[case]
    port, ref = _adaptive_pair(pts, mask, max_length, min_num_points, max_range)
    np.testing.assert_array_equal(port, ref)


def _node_length(j, low, high):
    """The kernel's node_length in numpy float32: node j (heap order) of the
    bisection's tree, its path walked from (low, high), then its mid."""
    half = np.float32(0.5)
    path = j + 1
    for b in range(path.bit_length() - 2, -1, -1):
        mid = half * (low + high)
        if (path >> b) & 1:
            low = mid
        else:
            high = mid
    return half * (low + high)


@pytest.mark.parametrize("max_length", [0.5, 0.9, 2.0, 3.7])
@pytest.mark.parametrize("first_ok", [1, 2, 3, 4, 5, 6])
def test_bisection_tree_lengths_bit_equal(first_ok, max_length):
    """The 31 lengths the kernel counts side by side are, bit for bit, the
    lengths the sequential bisection visits, on every one of its 32 paths,
    and the walk of the tree ends on the sequential loop's resolution; the
    plain twin's float32 tensor arithmetic takes the same values."""
    length = np.float32(max_length)
    low0 = length / np.float32(1 << first_ok)
    high0 = length / np.float32(1 << (first_ok - 1))
    tree = [_node_length(j, low0, high0) for j in range(31)]
    for outcomes in range(32):
        low, high, j = low0, high0, 0
        tlow = torch.tensor(low0)
        thigh = torch.tensor(high0)
        for step in range(5):
            mid = np.float32(0.5) * (low + high)
            tmid = 0.5 * (tlow + thigh)
            assert mid.tobytes() == tree[j].tobytes() == np.float32(tmid.item()).tobytes()
            if (outcomes >> step) & 1:
                low, tlow, j = mid, tmid, 2 * j + 2
            else:
                high, thigh, j = mid, tmid, 2 * j + 1
        assert np.float32(tlow.item()).tobytes() == low.tobytes()


@pytest.mark.parametrize("max_length", [0.5, 0.9, 2.0, 3.7])
@pytest.mark.parametrize("first_ok", [1, 2, 3, 4, 5, 6])
def test_bisection_in_two_rounds_bit_equal(first_ok, max_length):
    """Phase B in two rounds, as the kernel counts it where the card is
    short of SMs: the 7 nodes of depths 0-2 from the coarse interval, the
    walk down them, then the 3 nodes below the node it reached, each from
    the interval the walk left. On every one of the 32 paths the 10 lengths
    are, bit for bit, the sequential bisection's 5 mids, and the rounds end
    on its resolution."""
    length = np.float32(max_length)
    low0 = length / np.float32(1 << first_ok)
    high0 = length / np.float32(1 << (first_ok - 1))
    for outcomes in range(32):
        enough = [bool((outcomes >> step) & 1) for step in range(5)]
        low, high, mids = low0, high0, []
        for step in range(5):  # the sequential loop
            mid = np.float32(0.5) * (low + high)
            mids.append(mid)
            low, high = (mid, high) if enough[step] else (low, mid)
        rlow, rhigh, depth = low0, high0, 0
        for levels in (3, 2):  # the kernel's rounds: counts, then the walk
            lengths = [_node_length(j, rlow, rhigh) for j in range((1 << levels) - 1)]
            j = 0
            for step in range(levels):
                assert lengths[j].tobytes() == mids[depth + step].tobytes()
                rmid = np.float32(0.5) * (rlow + rhigh)
                if enough[depth + step]:
                    rlow, j = rmid, 2 * j + 2
                else:
                    rhigh, j = rmid, 2 * j + 1
            depth += levels
        assert rlow.tobytes() == low.tobytes()


@pytest.mark.parametrize("filters", [1, 2])
def test_voxel_filter_masks_fused_exact(filters):
    """voxel_filter_masks (the 2D step's K2: the random filter over 3D hits,
    then adaptive filters over their x and y) against JAX's voxel filter
    and adaptive filter on its output."""
    rng = np.random.RandomState(29)
    n = 1024
    a = rng.uniform(-np.pi, np.pi, n)
    r = rng.uniform(0.5, 9.0, n)
    pts = np.stack([r * np.cos(a), r * np.sin(a), rng.uniform(-0.1, 0.1, n)],
                   -1).astype(np.float32)
    mask = rng.rand(n) < 0.95
    key, perm = _perm(31, n)
    chosen = [(0.5, 200, 8.0), (0.9, 100, 50.0)][:filters]
    keep, *adaptive = voxel_filter_masks(torch.from_numpy(pts), torch.from_numpy(mask), 0.05,
                                         perm, chosen, 2)
    ref = np.asarray(j_voxel_filter_mask(jnp.asarray(pts), jnp.asarray(mask), 0.05, key))
    np.testing.assert_array_equal(keep.numpy(), ref)
    zeros = np.zeros(n, np.float32)
    for got, (max_length, min_num_points, max_range) in zip(adaptive, chosen):
        jref = j_adaptive(JPointCloud(jnp.asarray(pts[:, 0:2]), jnp.asarray(ref),
                                      jnp.asarray(zeros)),
                          max_length, min_num_points, max_range, key)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jref.mask))


def _index_by_division(v, r):
    return np.floor(v / r + np.float32(0.5))


def _index_by_product(v, r):
    """The kernel's axis_index(float, Length) in numpy float32: the product
    with the reciprocal, the division where the sum lies within 8 ulps of
    an integer."""
    inv = np.float32(1.0) / r
    y = v * inv + np.float32(0.5)
    f = np.floor(y)
    guard = np.maximum(np.abs(y), np.float32(1.0)) * np.float32(2.0 ** -20)
    d = y - f
    exact = (d < guard) | (d > np.float32(1.0) - guard)
    return np.where(exact, _index_by_division(v, r), f), exact


@pytest.mark.parametrize("resolution", [0.025, 0.05, 0.15, 0.3125, 0.7, 1.9])
def test_voxel_index_by_product_is_the_division_s(resolution):
    """K2's voxel index by a multiply equals floor(v / resolution + 0.5) by
    IEEE division, bit for bit, on random coordinates and on coordinates at
    and next to every cell boundary (where the kernel divides)."""
    rng = np.random.RandomState(41)
    r = np.float32(resolution)
    v = rng.uniform(-60.0, 60.0, 200000).astype(np.float32)
    k = rng.randint(-2000, 2000, 50000).astype(np.float32)
    edge = ((k + np.float32(0.5)) * r).astype(np.float32)
    near = np.concatenate([np.nextafter(edge, np.float32(-np.inf)), edge,
                           np.nextafter(edge, np.float32(np.inf))])
    for values in (v, near):
        got, exact = _index_by_product(values, r)
        np.testing.assert_array_equal(got, _index_by_division(values, r))
    assert exact.mean() > 0.5 and _index_by_product(v, r)[1].mean() < 0.01
