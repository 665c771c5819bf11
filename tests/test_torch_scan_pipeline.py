"""The port's preprocess_scan_2d and the 2D step's entry with its adaptive
filters (plain twins of kernels K1 and K2) against the JAX package: points
within 1e-5 m, masks equal exactly on inputs kept at least 1e-3 m from every
gate."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cartographer_tpu.ops.scan_pipeline_2d import (
    ScanPreprocessParams2D as JParams,
    preprocess_scan_2d as j_preprocess,
)
from cartographer_tpu.sensor.voxel_filter import adaptive_voxel_filter as j_adaptive
from cartographer_tpu.transform.rigid import Rigid3 as JRigid3
from cartographer_tpu_torch.ops.scan_pipeline_2d import (
    ScanPreprocessParams2D,
    preprocess_and_filter_scan_2d,
    preprocess_scan_2d,
)
from cartographer_tpu_torch.simulation import reference_permutation
from cartographer_tpu_torch.transform.rigid import Rigid3

N = 512
PARAMS = dict(min_range=0.3, max_range=12.0, min_z=-0.8, max_z=2.0,
              missing_data_ray_length=5.0, voxel_filter_size=0.025)


def _quat(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    return np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis]).astype(np.float32)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    # Ranges well inside or beyond the gates; z near the sensor plane.
    ranges = np.where(rng.rand(N) < 0.8, rng.uniform(0.6, 11.5, N), rng.uniform(12.5, 20.0, N))
    angles = rng.uniform(-np.pi, np.pi, N)
    points = np.stack([ranges * np.cos(angles), ranges * np.sin(angles),
                       rng.uniform(-0.2, 0.4, N)], -1).astype(np.float32)
    times01 = np.linspace(0.0, 1.0, N).astype(np.float32)
    mask = rng.rand(N) < 0.9
    origins = np.tile(np.array([0.05, -0.02, 0.1], np.float32), (N, 1))
    poses = [(np.array([0.3, -0.2, 0.0], np.float32), _quat([0, 0, 1], 0.2)),
             (np.array([0.5, -0.1, 0.01], np.float32), _quat([0.05, 0.02, 1], 0.26))]
    gravity = _quat([1, 0.3, 0], 0.01)
    return points, times01, mask, origins, poses, gravity


def test_preprocess_scan_2d_matches_jax():
    points, times01, mask, origins, poses, gravity = _inputs(0)
    key = jax.random.PRNGKey(9)
    perm = torch.from_numpy(np.array(jax.random.permutation(key, N), np.int32))
    ref_rd, ref_origin = j_preprocess(
        jnp.asarray(points), jnp.asarray(times01), jnp.asarray(mask), jnp.asarray(origins),
        JRigid3(*map(jnp.asarray, poses[0])), JRigid3(*map(jnp.asarray, poses[1])),
        jnp.asarray(gravity), JParams(**PARAMS), key)
    t = torch.from_numpy
    rd, origin = preprocess_scan_2d(
        t(points), t(times01), t(mask), t(origins), Rigid3(t(poses[0][0]), t(poses[0][1])),
        Rigid3(t(poses[1][0]), t(poses[1][1])), t(gravity), ScanPreprocessParams2D(**PARAMS),
        perm)
    for port, ref in ((rd.returns.points, ref_rd.returns.points),
                      (rd.misses.points, ref_rd.misses.points),
                      (rd.origin, ref_rd.origin), (origin, ref_origin)):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(rd.returns.mask.numpy(), np.asarray(ref_rd.returns.mask))
    np.testing.assert_array_equal(rd.misses.mask.numpy(), np.asarray(ref_rd.misses.mask))
    assert rd.returns.mask.sum() > 300 and rd.misses.mask.sum() > 50


# The 2D step's two adaptive filters at the frontend's defaults: the
# matcher's and the loop closure's.
FILTERS = ((0.5, 200, 50.0), (0.9, 100, 50.0))


@pytest.mark.parametrize("robots", [1, 3])
def test_preprocess_and_filter_scan_2d_matches_jax(robots):
    """The 2D step's entry (`preprocess_and_filter_scan_2d`: K1, the random
    filter and both adaptive filters, one launch on the card), robot by
    robot against JAX's preprocess_scan_2d and adaptive_voxel_filter on its
    returns, on the permutation JAX draws for each robot's seed
    (`simulation.reference_permutation`): points within 1e-5 m, masks
    exact."""
    rows = [_inputs(10 + r) for r in range(robots)]
    seeds = [7 + 3 * r for r in range(robots)]
    t = torch.from_numpy

    def lead(k, sub=None):
        arrays = [row[k] if sub is None else row[k][sub[0]][sub[1]] for row in rows]
        return t(np.stack(arrays)) if robots > 1 else t(arrays[0])

    perms = [reference_permutation(s, N) for s in seeds]
    perm = t(np.stack(perms)) if robots > 1 else t(perms[0])
    rd, origin, adaptive = preprocess_and_filter_scan_2d(
        lead(0), lead(1), lead(2), lead(3), Rigid3(lead(4, (0, 0)), lead(4, (0, 1))),
        Rigid3(lead(4, (1, 0)), lead(4, (1, 1))), lead(5), ScanPreprocessParams2D(**PARAMS),
        perm, FILTERS)
    for r, ((points, times01, mask, origins, poses, gravity), seed) in enumerate(
            zip(rows, seeds)):
        key = jax.random.PRNGKey(seed)
        ref_rd, ref_origin = j_preprocess(
            jnp.asarray(points), jnp.asarray(times01), jnp.asarray(mask), jnp.asarray(origins),
            JRigid3(*map(jnp.asarray, poses[0])), JRigid3(*map(jnp.asarray, poses[1])),
            jnp.asarray(gravity), JParams(**PARAMS), key)
        at = (lambda x: x[r]) if robots > 1 else (lambda x: x)
        for port, ref in ((rd.returns.points, ref_rd.returns.points),
                          (rd.misses.points, ref_rd.misses.points),
                          (rd.origin, ref_rd.origin), (origin, ref_origin)):
            np.testing.assert_allclose(at(port).numpy(), np.asarray(ref), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(at(rd.returns.mask).numpy(),
                                      np.asarray(ref_rd.returns.mask))
        np.testing.assert_array_equal(at(rd.misses.mask).numpy(), np.asarray(ref_rd.misses.mask))
        for got, (max_length, min_num_points, max_range) in zip(adaptive, FILTERS):
            ref = j_adaptive(ref_rd.returns, max_length, min_num_points, max_range, key)
            np.testing.assert_array_equal(at(got).numpy(), np.asarray(ref.mask))
            assert 0 < int(at(got).sum()) < int(at(rd.returns.mask).sum())
