"""The port's 3D real-time correlative search (plain twin of kernel K17)
against the JAX package's `real_time_correlative_match_3d`.

Scores agree within 1e-5 (the two sum the points in other orders); the
pose is the same candidate, so its translation offset is equal and its
quaternion within 1e-6, unless two candidates score within 1e-5 of each
other (a tie the summation order may break either way). Every case keeps
the cloud's largest range away from the ranges where a rotation index sits
on the window's edge (|k step| = window), where the float32 angular step of
the two packages could fall on either side by an ulp."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cartographer_tpu.ops.grid_3d import Grid3D as JGrid3D
from cartographer_tpu.ops.scan_matcher_3d import (
    CorrelativeSearchParams3D as JParams,
    real_time_correlative_match_3d as j_match,
)
from cartographer_tpu.transform import quaternion as jquat
from cartographer_tpu.transform.rigid import Rigid3 as JRigid3
from cartographer_tpu_torch.interop import grid3d_from_numpy
from cartographer_tpu_torch.ops.scan_matcher_3d import (
    CorrelativeSearchParams3D,
    correlative_match_3d,
    correlative_match_3d_plain,
    real_time_correlative_match_3d,
    search_sizes,
)
from cartographer_tpu_torch.transform.rigid import Rigid3
from test_ops_3d import build_grid_3d, make_environment_3d

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_grid(g):
    return grid3d_from_numpy(np.asarray(g.log_odds), np.asarray(g.known),
                             np.asarray(g.origin), g.resolution, "cpu")


def _quat(aa):
    return np.asarray(jquat.from_axis_angle(jnp.asarray(aa, jnp.float32)))


def _edge_margin(points, mask, resolution, params):
    """How far (in radians) the nearest rotation index k lies from the
    window's edge: min over k of | |k| step - window | at the float64 step."""
    r = max(float(np.linalg.norm(points[mask], axis=1).max()), 3.0 * resolution)
    step = (1.0 - 1e-3) * math.acos(1.0 - resolution ** 2 / (2.0 * r ** 2))
    _, na = search_sizes(resolution, params)
    return min(abs(k * step - params.angular_search_window) for k in range(na + 1))


def _compare(jgrid, points, mask, t0, q0, jparams, port_params):
    assert _edge_margin(points, mask, jgrid.resolution, jparams) > 1e-4
    jscore, jpose = j_match(jgrid, jnp.asarray(points), jnp.asarray(mask),
                            JRigid3(jnp.asarray(t0), jnp.asarray(q0)), jparams)
    x0 = _t(np.concatenate([t0, q0]).astype(np.float32))
    grid = _port_grid(jgrid)
    score, x, index = correlative_match_3d_plain(grid, _t(points), _t(mask), x0, port_params)
    np.testing.assert_allclose(float(score), float(jscore), atol=1e-5, rtol=0)
    same = (np.array_equal(x[0:3].numpy(), np.asarray(jpose.translation))
            and np.abs(x[3:7].numpy() - np.asarray(jpose.rotation)).max() < 1e-6)
    if not same:
        # A tie: JAX's pose must score within 1e-5 of the best here too.
        tie = correlative_match_3d_plain(
            grid, _t(points), _t(mask),
            _t(np.concatenate([np.asarray(jpose.translation), np.asarray(jpose.rotation)])),
            CorrelativeSearchParams3D(linear_search_window=0.0, angular_search_window=0.0,
                                      translation_delta_cost_weight=0.0,
                                      rotation_delta_cost_weight=0.0,
                                      max_scan_range=port_params.max_scan_range))[0]
        assert abs(float(tie) - float(score)) < 1e-5, (x, jpose)
    # The entry points agree with the twin on the CPU.
    s2, x2 = correlative_match_3d(grid, _t(points), _t(mask), x0, port_params)
    s3, pose3 = real_time_correlative_match_3d(grid, _t(points), _t(mask),
                                               Rigid3(x0[0:3], x0[3:7]), port_params)
    assert torch.equal(x2, x) and torch.equal(torch.cat([pose3.translation, pose3.rotation]), x)
    assert float(s2) == float(score) == float(s3)
    return score, x, index


def _params(**kw):
    return JParams(**kw), CorrelativeSearchParams3D(**kw)


def test_recovers_translation_like_jax():
    """The JAX package's own scene (tests/test_ops_3d.py TestCorrelative3D)."""
    world = make_environment_3d()
    jgrid = build_grid_3d(world)
    scan = (world - np.float32([0.4, -0.2, 0.0])).astype(np.float32)
    jparams, params = _params(linear_search_window=0.6, angular_search_window=0.02,
                              max_scan_range=6.0)
    score, x, _ = _compare(jgrid, scan, np.ones(len(scan), bool), np.zeros(3, np.float32),
                           np.float32([1, 0, 0, 0]), jparams, params)
    np.testing.assert_allclose(x[0:3].numpy(), [0.4, -0.2, 0.0], atol=0.21)
    assert float(score) > 0.3


def test_random_crop_rotated_and_shifted_cloud():
    """A random dense window (known and unknown cells, random log-odds) and
    a masked random cloud out to about 6.5 m, searched around a rotated and
    shifted initial pose; every rotation of the window is valid here."""
    rng = np.random.RandomState(7)
    size, res = 40, 0.1
    log_odds = rng.uniform(-2.2, 2.2, (size,) * 3).astype(np.float32)
    known = rng.rand(size, size, size) > 0.3
    jgrid = JGrid3D(log_odds=jnp.asarray(log_odds), known=jnp.asarray(known),
                    origin=jnp.asarray(np.float32([-2.0, -2.0, -2.0])), resolution=res)
    n = 300
    points = rng.uniform(-1.6, 1.6, (n, 3)).astype(np.float32)
    points[0] = [5.0, 4.0, 1.0]  # the largest range, about 6.5 m: all 7 angles are valid
    mask = rng.rand(n) > 0.2
    mask[0] = True
    jparams, params = _params(linear_search_window=0.25, angular_search_window=0.05,
                              max_scan_range=6.0)
    nl, na = search_sizes(res, params)
    assert (nl, na) == (3, 3)
    _, _, index = _compare(jgrid, points, mask, np.float32([0.13, -0.07, 0.04]),
                           _quat([0.03, -0.02, 0.2]), jparams, params)
    assert index > 0


def test_default_window_on_a_coarse_grid():
    """The default window (0.15 m, 1 degree, 60 m) on a 0.2 m grid, a room
    three times the size of the others: at ranges of 12-18 m only the 27
    rotations one step around the initial one are valid of the 11^3."""
    world = make_environment_3d(num=600, seed=5) * 3.0
    jgrid = build_grid_3d(world, resolution=0.2, size=128, num_inserts=4)
    scan = (world - np.float32([0.25, 0.1, 0.0])).astype(np.float32)
    jparams, params = _params(linear_search_window=0.15,
                              angular_search_window=math.radians(1.0))
    assert search_sizes(0.2, params) == (1, 5)
    _compare(jgrid, scan, np.ones(len(scan), bool), np.float32([0.05, 0.0, 0.0]),
             _quat([0.0, 0.0, 0.004]), jparams, params)


def test_empty_cloud_takes_the_first_candidate():
    jgrid = build_grid_3d(make_environment_3d(num=100, seed=2))
    points = np.ones((16, 3), np.float32)
    params = CorrelativeSearchParams3D(linear_search_window=0.4, angular_search_window=0.02,
                                       max_scan_range=6.0)
    x0 = _t(np.float32([0.1, 0.2, 0.3, 1, 0, 0, 0]))
    score, x = correlative_match_3d(_port_grid(jgrid), _t(points), torch.zeros(16, dtype=bool),
                                    x0, params)
    # No point scores: every candidate is 0, and the lowest flat index, the
    # first valid rotation and the first translation, wins.
    assert float(score) == 0.0
    nl, _ = search_sizes(0.2, params)
    np.testing.assert_allclose(x[0:3].numpy(), x0[0:3].numpy() - nl * np.float32(0.2),
                               atol=1e-6)


@pytest.mark.parametrize("n", [1, 100, 512])
def test_pairwise_sum_is_the_kernel_tree(n):
    from cartographer_tpu_torch.ops.scan_matcher_3d import _pairwise_sum

    x = torch.from_numpy(np.random.RandomState(n).rand(3, n).astype(np.float32))
    padded = torch.nn.functional.pad(x, (0, (1 << (n - 1).bit_length()) - n))
    while padded.shape[-1] > 1:
        h = padded.shape[-1] // 2
        padded = torch.stack([padded[:, i] + padded[:, i + h] for i in range(h)], -1)
    assert torch.equal(_pairwise_sum(x), padded[:, 0])
    np.testing.assert_allclose(_pairwise_sum(x).numpy(), x.double().sum(-1).numpy(), rtol=1e-5)
