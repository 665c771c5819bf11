"""The port's bicubic interpolation, analytic gradient and LM matcher (plain
twin of kernel K3) against the JAX package, on a grid built by the JAX
package and carried across."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cartographer_tpu.ops.grid_2d import Grid2D as JGrid2D, insert_range_data as j_insert
from cartographer_tpu.ops.interp import interp_bicubic as j_interp_bicubic
from cartographer_tpu.ops.scan_matcher_2d import (
    GaussNewtonMatcherParams2D as JParams,
    gauss_newton_match_2d as j_match,
    occupied_space_residuals as j_residuals,
)
from cartographer_tpu.sensor.point_cloud import PointCloud as JPointCloud, RangeData as JRangeData
from cartographer_tpu.transform.rigid import Rigid2 as JRigid2
from cartographer_tpu_torch.interop import grid2d_from_numpy
from cartographer_tpu_torch.ops.interp import interp_bicubic
from cartographer_tpu_torch.ops.scan_matcher_2d import (
    GaussNewtonMatcherParams2D,
    gauss_newton_match_2d,
    occupied_space_residuals_and_jacobian,
)
from cartographer_tpu_torch.transform.rigid import Rigid2

SIZE, RES = 256, 0.05


def _room_scan(rng, n=300):
    """Points on the walls of a 10 x 8 m room, seen from the origin."""
    side = rng.randint(4, size=n)
    u = rng.uniform(-1, 1, n)
    x = np.select([side == 0, side == 1], [5.013, -4.987], 5.0 * u)
    y = np.select([side == 2, side == 3], [4.013, -3.987], 4.0 * u)
    return np.stack([x, y], -1).astype(np.float32)


@pytest.fixture(scope="module")
def jax_grid():
    rng = np.random.RandomState(0)
    grid = JGrid2D.create(SIZE, RES, jnp.zeros(2))
    for _ in range(3):
        pts = _room_scan(rng)
        rd = JRangeData(jnp.zeros(2), JPointCloud.from_numpy(pts, 512),
                        JPointCloud.empty(512, 2))
        grid = j_insert(grid, rd, ray_samples=128, method="scatter")
    return grid


def _port_grid(grid):
    return grid2d_from_numpy(np.asarray(grid.log_odds), np.asarray(grid.known),
                             np.asarray(grid.origin), grid.resolution, "cpu")


def test_interp_bicubic():
    rng = np.random.RandomState(1)
    grid = rng.rand(32, 24).astype(np.float32)
    coords = rng.uniform(-3, 35, (500, 2)).astype(np.float32)  # includes the clamped border
    np.testing.assert_allclose(
        interp_bicubic(torch.from_numpy(grid), torch.from_numpy(coords)).numpy(),
        np.asarray(j_interp_bicubic(jnp.asarray(grid), jnp.asarray(coords))), atol=1e-6, rtol=0)


def test_analytic_gradient_matches_jax_grad(jax_grid):
    rng = np.random.RandomState(2)
    pts = _room_scan(rng, 200)
    mask = rng.rand(200) < 0.9
    pose = np.array([0.04, -0.03, 0.02], np.float32)

    def cost(pose_vec):
        r = j_residuals(jax_grid.probability(), jax_grid, jnp.asarray(pts), jnp.asarray(mask),
                        pose_vec, 1.0, method="gather")
        return 0.5 * jnp.sum(r * r)

    ref = np.asarray(jax.grad(cost)(jnp.asarray(pose)))
    r, jac = occupied_space_residuals_and_jacobian(
        _port_grid(jax_grid), torch.from_numpy(pts), torch.from_numpy(mask),
        torch.from_numpy(pose), 1.0)
    np.testing.assert_allclose((jac.T @ r).numpy(), ref, rtol=1e-4, atol=0)


@pytest.mark.parametrize("offset", [(0.03, -0.02, 0.01), (-0.05, 0.04, -0.02)])
def test_gauss_newton_match_2d(jax_grid, offset):
    rng = np.random.RandomState(3)
    pts = _room_scan(rng, 256)
    mask = np.ones(256, bool)
    init = np.asarray(offset, np.float32)
    params = dict(occupied_space_weight=1.0, translation_weight=1.0, rotation_weight=1.0)
    ref_pose, ref_cost = j_match(jax_grid, jnp.asarray(pts), jnp.asarray(mask),
                                 JRigid2.from_vector(jnp.asarray(init)), JParams(**params))
    pose, cost = gauss_newton_match_2d(
        _port_grid(jax_grid), torch.from_numpy(pts), torch.from_numpy(mask),
        Rigid2.from_vector(torch.from_numpy(init)), GaussNewtonMatcherParams2D(**params))
    np.testing.assert_allclose(pose.to_vector().numpy(), np.asarray(ref_pose.to_vector()),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(cost), float(ref_cost), rtol=1e-4)
    # The solve moved toward the true pose (the origin).
    assert np.abs(pose.to_vector().numpy()[:2]).max() < np.abs(init[:2]).max()
