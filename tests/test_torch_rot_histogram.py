"""The port's rotational histogram and its yaw scoring (plain twins of
kernels K12 and K13) against the JAX package."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cartographer_tpu.ops.rot_histogram import (
    compute_rotational_histogram as j_histogram,
    match_histograms as j_match,
    rotate_histogram as j_rotate,
)
from cartographer_tpu_torch.ops.rot_histogram import (
    compute_rotational_histogram,
    match_histograms,
    rotate_histogram,
)

torch.set_num_threads(1)


def _room(rng, n, height=2.4):
    """Points on the walls of a 7 x 5 m room, turned off the axes."""
    side = rng.randint(4, size=n)
    u = rng.uniform(-1, 1, n)
    x = np.where(side == 0, 3.5, np.where(side == 1, -3.5, 3.5 * u))
    y = np.where(side == 2, 2.5, np.where(side == 3, -2.5, np.where(side < 2, 2.5 * u, 0)))
    c, s = np.cos(0.4), np.sin(0.4)
    return np.stack([c * x - s * y, s * x + c * y, rng.uniform(0, height, n)],
                    -1).astype(np.float32)


def _both(pts, mask, size=120):
    ref = np.asarray(j_histogram(jnp.asarray(pts), jnp.asarray(mask), size))
    got = compute_rotational_histogram(torch.from_numpy(pts), torch.from_numpy(mask), size)
    return got.numpy(), ref


@pytest.mark.parametrize("n,size", [(512, 120), (300, 120), (256, 60)])
def test_histogram_matches_jax(n, size):
    rng = np.random.RandomState(n)
    pts = _room(rng, n)
    mask = rng.rand(n) < 0.9
    got, ref = _both(pts, mask, size)
    # 1e-5 per bin, and 1e-6 of a bin that holds tens of weights: JAX adds
    # them one by one, the port in a pairwise tree.
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-6)
    assert ref.sum() > 5.0 and got.shape == (size,)
    # Walls in two directions: the histogram has two peaks a quarter turn apart.
    peak = int(np.argmax(ref))
    assert ref[(peak + size // 2) % size] > 0.2 * ref[peak]


def test_empty_cloud_gives_zeros():
    pts = _room(np.random.RandomState(1), 64)
    got, ref = _both(pts, np.zeros(64, bool))
    np.testing.assert_array_equal(got, np.zeros(120, np.float32))
    np.testing.assert_array_equal(ref, got)


def test_one_slice_cloud():
    rng = np.random.RandomState(2)
    pts = _room(rng, 128, height=0.15)  # all within one 0.2 m slice
    got, ref = _both(pts, np.ones(128, bool))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert ref.sum() > 1.0


@pytest.mark.parametrize("angle", [0.0, 0.3, -1.1, 3.0, -7.5])
def test_rotate_matches_jax(angle):
    rng = np.random.RandomState(3)
    hist = rng.rand(120).astype(np.float32)
    ref = np.asarray(j_rotate(jnp.asarray(hist), jnp.float32(angle)))
    got = rotate_histogram(torch.from_numpy(hist), torch.tensor(angle, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.sum().item(), hist.sum(), rtol=1e-5)


def test_rotation_follows_the_cloud():
    """The histogram of a cloud turned about z is the histogram turned."""
    rng = np.random.RandomState(4)
    pts = _room(rng, 512)
    mask = np.ones(512, bool)
    yaw = 13 * np.pi / 120  # a whole number of bins: the peaks stay sharp
    c, s = np.cos(yaw), np.sin(yaw)
    turned = np.stack([c * pts[:, 0] - s * pts[:, 1], s * pts[:, 0] + c * pts[:, 1],
                       pts[:, 2]], -1).astype(np.float32)
    a = compute_rotational_histogram(torch.from_numpy(pts), torch.from_numpy(mask))
    b = compute_rotational_histogram(torch.from_numpy(turned), torch.from_numpy(mask))
    rotated = rotate_histogram(a, torch.tensor(yaw, dtype=torch.float32))
    cos = float((rotated * b).sum() / (rotated.norm() * b.norm()))
    assert cos > 0.9, cos


@pytest.mark.parametrize("count,span", [(107, 0.27), (1259, np.pi)])
def test_match_histograms_matches_jax(count, span):
    """The candidate yaws of a local search (107 within 15 degrees) and of a
    full-circle search (1259), around an initial yaw."""
    rng = np.random.RandomState(count)
    pts = _room(rng, 512)
    mask = np.ones(512, bool)
    scan = np.asarray(j_histogram(jnp.asarray(pts), jnp.asarray(mask), 120))
    c, s = np.cos(0.7), np.sin(0.7)
    turned = np.stack([c * pts[:, 0] - s * pts[:, 1], s * pts[:, 0] + c * pts[:, 1],
                       pts[:, 2]], -1).astype(np.float32)
    submap = np.asarray(j_histogram(jnp.asarray(turned), jnp.asarray(mask), 120))
    angles = (0.65 + np.linspace(-span, span, count)).astype(np.float32)
    ref = np.asarray(j_match(jnp.asarray(submap), jnp.asarray(scan), jnp.asarray(angles)))
    got = match_histograms(torch.from_numpy(submap), torch.from_numpy(scan),
                           torch.from_numpy(angles)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    if count == 107:  # the local window: the best yaw is the cloud's turn, up to a bin
        assert abs(angles[int(np.argmax(got))] - 0.7) < np.pi / 120 + 0.03
    zero = match_histograms(torch.zeros(120), torch.from_numpy(scan), torch.from_numpy(angles))
    assert torch.equal(zero, torch.zeros(count))
