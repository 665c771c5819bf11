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
from cartographer_tpu.transform import quaternion as jquat
from cartographer_tpu_torch.ops.rot_histogram import (
    compute_rotational_histogram,
    level_quaternion,
    match_histograms,
    rotate_histogram,
    scan_histograms,
    scan_histograms_plain,
)
from cartographer_tpu_torch.transform import quaternion as quat

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
    # 1e-5 per bin, and 1e-6 of a bin that holds tens of weights: both add
    # each slice's and each bin's members in input order; XLA's other float
    # operations leave differences in the last bits.
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


def _unit(q):
    q = np.asarray(q, np.float64)
    return (q / np.linalg.norm(q)).astype(np.float32)


@pytest.mark.parametrize("n,tilt,yaw", [(512, 0.02, 0.35), (300, 0.0, -1.2), (1024, 0.05, 2.9)])
def test_scan_histograms_against_jax(n, tilt, yaw):
    """The 3D step's histograms (`scan_histograms`: the cloud levelled by the
    gravity quaternion with its yaw taken out, its histogram, and that
    rotated by the matched yaw; on the CPU the twin) against the JAX
    functions step by step: the levelling quaternion within 1e-6 and the
    levelled cloud within 1e-5 m of JAX's quaternion functions, the
    histogram of that cloud within 1e-5 (rtol 1e-6) of JAX's, its rotation
    within 1e-5 of JAX's rotate_histogram."""
    rng = np.random.RandomState(n)
    pts = _room(rng, n)
    mask = rng.rand(n) < 0.9
    g = _unit([np.cos(0.4), tilt, -0.5 * tilt, np.sin(0.4)])
    q = _unit([np.cos(0.5 * yaw), 0.01, 0.0, np.sin(0.5 * yaw)])
    args = (torch.from_numpy(pts), torch.from_numpy(mask), torch.from_numpy(g),
            torch.from_numpy(q), 120)
    hist, rotated = scan_histograms(*args)
    twin = scan_histograms_plain(*args)
    assert torch.equal(hist, twin[0]) and torch.equal(rotated, twin[1])

    jg = jnp.asarray(g)
    jlevel = jquat.multiply(jquat.from_yaw(-jquat.get_yaw(jg)), jg)
    level = level_quaternion(torch.from_numpy(g))
    np.testing.assert_allclose(level.numpy(), np.asarray(jlevel), atol=1e-6, rtol=0)
    levelled = quat.rotate_expanded(level, torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(levelled, np.asarray(jquat.rotate(jlevel, jnp.asarray(pts))),
                               atol=1e-5, rtol=0)
    ref = np.asarray(j_histogram(jnp.asarray(levelled), jnp.asarray(mask), 120))
    np.testing.assert_allclose(hist.numpy(), ref, atol=1e-5, rtol=1e-6)
    assert ref.sum() > 5.0
    ref_rot = np.asarray(j_rotate(jnp.asarray(hist.numpy()), jquat.get_yaw(jnp.asarray(q))))
    np.testing.assert_allclose(rotated.numpy(), ref_rot, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["empty", "one_slice"])
def test_scan_histograms_edge_clouds_against_jax(case):
    """An empty cloud (zeros, rotated zeros) and a cloud within one 0.2 m
    slice, levelled by a yaw alone (levelling takes it out), against JAX."""
    rng = np.random.RandomState(5)
    pts = _room(rng, 256, height=0.15)
    mask = np.zeros(256, bool) if case == "empty" else np.ones(256, bool)
    g = _unit([np.cos(0.3), 0.0, 0.0, np.sin(0.3)])
    q = _unit([np.cos(0.2), 0.0, 0.0, np.sin(0.2)])
    hist, rotated = scan_histograms(torch.from_numpy(pts), torch.from_numpy(mask),
                                    torch.from_numpy(g), torch.from_numpy(q), 60)
    jg = jnp.asarray(g)
    jlevel = jquat.multiply(jquat.from_yaw(-jquat.get_yaw(jg)), jg)
    ref = np.asarray(j_histogram(jquat.rotate(jlevel, jnp.asarray(pts)), jnp.asarray(mask), 60))
    np.testing.assert_allclose(hist.numpy(), ref, atol=1e-5, rtol=0)
    ref_rot = np.asarray(j_rotate(jnp.asarray(ref), jquat.get_yaw(jnp.asarray(q))))
    np.testing.assert_allclose(rotated.numpy(), ref_rot, atol=1e-5, rtol=0)
    if case == "empty":
        assert not hist.any() and not rotated.any()
    else:
        assert ref.sum() > 1.0
