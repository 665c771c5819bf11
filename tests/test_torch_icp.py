"""The port's point-to-point ICP (plain twins of kernels K23 and K24) against
the JAX package's `ops/icp.py`, on the CPU.

The distance form |a|^2 + |b|^2 - 2 a.b is the reference's, so near-ties of
the argmin can go either way between XLA's matrix product and the twin's
elementwise sums: correspondences are compared only where the two best
distances differ by more than 1e-5 relative, poses within tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cartographer_tpu.ops.icp import (
    IcpParams as JIcpParams,
    _correspondences as j_correspondences,
    _pairwise_sq_dist as j_pairwise_sq_dist,
    _rotation_matrix_to_quat as j_rotation_matrix_to_quat,
    icp_match as j_icp_match,
)
from cartographer_tpu.transform import Rigid3 as JRigid3, quaternion as jquat
from cartographer_tpu_torch.ops import icp
from cartographer_tpu_torch.transform import quaternion as quat
from cartographer_tpu_torch.transform.rigid import Rigid3
from test_icp_ndt import perturbed_pair
from test_ops_3d import make_environment_3d

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _separated_rows(world, target, target_mask):
    """Source rows whose two best masked distances differ by > 1e-5 relative."""
    d2 = np.asarray(j_pairwise_sq_dist(jnp.asarray(world), jnp.asarray(target)), np.float64)
    d2 = np.where(target_mask[None, :], d2, np.inf)
    two = np.sort(d2, axis=1)[:, :2]
    return np.abs(two[:, 1] - two[:, 0]) > 1e-5 * np.maximum(np.abs(two[:, 0]), 1e-12)


@pytest.mark.parametrize("max_dist", [0.3, 1.0, 100.0])
def test_correspondences_match_jax(max_dist):
    """Nearest targets, masked targets skipped, the distance gate applied."""
    rng = np.random.RandomState(3)
    world = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
    target = rng.uniform(-5, 5, (500, 3)).astype(np.float32)
    src_mask = rng.rand(300) < 0.9
    tgt_mask = rng.rand(500) < 0.8
    jnn, jvalid = j_correspondences(jnp.asarray(world), jnp.asarray(src_mask),
                                    jnp.asarray(target), jnp.asarray(tgt_mask), max_dist)
    nn, valid = icp._correspondences(_t(world), _t(src_mask), _t(target), _t(tgt_mask),
                                     max_dist)
    assert nn.dtype == torch.int32
    rows = _separated_rows(world, target, tgt_mask)
    assert rows.mean() > 0.95
    np.testing.assert_array_equal(nn.numpy()[rows], np.asarray(jnn)[rows])
    assert tgt_mask[nn.numpy()].all()
    np.testing.assert_array_equal(valid.numpy()[rows], np.asarray(jvalid)[rows])
    assert 0 < valid.sum() <= src_mask.sum()


def test_correspondences_all_targets_masked():
    rng = np.random.RandomState(4)
    world = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    target = rng.uniform(-1, 1, (60, 3)).astype(np.float32)
    nn, valid = icp._correspondences(_t(world), torch.ones(50, dtype=torch.bool), _t(target),
                                     torch.zeros(60, dtype=torch.bool), 1.0)
    jnn, jvalid = j_correspondences(jnp.asarray(world), jnp.ones(50, bool),
                                    jnp.asarray(target), jnp.zeros(60, bool), 1.0)
    np.testing.assert_array_equal(nn.numpy(), np.asarray(jnn))
    assert not valid.any() and not np.asarray(jvalid).any()


def test_pairwise_sq_dist_matches_jax():
    rng = np.random.RandomState(5)
    a = rng.uniform(-30, 30, (64, 3)).astype(np.float32)
    b = rng.uniform(-30, 30, (80, 3)).astype(np.float32)
    np.testing.assert_allclose(icp._pairwise_sq_dist(_t(a), _t(b)).numpy(),
                               np.asarray(j_pairwise_sq_dist(jnp.asarray(a), jnp.asarray(b))),
                               atol=2e-3, rtol=1e-5)


def _planar(n, seed):
    """A cloud on one tilted plane: its cross-covariance has rank 2."""
    rng = np.random.RandomState(seed)
    uv = rng.uniform(-4, 4, (n, 2))
    e1, e2 = np.array([0.9, 0.1, 0.2]), np.array([-0.1, 0.8, 0.3])
    return (uv[:, :1] * e1 + uv[:, 1:] * e2 + np.array([0.2, -0.1, 1.3])).astype(np.float32)


def _pair(kind):
    """(source, source mask, target, target mask, true pose (t, q)) in numpy."""
    if kind == "room":
        src, sm, tgt, tm, true = perturbed_pair()
        return (np.asarray(src), np.asarray(sm), np.asarray(tgt), np.asarray(tm),
                np.asarray(true.translation), np.asarray(true.rotation))
    if kind == "identity":
        pts = make_environment_3d(num=300, seed=1)
        m = np.ones(300, bool)
        return pts, m, pts, m, np.zeros(3, np.float32), np.float32([1, 0, 0, 0])
    # planar: the target on a plane, the source moved off it by a small pose
    tgt = _planar(400, 6)
    true = JRigid3(jnp.asarray([0.05, -0.03, 0.02], jnp.float32),
                   jquat.from_axis_angle(jnp.asarray([0.0, 0.0, 0.03], jnp.float32)))
    src = np.asarray(true.inverse().apply(jnp.asarray(tgt)))
    m = np.ones(400, bool)
    return src, m, tgt, m, np.asarray(true.translation), np.asarray(true.rotation)


@pytest.mark.parametrize("kind", ["room", "planar"])
def test_one_round_matches_jax(kind):
    """One Kabsch round from the same start: the JAX icp_match with one
    iteration against the twin's K23 + K24 (general and rank-2 clouds)."""
    src, sm, tgt, tm, _, _ = _pair(kind)
    jpose, _, _ = j_icp_match(jnp.asarray(src), jnp.asarray(sm), jnp.asarray(tgt),
                              jnp.asarray(tm), JRigid3.identity(),
                              JIcpParams(max_iterations=1))
    x0 = torch.tensor([0, 0, 0, 1, 0, 0, 0], dtype=torch.float32)
    nn, world, valid = icp.nearest(_t(src), _t(sm), _t(tgt), _t(tm), x0, 1.0)
    pose, R, t = icp.kabsch(world, _t(tgt), nn, valid, x0)
    np.testing.assert_allclose(pose[0:3].numpy(), np.asarray(jpose.translation), atol=1e-5)
    np.testing.assert_allclose(pose[3:7].numpy(), np.asarray(jpose.rotation), atol=1e-5)
    np.testing.assert_allclose((R @ R.T).numpy(), np.eye(3), atol=1e-5)
    assert float(torch.linalg.det(R)) == pytest.approx(1.0, abs=1e-5)


@pytest.mark.parametrize("kind", ["room", "planar", "identity"])
def test_icp_match_matches_jax(kind):
    """The whole icp_match (30 rounds): pose within 1e-4 m and 1e-4 rad of
    the JAX result, fitness and RMSE within 1e-5."""
    src, sm, tgt, tm, true_t, true_q = _pair(kind)
    jpose, jfit, jrmse = j_icp_match(jnp.asarray(src), jnp.asarray(sm), jnp.asarray(tgt),
                                     jnp.asarray(tm), JRigid3.identity(), JIcpParams())
    identity = Rigid3(torch.zeros(3), torch.tensor([1.0, 0.0, 0.0, 0.0]))
    pose, fit, rmse = icp.icp_match(_t(src), _t(sm), _t(tgt), _t(tm), identity,
                                    icp.IcpParams())
    np.testing.assert_allclose(pose.translation.numpy(), np.asarray(jpose.translation),
                               atol=1e-4)
    dq = quat.multiply(quat.conjugate(_t(np.asarray(jpose.rotation))), pose.rotation)
    assert float(quat.to_axis_angle(dq).norm()) < 1e-4
    assert abs(float(fit) - float(jfit)) < 1e-5 and abs(float(rmse) - float(jrmse)) < 1e-5
    if kind != "planar":  # a plane slides along itself: only the JAX result binds there
        np.testing.assert_allclose(pose.translation.numpy(), true_t, atol=0.08)


@pytest.mark.parametrize("case", range(4))
def test_rotation_matrix_to_quat_four_cases(case):
    """Each of the four candidates (w, x, y or z largest) against JAX."""
    axis = np.eye(3)[case - 1] if case else np.float32([0.3, -0.2, 0.5])
    angle = 0.4 if case == 0 else 2.9
    aa = jnp.asarray(axis / np.linalg.norm(axis) * angle, jnp.float32)
    R = np.asarray(jquat.to_matrix(jquat.from_axis_angle(aa)), np.float32)
    ref = np.asarray(j_rotation_matrix_to_quat(jnp.asarray(R)))
    got = icp._rotation_matrix_to_quat(_t(R)).numpy()
    assert np.argmax(np.abs(got)) == case
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_masked_source_points_do_not_count():
    src, sm, tgt, tm, _, _ = _pair("room")
    sm = sm.copy()
    sm[::3] = False
    jpose, jfit, jrmse = j_icp_match(jnp.asarray(src), jnp.asarray(sm), jnp.asarray(tgt),
                                     jnp.asarray(tm), JRigid3.identity(),
                                     JIcpParams(max_iterations=10))
    pose, fit, rmse = icp.icp_match(_t(src), _t(sm), _t(tgt), _t(tm),
                                    Rigid3(torch.zeros(3), torch.tensor([1.0, 0, 0, 0])),
                                    icp.IcpParams(max_iterations=10))
    np.testing.assert_allclose(pose.translation.numpy(), np.asarray(jpose.translation),
                               atol=1e-4)
    assert abs(float(fit) - float(jfit)) < 1e-5 and abs(float(rmse) - float(jrmse)) < 1e-5
