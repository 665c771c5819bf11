"""The port's ImuBasedPoseExtrapolator against the JAX package's: the twin
of tests/test_imu_based_extrapolator.py, and the two modules on the same
queue of poses, IMU and odometry samples, where they agree to the bit (the
port's forward-difference Jacobian recomputes only the residual blocks a
variable reaches, and the other rows of a forward difference are 0)."""

import numpy as np
import pytest

from cartographer_tpu.core.config import ImuBasedExtrapolatorOptions as JOptions
from cartographer_tpu.mapping.imu_based_pose_extrapolator import (
    ImuBasedPoseExtrapolator as JExtrapolator,
)
from cartographer_tpu.sensor.data import ImuData as JImuData, OdometryData as JOdometryData
from cartographer_tpu_torch.core.config import ImuBasedExtrapolatorOptions
from cartographer_tpu_torch.core.time import from_seconds
from cartographer_tpu_torch.mapping.imu_based_pose_extrapolator import ImuBasedPoseExtrapolator
from cartographer_tpu_torch.sensor.data import ImuData, OdometryData
from cartographer_tpu_torch.transform import nquat

G = 9.806


def _circle_state(t, radius=2.0, omega=0.5):
    """Ground truth on a circle at a constant angular rate (yaw only)."""
    pos = np.array([radius * np.cos(omega * t), radius * np.sin(omega * t), 0.0])
    q = nquat.from_yaw(omega * t + np.pi / 2)
    accel = nquat.rotate(nquat.conjugate(q), -omega * omega * pos + np.array([0.0, 0.0, G]))
    gyro = nquat.rotate(nquat.conjugate(q), np.array([0.0, 0.0, omega]))
    return pos, q, accel, gyro


def _build(duration_s=1.2, pose_hz=10, imu_hz=100):
    _, _, a0, w0 = _circle_state(0.001)
    t0, q0, _, _ = _circle_state(0.001)
    e = ImuBasedPoseExtrapolator.initialize_with_imu(
        ImuBasedExtrapolatorOptions(gravity_constant=G),
        [ImuData(time=from_seconds(0.0), linear_acceleration=a0, angular_velocity=w0)],
        initial_poses=[(from_seconds(0.001), t0, q0)])
    imu_times = [(i + 1) / imu_hz for i in range(int(duration_s * imu_hz))]
    pose_times = [(i + 1) / pose_hz for i in range(int(duration_s * pose_hz))]
    for t, kind in sorted([(t, "imu") for t in imu_times] + [(t, "pose") for t in pose_times]):
        pos, q, accel, gyro = _circle_state(t)
        if kind == "imu":
            e.add_imu_data(ImuData(time=from_seconds(t), linear_acceleration=accel,
                                   angular_velocity=gyro))
        else:
            e.add_pose(from_seconds(t), pos, q)
    return e, pose_times[-1]


def test_extrapolates_ahead_of_pose_queue():
    e, t_last = _build()
    trans, rot = e.extrapolate_pose(from_seconds(t_last + 0.1))
    gt_t, gt_q, _, _ = _circle_state(t_last + 0.1)
    assert np.linalg.norm(trans - gt_t) < 0.02, (trans, gt_t)
    assert abs(nquat.angle(nquat.multiply(nquat.conjugate(rot), gt_q))) < 0.02


def test_gravity_orientation_is_upright_for_planar_motion():
    e, t_last = _build()
    g_q = e.estimate_gravity_orientation(from_seconds(t_last + 0.05))
    assert np.dot(nquat.rotate(g_q, np.array([0.0, 0.0, 1.0])), [0.0, 0.0, 1.0]) > 0.999


def test_short_queue_returns_newest_pose():
    t0, q0, a0, w0 = _circle_state(0.0)
    e = ImuBasedPoseExtrapolator.initialize_with_imu(
        ImuBasedExtrapolatorOptions(gravity_constant=G),
        [ImuData(time=from_seconds(0.0), linear_acceleration=a0, angular_velocity=w0)],
        initial_poses=[(from_seconds(0.001), t0, q0)])
    trans, _ = e.extrapolate_pose(from_seconds(0.5))
    np.testing.assert_allclose(trans, t0)


def test_batched_times_are_monotone_interpolants():
    e, t_last = _build()
    poses, velocity, _ = e.extrapolate_poses_with_gravity(
        [from_seconds(t_last + dt) for dt in (0.02, 0.05, 0.08, 0.1)])
    assert len(poses) == 4
    assert abs(np.linalg.norm(velocity) - 1.0) < 0.1  # omega * r = 1 m/s
    assert all(np.linalg.norm(poses[i + 1][0] - poses[i][0]) > 0 for i in range(3))


def _drive(extrapolator_cls, options_cls, imu_cls, odometry_cls, duration, scans=12):
    """A noisy queue: IMU at 100 Hz, odometry at 5 Hz, and the scan matcher's
    pose at 10 Hz, each extrapolated to first. Returns every output."""
    e = extrapolator_cls.initialize_with_imu(
        options_cls(pose_queue_duration=duration),
        [imu_cls(0, np.array([0.1, 0.0, 9.8]), np.zeros(3))])
    out = []
    for i in range(1, scans + 1):
        rng = np.random.RandomState(i)
        for k in range(10):
            e.add_imu_data(imu_cls(from_seconds((i - 1) * 0.1 + (k + 1) * 0.01),
                                   np.array([0.3, 0.1, 9.8]) + 0.05 * rng.randn(3),
                                   np.array([0.01, -0.02, 0.3]) + 0.01 * rng.randn(3)))
        if i % 2 == 0:
            e.add_odometry_data(odometry_cls(from_seconds(i * 0.1 - 0.03),
                                             np.array([0.1 * i, 0.01 * i, 0.0]),
                                             nquat.from_yaw(0.03 * i)))
        t = from_seconds(i * 0.1)
        trans, rot = e.extrapolate_pose(t)
        gravity = e.estimate_gravity_orientation(t)
        poses, velocity, _ = e.extrapolate_poses_with_gravity([t - 30000, t])
        out.append(np.concatenate([trans, rot, gravity, velocity, poses[0][0], poses[0][1]]))
        e.add_pose(t, trans + 0.01 * rng.randn(3),
                   nquat.normalize(rot + 0.001 * rng.randn(4)))
    return np.asarray(out), e.get_last_pose_time()


@pytest.mark.parametrize("duration", [0.4, 0.7])
def test_matches_the_jax_extrapolator(duration):
    ref, ref_last = _drive(JExtrapolator, JOptions, JImuData, JOdometryData, duration)
    got, last = _drive(ImuBasedPoseExtrapolator, ImuBasedExtrapolatorOptions, ImuData,
                       OdometryData, duration)
    assert last == ref_last
    np.testing.assert_allclose(got, ref, atol=1e-9, rtol=0)
    assert np.abs(np.diff(got[:, 0])).max() > 0.01  # it moves
