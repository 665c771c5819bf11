"""Constant-velocity pose extrapolation with IMU/odometry fusion [HOST].

Faithful equivalent of mapping::PoseExtrapolator
(cartographer/mapping/pose_extrapolator.cc): a short pose queue estimates
linear/angular velocity; IMU (via ImuTracker) provides orientation; odometry
overrides velocities when available. Used to predict the pose at scan time
and to unwarp points. Host numpy (double), mirroring the reference's
sequential per-sample updates; the batched per-point unwarp happens on device
from the two poses this class returns.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np

from cartographer_tpu_torch.core.time import Duration, Time, to_seconds
from cartographer_tpu_torch.sensor.data import ImuData, OdometryData
from cartographer_tpu_torch.transform import nquat


@dataclasses.dataclass
class TimedPose:
    time: Time
    translation: np.ndarray  # (3,)
    rotation: np.ndarray  # (4,) quaternion


class PoseExtrapolator:
    def __init__(self, pose_queue_duration: Duration, imu_gravity_time_constant: float):
        self._pose_queue_duration = pose_queue_duration
        self._gravity_time_constant = imu_gravity_time_constant
        self._timed_pose_queue: Deque[TimedPose] = deque()
        self._imu_data: Deque[ImuData] = deque()
        self._odometry_data: Deque[OdometryData] = deque()
        self._imu_tracker = None
        self._odometry_imu_tracker = None
        self._extrapolation_imu_tracker = None
        self._linear_velocity_from_poses = np.zeros(3)
        self._angular_velocity_from_poses = np.zeros(3)
        self._linear_velocity_from_odometry = np.zeros(3)
        self._angular_velocity_from_odometry = np.zeros(3)

    # -- Construction helpers (pose_extrapolator.cc:35-53) -------------------

    @staticmethod
    def initialize_with_imu(pose_queue_duration: Duration,
                            imu_gravity_time_constant: float,
                            imu_data: ImuData) -> "PoseExtrapolator":
        e = PoseExtrapolator(pose_queue_duration, imu_gravity_time_constant)
        e.add_imu_data(imu_data)
        tracker = e._make_imu_tracker(imu_data.time)
        tracker.add_imu_linear_acceleration_observation(imu_data.linear_acceleration)
        tracker.add_imu_angular_velocity_observation(imu_data.angular_velocity)
        tracker.advance(imu_data.time)
        e._imu_tracker = tracker
        e.add_pose(imu_data.time,
                   np.zeros(3), tracker.orientation.copy())
        return e

    def _make_imu_tracker(self, time: Time):
        from cartographer_tpu_torch.mapping.imu_tracker import ImuTracker
        return ImuTracker(self._gravity_time_constant, time)

    # -- Queries --------------------------------------------------------------

    def get_last_pose_time(self) -> Optional[Time]:
        return self._timed_pose_queue[-1].time if self._timed_pose_queue else None

    def get_last_extrapolated_time(self) -> Optional[Time]:
        return self._extrapolation_imu_tracker.time if self._extrapolation_imu_tracker else None

    # -- Updates (pose_extrapolator.cc:69-142) --------------------------------

    def add_pose(self, time: Time, translation: np.ndarray, rotation: np.ndarray) -> None:
        if self._imu_tracker is None:
            tracker_start = time
            if self._imu_data:
                tracker_start = min(tracker_start, self._imu_data[0].time)
            self._imu_tracker = self._make_imu_tracker(tracker_start)
        self._timed_pose_queue.append(
            TimedPose(time, np.asarray(translation, float), np.asarray(rotation, float)))
        while (len(self._timed_pose_queue) > 2
               and self._timed_pose_queue[1].time <= time - self._pose_queue_duration):
            self._timed_pose_queue.popleft()
        self._update_velocities_from_poses()
        self._advance_imu_tracker(time, self._imu_tracker)
        self._trim_imu_data()
        self._trim_odometry_data()
        self._odometry_imu_tracker = self._imu_tracker.copy()
        self._extrapolation_imu_tracker = self._imu_tracker.copy()

    def add_imu_data(self, imu_data: ImuData) -> None:
        assert not self._timed_pose_queue or imu_data.time >= self._timed_pose_queue[-1].time
        self._imu_data.append(imu_data)
        self._trim_imu_data()

    def add_odometry_data(self, odometry_data: OdometryData) -> None:
        assert not self._timed_pose_queue or odometry_data.time >= self._timed_pose_queue[-1].time
        self._odometry_data.append(odometry_data)
        self._trim_odometry_data()
        if len(self._odometry_data) < 2:
            return
        oldest = self._odometry_data[0]
        newest = self._odometry_data[-1]
        odometry_time_delta = to_seconds(oldest.time - newest.time)  # negative
        # newest.pose^-1 * oldest.pose
        inv_rot = nquat.conjugate(newest.pose_rotation)
        delta_rot = nquat.multiply(inv_rot, oldest.pose_rotation)
        delta_trans = nquat.rotate(inv_rot, oldest.pose_translation - newest.pose_translation)
        self._angular_velocity_from_odometry = (
            nquat.to_axis_angle(delta_rot) / odometry_time_delta)
        if not self._timed_pose_queue:
            return
        linear_velocity_in_tracking_frame = delta_trans / odometry_time_delta
        orientation_at_newest_odometry_time = nquat.multiply(
            self._timed_pose_queue[-1].rotation,
            self._extrapolate_rotation(newest.time, self._odometry_imu_tracker))
        self._linear_velocity_from_odometry = nquat.rotate(
            orientation_at_newest_odometry_time, linear_velocity_in_tracking_frame)

    # -- Extrapolation (pose_extrapolator.cc:144-178, 226-258) ---------------

    def extrapolate_pose(self, time: Time) -> Tuple[np.ndarray, np.ndarray]:
        newest = self._timed_pose_queue[-1]
        assert time >= newest.time, (time, newest.time)
        translation = self._extrapolate_translation(time) + newest.translation
        rotation = nquat.multiply(
            newest.rotation,
            self._extrapolate_rotation(time, self._extrapolation_imu_tracker))
        return translation, rotation

    def estimate_gravity_orientation(self, time: Time) -> np.ndarray:
        tracker = self._imu_tracker.copy()
        self._advance_imu_tracker(time, tracker)
        return tracker.orientation

    def extrapolate_poses_with_gravity(self, times: List[Time]):
        """Batched variant used by the 3D frontend
        (local_trajectory_builder_3d.cc:622-627): poses at every time, current
        velocity, and gravity orientation at the last time."""
        poses = [self.extrapolate_pose(t) for t in times]
        current_velocity = (
            self._linear_velocity_from_odometry
            if len(self._odometry_data) >= 2 else self._linear_velocity_from_poses)
        return poses, current_velocity, self.estimate_gravity_orientation(times[-1])

    # -- Internals ------------------------------------------------------------

    def _update_velocities_from_poses(self) -> None:
        if len(self._timed_pose_queue) < 2:
            return
        newest = self._timed_pose_queue[-1]
        oldest = self._timed_pose_queue[0]
        queue_delta = to_seconds(newest.time - oldest.time)
        if queue_delta < to_seconds(self._pose_queue_duration):
            return
        self._linear_velocity_from_poses = (
            newest.translation - oldest.translation) / queue_delta
        self._angular_velocity_from_poses = (
            nquat.to_axis_angle(
                nquat.multiply(nquat.conjugate(oldest.rotation), newest.rotation))
            / queue_delta)

    def _trim_imu_data(self) -> None:
        while (len(self._imu_data) > 1 and self._timed_pose_queue
               and self._imu_data[1].time <= self._timed_pose_queue[-1].time):
            self._imu_data.popleft()

    def _trim_odometry_data(self) -> None:
        while (len(self._odometry_data) > 2 and self._timed_pose_queue
               and self._odometry_data[1].time <= self._timed_pose_queue[-1].time):
            self._odometry_data.popleft()

    def _advance_imu_tracker(self, time: Time, imu_tracker) -> None:
        assert time >= imu_tracker.time
        if not self._imu_data or time < self._imu_data[0].time:
            # No IMU data: integrate pose/odometry angular velocity and fake
            # gravity for 2D stability (pose_extrapolator.cc:206-217).
            imu_tracker.advance(time)
            imu_tracker.add_imu_linear_acceleration_observation(np.array([0.0, 0.0, 1.0]))
            imu_tracker.add_imu_angular_velocity_observation(
                self._angular_velocity_from_poses
                if len(self._odometry_data) < 2 else self._angular_velocity_from_odometry)
            return
        if imu_tracker.time < self._imu_data[0].time:
            imu_tracker.advance(self._imu_data[0].time)
        for sample in self._imu_data:
            if sample.time < imu_tracker.time:
                continue
            if sample.time >= time:
                break
            imu_tracker.advance(sample.time)
            imu_tracker.add_imu_linear_acceleration_observation(sample.linear_acceleration)
            imu_tracker.add_imu_angular_velocity_observation(sample.angular_velocity)
        imu_tracker.advance(time)

    def _extrapolate_rotation(self, time: Time, imu_tracker) -> np.ndarray:
        assert time >= imu_tracker.time
        self._advance_imu_tracker(time, imu_tracker)
        return nquat.multiply(
            nquat.conjugate(self._imu_tracker.orientation), imu_tracker.orientation)

    def _extrapolate_translation(self, time: Time) -> np.ndarray:
        newest = self._timed_pose_queue[-1]
        extrapolation_delta = to_seconds(time - newest.time)
        if len(self._odometry_data) < 2:
            return extrapolation_delta * self._linear_velocity_from_poses
        return extrapolation_delta * self._linear_velocity_from_odometry
