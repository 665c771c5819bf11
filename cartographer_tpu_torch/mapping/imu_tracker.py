"""Gravity-direction EMA filter + gyro integration [HOST].

Faithful equivalent of mapping::ImuTracker (cartographer/mapping/imu_tracker.cc):
keeps an orientation estimate by integrating angular velocity and correcting
with an exponential moving average of the measured gravity direction.
"""

from __future__ import annotations

import math

import numpy as np

from cartographer_tpu_torch.core.time import Time, to_seconds
from cartographer_tpu_torch.transform import nquat


class ImuTracker:
    def __init__(self, imu_gravity_time_constant: float, time: Time):
        self._tau = imu_gravity_time_constant
        self.time = time
        self._last_linear_acceleration_time: Time | None = None
        self.orientation = nquat.IDENTITY.copy()
        self.gravity_vector = np.array([0.0, 0.0, 1.0])
        self._imu_angular_velocity = np.zeros(3)

    def copy(self) -> "ImuTracker":
        t = ImuTracker(self._tau, self.time)
        t._last_linear_acceleration_time = self._last_linear_acceleration_time
        t.orientation = self.orientation.copy()
        t.gravity_vector = self.gravity_vector.copy()
        t._imu_angular_velocity = self._imu_angular_velocity.copy()
        return t

    def advance(self, time: Time) -> None:
        """Integrate angular velocity up to `time` (imu_tracker.cc:39-48)."""
        assert self.time <= time, (self.time, time)
        delta_t = to_seconds(time - self.time)
        rotation = nquat.from_axis_angle(self._imu_angular_velocity * delta_t)
        self.orientation = nquat.normalize(nquat.multiply(self.orientation, rotation))
        self.gravity_vector = nquat.rotate(nquat.conjugate(rotation), self.gravity_vector)
        self.time = time

    def add_imu_linear_acceleration_observation(self, linear_acceleration: np.ndarray) -> None:
        """EMA gravity update + orientation correction (imu_tracker.cc:50-69)."""
        delta_t = (
            to_seconds(self.time - self._last_linear_acceleration_time)
            if self._last_linear_acceleration_time is not None
            else math.inf
        )
        self._last_linear_acceleration_time = self.time
        alpha = 1.0 - math.exp(-delta_t / self._tau)
        self.gravity_vector = (1.0 - alpha) * self.gravity_vector + alpha * np.asarray(
            linear_acceleration, float)
        rotation = nquat.from_two_vectors(
            self.gravity_vector,
            nquat.rotate(nquat.conjugate(self.orientation), np.array([0.0, 0.0, 1.0])),
        )
        self.orientation = nquat.normalize(nquat.multiply(self.orientation, rotation))

    def add_imu_angular_velocity_observation(self, angular_velocity: np.ndarray) -> None:
        self._imu_angular_velocity = np.asarray(angular_velocity, float)
