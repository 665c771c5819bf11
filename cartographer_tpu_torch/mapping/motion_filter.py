"""Pose similarity gate [HOST].

Reference: mapping/internal/motion_filter.{h,cc} — a pose is "similar" to the
last kept one (and therefore dropped before submap insertion) unless enough
time passed, it moved far enough, or rotated far enough.
"""

from __future__ import annotations

import numpy as np

from cartographer_tpu_torch.core.config import MotionFilterOptions
from cartographer_tpu_torch.core.time import Time, from_seconds
from cartographer_tpu_torch.transform import nquat


class MotionFilter:
    def __init__(self, options: MotionFilterOptions):
        self._options = options
        self._num_total = 0
        self._num_different = 0
        self._last_time: Time | None = None
        self._last_translation: np.ndarray | None = None
        self._last_rotation: np.ndarray | None = None

    def is_similar(self, time: Time, translation: np.ndarray, rotation: np.ndarray) -> bool:
        self._num_total += 1
        if self._last_time is not None:
            dt = time - self._last_time
            dist = float(np.linalg.norm(translation - self._last_translation))
            dq = nquat.multiply(nquat.conjugate(self._last_rotation), rotation)
            dangle = nquat.angle(dq)
            if (dt <= from_seconds(self._options.max_time_seconds)
                    and dist <= self._options.max_distance_meters
                    and dangle <= self._options.max_angle_radians):
                return True
        self._num_different += 1
        self._last_time = time
        self._last_translation = np.asarray(translation, float)
        self._last_rotation = np.asarray(rotation, float)
        return False

    @property
    def reduction(self) -> str:
        return f"{self._num_different}/{self._num_total}"
