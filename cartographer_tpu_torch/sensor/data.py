"""Host-side typed sensor samples.

Reference equivalents: sensor/{imu_data,odometry_data,fixed_frame_pose_data,
landmark_data,timed_point_cloud_data}.h. These flow through the collator
queues on the host; numpy (not jnp) to keep per-sample handling cheap.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from cartographer_tpu_torch.core.time import Time


@dataclasses.dataclass
class ImuData:
    time: Time
    linear_acceleration: np.ndarray  # (3,) m/s^2
    angular_velocity: np.ndarray  # (3,) rad/s


@dataclasses.dataclass
class OdometryData:
    time: Time
    pose_translation: np.ndarray  # (3,)
    pose_rotation: np.ndarray  # (4,) quaternion (w, x, y, z)


@dataclasses.dataclass
class FixedFramePoseData:
    """GPS-like pose in a fixed frame; pose may be missing (invalid fix)."""

    time: Time
    pose_translation: Optional[np.ndarray]
    pose_rotation: Optional[np.ndarray]


@dataclasses.dataclass
class LandmarkObservation:
    id: str
    landmark_to_tracking_transform_translation: np.ndarray
    landmark_to_tracking_transform_rotation: np.ndarray
    translation_weight: float
    rotation_weight: float


@dataclasses.dataclass
class LandmarkData:
    time: Time
    landmark_observations: List[LandmarkObservation]


@dataclasses.dataclass
class TimedPointCloudData:
    """One raw scan: host container before padding to device capacity.

    Reference: sensor::TimedPointCloudData. `ranges` is (n, D) float32;
    `times` (n,) seconds relative to `time` (last point == 0, older points
    negative).
    """

    time: Time
    origin: np.ndarray  # (D,)
    ranges: np.ndarray  # (n, D)
    times: np.ndarray  # (n,)
    intensities: Optional[np.ndarray] = None  # (n,)
    # Per-point sensor origins (n, D) for merged multi-sensor batches
    # (reference: sensor::TimedPointCloudOriginData with per-point
    # origin_index, range_data_collator.h:42-44). None for single-sensor
    # batches, meaning every point shares `origin`. The TPU build resolves
    # origin_index into a dense gathered array so downstream kernels stay
    # index-free.
    origins: Optional[np.ndarray] = None

    def per_point_origins(self, dims: int = 3) -> np.ndarray:
        """Dense (n, dims) origins; broadcasts `origin` when `origins` is None."""
        n = self.ranges.shape[0]
        out = np.zeros((n, dims), np.float32)
        src = self.origins if self.origins is not None else self.origin[None, :]
        d = min(dims, src.shape[-1])
        out[:, :d] = src[..., :d]
        return out
