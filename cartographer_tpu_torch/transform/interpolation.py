"""Pose interpolation on tensors: translation lerp, rotation slerp."""

from __future__ import annotations

import torch

from cartographer_tpu_torch.transform import quaternion as quat
from cartographer_tpu_torch.transform.rigid import Rigid3


def interpolate_rigid3(start: Rigid3, end: Rigid3, factor: torch.Tensor) -> Rigid3:
    """Interpolate between two poses with factor in [0, 1]."""
    t = start.translation + factor[..., None] * (end.translation - start.translation)
    q = quat.slerp(start.rotation, end.rotation, factor)
    return Rigid3(t, q)
