"""Padded, masked point clouds of tensors.

Counterpart of the JAX package's `sensor/point_cloud.py`: every cloud has a
static capacity N and a validity mask, so the tests feed both packages the
same padded arrays.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PointCloud:
    """Fixed-capacity point cloud: points (N, D), mask (N,), intensities (N,).

    Padded entries have mask == False and finite (zero) coordinates.
    """

    points: torch.Tensor
    mask: torch.Tensor
    intensities: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def transform(self, pose) -> "PointCloud":
        """Apply a Rigid2 (D=2) or Rigid3 (D=3) to all points."""
        return dataclasses.replace(self, points=pose.apply(self.points))

    def filter_mask(self, keep: torch.Tensor) -> "PointCloud":
        return dataclasses.replace(self, mask=self.mask & keep)

    def robot(self, r: int) -> "PointCloud":
        """Cloud r of a batch with a leading robot dimension (views)."""
        return PointCloud(self.points[r], self.mask[r], self.intensities[r])

    def compact(self, capacity: int) -> "PointCloud":
        """Pack valid points to the front (stable) and truncate to `capacity`,
        along the point axis (every leading axis is a batch of clouds).

        The argsort key is an integer copy of ~mask: not every backend sorts
        bool tensors.
        """
        order = torch.argsort((~self.mask).to(torch.int32), dim=-1, stable=True)
        order = order[..., :capacity]
        return PointCloud(torch.take_along_dim(self.points, order[..., None], dim=-2),
                          torch.take_along_dim(self.mask, order, dim=-1),
                          torch.take_along_dim(self.intensities, order, dim=-1))


@dataclasses.dataclass(frozen=True)
class RangeData:
    """origin (D,) + returns/misses clouds (reference sensor::RangeData)."""

    origin: torch.Tensor
    returns: PointCloud
    misses: PointCloud

    def transform(self, pose) -> "RangeData":
        return RangeData(pose.apply(self.origin), self.returns.transform(pose),
                         self.misses.transform(pose))

    def robot(self, r: int) -> "RangeData":
        """Robot r's range data of a batch with a leading robot dimension
        (views of the batch's tensors)."""
        return RangeData(self.origin[r], self.returns.robot(r), self.misses.robot(r))
