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

    def compact(self, capacity: int) -> "PointCloud":
        """Pack valid points to the front (stable) and truncate to `capacity`.

        The argsort key is an integer copy of ~mask: not every backend sorts
        bool tensors.
        """
        order = torch.argsort((~self.mask).to(torch.int32), stable=True)[:capacity]
        return PointCloud(self.points[order], self.mask[order], self.intensities[order])


@dataclasses.dataclass(frozen=True)
class RangeData:
    """origin (D,) + returns/misses clouds (reference sensor::RangeData)."""

    origin: torch.Tensor
    returns: PointCloud
    misses: PointCloud

    def transform(self, pose) -> "RangeData":
        return RangeData(pose.apply(self.origin), self.returns.transform(pose),
                         self.misses.transform(pose))
