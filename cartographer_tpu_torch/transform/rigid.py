"""Rigid2 / Rigid3: batched SE(2)/SE(3) transforms as dataclasses of tensors.

Counterpart of the JAX package's `transform/rigid.py`
(cartographer/transform/rigid_transform.h). Fields with leading batch
dimensions represent a batch of transforms.
"""

from __future__ import annotations

import dataclasses

import torch

from cartographer_tpu_torch.transform import quaternion as quat


@dataclasses.dataclass(frozen=True)
class Rigid2:
    """SE(2): translation (..., 2) and rotation angle (...,) in radians."""

    translation: torch.Tensor
    rotation: torch.Tensor

    @staticmethod
    def from_vector(v: torch.Tensor) -> "Rigid2":
        """(..., 3) [x, y, theta] -> Rigid2."""
        return Rigid2(v[..., 0:2], v[..., 2])

    def to_vector(self) -> torch.Tensor:
        return torch.cat([self.translation, self.rotation[..., None]], dim=-1)

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        """Transform points (..., N, 2) (or (..., 2)) by this transform."""
        c, s = torch.cos(self.rotation), torch.sin(self.rotation)
        x, y = points[..., 0], points[..., 1]
        if points.dim() > self.rotation.dim() + 1:
            c, s = c[..., None], s[..., None]
            t = self.translation[..., None, :]
        else:
            t = self.translation
        return torch.stack([c * x - s * y, s * x + c * y], dim=-1) + t

    def compose(self, other: "Rigid2") -> "Rigid2":
        """self * other (apply other first, then self)."""
        return Rigid2(self.apply(other.translation), self.rotation + other.rotation)

    def inverse(self) -> "Rigid2":
        inv_rot = -self.rotation
        c, s = torch.cos(inv_rot), torch.sin(inv_rot)
        tx, ty = -self.translation[..., 0], -self.translation[..., 1]
        return Rigid2(torch.stack([c * tx - s * ty, s * tx + c * ty], dim=-1), inv_rot)


@dataclasses.dataclass(frozen=True)
class Rigid3:
    """SE(3): translation (..., 3) and rotation quaternion (..., 4) (w,x,y,z)."""

    translation: torch.Tensor
    rotation: torch.Tensor

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        """Transform points (..., N, 3) (or (..., 3)) by this transform."""
        if points.dim() > self.translation.dim():
            q = self.rotation[..., None, :]
            t = self.translation[..., None, :]
        else:
            q, t = self.rotation, self.translation
        return quat.rotate(q, points) + t

    def compose(self, other: "Rigid3") -> "Rigid3":
        return Rigid3(
            self.apply(other.translation),
            quat.normalize(quat.multiply(self.rotation, other.rotation)),
        )

    def inverse(self) -> "Rigid3":
        inv_q = quat.conjugate(self.rotation)
        return Rigid3(quat.rotate(inv_q, -self.translation), inv_q)
