"""Quaternion math on tensors, batched, (w, x, y, z) convention.

Counterpart of the JAX package's `transform/quaternion.py`; every op
broadcasts over leading dimensions.
"""

from __future__ import annotations

import torch


def normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., 0:1], -q[..., 1:4]], dim=-1)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by quaternions q (..., 4); broadcasts."""
    qw = q[..., 0:1]
    qv = q[..., 1:4].expand(v.shape)
    t = 2.0 * torch.linalg.cross(qv, v)
    return v + qw * t + torch.linalg.cross(qv, t)


def from_axis_angle(aa: torch.Tensor) -> torch.Tensor:
    """Exponential map: axis-angle vector (..., 3) -> quaternion (..., 4),
    with the Taylor branch below |aa|^2 = 1e-12."""
    angle_sq = torch.sum(aa * aa, dim=-1)
    angle = torch.sqrt(angle_sq.clamp(min=1e-32))
    half = 0.5 * angle
    small = angle_sq < 1e-12
    k = torch.where(small, 0.5 - angle_sq / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - angle_sq / 8.0, torch.cos(half))
    return torch.cat([w[..., None], k[..., None] * aa], dim=-1)


def to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """Log map: quaternion (..., 4) -> axis-angle vector (..., 3), angle in
    [0, pi] (q and -q give the same vector)."""
    q = torch.where(q[..., 0:1] < 0, -q, q)
    w = q[..., 0].clamp(-1.0, 1.0)
    v = q[..., 1:4]
    vnorm_sq = torch.sum(v * v, dim=-1)
    vnorm = torch.sqrt(vnorm_sq.clamp(min=1e-32))
    angle = 2.0 * torch.atan2(vnorm, w)
    small = vnorm_sq < 1e-12
    scale = torch.where(small, 2.0 / w.clamp(min=1e-12), angle / vnorm)
    return scale[..., None] * v


def get_yaw(q: torch.Tensor) -> torch.Tensor:
    """Yaw of the rotation: the direction of the rotated x axis projected
    onto the xy plane (transform::GetYaw)."""
    w, x, y, z = q.unbind(-1)
    return torch.atan2(2 * (x * y + w * z), 1 - 2 * (y * y + z * z))


def from_yaw(yaw: torch.Tensor) -> torch.Tensor:
    half = 0.5 * yaw
    zeros = torch.zeros_like(half)
    return torch.stack([torch.cos(half), zeros, zeros, torch.sin(half)], dim=-1)


def slerp(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation between quaternions along the shortest arc;
    linear when the two are nearly parallel (sin(theta) < 1e-6)."""
    dot = torch.sum(a * b, dim=-1, keepdim=True)
    b = torch.where(dot < 0, -b, b)
    dot = dot.abs()
    theta = torch.arccos(dot.clamp(-1.0, 1.0))
    sin_theta = torch.sin(theta)
    near = sin_theta < 1e-6
    t_ = t[..., None] if t.dim() < dot.dim() else t
    safe = torch.where(near, torch.ones_like(sin_theta), sin_theta)
    wa = torch.where(near, 1.0 - t_, torch.sin((1.0 - t_) * theta) / safe)
    wb = torch.where(near, t_, torch.sin(t_ * theta) / safe)
    return normalize(wa * a + wb * b)
