"""The SE(2) pose-graph residual of sparse pose adjustment (SPA).

Counterpart of the JAX package's `ops/spa.py` (l.45-57,
spa_cost_function_2d.cc): for a constraint with relative pose z between
poses a and b,

    e = [ (R(theta_a)^T (t_b - t_a) - z_t) * w_t ;  wrap(theta_b - theta_a - z_theta) * w_r ]

Batched over the constraint axis; `constraint_jacobians` is the analytic
form of `jax.jacfwd` of the residual (the wrap's floor carries no
derivative). `csrc/schur_spa_2d.cu` (K8) computes both in the same order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_PI = float(np.float32(math.pi))
_TWO_PI = float(np.float32(2.0 * math.pi))


def wrap_angle(a: torch.Tensor) -> torch.Tensor:
    """a - 2 pi floor((a + pi) / (2 pi)) in float32, into [-pi, pi)."""
    two_pi = torch.full((), _TWO_PI, dtype=a.dtype, device=a.device)
    return a - two_pi * torch.floor((a + _PI) / two_pi)


def constraint_residual(pa: torch.Tensor, pb: torch.Tensor, rel: torch.Tensor,
                        tw: torch.Tensor, rw: torch.Tensor) -> torch.Tensor:
    """(C, 3) weighted residuals of poses pa, pb (C, 3) against rel (C, 3)."""
    c, s = torch.cos(pa[:, 2]), torch.sin(pa[:, 2])
    dx, dy = pb[:, 0] - pa[:, 0], pb[:, 1] - pa[:, 1]
    e0 = (c * dx + s * dy - rel[:, 0]) * tw
    e1 = (-s * dx + c * dy - rel[:, 1]) * tw
    er = wrap_angle(pb[:, 2] - pa[:, 2] - rel[:, 2]) * rw
    return torch.stack([e0, e1, er], -1)


def constraint_jacobians(pa: torch.Tensor, pb: torch.Tensor, tw: torch.Tensor,
                         rw: torch.Tensor):
    """(Ja, Jb), each (C, 3, 3): d residual / d pa and d residual / d pb."""
    c, s = torch.cos(pa[:, 2]), torch.sin(pa[:, 2])
    dx, dy = pb[:, 0] - pa[:, 0], pb[:, 1] - pa[:, 1]
    z = torch.zeros_like(c)
    ja = torch.stack([
        torch.stack([-c * tw, -s * tw, (-s * dx + c * dy) * tw], -1),
        torch.stack([s * tw, -c * tw, (-c * dx - s * dy) * tw], -1),
        torch.stack([z, z, -rw], -1)], -2)
    jb = torch.stack([
        torch.stack([c * tw, s * tw, z], -1),
        torch.stack([-s * tw, c * tw, z], -1),
        torch.stack([z, z, rw], -1)], -2)
    return ja, jb
