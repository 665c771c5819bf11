"""Levenberg-Marquardt 3D scan refinement (CeresScanMatcher3D).

Counterpart of `gauss_newton_match_3d` in the JAX package's
`ops/scan_matcher_3d.py` (ceres_scan_matcher_3d.cc): residuals
w / sqrt(n) * (1 - P(T p)) with P the trilinear probability, for the
high-resolution cloud on the high-resolution grid and the low-resolution
cloud on the low one, a translation penalty toward the prediction and a
rotation penalty toward the initial rotation, minimized on the SE(3)
tangent [dt, so3] (or [dt, yaw] with `only_optimize_yaw`) with the update
t += dt, q = q * exp(so3).

The JAX package differentiates the residuals with jax.jacfwd; here the
Jacobian is written out: d world / d so3 = -R(q) [p]x for the rotation on
the right, and the inverse right Jacobian of SO(3) for the rotation penalty.

`gauss_newton_match_3d` launches the CUDA kernel `csrc/scan_matcher_3d.cu`
(K11), the whole solve in one launch, on CUDA tensors and runs the plain twin
(`residuals_and_jacobian_3d` + `gauss_newton.lm_solve`) on CPU tensors. The
intensity residual and the real-time correlative search of the JAX module
are not ported.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from cartographer_tpu_torch.core.tensor import true_div
from cartographer_tpu_torch.ops import cuda
from cartographer_tpu_torch.ops.gauss_newton import lm_solve
from cartographer_tpu_torch.ops.grid_3d import Grid3D
from cartographer_tpu_torch.ops.interp import trilinear_with_gradient
from cartographer_tpu_torch.transform import quaternion as quat
from cartographer_tpu_torch.transform.rigid import Rigid3

_FUNCTION_TOLERANCE = 1e-6  # Ceres Solver::Options default, as lm_solve

_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
_KERNEL = cuda.CudaKernel(
    "scan_matcher_3d.cu", "scan_matcher_3d",
    [_P, _P, _P, _F, _I, _P, _P, _I,  # high grid, high cloud
     _P, _P, _P, _F, _I, _P, _P, _I,  # low grid, low cloud
     _P, _P, _F, _F, _F, _F, _I, _I, _I, _F, _P, _P, _P])


@dataclasses.dataclass(frozen=True)
class GaussNewtonMatcherParams3D:
    occupied_space_weight_0: float = 1.0  # high resolution
    occupied_space_weight_1: float = 6.0  # low resolution
    intensity_weight: float = 0.0  # the intensity residual is not ported: must stay 0
    translation_weight: float = 5.0
    rotation_weight: float = 4e2
    only_optimize_yaw: bool = False
    num_iterations: int = 12
    use_nonmonotonic_steps: bool = False


def se3_retract(pose: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Boxplus on the pose vector [t (3), q (4)]: t += delta[0:3],
    q = normalize(q * exp(delta[3:6]))."""
    q = quat.normalize(quat.multiply(pose[3:7], quat.from_axis_angle(delta[3:6])))
    return torch.cat([pose[0:3] + delta[0:3], q])


def _occupied_residuals(grid: Grid3D, points, mask, pose: torch.Tensor, weight: float):
    """Residuals (M,) and their Jacobian (M, 6) on the tangent at `pose`."""
    t, q = pose[0:3], pose[3:7]
    world = quat.rotate(q, points) + t
    coords = grid.world_to_cell_continuous(world)
    p, dp = trilinear_with_gradient(grid.probability_at, grid.log_odds.shape, coords)
    n = torch.clamp(mask.to(torch.float32).sum(), min=1.0)
    scale = torch.full_like(n, weight) / torch.sqrt(n)
    r = torch.where(mask, scale * (1.0 - p), torch.zeros_like(p))
    g_world = -scale * true_div(dp, grid.resolution)  # d r / d world
    g_body = quat.rotate(quat.conjugate(q), g_world)
    jac = torch.cat([g_world, torch.linalg.cross(points, g_body)], dim=-1)
    return r, torch.where(mask[:, None], jac, torch.zeros_like(jac))


def _skew(v: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(v[0])
    return torch.stack([torch.stack([zero, -v[2], v[1]]),
                        torch.stack([v[2], zero, -v[0]]),
                        torch.stack([-v[1], v[0], zero])])


def so3_inverse_right_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """d log(exp(phi) exp(delta)) / d delta at delta = 0:
    I + [phi]x / 2 + c [phi]x^2, c = 1 / theta^2 - cot(theta / 2) / (2 theta)
    (1 / 12 below theta^2 = 1e-6)."""
    theta_sq = torch.sum(phi * phi)
    theta = torch.sqrt(theta_sq.clamp(min=1e-12))
    half = 0.5 * theta
    c = torch.where(theta_sq < 1e-6, torch.full_like(theta, 1.0 / 12.0),
                    1.0 / theta_sq.clamp(min=1e-12)
                    - torch.cos(half) / (2.0 * theta * torch.sin(half).clamp(min=1e-12)))
    k = _skew(phi)
    return torch.eye(3, dtype=phi.dtype, device=phi.device) + 0.5 * k + c * (k @ k)


def residuals_and_jacobian_3d(high_grid: Grid3D, low_grid: Grid3D, high_points, high_mask,
                              low_points, low_mask, pose: torch.Tensor,
                              target_translation: torch.Tensor,
                              target_rotation: torch.Tensor,
                              params: GaussNewtonMatcherParams3D):
    """All residuals (Nh + Nl + 6,) at the pose vector [t, q] and their
    Jacobian on the tangent: (R, 6), or (R, 4) = [dt, yaw] with
    `only_optimize_yaw`."""
    r_h, j_h = _occupied_residuals(high_grid, high_points, high_mask, pose,
                                   params.occupied_space_weight_0)
    r_l, j_l = _occupied_residuals(low_grid, low_points, low_mask, pose,
                                   params.occupied_space_weight_1)
    w_t, w_r = params.translation_weight, params.rotation_weight
    r_t = w_t * (pose[0:3] - target_translation)
    phi = quat.to_axis_angle(quat.multiply(quat.conjugate(target_rotation), pose[3:7]))
    r_r = w_r * phi
    eye, zero = torch.eye(3, device=pose.device), torch.zeros(3, 3, device=pose.device)
    j_t = torch.cat([w_t * eye, zero], dim=1)
    j_r = torch.cat([zero, w_r * so3_inverse_right_jacobian(phi)], dim=1)
    r = torch.cat([r_h, r_l, r_t, r_r])
    jac = torch.cat([j_h, j_l, j_t, j_r])
    if params.only_optimize_yaw:
        jac = torch.cat([jac[:, 0:3], jac[:, 5:6]], dim=1)
    return r, jac


def _match_plain(high_grid, low_grid, high_points, high_mask, low_points, low_mask, x0,
                 target_translation, params):
    target_rotation = x0[3:7]

    def residual_and_jacobian(x):
        return residuals_and_jacobian_3d(high_grid, low_grid, high_points, high_mask,
                                         low_points, low_mask, x, target_translation,
                                         target_rotation, params)

    if params.only_optimize_yaw:
        def retract(x, d):
            return se3_retract(x, torch.cat([d[0:3], torch.zeros_like(d[0:2]), d[3:4]]))
        tangent_dim = 4
    else:
        retract, tangent_dim = se3_retract, 6
    return lm_solve(residual_and_jacobian, x0, retract_fn=retract, tangent_dim=tangent_dim,
                    num_iterations=params.num_iterations,
                    function_tolerance=_FUNCTION_TOLERANCE,
                    nonmonotonic=params.use_nonmonotonic_steps)


def _check_grid(grid: Grid3D, name: str):
    s = grid.size
    cuda.check(grid.log_odds, f"{name} log_odds", torch.float32, (s, s, s))
    cuda.check(grid.known, f"{name} known", torch.bool, (s, s, s))
    cuda.check(grid.origin, f"{name} origin", torch.float32, (3,))
    return (grid.log_odds.data_ptr(), grid.known.data_ptr(), grid.origin.data_ptr(),
            float(grid.resolution), s)


def _match_kernel(high_grid, low_grid, high_points, high_mask, low_points, low_mask, x0,
                  target_translation, params):
    nh, nl = high_points.shape[0], low_points.shape[0]
    cuda.check(high_points, "high points", torch.float32, (nh, 3))
    cuda.check(high_mask, "high mask", torch.bool, (nh,))
    cuda.check(low_points, "low points", torch.float32, (nl, 3))
    cuda.check(low_mask, "low mask", torch.bool, (nl,))
    cuda.check(x0, "initial pose", torch.float32, (7,))
    cuda.check(target_translation, "target translation", torch.float32, (3,))
    device = x0.device
    x = torch.empty(7, dtype=torch.float32, device=device)
    cost = torch.empty((), dtype=torch.float32, device=device)
    iterations = torch.empty((), dtype=torch.int32, device=device)
    _KERNEL(device, *_check_grid(high_grid, "high grid"), high_points.data_ptr(),
            high_mask.data_ptr(), nh, *_check_grid(low_grid, "low grid"),
            low_points.data_ptr(), low_mask.data_ptr(), nl, x0.data_ptr(),
            target_translation.data_ptr(), float(params.occupied_space_weight_0),
            float(params.occupied_space_weight_1), float(params.translation_weight),
            float(params.rotation_weight), int(params.only_optimize_yaw),
            int(params.num_iterations), int(params.use_nonmonotonic_steps),
            _FUNCTION_TOLERANCE, x.data_ptr(), cost.data_ptr(), iterations.data_ptr())
    return x, cost, iterations


def lm_match_3d(high_grid: Grid3D, low_grid: Grid3D, high_points, high_mask, low_points,
                low_mask, x0: torch.Tensor, target_translation: torch.Tensor,
                params: GaussNewtonMatcherParams3D):
    """The solve on pose vectors [t, q]: -> (pose (7,), final cost, LM
    iterations)."""
    if params.intensity_weight > 0:
        raise NotImplementedError("the intensity residual of the 3D matcher is not ported")
    args = (high_grid, low_grid, high_points, high_mask, low_points, low_mask)
    if x0.is_cuda:
        return _match_kernel(*args, x0.contiguous(), target_translation.contiguous(), params)
    return _match_plain(*args, x0, target_translation, params)


def gauss_newton_match_3d(high_grid: Grid3D, low_grid: Grid3D, high_points, high_mask,
                          low_points, low_mask, initial_pose: Rigid3,
                          params: GaussNewtonMatcherParams3D,
                          target_translation: Optional[torch.Tensor] = None
                          ) -> Tuple[Rigid3, torch.Tensor]:
    """CeresScanMatcher3D::Match: refine `initial_pose` of the two clouds
    (scan frame) on the two grids. The translation penalty pulls toward
    `target_translation` (the prediction), the rotation penalty toward
    `initial_pose.rotation`. Returns (refined pose, final cost)."""
    if target_translation is None:
        target_translation = initial_pose.translation
    x0 = torch.cat([initial_pose.translation, initial_pose.rotation])
    x, cost, _ = lm_match_3d(high_grid, low_grid, high_points, high_mask, low_points,
                             low_mask, x0, target_translation, params)
    return Rigid3(x[0:3], x[3:7]), cost
