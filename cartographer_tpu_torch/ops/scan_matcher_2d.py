"""Levenberg-Marquardt 2D scan refinement (CeresScanMatcher2D).

Counterpart of the JAX package's `ops/scan_matcher_2d.py`
(ceres_scan_matcher_2d.cc with occupied_space_cost_function_2d.cc): one
residual w / sqrt(n) * (1 - P(T p)) per padded point, P the bicubic
probability of the grid, plus a translation penalty toward the prediction
and a rotation penalty toward the initial rotation, minimized over
(x, y, theta).

`gauss_newton_match_2d` launches the CUDA kernel `csrc/scan_matcher_2d.cu`
(K3), which runs the whole solve in one launch, on CUDA tensors and the
plain twin (`occupied_space_residuals_and_jacobian` + `gauss_newton.lm_solve`)
on CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from cartographer_tpu_torch.ops import cuda
from cartographer_tpu_torch.ops.gauss_newton import lm_solve
from cartographer_tpu_torch.ops.grid_2d import Grid2D
from cartographer_tpu_torch.ops.interp import bicubic_with_gradient
from cartographer_tpu_torch.ops.probability import UNKNOWN_PROBABILITY, log_odds_to_probability
from cartographer_tpu_torch.core.tensor import true_div
from cartographer_tpu_torch.transform.rigid import Rigid2

_FUNCTION_TOLERANCE = 1e-6  # Ceres Solver::Options default, as lm_solve

_KERNEL = cuda.CudaKernel(
    "scan_matcher_2d.cu", "scan_matcher_2d",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
     ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])


@dataclasses.dataclass(frozen=True)
class GaussNewtonMatcherParams2D:
    occupied_space_weight: float = 1.0
    translation_weight: float = 10.0
    rotation_weight: float = 40.0
    num_iterations: int = 20  # ceres_solver_options.max_num_iterations
    use_nonmonotonic_steps: bool = False


def occupied_space_residuals_and_jacobian(grid: Grid2D, points: torch.Tensor,
                                          mask: torch.Tensor, pose_vec: torch.Tensor,
                                          weight: float):
    """Residuals (M,) w / sqrt(n) * (1 - P(T p)) (0 where masked) and their
    Jacobian (M, 3) with respect to pose_vec = [x, y, theta]."""
    c, s = torch.cos(pose_vec[2]), torch.sin(pose_vec[2])
    x, y = points[..., 0], points[..., 1]
    rx = c * x - s * y
    ry = s * x + c * y
    world = torch.stack([rx, ry], dim=-1) + pose_vec[0:2]
    coords = grid.world_to_cell_continuous(world)

    def probability_at(ii, jj):
        return torch.where(grid.known[ii, jj], log_odds_to_probability(grid.log_odds[ii, jj]),
                           torch.full_like(grid.log_odds[ii, jj], UNKNOWN_PROBABILITY))

    p, dp = bicubic_with_gradient(probability_at, grid.log_odds.shape, coords)
    n = torch.clamp(mask.to(torch.float32).sum(), min=1.0)
    scale = torch.full_like(n, weight) / torch.sqrt(n)
    dp = true_div(dp, grid.resolution)  # d coords / d world = 1 / resolution
    jac = torch.stack([dp[..., 0], dp[..., 1], dp[..., 1] * rx - dp[..., 0] * ry], dim=-1)
    residuals = torch.where(mask, scale * (1.0 - p), torch.zeros_like(p))
    jac = torch.where(mask[:, None], -scale * jac, torch.zeros_like(jac))
    return residuals, jac


def _match_plain(grid, points, mask, x0, target_translation, params):
    target_rotation = x0[2]
    w_t, w_r = params.translation_weight, params.rotation_weight
    penalty_jac = torch.tensor([[w_t, 0.0, 0.0], [0.0, w_t, 0.0], [0.0, 0.0, w_r]],
                               dtype=torch.float32).to(x0.device, non_blocking=True)

    def residual_and_jacobian(x):
        r, jac = occupied_space_residuals_and_jacobian(
            grid, points, mask, x, params.occupied_space_weight)
        r_t = w_t * (x[0:2] - target_translation)
        r_r = w_r * (x[2:3] - target_rotation)
        return torch.cat([r, r_t, r_r]), torch.cat([jac, penalty_jac])

    return lm_solve(residual_and_jacobian, x0, num_iterations=params.num_iterations,
                    function_tolerance=_FUNCTION_TOLERANCE,
                    nonmonotonic=params.use_nonmonotonic_steps)


def _match_kernel(grid, points, mask, x0, target_translation, params):
    size = grid.size
    m = points.shape[0]
    cuda.check(grid.log_odds, "log_odds", torch.float32, (size, size))
    cuda.check(grid.known, "known", torch.bool, (size, size))
    cuda.check(grid.origin, "grid origin", torch.float32, (2,))
    cuda.check(points, "points", torch.float32, (m, 2))
    cuda.check(mask, "mask", torch.bool, (m,))
    cuda.check(x0, "initial pose", torch.float32, (3,))
    cuda.check(target_translation, "target translation", torch.float32, (2,))
    device = points.device
    x = torch.empty(3, dtype=torch.float32, device=device)
    cost = torch.empty((), dtype=torch.float32, device=device)
    iterations = torch.empty((), dtype=torch.int32, device=device)
    _KERNEL(device, grid.log_odds.data_ptr(), grid.known.data_ptr(),
            grid.origin.data_ptr(), float(grid.resolution), size, points.data_ptr(),
            mask.data_ptr(), m, x0.data_ptr(), target_translation.data_ptr(),
            float(params.occupied_space_weight), float(params.translation_weight),
            float(params.rotation_weight), int(params.num_iterations),
            int(params.use_nonmonotonic_steps), _FUNCTION_TOLERANCE, x.data_ptr(),
            cost.data_ptr(), iterations.data_ptr())
    return x, cost, iterations


def lm_match_2d(grid: Grid2D, points: torch.Tensor, mask: torch.Tensor, x0: torch.Tensor,
                target_translation: torch.Tensor, params: GaussNewtonMatcherParams2D):
    """The solve on pose vectors: -> (pose (3,), final cost, LM iterations)."""
    if points.is_cuda:
        return _match_kernel(grid, points, mask, x0.contiguous(),
                             target_translation.contiguous(), params)
    return _match_plain(grid, points, mask, x0, target_translation, params)


def gauss_newton_match_2d(grid: Grid2D, points: torch.Tensor, mask: torch.Tensor,
                          initial_pose: Rigid2, params: GaussNewtonMatcherParams2D,
                          target_translation: torch.Tensor = None
                          ) -> Tuple[Rigid2, torch.Tensor]:
    """Refine `initial_pose` of the scan (points in scan frame) on the grid.

    The translation penalty pulls toward `target_translation` (the
    prediction), the rotation penalty toward `initial_pose.rotation`
    (ceres_scan_matcher_2d.cc:63-107). Returns (refined_pose, final_cost).
    """
    if target_translation is None:
        target_translation = initial_pose.translation
    x, cost, _ = lm_match_2d(grid, points, mask, initial_pose.to_vector(),
                             target_translation, params)
    return Rigid2.from_vector(x), cost
