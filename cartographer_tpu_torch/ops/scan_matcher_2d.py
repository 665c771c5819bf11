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
on CPU tensors. On a `TsdfGrid2D` both read its score surface in place of
the probability (K3's TSDF form, `scan_matcher_2d_tsdf`), as the JAX
matcher does through `grid.probability()`; the loop-closure refine runs
there. The TSDF frontend's own matcher is `tsdf_2d.lm_match_tsdf_2d` (K22).

With a leading robot dimension (R, M, 2) on the points, a sequence of R
grids and a row per robot of every other tensor (the cross-robot batched
step), the kernel solves every robot in one launch, one block per robot,
each with its own early exit; one solve is the R = 1 case. The plain twin
solves robot by robot.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from cartographer_tpu_torch.core.tensor import f32, true_div
from cartographer_tpu_torch.ops import cuda
from cartographer_tpu_torch.ops.gauss_newton import lm_solve
from cartographer_tpu_torch.ops.grid_2d import Grid2D
from cartographer_tpu_torch.ops.interp import bicubic_with_gradient
from cartographer_tpu_torch.transform.rigid import Rigid2

_FUNCTION_TOLERANCE = 1e-6  # Ceres Solver::Options default, as lm_solve

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The arguments after the kernel's own surface scalars (none, or one).
LM_ARGS = [_F, _I, _P, _P, _I, _P, _P, _P, _F, _F, _F, _I, _I, _F, _P, _P, _P]
# One kernel per surface form (Grid2D.SURFACE, TsdfGrid2D.SURFACE).
_KERNELS = {
    "occupancy": cuda.CudaKernel("scan_matcher_2d.cu", "scan_matcher_2d", [_P, _I] + LM_ARGS),
    "tsdf": cuda.CudaKernel("scan_matcher_2d.cu", "scan_matcher_2d_tsdf",
                            [_P, _I, _F] + LM_ARGS)}


@dataclasses.dataclass(frozen=True)
class GaussNewtonMatcherParams2D:
    occupied_space_weight: float = 1.0
    translation_weight: float = 10.0
    rotation_weight: float = 40.0
    num_iterations: int = 20  # ceres_solver_options.max_num_iterations
    use_nonmonotonic_steps: bool = False


def occupied_space_residuals_and_jacobian(grid, points: torch.Tensor,
                                          mask: torch.Tensor, pose_vec: torch.Tensor,
                                          weight: float):
    """Residuals (M,) w / sqrt(n) * (1 - P(T p)) (0 where masked) and their
    Jacobian (M, 3) with respect to pose_vec = [x, y, theta]; P is the
    probability of a Grid2D or the score surface of a TsdfGrid2D."""
    c, s = torch.cos(pose_vec[2]), torch.sin(pose_vec[2])
    x, y = points[..., 0], points[..., 1]
    rx = c * x - s * y
    ry = s * x + c * y
    world = torch.stack([rx, ry], dim=-1) + pose_vec[0:2]
    coords = grid.world_to_cell_continuous(world)
    p, dp = bicubic_with_gradient(grid.score_at, (grid.size, grid.size), coords)
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


def launch_lm(kernel, scalars, grids, points, mask, x0, target_translation, params,
              nonmonotonic: bool):
    """One launch of a K3-template solve (K3, its TSDF form, K22): `grids`
    one grid per robot, `points` (M, 2) for one robot or (R, M, 2), `mask`,
    `x0` (3,) and `target_translation` (2,) with the same leading R,
    `scalars` the kernel's surface scalars; -> (poses, costs, LM
    iterations) with that leading R."""
    robots = points.shape[0] if points.dim() == 3 else None
    m = points.shape[-2]
    size, res = cuda.robot_grids(grids, robots or 1)
    table = cuda.pointer_table([g.surface_row() for g in grids])
    strides = np.array([
        cuda.robot_stride(points, "points", torch.float32, (m, 2), robots),
        cuda.robot_stride(mask, "mask", torch.bool, (m,), robots),
        cuda.robot_stride(x0, "initial pose", torch.float32, (3,), robots),
        cuda.robot_stride(target_translation, "target translation", torch.float32, (2,),
                          robots)], np.int64)
    device, lead = points.device, (() if robots is None else (robots,))
    x = torch.empty((*lead, 3), dtype=torch.float32, device=device)
    cost = torch.empty(lead, dtype=torch.float32, device=device)
    iterations = torch.empty(lead, dtype=torch.int32, device=device)
    kernel(device, table, robots or 1, *scalars, float(res), size, points.data_ptr(),
           mask.data_ptr(), m, x0.data_ptr(), target_translation.data_ptr(),
           strides.ctypes.data, float(params.occupied_space_weight),
           float(params.translation_weight), float(params.rotation_weight),
           int(params.num_iterations), int(nonmonotonic), _FUNCTION_TOLERANCE, x.data_ptr(),
           cost.data_ptr(), iterations.data_ptr())
    return x, cost, iterations


def per_robot(launch, plain, grid, points, mask, x0, target_translation, params):
    """A solve on pose vectors for one robot ((M, 2) points, one grid) or R
    ((R, M, 2) points, R grids, a leading R on the rest): `launch(grids,
    ...)` on CUDA tensors, `plain(grid, ...)` robot by robot on CPU
    tensors."""
    if points.is_cuda:
        if points.dim() == 2:
            return launch([grid], points, mask, x0.contiguous(),
                          target_translation.contiguous(), params)
        return launch(list(grid), points, mask, x0, target_translation, params)
    if points.dim() == 2:
        return plain(grid, points, mask, x0, target_translation, params)
    rows = [plain(g, points[r], mask[r], x0[r], target_translation[r], params)
            for r, g in enumerate(grid)]
    return tuple(torch.stack(t) for t in zip(*rows))


def _launch(grids, points, mask, x0, target_translation, params):
    surface = grids[0].SURFACE
    scalars = (f32(grids[0].truncation_distance),) if surface == "tsdf" else ()
    return launch_lm(_KERNELS[surface], scalars, grids, points, mask, x0, target_translation,
                     params, params.use_nonmonotonic_steps)


def lm_match_2d(grid, points: torch.Tensor, mask: torch.Tensor, x0: torch.Tensor,
                target_translation: torch.Tensor, params: GaussNewtonMatcherParams2D):
    """The solve on pose vectors, on a Grid2D or the score surface of a
    TsdfGrid2D: -> (pose (3,), final cost, LM iterations). With (R, M, 2)
    points, R grids and a leading R on the rest: R robots' solves, one
    launch on the card."""
    return per_robot(_launch, _match_plain, grid, points, mask, x0, target_translation,
                     params)


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
