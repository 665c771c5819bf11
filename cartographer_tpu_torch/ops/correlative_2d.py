"""Real-time correlative scan matching 2D: the exhaustive (theta, x, y)
window search around a pose estimate.

Counterpart of the JAX package's `ops/correlative_2d.py`
(real_time_correlative_scan_matcher_2d.cc), implementing its gather form
`_scores_gather` (l.82): every candidate scores the mean grid probability
under the rotated and shifted scan points (out-of-map cells count as
UNKNOWN), times the motion prior exp(-(d*w_t + |dtheta|*w_r)^2); angles
beyond the window score -inf; the result is the first argmax in (angle, x, y)
order, as `jnp.argmax` gives it. The angular step depends on the data (the
largest range of the cloud), so it is computed on the device and the
candidate count is the static worst case from `max_scan_range`.

`real_time_correlative_match` launches the CUDA kernel `csrc/correlative_2d.cu`
(K5) on CUDA tensors and the plain twin on CPU tensors. On a `TsdfGrid2D`
both score its score surface (K5's TSDF form, `correlative_2d_tsdf`): 0 in
unknown cells, UNKNOWN outside the map, as the JAX search reads it through
`grid.probability()`. Both sum the point axis (padded to a power of two) as
the same pairwise halving tree, so on the card the twin's scores are
bit-equal to the kernel's.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Tuple

import torch

from cartographer_tpu_torch.core.tensor import f32, true_div
from cartographer_tpu_torch.ops import cuda
from cartographer_tpu_torch.ops.grid_2d import Grid2D
from cartographer_tpu_torch.ops.probability import UNKNOWN_PROBABILITY

# One kernel per surface form (Grid2D.SURFACE, TsdfGrid2D.SURFACE).
_KERNELS = {
    "occupancy": cuda.CudaKernel(
        "correlative_2d.cu", "correlative_2d",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
         ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]),
    "tsdf": cuda.CudaKernel(
        "correlative_2d.cu", "correlative_2d_tsdf",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p, ctypes.c_float,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
         ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p])}

MAX_POINTS = 4096  # the kernel keeps one float per (padded) point in shared memory


@dataclasses.dataclass(frozen=True)
class CorrelativeSearchParams:
    linear_search_window: float = 0.1  # meters
    angular_search_window: float = math.radians(20.0)
    translation_delta_cost_weight: float = 1e-1
    rotation_delta_cost_weight: float = 1e-1
    max_scan_range: float = 30.0  # bounds the angular step statically

    def num_linear(self, resolution: float) -> int:
        return int(math.ceil(self.linear_search_window / resolution))

    def static_num_angles(self, resolution: float) -> int:
        return static_num_angles(self.angular_search_window, self.max_scan_range, resolution)


def static_num_angles(angular_window: float, max_scan_range: float, resolution: float) -> int:
    """Worst-case (finest step) angle count, correlative_scan_matcher_2d.cc:40-44."""
    step = (1.0 - 1e-3) * math.acos(1.0 - resolution**2 / (2.0 * max_scan_range**2))
    return 2 * int(math.ceil(angular_window / step)) + 1


def angular_step(points: torch.Tensor, mask: torch.Tensor, resolution: float) -> torch.Tensor:
    """Data-dependent angular step (SearchParameters ctor,
    correlative_scan_matcher_2d.cc:31-42), a 0-d tensor."""
    x, y = points[:, 0], points[:, 1]
    ranges = torch.sqrt(x * x + y * y)
    max_range = torch.clamp(torch.max(torch.where(mask, ranges, torch.zeros_like(ranges))),
                            min=f32(3.0 * resolution))
    ratio = true_div(torch.full_like(max_range, f32(resolution**2)), 2.0 * (max_range * max_range))
    return f32(1.0 - 1e-3) * torch.arccos(1.0 - ratio)


def candidate_cells(grid: Grid2D, points: torch.Tensor, mask: torch.Tensor,
                    initial_pose: torch.Tensor, num_angles: int, angular_window: float):
    """-> (deltas (A,), angle_valid (A,), cells (A, N, 2) int64): the angle
    offsets around initial_pose[2] and the scan discretised at each."""
    step = angular_step(points, mask, grid.resolution)
    half = (num_angles - 1) // 2
    deltas = (torch.arange(num_angles, dtype=torch.float32, device=points.device) - half) * step
    limit = torch.full((), f32(angular_window + 1e-6), device=points.device)
    angle_valid = torch.abs(deltas) <= limit
    theta = initial_pose[2] + deltas
    c, s = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    x, y = points[None, :, 0], points[None, :, 1]
    world = torch.stack([(c * x - s * y) + initial_pose[0], (s * x + c * y) + initial_pose[1]], -1)
    cells = torch.floor(true_div(world - grid.origin, grid.resolution)).long()
    return deltas, angle_valid, cells


def probability_at(grid, cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """Probability of cells (cx, cy) of a Grid2D, out-of-map cells and cells
    never updated UNKNOWN_PROBABILITY; of a TsdfGrid2D its score surface,
    out-of-map cells UNKNOWN_PROBABILITY."""
    size = grid.size
    inside = (cx >= 0) & (cx < size) & (cy >= 0) & (cy < size)
    score = grid.score_at(torch.clamp(cx, 0, size - 1), torch.clamp(cy, 0, size - 1))
    return torch.where(inside, score, torch.full_like(score, UNKNOWN_PROBABILITY))


def tree_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a power of two) as a pairwise halving tree:
    v[k] += v[k + h] for h = n/2, n/4, ..., 1. The kernels sum in this order."""
    n = v.shape[-1]
    while n > 1:
        n //= 2
        v = v[..., :n] + v[..., n:2 * n]
    return v[..., 0]


def pad_points(points: torch.Tensor, mask: torch.Tensor):
    """Pad the point axis with masked zeros to a power of two (>= 2)."""
    n = points.shape[0]
    p = max(2, 1 << (n - 1).bit_length())
    if p == n:
        return points.contiguous(), mask.contiguous()
    return (torch.cat([points, points.new_zeros((p - n, 2))]).contiguous(),
            torch.cat([mask, mask.new_zeros(p - n)]).contiguous())


def scores_plain(grid: Grid2D, points: torch.Tensor, mask: torch.Tensor,
                 initial_pose: torch.Tensor, params: CorrelativeSearchParams):
    """-> (scores (A, W, W), deltas (A,)): the plain twin of K5's scoring."""
    res = grid.resolution
    nl = params.num_linear(res)
    points, mask = pad_points(points, mask)
    deltas, angle_valid, cells = candidate_cells(
        grid, points, mask, initial_pose, params.static_num_angles(res),
        params.angular_search_window)
    shifts = torch.arange(-nl, nl + 1, device=points.device)
    sx = cells[:, None, None, :, 0] + shifts[None, :, None, None]
    sy = cells[:, None, None, :, 1] + shifts[None, None, :, None]
    p = probability_at(grid, sx, sy)  # (A, W, W, N)
    total = tree_sum(torch.where(mask, p, torch.zeros_like(p)))
    num_valid = torch.clamp(mask.sum(), min=1).to(torch.float32)
    raw = total / num_valid
    dxy = torch.abs(shifts.to(torch.float32)) * f32(res)
    dist = torch.sqrt(dxy[:, None] * dxy[:, None] + dxy[None, :] * dxy[None, :])
    q = (dist[None] * f32(params.translation_delta_cost_weight)
         + torch.abs(deltas)[:, None, None] * f32(params.rotation_delta_cost_weight))
    scores = torch.where(angle_valid[:, None, None], raw * torch.exp(-(q * q)),
                         torch.full_like(raw, -math.inf))
    return scores, deltas


def _best(scores: torch.Tensor, deltas: torch.Tensor, initial_pose: torch.Tensor,
          nl: int, res: float) -> torch.Tensor:
    w = scores.shape[-1]
    flat = torch.argmax(scores.reshape(-1))  # first maximum, as jnp.argmax
    a, ix, iy = flat // (w * w), (flat // w) % w, flat % w
    shift = torch.stack([ix, iy]).to(torch.float32) - nl
    return torch.cat([scores.reshape(-1)[flat][None],
                      initial_pose[0:2] + shift * f32(res),
                      (initial_pose[2] + deltas[a])[None]])


def correlative_match_plain(grid: Grid2D, points: torch.Tensor, mask: torch.Tensor,
                            initial_pose: torch.Tensor, params: CorrelativeSearchParams):
    scores, deltas = scores_plain(grid, points, mask, initial_pose, params)
    return _best(scores, deltas, initial_pose, params.num_linear(grid.resolution),
                 grid.resolution), scores


def _match_kernel(grid: Grid2D, points: torch.Tensor, mask: torch.Tensor,
                  initial_pose: torch.Tensor, params: CorrelativeSearchParams):
    res, size = grid.resolution, grid.size
    nl = params.num_linear(res)
    num_angles = params.static_num_angles(res)
    points, mask = pad_points(points, mask)
    n = points.shape[0]
    if n > MAX_POINTS:
        raise ValueError(f"correlative_2d: at most {MAX_POINTS} points, got {n}")
    surface = grid.surface_args()
    cuda.check(grid.origin, "grid origin", torch.float32, (2,))
    cuda.check(points, "points", torch.float32, (n, 2))
    cuda.check(mask, "mask", torch.bool, (n,))
    cuda.check(initial_pose, "initial pose", torch.float32, (3,))
    device = points.device
    w = 2 * nl + 1
    scores = torch.empty((num_angles, w, w), dtype=torch.float32, device=device)
    deltas = torch.empty(num_angles, dtype=torch.float32, device=device)
    key = torch.empty(1, dtype=torch.int64, device=device)
    best = torch.empty(4, dtype=torch.float32, device=device)
    _KERNELS[grid.SURFACE](device, *surface, grid.origin.data_ptr(), f32(res), size,
               points.data_ptr(), mask.data_ptr(), n, initial_pose.data_ptr(), num_angles, nl,
               f32(params.angular_search_window + 1e-6),
               f32(params.translation_delta_cost_weight),
               f32(params.rotation_delta_cost_weight), f32(res**2), f32(3.0 * res),
               scores.data_ptr(), deltas.data_ptr(), key.data_ptr(), best.data_ptr())
    return best, scores


def real_time_correlative_match(grid: Grid2D, points: torch.Tensor, mask: torch.Tensor,
                                initial_pose: torch.Tensor, params: CorrelativeSearchParams
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exhaustive window search around `initial_pose` ([x, y, theta] in the
    grid frame; `points` (N, 2) in the scan frame, `mask` (N,)).

    Returns (score, pose (3,)) as device tensors: the best candidate's
    prior-weighted mean probability and its pose."""
    match = _match_kernel if points.is_cuda else correlative_match_plain
    best, _ = match(grid, points, mask, initial_pose, params)
    return best[0], best[1:4]
