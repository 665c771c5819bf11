"""3D scan matching: Levenberg-Marquardt refinement (CeresScanMatcher3D)
and the real-time correlative search (RealTimeCorrelativeScanMatcher3D).

Counterpart of `gauss_newton_match_3d` and `real_time_correlative_match_3d`
in the JAX package's `ops/scan_matcher_3d.py`.

The refinement (ceres_scan_matcher_3d.cc, intensity_cost_function_3d.cc):
residuals w / sqrt(n) * (1 - P(T p)) with P the trilinear probability, for
the high-resolution cloud on the high-resolution grid and the
low-resolution cloud on the low one; with an intensity grid and a positive
`intensity_weight`, w / sqrt(n) * huber_clip(I(T p) - i) for the
high-resolution points whose intensity i is at most the threshold, with I
the trilinear running-average intensity; a translation penalty toward the
prediction and a rotation penalty toward the initial rotation, minimized
on the SE(3) tangent [dt, so3] (or [dt, yaw] with `only_optimize_yaw`) with
the update t += dt, q = q * exp(so3). The JAX package differentiates the
residuals with jax.jacfwd; here the Jacobian is written out: d world / d so3
= -R(q) [p]x for the rotation on the right, the soft clip's derivative for
the intensity rows, and the inverse right Jacobian of SO(3) for the
rotation penalty. `lm_match_3d` launches `csrc/scan_matcher_3d.cu` (K11),
the whole solve in one launch, on CUDA tensors and runs the plain twin
(`residuals_and_jacobian_3d` + `gauss_newton.lm_solve`) on CPU tensors.

The correlative search (real_time_correlative_scan_matcher_3d.cc): every
(x, y, z, rx, ry, rz) candidate of a window around the initial pose scored
as the mean probability of the rotated and shifted cloud's cells times the
motion prior exp(-(|dt| w_t + |aa| w_r)^2), and the best taken. The angular
step depends on the cloud's largest range, so the rotation count is static
(from `max_scan_range`) and the candidates beyond the window are skipped.
`correlative_match_3d` launches `csrc/correlative_3d.cu` (K17, the whole
search in one launch: each block takes the step size itself and the last
block decodes the winner) on CUDA tensors and runs the plain twin on CPU
tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Optional, Tuple

import torch

import math

import numpy as np

from cartographer_tpu_torch.core.tensor import true_div
from cartographer_tpu_torch.ops import cuda
from cartographer_tpu_torch.ops.gauss_newton import lm_solve
from cartographer_tpu_torch.ops.grid_3d import Grid3D, IntensityGrid3D
from cartographer_tpu_torch.ops.interp import trilinear_with_gradient
from cartographer_tpu_torch.ops.probability import UNKNOWN_PROBABILITY
from cartographer_tpu_torch.transform import quaternion as quat
from cartographer_tpu_torch.transform.rigid import Rigid3

_FUNCTION_TOLERANCE = 1e-6  # Ceres Solver::Options default, as lm_solve
# K17 keeps a cloud's cells in shared memory up to 12,288 points (its
# kSharedPoints); above, each of at most 4 blocks per SM keeps them in its
# slice of a device scratch.
_CORRELATIVE_SHARED_POINTS = 12288
_CORRELATIVE_LARGE_BLOCKS_PER_SM = 4

_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
_KERNEL = cuda.CudaKernel(
    "scan_matcher_3d.cu", "scan_matcher_3d",
    [_P, _P, _P, _F, _I, _P, _P, _I,  # high grid, high cloud
     _P, _P, _P, _F, _I, _P, _P, _I,  # low grid, low cloud
     _P, _P, _P, _F, _I, _P, _F, _F, _F,  # intensity grid and intensities (nullable)
     _P, _P, _F, _F, _F, _F, _I, _I, _I, _F, _P, _P, _P])
_CORRELATIVE_KERNEL = cuda.CudaKernel(
    "correlative_3d.cu", "correlative_3d",
    [_P, _P, _P, _F, _I, _P, _P, _I, _I, _P, _I, _I, _F, _F, _F, _F, _F, _F, _P, _P, _I,
     _P, _P, _P])
_correlative_sync = {}  # device index -> K17's two zero words (best key, ticket)
_correlative_lock = threading.Lock()


@dataclasses.dataclass(frozen=True)
class GaussNewtonMatcherParams3D:
    occupied_space_weight_0: float = 1.0  # high resolution
    occupied_space_weight_1: float = 6.0  # low resolution
    intensity_weight: float = 0.0  # 0 = no intensity residual
    intensity_huber_scale: float = 0.3
    intensity_threshold: float = 40.0
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


def _intensity_residuals(grid: IntensityGrid3D, points, mask, intensities,
                         pose: torch.Tensor, params: GaussNewtonMatcherParams3D):
    """The intensity rows (M,) and their Jacobian (M, 6): the Huber-style
    soft clip of I(T p) - i, the identity up to twice the scale and
    scale + sqrt(scale (|r| - scale)) beyond it, with jax.jacfwd's
    derivatives (sign(0) = 0; half of each side at the clip's kink)."""
    t, q = pose[0:3], pose[3:7]
    world = quat.rotate(q, points) + t
    average = grid.average()
    pred, dpred = trilinear_with_gradient(lambda i, j, k: average[i, j, k], average.shape,
                                          grid.world_to_cell_continuous(world))
    m = mask & (intensities <= params.intensity_threshold)
    n = torch.clamp(m.to(torch.float32).sum(), min=1.0)
    weight = torch.full_like(n, params.intensity_weight) / torch.sqrt(n)
    r = pred - intensities
    s = params.intensity_huber_scale
    a = r.abs()
    arg = s * (a - s)
    outlier = arg > 0
    soft = torch.where(outlier, torch.sqrt(torch.where(outlier, arg, torch.ones_like(arg))),
                       torch.zeros_like(arg))
    bound = s + soft
    sign = torch.sign(r)
    clipped = sign * torch.minimum(a, bound)
    d_bound = torch.where(outlier, 0.5 * s * sign / torch.where(outlier, soft, 1.0),
                          torch.zeros_like(a))
    d_min = torch.where(a < bound, sign, torch.where(a > bound, d_bound, 0.5 * (sign + d_bound)))
    d_r = sign * d_min  # d clipped / d pred
    res = torch.where(m, weight * clipped, torch.zeros_like(r))
    g_world = (weight * d_r)[:, None] * true_div(dpred, grid.resolution)
    g_body = quat.rotate(quat.conjugate(q), g_world)
    jac = torch.cat([g_world, torch.linalg.cross(points, g_body)], dim=-1)
    return res, torch.where(m[:, None], jac, torch.zeros_like(jac))


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
                              params: GaussNewtonMatcherParams3D,
                              intensity_grid: Optional[IntensityGrid3D] = None,
                              high_intensities: Optional[torch.Tensor] = None):
    """All residuals (Nh + Nl [+ Nh intensity rows] + 6,) at the pose vector
    [t, q] and their Jacobian on the tangent: (R, 6), or (R, 4) = [dt, yaw]
    with `only_optimize_yaw`."""
    r_h, j_h = _occupied_residuals(high_grid, high_points, high_mask, pose,
                                   params.occupied_space_weight_0)
    r_l, j_l = _occupied_residuals(low_grid, low_points, low_mask, pose,
                                   params.occupied_space_weight_1)
    rows, jacs = [r_h, r_l], [j_h, j_l]
    if _uses_intensity(intensity_grid, params):
        r_i, j_i = _intensity_residuals(intensity_grid, high_points, high_mask,
                                        high_intensities, pose, params)
        rows.append(r_i)
        jacs.append(j_i)
    w_t, w_r = params.translation_weight, params.rotation_weight
    r_t = w_t * (pose[0:3] - target_translation)
    phi = quat.to_axis_angle(quat.multiply(quat.conjugate(target_rotation), pose[3:7]))
    r_r = w_r * phi
    eye, zero = torch.eye(3, device=pose.device), torch.zeros(3, 3, device=pose.device)
    j_t = torch.cat([w_t * eye, zero], dim=1)
    j_r = torch.cat([zero, w_r * so3_inverse_right_jacobian(phi)], dim=1)
    r = torch.cat([*rows, r_t, r_r])
    jac = torch.cat([*jacs, j_t, j_r])
    if params.only_optimize_yaw:
        jac = torch.cat([jac[:, 0:3], jac[:, 5:6]], dim=1)
    return r, jac


def _uses_intensity(intensity_grid, params) -> bool:
    return intensity_grid is not None and params.intensity_weight > 0


def _match_plain(high_grid, low_grid, high_points, high_mask, low_points, low_mask, x0,
                 target_translation, params, intensity_grid=None, high_intensities=None):
    target_rotation = x0[3:7]

    def residual_and_jacobian(x):
        return residuals_and_jacobian_3d(high_grid, low_grid, high_points, high_mask,
                                         low_points, low_mask, x, target_translation,
                                         target_rotation, params, intensity_grid,
                                         high_intensities)

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
                  target_translation, params, intensity_grid=None, high_intensities=None):
    nh, nl = high_points.shape[0], low_points.shape[0]
    cuda.check(high_points, "high points", torch.float32, (nh, 3))
    cuda.check(high_mask, "high mask", torch.bool, (nh,))
    cuda.check(low_points, "low points", torch.float32, (nl, 3))
    cuda.check(low_mask, "low mask", torch.bool, (nl,))
    cuda.check(x0, "initial pose", torch.float32, (7,))
    cuda.check(target_translation, "target translation", torch.float32, (3,))
    intensity = (None, None, None, 0.0, 0, None)  # no intensity rows: null pointers
    if _uses_intensity(intensity_grid, params):
        s = intensity_grid.size
        cuda.check(intensity_grid.sums, "intensity sums", torch.float32, (s, s, s))
        cuda.check(intensity_grid.counts, "intensity counts", torch.float32, (s, s, s))
        cuda.check(intensity_grid.origin, "intensity origin", torch.float32, (3,))
        cuda.check(high_intensities, "high intensities", torch.float32, (nh,))
        intensity = (intensity_grid.sums.data_ptr(), intensity_grid.counts.data_ptr(),
                     intensity_grid.origin.data_ptr(), float(intensity_grid.resolution), s,
                     high_intensities.data_ptr())
    device = x0.device
    x = torch.empty(7, dtype=torch.float32, device=device)
    cost = torch.empty((), dtype=torch.float32, device=device)
    iterations = torch.empty((), dtype=torch.int32, device=device)
    _KERNEL(device, *_check_grid(high_grid, "high grid"), high_points.data_ptr(),
            high_mask.data_ptr(), nh, *_check_grid(low_grid, "low grid"),
            low_points.data_ptr(), low_mask.data_ptr(), nl, *intensity,
            float(params.intensity_weight), float(params.intensity_huber_scale),
            float(params.intensity_threshold), x0.data_ptr(),
            target_translation.data_ptr(), float(params.occupied_space_weight_0),
            float(params.occupied_space_weight_1), float(params.translation_weight),
            float(params.rotation_weight), int(params.only_optimize_yaw),
            int(params.num_iterations), int(params.use_nonmonotonic_steps),
            _FUNCTION_TOLERANCE, x.data_ptr(), cost.data_ptr(), iterations.data_ptr())
    return x, cost, iterations


def lm_match_3d(high_grid: Grid3D, low_grid: Grid3D, high_points, high_mask, low_points,
                low_mask, x0: torch.Tensor, target_translation: torch.Tensor,
                params: GaussNewtonMatcherParams3D,
                intensity_grid: Optional[IntensityGrid3D] = None,
                high_intensities: Optional[torch.Tensor] = None):
    """The solve on pose vectors [t, q]: -> (pose (7,), final cost, LM
    iterations). The intensity rows are added when `intensity_grid` is given
    and `params.intensity_weight` is positive."""
    args = (high_grid, low_grid, high_points, high_mask, low_points, low_mask)
    if x0.is_cuda:
        return _match_kernel(*args, x0.contiguous(), target_translation.contiguous(), params,
                             intensity_grid, high_intensities)
    return _match_plain(*args, x0, target_translation, params, intensity_grid,
                        high_intensities)


def gauss_newton_match_3d(high_grid: Grid3D, low_grid: Grid3D, high_points, high_mask,
                          low_points, low_mask, initial_pose: Rigid3,
                          params: GaussNewtonMatcherParams3D,
                          target_translation: Optional[torch.Tensor] = None,
                          intensity_grid: Optional[IntensityGrid3D] = None,
                          high_intensities: Optional[torch.Tensor] = None
                          ) -> Tuple[Rigid3, torch.Tensor]:
    """CeresScanMatcher3D::Match: refine `initial_pose` of the two clouds
    (scan frame) on the two grids. The translation penalty pulls toward
    `target_translation` (the prediction), the rotation penalty toward
    `initial_pose.rotation`. Returns (refined pose, final cost)."""
    if target_translation is None:
        target_translation = initial_pose.translation
    x0 = torch.cat([initial_pose.translation, initial_pose.rotation])
    x, cost, _ = lm_match_3d(high_grid, low_grid, high_points, high_mask, low_points,
                             low_mask, x0, target_translation, params, intensity_grid,
                             high_intensities)
    return Rigid3(x[0:3], x[3:7]), cost


# ---------------------------------------------------------------- K17 correlative search


@dataclasses.dataclass(frozen=True)
class CorrelativeSearchParams3D:
    linear_search_window: float = 0.15
    angular_search_window: float = 0.0175  # math.rad(1.)
    translation_delta_cost_weight: float = 1e-1
    rotation_delta_cost_weight: float = 1e-1
    max_scan_range: float = 60.0


def search_sizes(resolution: float, params: CorrelativeSearchParams3D) -> Tuple[int, int]:
    """(nl, na): the 2 nl + 1 translations and 2 na + 1 angles per axis, from
    the window and the step at `max_scan_range` (static)."""
    nl = int(math.ceil(params.linear_search_window / resolution))
    static_step = (1.0 - 1e-3) * math.acos(
        1.0 - resolution ** 2 / (2.0 * params.max_scan_range ** 2))
    return nl, int(round(params.angular_search_window / static_step))


def _f32(x) -> torch.Tensor:
    return torch.tensor(np.float32(x))


def _pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a tree, x[:h] + x[h:] from half the padded
    length down to one, the order K17 adds in."""
    n = x.shape[-1]
    x = torch.nn.functional.pad(x, (0, (1 << max(n - 1, 0).bit_length()) - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _axis_angle_quaternion(aa: torch.Tensor):
    """quat.from_axis_angle with its sums written out in K17's order; also
    returns |aa|."""
    ax, ay, az = aa.unbind(-1)
    angle_sq = ax * ax + ay * ay + az * az
    angle = torch.sqrt(angle_sq.clamp(min=1e-32))
    half = 0.5 * angle
    small = angle_sq < 1e-12
    k = torch.where(small, 0.5 - angle_sq / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - angle_sq / 8.0, torch.cos(half))
    return torch.stack([w, k * ax, k * ay, k * az], -1), torch.sqrt(angle_sq)


def _angular_step(points, mask, resolution: float):
    """The per-scan angular step: (1 - 1e-3) acos(1 - r^2 / (2 R^2)) with R
    the largest masked range (at least 3 cells), in float32 as JAX does."""
    x, y, z = points.unbind(-1)
    ranges = torch.sqrt(x * x + y * y + z * z)
    dev = points.device
    largest = torch.maximum(torch.where(mask, ranges, torch.zeros_like(ranges)).max(),
                            _f32(3.0 * resolution).to(dev))
    ratio = _f32(resolution ** 2).to(dev) / (2.0 * (largest * largest))
    return _f32(1.0 - 1e-3).to(dev) * torch.acos(1.0 - ratio)


def correlative_match_3d_plain(grid: Grid3D, points, mask, x0: torch.Tensor,
                               params: CorrelativeSearchParams3D):
    """The plain twin of K17: the candidates of the valid rotations only (a
    skipped one scores -inf in JAX and is never chosen, since the zero
    rotation is always valid), in flat order, so ties go to the lowest
    flat index (rotation, then x, y, z) as jnp.argmax gives them."""
    dev = points.device
    res = grid.resolution
    nl, na = search_sizes(res, params)
    step = _angular_step(points, mask, res)
    ang = torch.arange(-na, na + 1, device=dev).to(torch.float32) * step
    valid = (ang.abs() <= _f32(params.angular_search_window + 1e-6).to(dev)).cpu()
    A, L = 2 * na + 1, 2 * nl + 1
    ks = torch.nonzero(valid)[:, 0]
    ii, jj, kk = torch.meshgrid(ks, ks, ks, indexing="ij")
    flat = ((ii * A + jj) * A + kk).reshape(-1).to(dev)
    aa = torch.stack([ang[ii.reshape(-1).to(dev)], ang[jj.reshape(-1).to(dev)],
                      ang[kk.reshape(-1).to(dev)]], -1)
    qs, ang_norm = _axis_angle_quaternion(aa)
    lin = torch.arange(-nl, nl + 1, device=dev).to(torch.float32) * _f32(res).to(dev)
    r = torch.arange(L, device=dev)
    shifts = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    lx, ly, lz = lin[shifts].unbind(-1)
    dist = torch.sqrt(lx * lx + ly * ly + lz * lz)
    num = torch.clamp(mask.sum(), min=1).to(torch.float32)
    wt = _f32(params.translation_delta_cost_weight).to(dev)
    wr = _f32(params.rotation_delta_cost_weight).to(dev)
    size = grid.size
    scores = []
    for c in range(0, qs.shape[0], 16):
        q = qs[c:c + 16, None, :]
        rotated = quat.rotate_expanded(x0[None, None, 3:7],
                                       quat.rotate_expanded(q, points[None]))
        cells = torch.floor(grid.world_to_cell_continuous(rotated + x0[0:3])).long()
        cells = cells[:, None] + (shifts - nl)[None, :, None]  # (chunk, T, N, 3)
        inb = ((cells >= 0) & (cells < size)).all(-1)
        cells = cells.clamp(0, size - 1)
        p = grid.probability_at(cells[..., 0], cells[..., 1], cells[..., 2])
        p = torch.where(inb, p, torch.full_like(p, UNKNOWN_PROBABILITY))
        raw = _pairwise_sum(torch.where(mask, p, torch.zeros_like(p))) / num
        v = dist * wt + ang_norm[c:c + 16, None] * wr
        scores.append(raw * torch.exp(-(v * v)))
    scores = torch.cat(scores)
    best = int(torch.argmax(scores))  # the first of equal maxima
    rot, t = divmod(best, shifts.shape[0])
    x = torch.cat([x0[0:3] + lin[shifts[t]],
                   quat.normalize(quat.multiply(x0[3:7], qs[rot]))])
    return scores.reshape(-1)[best], x, int(flat[rot]) * shifts.shape[0] + t


def _correlative_sync_words(dev: torch.device) -> torch.Tensor:
    """K17's best key and blocks' ticket on `dev`: zeroed once, and each call
    leaves them zero (its last block resets them)."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with _correlative_lock:
        words = _correlative_sync.get(index)
        if words is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("correlative_3d: call it once on this device before "
                                   "capturing it in a CUDA graph")
            words = _correlative_sync[index] = torch.zeros(2, dtype=torch.int64, device=dev)
    return words


def _correlative_kernel(grid: Grid3D, points, mask, x0, params):
    """K17 in one launch: -> (best score, best pose [t, q], its key (score
    bits << 32 | ~flat index) as a (1,) int64 tensor)."""
    n = points.shape[0]
    cuda.check(points, "points", torch.float32, (n, 3))
    cuda.check(mask, "mask", torch.bool, (n,))
    cuda.check(x0, "initial pose", torch.float32, (7,))
    if n < 1:
        raise ValueError("correlative_3d: the cloud is empty")
    res = grid.resolution
    nl, na = search_sizes(res, params)
    dev = x0.device
    sync = _correlative_sync_words(dev)
    cell_blocks = 0
    if n > _CORRELATIVE_SHARED_POINTS:
        cell_blocks = (_CORRELATIVE_LARGE_BLOCKS_PER_SM
                       * torch.cuda.get_device_properties(dev).multi_processor_count)
    cells = torch.empty(cell_blocks * 3 * n, dtype=torch.int32, device=dev)
    x = torch.empty(7, dtype=torch.float32, device=dev)
    score = torch.empty((), dtype=torch.float32, device=dev)
    key = torch.empty(1, dtype=torch.int64, device=dev)
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    _CORRELATIVE_KERNEL(dev, *_check_grid(grid, "grid"), points.data_ptr(), mask.data_ptr(), n,
                        1 << (n - 1).bit_length(), x0.data_ptr(), nl, na, f32(res ** 2),
                        f32(3.0 * res), f32(1.0 - 1e-3),
                        f32(params.angular_search_window + 1e-6),
                        f32(params.translation_delta_cost_weight),
                        f32(params.rotation_delta_cost_weight), sync.data_ptr(),
                        cells.data_ptr() if cell_blocks else None, cell_blocks, x.data_ptr(),
                        score.data_ptr(), key.data_ptr())
    return score, x, key


def correlative_match_3d(grid: Grid3D, points, mask, x0: torch.Tensor,
                         params: CorrelativeSearchParams3D):
    """RealTimeCorrelativeScanMatcher3D::Match around the pose vector x0 =
    [t, q] (7,): -> (best score, best pose vector), on x0's device."""
    if x0.is_cuda:
        score, x, _ = _correlative_kernel(grid, points, mask, x0.contiguous(), params)
    else:
        score, x, _ = correlative_match_3d_plain(grid, points, mask, x0, params)
    return score, x


def real_time_correlative_match_3d(grid: Grid3D, points, mask, initial_pose: Rigid3,
                                   params: CorrelativeSearchParams3D
                                   ) -> Tuple[torch.Tensor, Rigid3]:
    """The JAX package's signature: -> (best score, best pose)."""
    score, x = correlative_match_3d(
        grid, points, mask, torch.cat([initial_pose.translation, initial_pose.rotation]), params)
    return score, Rigid3(x[0:3], x[3:7])
