"""Fast correlative (loop-closure) 3D matching: the rotational pre-filter,
the mixed-resolution uint8 precomputation stack, the level-synchronous
branch and bound over (yaw, x, y, z) and the low-resolution gate.

Counterpart of the JAX package's `ops/bnb_3d.py`
(fast_correlative_scan_matcher_3d.cc, precomputation_grid_3d.cc),
implementing its beam path `_beam_candidates_3d` (l.182), `_match_tail`
(l.527), `fast_correlative_match_3d` (l.449), `match_full_submap_3d` (l.581)
and `match_full_submap_3d_exact` (l.685). The TPU's gather-free form of the
same search, `_dense_candidates_3d` (l.281), is not ported: the gather
scorer below covers its function.

The stack holds `full_resolution_depth` levels at full resolution (level h
is the max over 2^h cells per axis) and the deeper levels at halved
resolution, each with one stored-cell slack so that a parent bounds every
leaf below it; values are probabilities quantized to uint8. The search
scores every (yaw, offset) candidate of the top level, keeps the best
`beam_width`, splits each into its 8 children one level finer, down to the
leaves; the best 64 leaves must pass the low-resolution grid, and the
result is certified optimal when the best leaf scores at least the largest
bound any truncation dropped.

`build_precomputation_stack_3d` launches `csrc/bnb_3d.cu` `bnb3d_stack`
(K14); the per-yaw discretization of the clouds and the candidate scorer
launch its `bnb3d_discretize` and `bnb3d_score` (K15), on CUDA tensors; CPU
tensors take the plain twins. The beam selection is a stable sort (value
descending, index ascending: the order of `lax.top_k`), the same on both
paths. The point axis is summed as the same pairwise halving tree on both,
and the clouds are rotated with the same sequence of operations, so on the
card the twin's scores are bit-equal to the kernel's.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from cartographer_tpu_torch.core.tensor import f32, true_div
from cartographer_tpu_torch.ops import cuda
from cartographer_tpu_torch.ops.correlative_2d import tree_sum
from cartographer_tpu_torch.ops.grid_3d import Grid3D
from cartographer_tpu_torch.ops.probability import (
    MAX_PROBABILITY,
    MIN_PROBABILITY,
    UNKNOWN_PROBABILITY,
    log_odds_to_probability,
)
from cartographer_tpu_torch.ops.rot_histogram import match_histograms, match_histograms_plain
from cartographer_tpu_torch.transform import quaternion as quat

Q_SCALE = (MAX_PROBABILITY - MIN_PROBABILITY) / 255.0  # uint8 <-> probability
MAX_POINTS = 1024  # the scorer keeps one float per (padded) point of each warp in shared memory

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STACK = cuda.CudaKernel("bnb_3d.cu", "bnb3d_stack",
                         [_P, _P, _I, _I, _I, _F, _F, _P, _P, _P, _P])
_DISCRETIZE = cuda.CudaKernel("bnb_3d.cu", "bnb3d_discretize",
                              [_P, _I, _P, _I, _P, _P, _P, _F, _P])
_SCORE = cuda.CudaKernel("bnb_3d.cu", "bnb3d_score",
                         [_P, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P, _I, _F, _F, _F,
                          _P])


@dataclasses.dataclass(frozen=True)
class FastCorrelativeMatcherParams3D:
    branch_and_bound_depth: int = 8
    full_resolution_depth: int = 3
    min_rotational_score: float = 0.77
    min_low_resolution_score: float = 0.55
    linear_xy_search_window: float = 5.0
    linear_z_search_window: float = 1.0
    angular_search_window: float = math.radians(15.0)
    beam_width: int = 2048
    max_scan_range: float = 20.0  # static bound on the yaw candidate count

    def static_num_angles(self, resolution: float) -> int:
        step = (1.0 - 1e-3) * math.acos(1.0 - resolution**2 / (2.0 * self.max_scan_range**2))
        return 2 * int(math.ceil(self.angular_search_window / step)) + 1


@dataclasses.dataclass(frozen=True)
class PrecomputationStack3D:
    """full[h] (h < full_resolution_depth): the max over windows of 2^h
    cells per axis at full resolution; coarse[j] (level frd + j): the max
    over 2^(frd+j) cells stored every 2^(j+1) cells, zero-padded to
    (S/2)^3. uint8 quantized probabilities."""

    full: torch.Tensor  # (frd, S, S, S) uint8
    coarse: torch.Tensor  # (depth - frd, S/2, S/2, S/2) uint8
    depth: int
    full_resolution_depth: int

    def level(self, h: int):
        """(level volume, reduction exponent) of pyramid level h."""
        frd = self.full_resolution_depth
        if h >= frd:
            return self.coarse[h - frd], h - frd + 1
        return self.full[h], 0


# ---------------------------------------------------------------- K14


def _shift_max(arr: torch.Tensor, shift: int) -> torch.Tensor:
    """max(arr, arr shifted down by `shift`) along each axis, zero-padded."""
    for axis in range(3):
        shifted = arr.narrow(axis, shift, arr.shape[axis] - shift)
        pad = [0, 0] * 3
        pad[2 * (2 - axis) + 1] = shift
        arr = torch.maximum(arr, F.pad(shifted, pad))
    return arr


def _halve(arr: torch.Tensor) -> torch.Tensor:
    s = arr.shape[0] // 2
    return arr.reshape(s, 2, s, 2, s, 2).amax(dim=(1, 3, 5))


def quantize_plain(log_odds: torch.Tensor, known: torch.Tensor) -> torch.Tensor:
    prob = torch.where(known, log_odds_to_probability(log_odds),
                       torch.full_like(log_odds, UNKNOWN_PROBABILITY))
    v = torch.round(true_div(prob - MIN_PROBABILITY, Q_SCALE))
    return torch.clamp(v, 0, 255).to(torch.uint8)


def stack_plain(grid: Grid3D, depth: int, full_resolution_depth: int = 3
                ) -> PrecomputationStack3D:
    """The plain twin of K14 (`build_precomputation_stack_3d`, l.113-142)."""
    frd = max(1, min(full_resolution_depth, depth))
    q = quantize_plain(grid.log_odds, grid.known)
    s = q.shape[0]
    full_levels, current = [q], q
    for h in range(1, frd):
        current = _shift_max(current, 1 << (h - 1))
        full_levels.append(current)
    coarse = torch.zeros((depth - frd, s // 2, s // 2, s // 2), dtype=torch.uint8,
                         device=q.device)
    for j in range(depth - frd):
        current = _shift_max(_halve(_shift_max(current, 1 << (frd - 1))), 1)
        c = current.shape[0]
        coarse[j, :c, :c, :c] = current
    return PrecomputationStack3D(torch.stack(full_levels), coarse, depth, frd)


def build_precomputation_stack_3d(grid: Grid3D, depth: int, full_resolution_depth: int = 3
                                  ) -> PrecomputationStack3D:
    """The mixed-resolution pyramid of the grid's probabilities
    (PrecomputationGridStack3D), read straight from its log-odds and known
    mask."""
    if not grid.log_odds.is_cuda:
        return stack_plain(grid, depth, full_resolution_depth)
    frd = max(1, min(full_resolution_depth, depth))
    s = grid.size
    if s % (1 << (depth - frd)):
        raise ValueError(f"bnb3d_stack: grid size {s} does not halve {depth - frd} times")
    cuda.check(grid.log_odds, "log_odds", torch.float32, (s, s, s))
    cuda.check(grid.known, "known", torch.bool, (s, s, s))
    dev = grid.log_odds.device
    full = torch.empty((frd, s, s, s), dtype=torch.uint8, device=dev)
    coarse = torch.empty((depth - frd, s // 2, s // 2, s // 2), dtype=torch.uint8, device=dev)
    scratch_a = torch.empty(s ** 3 if depth > frd else 1, dtype=torch.uint8, device=dev)
    scratch_b = torch.empty((s // 2) ** 3 if depth > frd else 1, dtype=torch.uint8, device=dev)
    _STACK(dev, grid.log_odds.data_ptr(), grid.known.data_ptr(), s, depth, frd,
           f32(Q_SCALE), f32(MIN_PROBABILITY), full.data_ptr(), coarse.data_ptr(),
           scratch_a.data_ptr(), scratch_b.data_ptr())
    return PrecomputationStack3D(full, coarse, depth, frd)


# ---------------------------------------------------------------- K15


def discretize_plain(points: torch.Tensor, yaw_q: torch.Tensor, q_init: torch.Tensor,
                     translation: torch.Tensor, origin: torch.Tensor, resolution: float
                     ) -> torch.Tensor:
    """The plain twin of K15's discretization: (A, N, 3) int32 cells of
    floor((yaw_q[a] (q_init p) + translation - origin) / resolution)."""
    rotated = quat.rotate_expanded(q_init, points)[None, :, :]
    world = quat.rotate_expanded(yaw_q[:, None, :], rotated) + translation
    return torch.floor(true_div(world - origin, resolution)).to(torch.int32)


def discretize(points: torch.Tensor, yaw_q: torch.Tensor, q_init: torch.Tensor,
               translation: torch.Tensor, origin: torch.Tensor, resolution: float
               ) -> torch.Tensor:
    """The cloud (N, 3) rotated by q_init, then by each yaw (A, 4), shifted
    by `translation` and discretized on a grid at `origin`: (A, N, 3)."""
    if not points.is_cuda:
        return discretize_plain(points, yaw_q, q_init, translation, origin, resolution)
    n, a = points.shape[0], yaw_q.shape[0]
    cuda.check(points, "points", torch.float32, (n, 3))
    cuda.check(yaw_q, "yaw_q", torch.float32, (a, 4))
    for name, t, size in (("q_init", q_init, 4), ("translation", translation, 3),
                          ("origin", origin, 3)):
        cuda.check(t, name, torch.float32, (size,))
    out = torch.empty((a, n, 3), dtype=torch.int32, device=points.device)
    if a * n:
        _DISCRETIZE(points.device, points.data_ptr(), n, yaw_q.data_ptr(), a, q_init.data_ptr(),
                    translation.data_ptr(), origin.data_ptr(), f32(resolution), out.data_ptr())
    return out


def score_plain(level: torch.Tensor, re: int, window: int, size: int, cells: torch.Tensor,
                mask: torch.Tensor, a_idx: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor,
                oz: torch.Tensor) -> torch.Tensor:
    """The plain twin of K15's scorer (`_score_level` l.152; with a float
    level, window 1 and re 0, `_score_3d` l.724)."""
    dim = level.shape[-1]
    a = a_idx.long()
    c = [cells[a, :, k] + o[:, None] for k, o in enumerate((ox, oy, oz))]
    inb = ((c[0] > -window) & (c[0] < size) & (c[1] > -window) & (c[1] < size)
           & (c[2] > -window) & (c[2] < size))
    g = [torch.clamp(x, 0, size - 1) >> re for x in c]
    lin = (g[0].long() * dim + g[1].long()) * dim + g[2].long()
    v = level.reshape(-1)[lin]
    if v.dtype == torch.uint8:
        v = v.to(torch.float32) * f32(Q_SCALE) + f32(MIN_PROBABILITY)
    p = torch.where(inb, v, torch.full_like(v, UNKNOWN_PROBABILITY))
    total = tree_sum(torch.where(mask[None, :], p, torch.zeros_like(p)))
    return total / torch.clamp(mask.sum(), min=1).to(torch.float32)


def score(level: torch.Tensor, re: int, window: int, size: int, cells: torch.Tensor,
          mask: torch.Tensor, a_idx: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor,
          oz: torch.Tensor) -> torch.Tensor:
    """Mean level value (B,) under the candidates (a_idx, ox, oy, oz):
    point k of yaw a sits at cells[a, k] + offset, in full-resolution cells
    of a grid `size` wide; a candidate anchored more than `window` cells
    below the grid or beyond it reads UNKNOWN, others read the level at the
    clipped cell >> re. A uint8 level is dequantized. The point count is a
    power of two."""
    if not level.is_cuda:
        return score_plain(level, re, window, size, cells, mask, a_idx, ox, oy, oz)
    dim = level.shape[-1]
    a_n, n = cells.shape[0], cells.shape[1]
    b = a_idx.shape[0]
    if n > MAX_POINTS or n & (n - 1):
        raise ValueError(f"bnb3d_score: the point count must be a power of two <= {MAX_POINTS}")
    if level.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"bnb3d_score: level must be uint8 or float32, got {level.dtype}")
    cuda.check(level, "level", level.dtype, (dim, dim, dim))
    cuda.check(cells, "cells", torch.int32, (a_n, n, 3))
    cuda.check(mask, "mask", torch.bool, (n,))
    for name, t in (("a_idx", a_idx), ("ox", ox), ("oy", oy), ("oz", oz)):
        cuda.check(t, name, torch.int32, (b,))
    out = torch.empty(b, dtype=torch.float32, device=level.device)
    if b:
        _SCORE(level.device, level.data_ptr(), int(level.dtype == torch.uint8), dim, size, re,
               window, cells.data_ptr(), n, mask.data_ptr(), a_idx.data_ptr(), ox.data_ptr(),
               oy.data_ptr(), oz.data_ptr(), b, f32(Q_SCALE), f32(MIN_PROBABILITY),
               f32(UNKNOWN_PROBABILITY), out.data_ptr())
    return out


# ---------------------------------------------------------------- the search


def _top(scores: torch.Tensor, k: int):
    """(values, indices) of the k largest, ties to the lower index (lax.top_k)."""
    values, order = torch.sort(scores, descending=True, stable=True)
    return values[:k], order[:k]


def _beam_candidates(stack: PrecomputationStack3D, cells, mask, yaw_alive, w_xy: int,
                     w_z: int, size: int, num_angles: int, min_score: float, beam_width: int,
                     scorer):
    """The level-synchronous beam search from the stack top (l.182-278).
    Returns the leaf candidates (a_idx, ox, oy, oz, scores) and the largest
    bound the beam dropped."""
    depth, device = stack.depth, cells.device
    top_stride = 1 << (depth - 1)

    def offsets(w):
        n = 2 * ((w + top_stride - 1) // top_stride) + 1
        return ((torch.arange(n, device=device) - n // 2) * top_stride
                - top_stride // 2).to(torch.int32)

    offs_xy, offs_z = offsets(w_xy), offsets(w_z)
    nxy, nz = offs_xy.shape[0], offs_z.shape[0]
    a_idx = torch.arange(num_angles, device=device, dtype=torch.int32).repeat_interleave(
        nxy * nxy * nz)
    ox = offs_xy.repeat_interleave(nxy * nz).repeat(num_angles)
    oy = offs_xy.repeat_interleave(nz).repeat(num_angles * nxy)
    oz = offs_z.repeat(num_angles * nxy * nxy)
    level, re = stack.level(depth - 1)
    scores = scorer(level, re, top_stride, size, cells, mask, a_idx, ox, oy, oz)
    scores = torch.where(yaw_alive[a_idx.long()], scores, torch.full_like(scores, -math.inf))

    total = scores.shape[0]
    beam = min(beam_width, total)
    width = 8 * beam
    dropped = torch.full((), -math.inf, device=device)
    if total > width:
        values, order = _top(scores, width + 1)
        dropped = values[width]
        scores, keep = values[:width], order[:width]
        a_idx, ox, oy, oz = a_idx[keep], ox[keep], oy[keep], oz[keep]
    else:
        pad = width - total
        a_idx, ox, oy, oz = (F.pad(x, (0, pad)) for x in (a_idx, ox, oy, oz))
        scores = F.pad(scores, (0, pad), value=-math.inf)

    for h in range(depth - 2, -1, -1):
        values, order = _top(scores, beam + 1)
        dropped = torch.maximum(dropped, values[beam])
        top, order = values[:beam], order[:beam]
        pa, px, py, pz = a_idx[order], ox[order], oy[order], oz[order]
        child = 1 << h
        a_idx = pa.repeat(8)
        # Children in the order of the JAX program's dx, dy, dz tables.
        ox = torch.cat([px + (k & 1) * child for k in range(8)])
        oy = torch.cat([py + ((k >> 1) & 1) * child for k in range(8)])
        oz = torch.cat([pz + (k >> 2) * child for k in range(8)])
        alive = (top > f32(min_score)).repeat(8)
        level, re = stack.level(h)
        scores = scorer(level, re, child, size, cells, mask, a_idx, ox, oy, oz)
        scores = torch.where(alive, scores, torch.full_like(scores, -math.inf))
    return a_idx, ox, oy, oz, scores, dropped


def _match_tail(stack, grid: Grid3D, low_grid: Grid3D, low_probability, cells, mask, low_cells,
                low_mask, yaw_alive, rot_scores, yaw_qs_abs, init_translation, w_xy, w_z,
                num_angles, params: FastCorrelativeMatcherParams3D, min_score: float, plain):
    """Translation search, low-resolution gate and best-candidate selection
    (l.527-578). Returns the device vector [found, score, t (3), q (4),
    rotational score, low-resolution score, certified]."""
    scorer = score_plain if plain else score
    a_idx, ox, oy, oz, scores, dropped = _beam_candidates(
        stack, cells, mask, yaw_alive, w_xy, w_z, grid.size, num_angles, min_score,
        params.beam_width, scorer)
    k = min(64, scores.shape[0])
    values, order = _top(scores, min(k + 1, scores.shape[0]))
    if scores.shape[0] > k:
        dropped = torch.maximum(dropped, values[k])
    top, order = values[:k], order[:k]
    la, lx, ly, lz = a_idx[order], ox[order], oy[order], oz[order]
    ratio = f32(grid.resolution / low_grid.resolution)
    low_off = [torch.round(x.to(torch.float32) * ratio).to(torch.int32) for x in (lx, ly, lz)]
    low_scores = scorer(low_probability, 0, 1, low_grid.size, low_cells, low_mask, la, *low_off)
    gated = torch.where(low_scores >= f32(params.min_low_resolution_score), top,
                        torch.full_like(top, -math.inf))
    best = torch.argmax(gated)
    best_score = gated[best]
    offset = torch.stack([lx[best], ly[best], lz[best]]).to(torch.float32) * f32(
        grid.resolution)
    a_best = la[best].long()
    certified = (best_score >= dropped) | (dropped <= f32(min_score))
    return torch.cat([(best_score > f32(min_score)).to(torch.float32)[None], best_score[None],
                      init_translation + offset, quat.normalize(yaw_qs_abs[a_best]),
                      rot_scores[a_best][None], low_scores[best][None],
                      certified.to(torch.float32)[None]])


def _pad_pow2(points: torch.Tensor, mask: torch.Tensor):
    n = points.shape[0]
    p = max(2, 1 << (n - 1).bit_length())
    if p == n:
        return points.contiguous(), mask.contiguous()
    return (torch.cat([points, points.new_zeros((p - n, 3))]).contiguous(),
            torch.cat([mask, mask.new_zeros(p - n)]).contiguous())


def angular_step_3d(points: torch.Tensor, mask: torch.Tensor, resolution: float) -> torch.Tensor:
    """Data-dependent angular step from the cloud's largest range (l.489-491),
    a 0-d tensor on the cloud's device."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    ranges = torch.sqrt(x * x + y * y + z * z)
    max_range = torch.clamp(torch.max(torch.where(mask, ranges, torch.zeros_like(ranges))),
                            min=f32(3.0 * resolution))
    ratio = true_div(torch.full_like(max_range, f32(resolution**2)),
                     2.0 * (max_range * max_range))
    return f32(1.0 - 1e-3) * torch.arccos(1.0 - ratio)


def fast_correlative_match_3d(stack: PrecomputationStack3D, grid: Grid3D, low_grid: Grid3D,
                              points: torch.Tensor, mask: torch.Tensor,
                              low_points: torch.Tensor, low_mask: torch.Tensor,
                              scan_histogram: torch.Tensor, submap_histogram: torch.Tensor,
                              initial_translation: torch.Tensor, initial_rotation: torch.Tensor,
                              params: FastCorrelativeMatcherParams3D, min_score: float,
                              low_probability: Optional[torch.Tensor] = None,
                              plain: bool = False) -> torch.Tensor:
    """The local-window search around a pose estimate in the grid frame
    (the JAX package's beam path). `points` (N, 3) and `low_points` (Nl, 3)
    are the node's clouds with masks; `low_probability` is the low grid's
    probability volume when the caller caches it. Returns the device vector
    [found, score, t (3), q (4), rotational score, low-resolution score,
    certified]. `plain` runs the twins of K13 and K15 on any device."""
    res = grid.resolution
    num_angles = params.static_num_angles(res)
    device = points.device
    points, mask = _pad_pow2(points, mask)
    low_points, low_mask = _pad_pow2(low_points, low_mask)
    step = angular_step_3d(points, mask, res)
    half = (num_angles - 1) // 2
    deltas = (torch.arange(num_angles, dtype=torch.float32, device=device) - half) * step
    angle_valid = torch.abs(deltas) <= f32(params.angular_search_window + 1e-6)
    matcher = match_histograms_plain if plain else match_histograms
    initial_yaw = quat.get_yaw(initial_rotation)
    rot_scores = matcher(submap_histogram, scan_histogram, initial_yaw + deltas)
    yaw_alive = angle_valid & (rot_scores >= f32(params.min_rotational_score))
    yaw_qs = quat.from_yaw(deltas).contiguous()
    disc = discretize_plain if plain else discretize
    cells = disc(points, yaw_qs, initial_rotation, initial_translation, grid.origin, res)
    low_cells = disc(low_points, yaw_qs, initial_rotation, initial_translation, low_grid.origin,
                     low_grid.resolution)
    if low_probability is None:
        low_probability = low_grid.probability()
    w_xy = int(math.ceil(params.linear_xy_search_window / res))
    w_z = int(math.ceil(params.linear_z_search_window / res))
    return _match_tail(stack, grid, low_grid, low_probability, cells, mask, low_cells, low_mask,
                       yaw_alive, rot_scores, quat.multiply(yaw_qs, initial_rotation[None, :]),
                       initial_translation, w_xy, w_z, num_angles, params, min_score, plain)


def full_circle_yaws(resolution: float, max_scan_range: float) -> int:
    """The yaw count of a full-circle search at the reference's angular step
    (GenerateDiscreteScans with angular window pi), at most 4096."""
    step = (1.0 - 1e-3) * math.acos(1.0 - resolution**2 / (2.0 * max_scan_range**2))
    return min(2 * int(math.ceil(math.pi / step)) + 1, 4096)


def match_full_submap_3d(stack: PrecomputationStack3D, grid: Grid3D, low_grid: Grid3D,
                         points: torch.Tensor, mask: torch.Tensor, low_points: torch.Tensor,
                         low_mask: torch.Tensor, scan_histogram: torch.Tensor,
                         submap_histogram: torch.Tensor, node_rotation: torch.Tensor,
                         submap_rotation: torch.Tensor, params: FastCorrelativeMatcherParams3D,
                         min_score: float, top_k_yaws: int = 64, extra_window_cells: int = 4,
                         low_probability: Optional[torch.Tensor] = None,
                         plain: bool = False) -> torch.Tensor:
    """MatchFullSubmap: the search with no pose prior (l.581-674). The yaw
    axis covers the full circle, scored by the rotational histograms; the
    `top_k_yaws` best yaws passing the rotational gate enter the
    translation search over the whole grid (half its size plus
    `extra_window_cells`) from its center. Returns the vector of
    `fast_correlative_match_3d`, the pose in the grid frame; `certified`
    also requires that no yaw passing the gate was left out."""
    res, size, device = grid.resolution, grid.size, points.device
    points, mask = _pad_pow2(points, mask)
    low_points, low_mask = _pad_pow2(low_points, low_mask)
    q_rel = quat.normalize(quat.multiply(quat.conjugate(submap_rotation), node_rotation))
    center = grid.origin + f32(0.5 * size * res)
    n_yaws = full_circle_yaws(res, params.max_scan_range)
    deltas = ((torch.arange(n_yaws, dtype=torch.float32, device=device) - n_yaws // 2)
              * f32(2.0 * math.pi / n_yaws))
    matcher = match_histograms_plain if plain else match_histograms
    rot_all = matcher(submap_histogram, scan_histogram, quat.get_yaw(q_rel) + deltas)
    alive_all = rot_all >= f32(params.min_rotational_score)
    ranked = torch.where(alive_all, rot_all, torch.full_like(rot_all, -math.inf))
    k = min(top_k_yaws, n_yaws)
    _, sel = _top(ranked, k)
    yaw_qs = quat.from_yaw(deltas[sel]).contiguous()
    disc = discretize_plain if plain else discretize
    cells = disc(points, yaw_qs, q_rel, center, grid.origin, res)
    low_cells = disc(low_points, yaw_qs, q_rel, center, low_grid.origin, low_grid.resolution)
    if low_probability is None:
        low_probability = low_grid.probability()
    w = size // 2 + extra_window_cells
    out = _match_tail(stack, grid, low_grid, low_probability, cells, mask, low_cells, low_mask,
                      alive_all[sel], rot_all[sel], quat.multiply(yaw_qs, q_rel[None, :]),
                      center, w, w, k, params, min_score, plain)
    certified = (out[11] > 0.5) & (alive_all.sum() <= k)
    return torch.cat([out[:11], certified.to(torch.float32)[None]])


def match_full_submap_3d_exact(stack: PrecomputationStack3D, grid: Grid3D, low_grid: Grid3D,
                               points, mask, low_points, low_mask, scan_histogram,
                               submap_histogram, node_rotation, submap_rotation,
                               params: FastCorrelativeMatcherParams3D, min_score: float,
                               max_beam: int = 32768, max_yaws: int = 512,
                               low_probability: Optional[torch.Tensor] = None,
                               plain: bool = False):
    """Certified MatchFullSubmap by widening (l.685-721): rerun with a
    doubled beam and yaw budget until the certificate holds or both budgets
    cap out. Returns (found, score, translation (3,), rotation (4,),
    rotational score, low-resolution score, certified) as host values, one
    blocking copy per round."""
    if low_probability is None:
        low_probability = low_grid.probability()
    beam, top_k = params.beam_width, 64
    while True:
        p = dataclasses.replace(params, beam_width=beam)
        out = match_full_submap_3d(
            stack, grid, low_grid, points, mask, low_points, low_mask, scan_histogram,
            submap_histogram, node_rotation, submap_rotation, p, min_score, top_k_yaws=top_k,
            low_probability=low_probability, plain=plain).cpu().numpy()
        certified = bool(out[11] > 0.5)
        if certified or (beam >= max_beam and top_k >= max_yaws):
            return (bool(out[0] > 0.5), float(out[1]), out[2:5].astype(np.float64),
                    out[5:9].astype(np.float64), float(out[9]), float(out[10]), certified)
        beam = min(2 * beam, max_beam)
        top_k = min(2 * top_k, max_yaws)
