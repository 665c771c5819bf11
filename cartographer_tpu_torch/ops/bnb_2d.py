"""Fast correlative (loop-closure) 2D matching: the max-pool precomputation
pyramid and the level-synchronous branch and bound.

Counterpart of the JAX package's `ops/bnb_2d.py`
(fast_correlative_scan_matcher_2d.cc), implementing its beam path (l.147-228)
and `match_full_submap_exact` (l.398); the TPU's dense-bound form
`_match_dense` is not ported. Level h of the pyramid holds the max of the
probability grid over [x, x+2^h) x [y, y+2^h), padded with UNKNOWN at the
high edge. The search scores every (angle, offset) candidate of the top
level on the coarsest level, keeps the best `beam_width`, splits each into
its 4 children and rescores them one level finer, down to level 0. A level's
value bounds every leaf below it, so the result is certified optimal when
the best leaf scores at least the largest bound the beam dropped.

`build_precomputation_pyramid` launches the CUDA kernel `csrc/bnb_2d.cu`
`bnb_pyramid` (K6) and `score_candidates` its `bnb_score` (K7) on CUDA
tensors; CPU tensors take their plain twins. On a `TsdfGrid2D` level 0 is
its score surface (K6's TSDF form, `bnb_pyramid_tsdf`), as the JAX
constraint builder builds it from `grid.probability()`. The beam selection is a stable
sort (value descending, index ascending: the order of `lax.top_k`), the same
on both paths. The point axis is summed as the same pairwise halving tree on
both, so on the card the twin's scores are bit-equal to the kernel's.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from cartographer_tpu_torch.ops import cuda
from cartographer_tpu_torch.ops.correlative_2d import (
    candidate_cells,
    pad_points,
    static_num_angles,
    tree_sum,
)
from cartographer_tpu_torch.ops.grid_2d import Grid2D
from cartographer_tpu_torch.ops.probability import UNKNOWN_PROBABILITY

# One pyramid kernel per surface form (Grid2D.SURFACE, TsdfGrid2D.SURFACE).
_PYRAMIDS = {
    "occupancy": cuda.CudaKernel(
        "bnb_2d.cu", "bnb_pyramid",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
    "tsdf": cuda.CudaKernel(
        "bnb_2d.cu", "bnb_pyramid_tsdf",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p])}
_SCORE = cuda.CudaKernel(
    "bnb_2d.cu", "bnb_score",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])

MAX_POINTS = 1024  # the kernel keeps one float per (padded) point of each warp in shared memory


@dataclasses.dataclass(frozen=True)
class FastCorrelativeMatcherParams2D:
    linear_search_window: float = 7.0
    angular_search_window: float = math.radians(30.0)
    branch_and_bound_depth: int = 7
    beam_width: int = 4096
    max_scan_range: float = 30.0  # static bound of the angular candidate count

    def static_num_angles(self, resolution: float) -> int:
        return static_num_angles(self.angular_search_window, self.max_scan_range, resolution)


# ---------------------------------------------------------------- K6


def pyramid_plain(grid, depth: int) -> torch.Tensor:
    """The plain twin of K6: log-doubling with UNKNOWN padding, as l.60-78."""
    current = grid.probability()
    levels = [current]
    for h in range(1, depth):
        shift = 1 << (h - 1)
        shifted_x = F.pad(current[shift:, :], (0, 0, 0, shift), value=UNKNOWN_PROBABILITY)
        m = torch.maximum(current, shifted_x)
        shifted_y = F.pad(m[:, shift:], (0, shift), value=UNKNOWN_PROBABILITY)
        current = torch.maximum(m, shifted_y)
        levels.append(current)
    return torch.stack(levels)


def build_precomputation_pyramid(grid, depth: int) -> torch.Tensor:
    """(depth, S, S) pyramid of a Grid2D's probabilities or a TsdfGrid2D's
    score surface (PrecomputationGridStack2D,
    fast_correlative_scan_matcher_2d.cc:91-186)."""
    if not grid.origin.is_cuda:
        return pyramid_plain(grid, depth)
    size = grid.size
    out = torch.empty((depth, size, size), dtype=torch.float32, device=grid.origin.device)
    _PYRAMIDS[grid.SURFACE](out.device, *grid.surface_args(), size, depth, out.data_ptr())
    return out


# ---------------------------------------------------------------- K7


def score_candidates_plain(level: torch.Tensor, cells: torch.Tensor, mask: torch.Tensor,
                           a_idx: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor
                           ) -> torch.Tensor:
    """The plain twin of K7: mean level value under each candidate (B,),
    out-of-map cells UNKNOWN (`_score_candidates`, l.81)."""
    size = level.shape[-1]
    cx = cells[a_idx.long(), :, 0] + ox.long()[:, None]  # (B, N)
    cy = cells[a_idx.long(), :, 1] + oy.long()[:, None]
    inside = (cx >= 0) & (cx < size) & (cy >= 0) & (cy < size)
    lin = torch.clamp(cx, 0, size - 1) * size + torch.clamp(cy, 0, size - 1)
    p = torch.where(inside, level.reshape(-1)[lin],
                    torch.full(lin.shape, UNKNOWN_PROBABILITY, device=level.device))
    total = tree_sum(torch.where(mask[None, :], p, torch.zeros_like(p)))
    return total / torch.clamp(mask.sum(), min=1).to(torch.float32)


def score_candidates(level: torch.Tensor, cells: torch.Tensor, mask: torch.Tensor,
                     a_idx: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor) -> torch.Tensor:
    """Mean probability of candidates (a_idx, ox, oy) (B,) on one pyramid
    level; `cells` (A, N, 2) are the scan's cells at each angle, `mask` (N,)
    with N a power of two."""
    if not level.is_cuda:
        return score_candidates_plain(level, cells, mask, a_idx, ox, oy)
    size = level.shape[-1]
    a_n, n = cells.shape[0], cells.shape[1]
    b = a_idx.shape[0]
    if n > MAX_POINTS or n & (n - 1):
        raise ValueError(f"bnb_score: the point count must be a power of two <= {MAX_POINTS}")
    cuda.check(level, "level", torch.float32, (size, size))
    cuda.check(cells, "cells", torch.int32, (a_n, n, 2))
    cuda.check(mask, "mask", torch.bool, (n,))
    for name, t in (("a_idx", a_idx), ("ox", ox), ("oy", oy)):
        cuda.check(t, name, torch.int32, (b,))
    out = torch.empty(b, dtype=torch.float32, device=level.device)
    _SCORE(level.device, level.data_ptr(), size, cells.data_ptr(), n, mask.data_ptr(),
           a_idx.data_ptr(), ox.data_ptr(), oy.data_ptr(), b, out.data_ptr())
    return out


# ---------------------------------------------------------------- the search


def _top(scores: torch.Tensor, k: int):
    """(values, indices) of the k largest, ties to the lower index (lax.top_k)."""
    values, order = torch.sort(scores, descending=True, stable=True)
    return values[:k], order[:k]


def fast_correlative_match_2d(pyramid: torch.Tensor, grid: Grid2D, points: torch.Tensor,
                              mask: torch.Tensor, initial_pose: torch.Tensor,
                              params: FastCorrelativeMatcherParams2D, min_score: float,
                              linear_window_override: Optional[float] = None,
                              score=None) -> torch.Tensor:
    """Level-synchronous branch and bound (the JAX package's beam path).

    `pyramid` (depth, S, S) from build_precomputation_pyramid; `grid` gives
    the origin and resolution; `points` (N, 2) in the node's gravity-aligned
    frame with `mask` (N,); `initial_pose` (3,) the pose estimate in the grid
    frame. Returns a device vector [score, x, y, theta, found, certified]:
    `certified` holds when no subtree the beam dropped can hold a better leaf
    than the one found (the reference's exact DFS result on this input).
    `score` replaces the candidate scorer (a comparison passes the plain
    twin on the card)."""
    score = score or score_candidates
    depth = pyramid.shape[0]
    res, device = grid.resolution, points.device
    num_angles = params.static_num_angles(res)
    window = (params.linear_search_window if linear_window_override is None
              else linear_window_override)
    w_cells = int(math.ceil(window / res))
    points, mask = pad_points(points, mask)
    deltas, angle_valid, cells = candidate_cells(grid, points, mask, initial_pose, num_angles,
                                                 params.angular_search_window)
    index_type = torch.int32
    cells = cells.to(index_type).contiguous()

    top_stride = 1 << (depth - 1)
    num_off = 2 * ((w_cells + top_stride - 1) // top_stride) + 1
    offs = ((torch.arange(num_off, device=device) - num_off // 2) * top_stride
            - top_stride // 2).to(index_type)
    a_idx = torch.arange(num_angles, device=device, dtype=index_type).repeat_interleave(
        num_off * num_off)
    ox = offs.repeat_interleave(num_off).repeat(num_angles)
    oy = offs.repeat(num_angles * num_off)
    scores = score(pyramid[depth - 1], cells, mask, a_idx, ox, oy)
    neg_inf = torch.full_like(scores, -math.inf)
    scores = torch.where(angle_valid[a_idx.long()], scores, neg_inf)

    beam = params.beam_width
    cand = beam * 4
    total = scores.shape[0]
    k0 = min(cand, total)
    values, order = _top(scores, min(k0 + 1, total))
    dropped = values[k0] if k0 < total else torch.full((), -math.inf, device=device)
    pad = cand - k0
    a_idx = F.pad(a_idx[order[:k0]], (0, pad))
    ox = F.pad(ox[order[:k0]], (0, pad))
    oy = F.pad(oy[order[:k0]], (0, pad))
    scores = F.pad(values[:k0], (0, pad), value=-math.inf)

    for h in range(depth - 2, -1, -1):
        values, order = _top(scores, beam + 1)
        dropped = torch.maximum(dropped, values[beam])
        top, order = values[:beam], order[:beam]
        a_sel, ox_sel, oy_sel = a_idx[order], ox[order], oy[order]
        child = 1 << h
        a_idx = a_sel.repeat(4)
        ox = torch.cat([ox_sel, ox_sel + child, ox_sel, ox_sel + child])
        oy = torch.cat([oy_sel, oy_sel, oy_sel + child, oy_sel + child])
        alive = (top > min_score).repeat(4)
        scores = score(pyramid[h], cells, mask, a_idx, ox, oy)
        scores = torch.where(alive, scores, torch.full_like(scores, -math.inf))

    best = torch.argmax(scores)
    best_score = scores[best]
    shift = torch.stack([ox[best], oy[best]]).to(torch.float32)
    certified = (best_score >= dropped) | (dropped <= min_score)
    return torch.cat([best_score[None], initial_pose[0:2] + shift * res,
                      (initial_pose[2] + deltas[a_idx[best].long()])[None],
                      (best_score > min_score).to(torch.float32)[None],
                      certified.to(torch.float32)[None]])


def full_submap_window(grid: Grid2D) -> float:
    """Half-extent window of a full-submap search (MatchFullSubmap,
    fast_correlative_scan_matcher_2d.cc:210-225)."""
    return 0.5 * grid.size * grid.resolution * 0.7


def grid_center_pose(grid: Grid2D) -> torch.Tensor:
    """[x, y, 0] at the grid's center, the full-submap search's start."""
    center = grid.origin + 0.5 * grid.size * grid.resolution
    return torch.cat([center, torch.zeros(1, device=center.device)])


def match_full_submap_exact(pyramid: torch.Tensor, grid: Grid2D, points: torch.Tensor,
                            mask: torch.Tensor, params: FastCorrelativeMatcherParams2D,
                            min_score: float, max_beam: int = 65536):
    """Exact MatchFullSubmap by beam widening: rerun the search over the
    whole submap with a doubled beam until the result is certified (or
    `max_beam`). Returns (found, score, pose (3,) numpy, certified) as host
    values: one blocking fetch per round."""
    window = full_submap_window(grid)
    init = grid_center_pose(grid)
    beam = params.beam_width
    while True:
        p = dataclasses.replace(params, beam_width=beam)
        out = fast_correlative_match_2d(pyramid, grid, points, mask, init, p, min_score,
                                        linear_window_override=window).cpu().numpy()
        if out[5] > 0.5 or beam >= max_beam:
            return bool(out[4] > 0.5), float(out[0]), out[1:4].astype(float), bool(out[5] > 0.5)
        beam *= 2
