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
(K14). `fast_correlative_match_3d_batch` runs the local searches of a group
of pairs and `match_full_submap_3d_batch` a wave of full-submap ones: a
prelude (`local_searches`, `full_searches`: the angular steps, the yaws and
their rotational scores, K13) and then one launch of `bnb3d_descent` (K15)
for the whole group, the per-yaw discretization of the clouds, every
level's scoring and beam selection and the low-resolution gate included;
the one-pair entry points are their groups of one. CPU tensors, or
`plain`, take the plain twin (`_match_tail`: the descent level by level,
each selection a stable `torch.sort`, value descending and index
ascending: the order of `lax.top_k`). The kernel keeps the twin's order of
operations (the rotations, the pairwise halving tree over the points, the
selections' order), so on the card its rows equal the twin's bit for bit.
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
from cartographer_tpu_torch.ops.correlative_2d import pad_points, tree_sum
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

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STACK = cuda.CudaKernel("bnb_3d.cu", "bnb3d_stack",
                         [_P, _P, _I, _I, _I, _F, _F, _P, _P, _P, _P])


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


def score_plain(level: torch.Tensor, re: int, window: int, size: int, cells: torch.Tensor,
                mask: torch.Tensor, a_idx: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor,
                oz: torch.Tensor) -> torch.Tensor:
    """The plain twin of K15's scorer (`_score_level` l.152; with a float
    level, window 1 and re 0, `_score_3d` l.724): the mean level value (B,)
    under the candidates (a_idx, ox, oy, oz). Point k of yaw a sits at
    cells[a, k] + offset, in full-resolution cells of a grid `size` wide; a
    candidate anchored `window` or more cells below the grid or beyond it
    reads UNKNOWN, others read the level at the clipped cell >> re. A uint8
    level is dequantized. The point count is a power of two."""
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


# ---------------------------------------------------------------- the search


@dataclasses.dataclass
class Search3D:
    """One pair's translation search as `_match_tail` and K15 take it: the
    stack and grids, the clouds (padded to powers of two), the yaws
    (rotations `yaw_q` applied after `q_init`, their gate and rotational
    scores), the start `translation` in the grid frame and the linear
    windows in cells."""

    stack: PrecomputationStack3D
    grid: Grid3D
    low_grid: Grid3D
    low_probability: torch.Tensor
    points: torch.Tensor  # (N, 3)
    mask: torch.Tensor
    low_points: torch.Tensor  # (Nl, 3)
    low_mask: torch.Tensor
    yaw_q: torch.Tensor  # (A, 4)
    q_init: torch.Tensor  # (4,)
    translation: torch.Tensor  # (3,)
    yaw_alive: torch.Tensor  # (A,) bool
    rot_scores: torch.Tensor  # (A,)
    w_xy: int
    w_z: int


def _top(scores: torch.Tensor, k: int):
    """(values, indices) of the k largest, ties to the lower index (lax.top_k)."""
    values, order = torch.sort(scores, descending=True, stable=True)
    return values[:k], order[:k]


def _num_off(w: int, top_stride: int) -> int:
    """Top-level offsets per axis across a window of w cells."""
    return 2 * ((w + top_stride - 1) // top_stride) + 1


def _scored(scorer, level, re, window, size, cells, mask, a_idx, ox, oy, oz, live):
    """The candidates' scores, -inf where not `live`: only the live ones
    are scored, as K15 skips the others."""
    out = torch.full(a_idx.shape, -math.inf, device=level.device)
    out[live] = scorer(level, re, window, size, cells, mask, a_idx[live], ox[live], oy[live],
                       oz[live])
    return out


def _beam_candidates(stack: PrecomputationStack3D, cells, mask, yaw_alive, w_xy: int,
                     w_z: int, size: int, num_angles: int, min_score: float, beam_width: int,
                     scorer):
    """The level-synchronous beam search from the stack top (l.182-278).
    Returns the leaf candidates (a_idx, ox, oy, oz, scores) and the largest
    bound the beam dropped."""
    depth, device = stack.depth, cells.device
    top_stride = 1 << (depth - 1)

    def offsets(w):
        n = _num_off(w, top_stride)
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
    scores = _scored(scorer, level, re, top_stride, size, cells, mask, a_idx, ox, oy, oz,
                     yaw_alive[a_idx.long()])

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
        scores = _scored(scorer, level, re, child, size, cells, mask, a_idx, ox, oy, oz, alive)
    return a_idx, ox, oy, oz, scores, dropped


def _unit(q: torch.Tensor) -> torch.Tensor:
    """q / |q|, the squares added in K15's order."""
    w, x, y, z = q.unbind(-1)
    return q / torch.sqrt(((w * w + x * x) + y * y) + z * z)[..., None]


def _match_tail(s: Search3D, params: FastCorrelativeMatcherParams3D, min_score: float,
                score=None) -> torch.Tensor:
    """The plain twin of K15 for one pair: the discretization, translation
    search, low-resolution gate and best-candidate selection (l.527-578),
    each level's candidates scored by `score` (default `score_plain`; a
    wrapper may record the work). Returns the device vector [found, score,
    t (3), q (4), rotational score, low-resolution score, certified]."""
    score = score or score_plain
    grid, low_grid = s.grid, s.low_grid
    cells = discretize_plain(s.points, s.yaw_q, s.q_init, s.translation, grid.origin,
                             grid.resolution)
    low_cells = discretize_plain(s.low_points, s.yaw_q, s.q_init, s.translation,
                                 low_grid.origin, low_grid.resolution)
    a_idx, ox, oy, oz, scores, dropped = _beam_candidates(
        s.stack, cells, s.mask, s.yaw_alive, s.w_xy, s.w_z, grid.size, s.yaw_q.shape[0],
        min_score, params.beam_width, score)
    k = min(64, scores.shape[0])
    values, order = _top(scores, min(k + 1, scores.shape[0]))
    if scores.shape[0] > k:
        dropped = torch.maximum(dropped, values[k])
    top, order = values[:k], order[:k]
    la, lx, ly, lz = a_idx[order], ox[order], oy[order], oz[order]
    ratio = f32(grid.resolution / low_grid.resolution)
    low_off = [torch.round(x.to(torch.float32) * ratio).to(torch.int32) for x in (lx, ly, lz)]
    low_scores = score(s.low_probability, 0, 1, low_grid.size, low_cells, s.low_mask, la,
                       *low_off)
    gated = torch.where(low_scores >= f32(params.min_low_resolution_score), top,
                        torch.full_like(top, -math.inf))
    best = torch.argmax(gated)
    best_score = gated[best]
    offset = torch.stack([lx[best], ly[best], lz[best]]).to(torch.float32) * f32(
        grid.resolution)
    a_best = la[best].long()
    certified = (best_score >= dropped) | (dropped <= f32(min_score))
    return torch.cat([(best_score > f32(min_score)).to(torch.float32)[None], best_score[None],
                      s.translation + offset, _unit(quat.multiply(s.yaw_q[a_best], s.q_init)),
                      s.rot_scores[a_best][None], low_scores[best][None],
                      certified.to(torch.float32)[None]])


_DESCENT = cuda.CudaKernel(
    "bnb_3d.cu", "bnb3d_descent",
    [_P, _P] + [_I] * 7 + [_P] * 9 + [_F] * 7 + [_P] * 4 + [ctypes.c_longlong, _P, _I]
    + [_P] * 4)


def descent_inputs(searches, points: torch.Tensor, mask: torch.Tensor,
                   low_points: torch.Tensor, low_mask: torch.Tensor):
    """The torch glue of a group's launch: the pairs' yaw data stacked, and
    their tables. `points` (B, N, 3) and `low_points` (B, Nl, 3) with their
    masks are the pairs' padded clouds. -> dict of the launch's inputs."""
    s0 = searches[0]
    res, low_res = s0.grid.resolution, s0.low_grid.resolution
    depth, frd = s0.stack.depth, s0.stack.full_resolution_depth
    for s in searches:
        if (s.grid.resolution, s.low_grid.resolution) != (res, low_res):
            raise ValueError("bnb3d_descent: the pairs' grids must share their resolutions")
        if (s.stack.depth, s.stack.full_resolution_depth) != (depth, frd):
            raise ValueError("bnb3d_descent: the pairs' stacks must share their depths")
        if s.yaw_q.shape[0] != s0.yaw_q.shape[0]:
            raise ValueError("bnb3d_descent: the pairs must share their yaw count")
    top_stride = 1 << (depth - 1)
    dims = np.array([[s.grid.size, s.low_grid.size, _num_off(s.w_xy, top_stride),
                      _num_off(s.w_z, top_stride)] for s in searches], np.int32)
    stacked = {name: torch.stack([getattr(s, name) for s in searches]).contiguous()
               for name in ("yaw_q", "q_init", "translation", "yaw_alive", "rot_scores")}
    return dict(searches=searches, dims=dims, depth=depth, frd=frd, res=res, low_res=low_res,
                points=points.contiguous(), mask=mask.contiguous(),
                low_points=low_points.contiguous(), low_mask=low_mask.contiguous(), **stacked)


def descent_launch(d, params: FastCorrelativeMatcherParams3D, min_score: float) -> torch.Tensor:
    """One launch of K15 on `descent_inputs` (one per 64 pairs above that):
    -> (B, 12) rows [found, score, t (3), q (4), rotational score,
    low-resolution score, certified]."""
    searches, dims = d["searches"], d["dims"]
    points, low_points = d["points"], d["low_points"]
    pairs, n, nl = points.shape[0], points.shape[1], low_points.shape[1]
    angles = d["yaw_q"].shape[1]
    depth, frd, beam = d["depth"], d["frd"], params.beam_width
    cuda.check(points, "points", torch.float32, (pairs, n, 3))
    cuda.check(d["mask"], "mask", torch.bool, (pairs, n))
    cuda.check(low_points, "low_points", torch.float32, (pairs, nl, 3))
    cuda.check(d["low_mask"], "low_mask", torch.bool, (pairs, nl))
    for name, dtype, inner in (("yaw_q", torch.float32, (angles, 4)),
                               ("q_init", torch.float32, (4,)),
                               ("translation", torch.float32, (3,)),
                               ("yaw_alive", torch.bool, (angles,)),
                               ("rot_scores", torch.float32, (angles,))):
        cuda.check(d[name], name, dtype, (pairs, *inner))
    if n & (n - 1) or nl & (nl - 1):
        raise ValueError("bnb3d_descent: the point counts must be powers of two")
    for s, (size, low_size, _, _) in zip(searches, dims):
        cuda.check(s.stack.full, "stack.full", torch.uint8, (frd, size, size, size))
        half = size // 2
        cuda.check(s.stack.coarse, "stack.coarse", torch.uint8, (depth - frd, half, half, half))
        cuda.check(s.low_probability, "low_probability", torch.float32, (low_size,) * 3)
        cuda.check(s.grid.origin, "origin", torch.float32, (3,))
        cuda.check(s.low_grid.origin, "low origin", torch.float32, (3,))
    device = points.device
    top = [angles * int(nxy) * int(nxy) * int(nz) for _, _, nxy, nz in dims]
    mmax = max(max(m, 8 * min(beam, m)) for m in top) if pairs else 1
    pstride = max(beam, 64)
    i32 = dict(dtype=torch.int32, device=device)
    cells = torch.empty((pairs, angles, n, 4), **i32)
    low_cells = torch.empty((pairs, angles, nl, 4), **i32)
    counts = torch.empty((pairs, 2), **i32)
    items = torch.empty((pairs, 2, mmax, 2), **i32)
    parents = torch.empty((pairs, 2, pstride, 4), **i32)
    dropped = torch.empty(pairs, dtype=torch.float32, device=device)
    gate = torch.empty((pairs, 2, 64), dtype=torch.float32, device=device)
    barrier = torch.empty(2, **i32)
    out = torch.empty((pairs, 12), dtype=torch.float32, device=device)
    table = cuda.pointer_table([[s.stack.full, s.stack.coarse, s.low_probability, s.grid.origin,
                                 s.low_grid.origin] for s in searches])
    _DESCENT(device, table, dims.ctypes.data, pairs, depth, frd, beam, angles, n, nl,
             points.data_ptr(), d["mask"].data_ptr(), low_points.data_ptr(),
             d["low_mask"].data_ptr(), d["yaw_q"].data_ptr(), d["q_init"].data_ptr(),
             d["translation"].data_ptr(), d["yaw_alive"].data_ptr(), d["rot_scores"].data_ptr(),
             f32(d["res"]), f32(d["low_res"]),
             f32(d["res"] / d["low_res"]), f32(min_score),
             f32(params.min_low_resolution_score), f32(Q_SCALE), f32(MIN_PROBABILITY),
             cells.data_ptr(), low_cells.data_ptr(), counts.data_ptr(), items.data_ptr(), mmax,
             parents.data_ptr(), pstride, dropped.data_ptr(), gate.data_ptr(),
             barrier.data_ptr(), out.data_ptr())
    return out


def _match(searches, points, mask, low_points, low_mask, params, min_score, plain):
    """(B, 12) rows of the searches: one launch of K15 for the group on CUDA
    tensors, the plain twin pair by pair on CPU tensors or with `plain`."""
    if plain or not points.is_cuda:
        return torch.stack([_match_tail(s, params, min_score) for s in searches])
    return descent_launch(descent_inputs(searches, points, mask, low_points, low_mask), params,
                          min_score)


def angular_step_3d(points: torch.Tensor, mask: torch.Tensor, resolution: float) -> torch.Tensor:
    """Data-dependent angular step from the cloud's largest range (l.489-491):
    of clouds (..., N, 3) with masks (..., N), a (...) tensor on their
    device."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    ranges = torch.sqrt(x * x + y * y + z * z)
    max_range = torch.clamp(torch.amax(torch.where(mask, ranges, torch.zeros_like(ranges)), -1),
                            min=f32(3.0 * resolution))
    ratio = true_div(torch.full_like(max_range, f32(resolution**2)),
                     2.0 * (max_range * max_range))
    return f32(1.0 - 1e-3) * torch.arccos(1.0 - ratio)


def _low_probabilities(low_grids, low_probabilities):
    if low_probabilities is None:
        low_probabilities = [None] * len(low_grids)
    return [g.probability() if p is None else p for g, p in zip(low_grids, low_probabilities)]


def _chunks(points: torch.Tensor, grids):
    """The pairs whose preludes run as one batch of tensor operations: the
    whole group on CUDA tensors (the operations are elementwise or a max,
    so each pair's values equal its own call's); one pair at a time on CPU
    tensors, where a vectorized cos or arccos may round a value apart from
    the scalar code that takes the same value at another index, or where
    the pairs' resolutions differ."""
    if points.is_cuda and len({g.resolution for g in grids}) == 1:
        return [slice(0, len(grids))]
    return [slice(b, b + 1) for b in range(len(grids))]


def local_searches(stacks, grids, low_grids, points: torch.Tensor, mask: torch.Tensor,
                   low_points: torch.Tensor, low_mask: torch.Tensor,
                   scan_histograms: torch.Tensor, submap_histograms,
                   initial_translations: torch.Tensor, initial_rotations: torch.Tensor,
                   params: FastCorrelativeMatcherParams3D, low_probabilities=None,
                   plain: bool = False):
    """The prelude of a group's local-window searches (l.449-525): the
    clouds padded to powers of two, then the angular steps, the yaws and,
    pair by pair, their rotational scores (K13; its twin with `plain`),
    for the group at once on CUDA tensors (`_chunks`).
    -> ([Search3D], (points, mask, low_points, low_mask) padded)."""
    points, mask = pad_points(points, mask)
    low_points, low_mask = pad_points(low_points, low_mask)
    matcher = match_histograms_plain if plain else match_histograms
    lows = _low_probabilities(low_grids, low_probabilities)
    searches = []
    for chunk in _chunks(points, grids):
        res = grids[chunk.start].resolution
        num_angles = params.static_num_angles(res)
        step = angular_step_3d(points[chunk], mask[chunk], res)
        half = (num_angles - 1) // 2
        deltas = (torch.arange(num_angles, dtype=torch.float32, device=points.device)
                  - half) * step[:, None]
        angle_valid = torch.abs(deltas) <= f32(params.angular_search_window + 1e-6)
        q_init = initial_rotations[chunk]
        angles = quat.get_yaw(q_init)[:, None] + deltas
        first = chunk.start
        rot_scores = torch.stack([matcher(submap_histograms[first + i], scan_histograms[first + i],
                                          angles[i]) for i in range(angles.shape[0])])
        alive = angle_valid & (rot_scores >= f32(params.min_rotational_score))
        yaw_q = quat.from_yaw(deltas).contiguous()
        for i in range(angles.shape[0]):
            b = first + i
            searches.append(Search3D(
                stacks[b], grids[b], low_grids[b], lows[b], points[b], mask[b], low_points[b],
                low_mask[b], yaw_q[i], q_init[i], initial_translations[b], alive[i],
                rot_scores[i], int(math.ceil(params.linear_xy_search_window / res)),
                int(math.ceil(params.linear_z_search_window / res))))
    return searches, (points, mask, low_points, low_mask)


def fast_correlative_match_3d_batch(stacks, grids, low_grids, points: torch.Tensor,
                                    mask: torch.Tensor, low_points: torch.Tensor,
                                    low_mask: torch.Tensor, scan_histograms: torch.Tensor,
                                    submap_histograms, initial_translations: torch.Tensor,
                                    initial_rotations: torch.Tensor,
                                    params: FastCorrelativeMatcherParams3D, min_score: float,
                                    low_probabilities=None, plain: bool = False
                                    ) -> torch.Tensor:
    """The local-window searches of a group of pairs (the JAX package's beam
    path): pair b searches its clouds `points[b]` (N, 3) and `low_points[b]`
    (Nl, 3) with their masks, from the pose (`initial_translations[b]`,
    `initial_rotations[b]`) in the frame of `grids[b]`, on `stacks[b]`
    (from build_precomputation_stack_3d of that grid) and `low_grids[b]`
    (`low_probabilities[b]` its probability volume, when the caller caches
    it). -> (B, 12) device rows [found, score, t (3), q (4), rotational
    score, low-resolution score, certified]. The prelude pair by pair
    (`local_searches`), then one launch of K15 for the group on CUDA tensors
    (one per 64 pairs), or the plain twins pair by pair on CPU tensors or
    with `plain` (K13's too)."""
    searches, clouds = local_searches(stacks, grids, low_grids, points, mask, low_points,
                                      low_mask, scan_histograms, submap_histograms,
                                      initial_translations, initial_rotations, params,
                                      low_probabilities, plain)
    return _match(searches, *clouds, params, min_score, plain)


def fast_correlative_match_3d(stack: PrecomputationStack3D, grid: Grid3D, low_grid: Grid3D,
                              points: torch.Tensor, mask: torch.Tensor,
                              low_points: torch.Tensor, low_mask: torch.Tensor,
                              scan_histogram: torch.Tensor, submap_histogram: torch.Tensor,
                              initial_translation: torch.Tensor, initial_rotation: torch.Tensor,
                              params: FastCorrelativeMatcherParams3D, min_score: float,
                              low_probability: Optional[torch.Tensor] = None,
                              plain: bool = False) -> torch.Tensor:
    """The local-window search around a pose estimate in the grid frame, the
    group of one of `fast_correlative_match_3d_batch`. `points` (N, 3) and
    `low_points` (Nl, 3) are the node's clouds with masks. Returns the
    device vector [found, score, t (3), q (4), rotational score,
    low-resolution score, certified]."""
    return fast_correlative_match_3d_batch(
        [stack], [grid], [low_grid], points[None], mask[None], low_points[None], low_mask[None],
        scan_histogram[None], [submap_histogram], initial_translation[None],
        initial_rotation[None], params, min_score, [low_probability], plain)[0]


def full_circle_yaws(resolution: float, max_scan_range: float) -> int:
    """The yaw count of a full-circle search at the reference's angular step
    (GenerateDiscreteScans with angular window pi), at most 4096."""
    step = (1.0 - 1e-3) * math.acos(1.0 - resolution**2 / (2.0 * max_scan_range**2))
    return min(2 * int(math.ceil(math.pi / step)) + 1, 4096)


def full_searches(stacks, grids, low_grids, points: torch.Tensor, mask: torch.Tensor,
                  low_points: torch.Tensor, low_mask: torch.Tensor,
                  scan_histograms: torch.Tensor, submap_histograms,
                  node_rotations: torch.Tensor, submap_rotations: torch.Tensor,
                  params: FastCorrelativeMatcherParams3D, top_k_yaws: int = 64,
                  extra_window_cells: int = 4, low_probabilities=None, plain: bool = False):
    """The per-pair prelude of a wave of full-submap searches (l.581-665):
    the clouds padded, then per pair the full circle's yaws scored by K13
    (its twin with `plain`) and the `top_k_yaws` best kept, the window the
    whole grid from its center. -> ([Search3D], (points, mask, low_points,
    low_mask) padded, (B,) whether no yaw passing the gate was left out)."""
    points, mask = pad_points(points, mask)
    low_points, low_mask = pad_points(low_points, low_mask)
    matcher = match_histograms_plain if plain else match_histograms
    lows = _low_probabilities(low_grids, low_probabilities)
    searches, complete = [], []
    for b, (stack, grid, low_grid) in enumerate(zip(stacks, grids, low_grids)):
        res, size = grid.resolution, grid.size
        q_rel = quat.normalize(quat.multiply(quat.conjugate(submap_rotations[b]),
                                             node_rotations[b]))
        center = grid.origin + f32(0.5 * size * res)
        n_yaws = full_circle_yaws(res, params.max_scan_range)
        deltas = ((torch.arange(n_yaws, dtype=torch.float32, device=points.device)
                   - n_yaws // 2) * f32(2.0 * math.pi / n_yaws))
        rot_all = matcher(submap_histograms[b], scan_histograms[b], quat.get_yaw(q_rel) + deltas)
        alive_all = rot_all >= f32(params.min_rotational_score)
        ranked = torch.where(alive_all, rot_all, torch.full_like(rot_all, -math.inf))
        k = min(top_k_yaws, n_yaws)
        _, sel = _top(ranked, k)
        yaw_q = quat.from_yaw(deltas[sel]).contiguous()
        w = size // 2 + extra_window_cells
        searches.append(Search3D(
            stack, grid, low_grid, lows[b], points[b], mask[b], low_points[b], low_mask[b],
            yaw_q, q_rel, center, alive_all[sel], rot_all[sel], w, w))
        complete.append(alive_all.sum() <= k)
    return searches, (points, mask, low_points, low_mask), torch.stack(complete)


def match_full_submap_3d_batch(stacks, grids, low_grids, points: torch.Tensor,
                               mask: torch.Tensor, low_points: torch.Tensor,
                               low_mask: torch.Tensor, scan_histograms: torch.Tensor,
                               submap_histograms, node_rotations: torch.Tensor,
                               submap_rotations: torch.Tensor,
                               params: FastCorrelativeMatcherParams3D, min_score: float,
                               top_k_yaws: int = 64, extra_window_cells: int = 4,
                               low_probabilities=None, plain: bool = False) -> torch.Tensor:
    """MatchFullSubmap for a wave of requests (l.581-674), the searches with
    no pose prior: pair b's yaw axis covers the full circle, scored by the
    rotational histograms; the `top_k_yaws` best yaws passing the rotational
    gate enter the translation search over the whole grid (half its size
    plus `extra_window_cells`) from its center (`full_searches`). -> (B, 12)
    rows as `fast_correlative_match_3d_batch`'s, the pose in the grid frame;
    `certified` also requires that no yaw passing the gate was left out.
    One launch of K15 for the wave on CUDA tensors."""
    searches, clouds, complete = full_searches(
        stacks, grids, low_grids, points, mask, low_points, low_mask, scan_histograms,
        submap_histograms, node_rotations, submap_rotations, params, top_k_yaws,
        extra_window_cells, low_probabilities, plain)
    rows = _match(searches, *clouds, params, min_score, plain)
    certified = (rows[:, 11] > 0.5) & complete
    return torch.cat([rows[:, :11], certified.to(torch.float32)[:, None]], 1)


def match_full_submap_3d(stack: PrecomputationStack3D, grid: Grid3D, low_grid: Grid3D,
                         points: torch.Tensor, mask: torch.Tensor, low_points: torch.Tensor,
                         low_mask: torch.Tensor, scan_histogram: torch.Tensor,
                         submap_histogram: torch.Tensor, node_rotation: torch.Tensor,
                         submap_rotation: torch.Tensor, params: FastCorrelativeMatcherParams3D,
                         min_score: float, top_k_yaws: int = 64, extra_window_cells: int = 4,
                         low_probability: Optional[torch.Tensor] = None,
                         plain: bool = False) -> torch.Tensor:
    """MatchFullSubmap for one request, the wave of one of
    `match_full_submap_3d_batch`: the row of the search."""
    return match_full_submap_3d_batch(
        [stack], [grid], [low_grid], points[None], mask[None], low_points[None], low_mask[None],
        scan_histogram[None], [submap_histogram], node_rotation[None], submap_rotation[None],
        params, min_score, top_k_yaws, extra_window_cells, [low_probability], plain)[0]


def match_full_submap_3d_exact_batch(stacks, grids, low_grids, points, mask, low_points,
                                     low_mask, scan_histograms, submap_histograms,
                                     node_rotations, submap_rotations,
                                     params: FastCorrelativeMatcherParams3D, min_score: float,
                                     max_beam: int = 32768, max_yaws: int = 512,
                                     low_probabilities=None, plain: bool = False):
    """Certified MatchFullSubmap by widening (l.685-721) for a wave of
    requests: each round runs every request not yet certified at the
    round's beam and yaw budget (all start at the configured beam and 64
    yaws and double together), one launch of K15 and one blocking copy a
    round, until the certificate holds or both budgets cap out. Returns per
    request (found, score, translation (3,), rotation (4,), rotational
    score, low-resolution score, certified) as host values."""
    lows = _low_probabilities(low_grids, low_probabilities)
    results = [None] * len(stacks)
    todo = list(range(len(stacks)))
    beam, top_k = params.beam_width, 64
    while todo:
        sel = (lambda x: x) if len(todo) == len(stacks) else (lambda x: x[todo])
        pick = lambda xs: [xs[i] for i in todo]  # noqa: E731
        rows = match_full_submap_3d_batch(
            pick(stacks), pick(grids), pick(low_grids), sel(points), sel(mask),
            sel(low_points), sel(low_mask), sel(scan_histograms), pick(submap_histograms),
            sel(node_rotations), sel(submap_rotations),
            dataclasses.replace(params, beam_width=beam), min_score, top_k_yaws=top_k,
            low_probabilities=pick(lows), plain=plain).cpu().numpy()
        last = beam >= max_beam and top_k >= max_yaws
        left = []
        for i, out in zip(todo, rows):
            certified = bool(out[11] > 0.5)
            if certified or last:
                results[i] = (bool(out[0] > 0.5), float(out[1]), out[2:5].astype(np.float64),
                              out[5:9].astype(np.float64), float(out[9]), float(out[10]),
                              certified)
            else:
                left.append(i)
        todo = left
        beam = min(2 * beam, max_beam)
        top_k = min(2 * top_k, max_yaws)
    return results


def match_full_submap_3d_exact(stack: PrecomputationStack3D, grid: Grid3D, low_grid: Grid3D,
                               points, mask, low_points, low_mask, scan_histogram,
                               submap_histogram, node_rotation, submap_rotation,
                               params: FastCorrelativeMatcherParams3D, min_score: float,
                               max_beam: int = 32768, max_yaws: int = 512,
                               low_probability: Optional[torch.Tensor] = None,
                               plain: bool = False):
    """Certified MatchFullSubmap by widening for one request: (found, score,
    translation (3,), rotation (4,), rotational score, low-resolution score,
    certified) as host values, one blocking copy per round."""
    return match_full_submap_3d_exact_batch(
        [stack], [grid], [low_grid], points[None], mask[None], low_points[None], low_mask[None],
        scan_histogram[None], [submap_histogram], node_rotation[None], submap_rotation[None],
        params, min_score, max_beam, max_yaws, [low_probability], plain)[0]
