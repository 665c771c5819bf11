"""Dense 2D occupancy grid and raycast insertion.

Counterpart of the JAX package's `ops/grid_2d.py` (mapping/2d/grid_2d.cc,
probability_grid_range_data_inserter_2d.cc): a fixed-size square float32
log-odds grid; a scan marks its hit cells and the free cells sampled along
every ray, and each cell changes at most once per scan, hit taking
precedence over free. The port implements the JAX package's scatter form.

`insert_into_slots` updates a batch of grids (the two active submaps) in
place: the JAX program donates the grids and returns new ones, here the
tensors are overwritten. On CUDA tensors it launches the kernel
`csrc/insert_2d.cu` (K4: a mark pass into per-slot bitmaps of 2 bits a
cell, kept in an `InsertScratch`, and a pass over the marked bitmap words),
on CPU tensors it runs the plain twin. With a
leading robot dimension on the scan (the cross-robot batched step), it
inserts R robots' scans into their own grids, wherever each robot keeps
them, in one launch; one robot is the R = 1 case.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from cartographer_tpu_torch.core.tensor import to_device, true_div
from cartographer_tpu_torch.ops import cuda
from cartographer_tpu_torch.ops.probability import (
    MAX_LOG_ODDS,
    MIN_LOG_ODDS,
    UNKNOWN_PROBABILITY,
    clamp_log_odds,
    log_odds_to_probability,
    probability_to_log_odds,
)
from cartographer_tpu_torch.sensor.point_cloud import RangeData

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_KERNEL = cuda.CudaKernel(
    "insert_2d.cu", "insert_2d",
    [_P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _F, _I, _I, _I, _I, _F, _F, _F, _F])


@dataclasses.dataclass(frozen=True)
class Grid2D:
    """Square log-odds occupancy grid in a local (submap) frame.

    Cell (i, j) covers world [origin + (i, j) * resolution, + resolution);
    i indexes x, j indexes y. `known` marks ever-updated cells. A batch of
    grids carries a leading dimension on every tensor field.
    """

    log_odds: torch.Tensor  # (..., S, S) float32
    known: torch.Tensor  # (..., S, S) bool
    origin: torch.Tensor  # (..., 2) float32, world position of cell (0, 0) corner
    resolution: float

    # The form of the matching kernels (K3, K5, K6) that reads this grid's
    # surface; TsdfGrid2D has "tsdf".
    SURFACE = "occupancy"

    @staticmethod
    def create(size: int, resolution: float, center, device) -> "Grid2D":
        origin = np.asarray(center, np.float32) - np.float32(0.5 * size * resolution)
        return Grid2D(
            log_odds=torch.zeros((size, size), dtype=torch.float32, device=device),
            known=torch.zeros((size, size), dtype=torch.bool, device=device),
            origin=to_device(origin.astype(np.float32), device),
            resolution=resolution,
        )

    @property
    def size(self) -> int:
        return self.log_odds.shape[-1]

    def slot(self, i: int) -> "Grid2D":
        """Grid i of a batch (views of the batch's tensors)."""
        return Grid2D(self.log_odds[i], self.known[i], self.origin[i], self.resolution)

    def clone(self) -> "Grid2D":
        return Grid2D(self.log_odds.clone(), self.known.clone(), self.origin.clone(),
                      self.resolution)

    def world_to_cell_continuous(self, points: torch.Tensor) -> torch.Tensor:
        """World (..., 2) -> fractional cell coordinates (cell centers at .5)."""
        return true_div(points - self.origin, self.resolution)

    def score_at(self, ii: torch.Tensor, jj: torch.Tensor) -> torch.Tensor:
        """The matchers' surface at cells (ii, jj), all inside the grid: the
        probability, UNKNOWN_PROBABILITY where never updated."""
        lo = self.log_odds[..., ii, jj]
        return torch.where(self.known[..., ii, jj], log_odds_to_probability(lo),
                           torch.full_like(lo, UNKNOWN_PROBABILITY))

    def probability(self) -> torch.Tensor:
        """(S, S) the matchers' surface: the probability, UNKNOWN_PROBABILITY
        where never updated."""
        return torch.where(self.known, log_odds_to_probability(self.log_odds),
                           torch.full_like(self.log_odds, UNKNOWN_PROBABILITY))

    def surface_row(self) -> tuple:
        """This (S, S) grid's row of the matching kernels' pointer table (K3,
        K5): its log-odds, known flags and origin."""
        size = self.size
        cuda.check(self.log_odds, "log_odds", torch.float32, (size, size))
        cuda.check(self.known, "known", torch.bool, (size, size))
        cuda.check(self.origin, "grid origin", torch.float32, (2,))
        return self.log_odds, self.known, self.origin

    def surface_args(self) -> tuple:
        """The surface arguments of the matching kernels' occupancy form:
        the log-odds and known pointers of one (S, S) grid."""
        size = self.size
        cuda.check(self.log_odds, "log_odds", torch.float32, (size, size))
        cuda.check(self.known, "known", torch.bool, (size, size))
        return self.log_odds.data_ptr(), self.known.data_ptr()


# ---------------------------------------------------------------- plain twin


def _scatter_mask(points: torch.Tensor, valid: torch.Tensor, origin: torch.Tensor,
                  resolution: float, size: int) -> torch.Tensor:
    """(S, S) bool: cells floor((p - origin) / res) of the valid points."""
    cells = torch.floor(true_div(points - origin, resolution))
    inside = valid & (cells >= 0).all(-1) & (cells < size).all(-1)
    cells = torch.where(inside[..., None], cells, torch.zeros_like(cells)).long()
    lin = torch.where(inside, cells[..., 0] * size + cells[..., 1],
                      torch.full_like(cells[..., 0], size * size))
    out = torch.zeros(size * size + 1, dtype=torch.bool, device=points.device)
    out[lin.reshape(-1)] = True
    return out[:size * size].reshape(size, size)


def _masks_plain(origin_grid, resolution, size, rd: RangeData, insert_free_space,
                 ray_samples):
    hits = rd.returns
    hit_mask = _scatter_mask(hits.points, hits.mask, origin_grid, resolution, size)
    if not insert_free_space:
        return hit_mask, torch.zeros_like(hit_mask)
    k = torch.arange(ray_samples, dtype=torch.float32, device=hits.points.device)

    def ray_free(points, mask, include_end):
        delta = points - rd.origin
        t = true_div(k + 1.0 if include_end else k, float(ray_samples))
        samples = rd.origin + t[:, None, None] * delta[None, :, :]
        valid = mask[None, :].expand(samples.shape[:-1])
        return _scatter_mask(samples.reshape(-1, 2), valid.reshape(-1), origin_grid,
                             resolution, size)

    free = ray_free(hits.points, hits.mask, False)
    free = free | ray_free(rd.misses.points, rd.misses.mask, True)
    return hit_mask, free & ~hit_mask


def _insert_plain(grids: Grid2D, rd: RangeData, active, do_insert, hit_lo, miss_lo,
                  insert_free_space, ray_samples) -> None:
    for b in range(grids.log_odds.shape[0]):
        g = grids.slot(b)
        hit, free = _masks_plain(g.origin, g.resolution, g.size, rd, insert_free_space,
                                 ray_samples)
        log_odds = clamp_log_odds(g.log_odds + torch.where(hit, hit_lo, 0.0)
                                  + torch.where(free, miss_lo, 0.0))
        gate = active[b] & do_insert
        g.log_odds.copy_(torch.where(gate, log_odds, g.log_odds))
        g.known.copy_(torch.where(gate, g.known | hit | free, g.known))


# ---------------------------------------------------------------- wrappers


@dataclasses.dataclass
class InsertScratch:
    """K4's per-slot bitmaps of marked cells, 2 bits a cell (hit, free); the
    kernel leaves them zero after each scan."""

    bits: torch.Tensor  # (slots, ceil(S^2 / 16)) int32

    @staticmethod
    def create(slots: int, size: int, device) -> "InsertScratch":
        return InsertScratch(
            torch.zeros((slots, (size * size + 15) // 16), dtype=torch.int32, device=device))


def insert_into_slots(grids, rd: RangeData, active: torch.Tensor,
                      do_insert: torch.Tensor, hit_probability: float,
                      miss_probability: float, insert_free_space: bool,
                      ray_samples: int, scratch=None) -> None:
    """Insert one scan (in the grids' frame) into every grid of the batch
    whose `active` flag is set, when `do_insert` (0-d bool) holds; in place.
    With (R, N, 2) clouds, (R, 2) origin, (R, slots) `active` and (R,)
    `do_insert`, `grids` (and `scratch`, if given) are R robots' batches."""
    hit_lo = probability_to_log_odds(hit_probability)
    miss_lo = probability_to_log_odds(miss_probability)
    robots = rd.returns.points.shape[0] if rd.returns.points.dim() == 3 else None
    if not rd.returns.points.is_cuda:
        jobs = ([(grids, rd, active, do_insert)] if robots is None else
                [(grids[r], rd.robot(r), active[r], do_insert[r]) for r in range(robots)])
        for g, one, a, d in jobs:
            _insert_plain(g, one, a, d, hit_lo, miss_lo, insert_free_space, ray_samples)
        return
    if robots is None:
        grids, scratch = [grids], None if scratch is None else [scratch]
    n = rd.returns.points.shape[-2]
    size, res = cuda.robot_grids(grids, robots or 1)
    slots = grids[0].log_odds.shape[0]
    if scratch is None:
        scratch = [InsertScratch.create(slots, size, rd.returns.points.device)
                   for _ in grids]
    rows = []
    for g, sc in zip(grids, scratch):
        cuda.check(g.log_odds, "log_odds", torch.float32, (slots, size, size))
        cuda.check(g.known, "known", torch.bool, (slots, size, size))
        cuda.check(g.origin, "grid origin", torch.float32, (slots, 2))
        cuda.check(sc.bits, "bitmaps", torch.int32, (slots, (size * size + 15) // 16))
        rows.append((g.log_odds, g.known, g.origin, sc.bits))
    inputs = ((rd.returns.points, "returns", torch.float32, (n, 2)),
              (rd.returns.mask, "returns mask", torch.bool, (n,)),
              (rd.misses.points, "misses", torch.float32, (n, 2)),
              (rd.misses.mask, "misses mask", torch.bool, (n,)),
              (rd.origin, "origin", torch.float32, (2,)),
              (active, "active", torch.bool, (slots,)),
              (do_insert, "do_insert", torch.bool, ()))
    strides = np.array([cuda.robot_stride(t, name, dtype, inner, robots)
                        for t, name, dtype, inner in inputs], np.int64)
    _KERNEL(rd.returns.points.device, cuda.pointer_table(rows), robots or 1,
            *(t.data_ptr() for t, _, _, _ in inputs[:4]), n, rd.origin.data_ptr(),
            active.data_ptr(), do_insert.data_ptr(), strides.ctypes.data, float(res), size,
            int(ray_samples), int(insert_free_space), slots, hit_lo, miss_lo, MIN_LOG_ODDS,
            MAX_LOG_ODDS)


def insert_range_data(grid: Grid2D, range_data: RangeData, hit_probability: float = 0.55,
                      miss_probability: float = 0.49, insert_free_space: bool = True,
                      ray_samples: int = 600) -> Grid2D:
    """Insert one scan (already in the grid frame) into a copy of the grid
    (ProbabilityGridRangeDataInserter2D::Insert)."""
    device = grid.log_odds.device
    batch = Grid2D(grid.log_odds[None].clone(), grid.known[None].clone(),
                   grid.origin[None].clone(), grid.resolution)
    insert_into_slots(batch, range_data, torch.ones(1, dtype=torch.bool, device=device),
                      torch.ones((), dtype=torch.bool, device=device), hit_probability,
                      miss_probability, insert_free_space, ray_samples)
    return batch.slot(0)
