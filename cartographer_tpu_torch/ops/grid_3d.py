"""Dense 3D grids: the windows the 3D matchers read.

Counterpart of `Grid3D` and `IntensityGrid3D` in the JAX package's
`ops/grid_3d.py`: a cubic log-odds volume with a known mask, and a cubic
running-average intensity volume (sums and counts); cell (i, j, k) covers
[origin + idx * resolution, + resolution). The 3D frontend fills both by
cropping paged grids (`ops/paged_grid_3d.py:crop_dense`,
`crop_dense_intensity`); the scan-match testbed fills a `Grid3D` with
`insert_range_data_3d`, which launches `csrc/grid_3d.cu` (K25) on CUDA
tensors and runs its plain twin on CPU tensors. `insert_intensities` adds
returns into an `IntensityGrid3D` in place, each cell's returns in input
order: `csrc/grid_3d.cu` (K30) on CUDA tensors, its plain twin on CPU
tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from cartographer_tpu_torch.core.tensor import f32, index_add_in_order_, to_device, true_div
from cartographer_tpu_torch.ops import cuda
from cartographer_tpu_torch.ops.probability import (
    MAX_LOG_ODDS,
    MIN_LOG_ODDS,
    UNKNOWN_PROBABILITY,
    clamp_log_odds,
    log_odds_to_probability,
    probability_to_log_odds,
)

_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
_INSERT_KERNEL = cuda.CudaKernel(
    "grid_3d.cu", "dense_insert_3d",
    [_P, _P, _P, _F, _I, _P, _P, _P, _I, _F, _F, _I, _F, _F, _P, _P, _P, _P])
_INTENSITY_KERNEL = cuda.CudaKernel(
    "grid_3d.cu", "dense_intensity_insert_3d", [_P, _P, _P, _F, _I, _P, _P, _P, _I, _F, _P])


@dataclasses.dataclass(frozen=True)
class Grid3D:
    log_odds: torch.Tensor  # (S, S, S) float32
    known: torch.Tensor  # (S, S, S) bool
    origin: torch.Tensor  # (3,) float32
    resolution: float

    @staticmethod
    def create(size: int, resolution: float, center, device) -> "Grid3D":
        origin = np.asarray(center, np.float32) - np.float32(0.5 * size * resolution)
        return Grid3D(
            log_odds=torch.zeros((size, size, size), dtype=torch.float32, device=device),
            known=torch.zeros((size, size, size), dtype=torch.bool, device=device),
            origin=to_device(origin.astype(np.float32), device), resolution=float(resolution))

    @property
    def size(self) -> int:
        return self.log_odds.shape[0]

    def world_to_cell_continuous(self, points: torch.Tensor) -> torch.Tensor:
        return true_div(points - self.origin, self.resolution)

    def world_to_cell(self, points: torch.Tensor) -> torch.Tensor:
        return torch.floor(self.world_to_cell_continuous(points)).to(torch.int32)

    def probability_at(self, ii, jj, kk) -> torch.Tensor:
        """Probability of the cells (ii, jj, kk): UNKNOWN where not known."""
        lo = self.log_odds[ii, jj, kk]
        return torch.where(self.known[ii, jj, kk], log_odds_to_probability(lo),
                           torch.full_like(lo, UNKNOWN_PROBABILITY))

    def probability(self) -> torch.Tensor:
        return torch.where(self.known, log_odds_to_probability(self.log_odds),
                           torch.full_like(self.log_odds, UNKNOWN_PROBABILITY))


@dataclasses.dataclass(frozen=True)
class IntensityGrid3D:
    """Running-average intensity per voxel (IntensityHybridGrid)."""

    sums: torch.Tensor  # (S, S, S) float32
    counts: torch.Tensor  # (S, S, S) float32
    origin: torch.Tensor  # (3,) float32
    resolution: float

    @staticmethod
    def create(size: int, resolution: float, center, device) -> "IntensityGrid3D":
        origin = np.asarray(center, np.float32) - np.float32(0.5 * size * resolution)
        shape = (size, size, size)
        return IntensityGrid3D(
            sums=torch.zeros(shape, dtype=torch.float32, device=device),
            counts=torch.zeros(shape, dtype=torch.float32, device=device),
            origin=to_device(origin.astype(np.float32), device), resolution=float(resolution))

    @property
    def size(self) -> int:
        return self.sums.shape[0]

    def world_to_cell_continuous(self, points: torch.Tensor) -> torch.Tensor:
        return true_div(points - self.origin, self.resolution)

    def average(self) -> torch.Tensor:
        return self.sums / self.counts.clamp(min=1.0)


# ---------------------------------------------------------------- K25 insert


def _flat_index(cells: torch.Tensor, valid: torch.Tensor, size: int) -> torch.Tensor:
    """Flatten (..., 3) cells; cells outside the grid or not valid -> size^3."""
    cells = cells.long()
    inb = ((cells >= 0) & (cells < size)).all(dim=-1) & valid
    lin = (cells[..., 0] * size + cells[..., 1]) * size + cells[..., 2]
    return torch.where(inb, lin, torch.full_like(lin, size ** 3))


def insert_range_data_3d_plain(grid: Grid3D, origin: torch.Tensor, returns: torch.Tensor,
                               mask: torch.Tensor, hit_probability: float = 0.55,
                               miss_probability: float = 0.49,
                               num_free_space_voxels: int = 2) -> Grid3D:
    """The plain twin of K25: the JAX program in PyTorch."""
    s = grid.size
    flat = s ** 3
    dev = returns.device
    hit_cells = grid.world_to_cell(returns).long()
    hit_mask = torch.zeros(flat + 1, dtype=torch.bool, device=dev)
    hit_mask[_flat_index(hit_cells, mask, s)] = True
    hit_mask = hit_mask[:flat]
    miss_mask = torch.zeros(flat, dtype=torch.bool, device=dev)
    if num_free_space_voxels > 0:
        origin_cell = grid.world_to_cell(origin).long()
        delta = hit_cells - origin_cell[None, :]
        num_samples = delta.abs().amax(dim=-1)
        ks = torch.arange(1, num_free_space_voxels + 1, device=dev)
        positions = (num_samples[:, None] - ks[None, :]).clamp(min=0)
        miss_cells = origin_cell[None, None, :] + torch.div(
            delta[:, None, :] * positions[:, :, None],
            num_samples.clamp(min=1)[:, None, None], rounding_mode="floor")
        miss_valid = (mask & (num_samples > 0))[:, None].expand(positions.shape)
        miss = torch.zeros(flat + 1, dtype=torch.bool, device=dev)
        miss[_flat_index(miss_cells, miss_valid, s).reshape(-1)] = True
        miss_mask = miss[:flat] & ~hit_mask
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    log_odds = clamp_log_odds(
        grid.log_odds.reshape(-1)
        + torch.where(hit_mask, probability_to_log_odds(hit_probability), zero)
        + torch.where(miss_mask, probability_to_log_odds(miss_probability), zero))
    known = grid.known | (hit_mask | miss_mask).reshape(s, s, s)
    return dataclasses.replace(grid, log_odds=log_odds.reshape(s, s, s), known=known)


def _insert_kernel(grid: Grid3D, origin, returns, mask, hit_probability, miss_probability,
                   num_free_space_voxels) -> Grid3D:
    s, n = grid.size, returns.shape[0]
    cuda.check(grid.log_odds, "log_odds", torch.float32, (s, s, s))
    cuda.check(grid.known, "known", torch.bool, (s, s, s))
    cuda.check(grid.origin, "grid origin", torch.float32, (3,))
    cuda.check(origin, "sensor origin", torch.float32, (3,))
    cuda.check(returns, "returns", torch.float32, (n, 3))
    cuda.check(mask, "mask", torch.bool, (n,))
    dev = returns.device
    hit = torch.empty(s ** 3, dtype=torch.uint8, device=dev)
    miss = torch.empty(s ** 3, dtype=torch.uint8, device=dev)
    log_odds = torch.empty_like(grid.log_odds)
    known = torch.empty_like(grid.known)
    _INSERT_KERNEL(dev, grid.log_odds.data_ptr(), grid.known.data_ptr(), grid.origin.data_ptr(),
                   grid.resolution, s, origin.data_ptr(), returns.data_ptr(), mask.data_ptr(),
                   n, probability_to_log_odds(hit_probability),
                   probability_to_log_odds(miss_probability), int(num_free_space_voxels),
                   MIN_LOG_ODDS, MAX_LOG_ODDS, hit.data_ptr(), miss.data_ptr(),
                   log_odds.data_ptr(), known.data_ptr())
    return dataclasses.replace(grid, log_odds=log_odds, known=known)


def insert_range_data_3d(grid: Grid3D, origin: torch.Tensor, returns: torch.Tensor,
                         mask: torch.Tensor, hit_probability: float = 0.55,
                         miss_probability: float = 0.49,
                         num_free_space_voxels: int = 2) -> Grid3D:
    """RangeDataInserter3D::Insert: `returns` (N, 3) hits and the sensor
    `origin` (3,) in the grid frame, `mask` (N,). Hits first, then the last
    `num_free_space_voxels` cells of each ray before its hit get a miss
    update where no hit lands; returns a new grid."""
    insert = _insert_kernel if returns.is_cuda else insert_range_data_3d_plain
    return insert(grid, origin, returns, mask, hit_probability, miss_probability,
                  num_free_space_voxels)


# ---------------------------------------------------------------- K30 insert


def _intensity_cells(grid: IntensityGrid3D, returns, intensities, mask, threshold: float):
    """-> (lin (N,) int64, ok (N,)): each return's flat cell and whether it
    adds (masked in, intensity <= threshold, inside the cube)."""
    s = grid.size
    cells = torch.floor(grid.world_to_cell_continuous(returns)).to(torch.int32)
    valid = mask & (intensities <= f32(threshold))
    ok = ((cells >= 0) & (cells < s)).all(dim=-1) & valid
    cells = cells.long()
    return (cells[:, 0] * s + cells[:, 1]) * s + cells[:, 2], ok


def insert_intensities_plain(grid: IntensityGrid3D, returns: torch.Tensor,
                             intensities: torch.Tensor, mask: torch.Tensor,
                             intensity_threshold: float) -> IntensityGrid3D:
    """The plain twin of K30: each cell's returns added to its old sum and
    count in input order, in place."""
    lin, ok = _intensity_cells(grid, returns, intensities, mask, intensity_threshold)
    lin = lin[ok]
    index_add_in_order_(grid.sums.view(-1), lin, intensities[ok])
    index_add_in_order_(grid.counts.view(-1), lin, torch.ones_like(intensities[ok]))
    return grid


def insert_intensities(grid: IntensityGrid3D, returns: torch.Tensor, intensities: torch.Tensor,
                       mask: torch.Tensor, intensity_threshold: float) -> IntensityGrid3D:
    """InsertIntensitiesIntoGrid: the masked `returns` (N, 3) in the grid
    frame whose `intensities` (N,) are at most the threshold add their
    intensity and 1 to their cell's sum and count; returns outside the cube
    add nothing. In place; returns `grid`."""
    if not returns.is_cuda:
        return insert_intensities_plain(grid, returns, intensities, mask, intensity_threshold)
    s, n = grid.size, returns.shape[0]
    cuda.check(grid.sums, "sums", torch.float32, (s, s, s))
    cuda.check(grid.counts, "counts", torch.float32, (s, s, s))
    cuda.check(grid.origin, "grid origin", torch.float32, (3,))
    cuda.check(returns, "returns", torch.float32, (n, 3))
    cuda.check(intensities, "intensities", torch.float32, (n,))
    cuda.check(mask, "mask", torch.bool, (n,))
    keys = torch.empty(max(2, 1 << max(n - 1, 0).bit_length()), dtype=torch.int64,
                       device=returns.device)
    _INTENSITY_KERNEL(returns.device, grid.sums.data_ptr(), grid.counts.data_ptr(),
                      grid.origin.data_ptr(), grid.resolution, s, returns.data_ptr(),
                      intensities.data_ptr(), mask.data_ptr(), n, f32(intensity_threshold),
                      keys.data_ptr())
    return grid
