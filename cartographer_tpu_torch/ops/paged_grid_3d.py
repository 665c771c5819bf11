"""Paged (sparse) 3D occupancy grid: a page pool behind a page table.

Counterpart of the JAX package's `ops/paged_grid_3d.py` (the reference's
unbounded HybridGrid, mapping/3d/hybrid_grid.h): a fixed pool of P dense
pages of B^3 voxels, a dense int32 page table over `num_blocks`^3 blocks,
allocation of pages on the host (a dict from block to pool slot, with a
host mirror of the table), and four device programs, all in
`csrc/paged_grid_3d.cu`:

  - `insert_paged` (K9): hits and the trailing free-space cells of each
    ray, through the page table into the pool, in place (the JAX program
    returns a new pool);
  - `crop_dense` (K10): the pages that cover a size^3 window gathered into
    a dense `Grid3D` for the matcher;
  - `insert_intensity_paged` (K18): the running-average intensity pools of
    the reference's IntensityHybridGrid (sums and counts behind their own
    page table), fed with the returns whose intensity is at most the
    threshold, in place, each cell's returns in their order, for scans of
    any size (`csrc/in_order_scatter.cuh`: one block up to 8,192 returns, a
    cluster of blocks above);
  - `crop_dense_intensity` (K19): K10's crop of the two intensity pools
    into a dense `IntensityGrid3D`.

Each launches its CUDA kernel on CUDA tensors and runs the plain PyTorch
twin, the JAX program written in PyTorch, on CPU tensors.

`compact()` keeps the sliced pools on the device as fresh tensors, which
frees the full pools; the JAX package moves them to host memory instead.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cartographer_tpu_torch.core.tensor import to_device, true_div
from cartographer_tpu_torch.ops import cuda, in_order_scatter
from cartographer_tpu_torch.ops.grid_3d import Grid3D, IntensityGrid3D
from cartographer_tpu_torch.ops.probability import (
    MAX_LOG_ODDS,
    MIN_LOG_ODDS,
    clamp_log_odds,
    log_odds_to_probability,
    probability_to_log_odds,
)

_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
_INSERT_KERNEL = cuda.CudaKernel(
    "paged_grid_3d.cu", "paged_insert_3d",
    [_P, _P, _P, _P, _F, _I, _I, _I, _P, _P, _P, _I, _F, _F, _I, _F, _F, _P, _P])
_CROP_ARGS = [_P, _P, _P, _P, _F, _I, _I, _I, _F, _F, _F, _I, _P, _P, _P]
_CROP_KERNEL = cuda.CudaKernel("paged_grid_3d.cu", "paged_crop_3d", _CROP_ARGS)
_INTENSITY_INSERT_KERNEL = cuda.CudaKernel(
    "paged_grid_3d.cu", "paged_intensity_insert_3d",
    [_P, _P, _P, _P, _F, _I, _I, _I, _P, _P, _P, _I, _F, _I])
_INTENSITY_CROP_KERNEL = cuda.CudaKernel("paged_grid_3d.cu", "paged_intensity_crop_3d",
                                         _CROP_ARGS)


@dataclasses.dataclass(frozen=True)
class PagedGrid3D:
    """Block (bx, by, bz) covers world cells [b * B, (b + 1) * B); the page
    table holds its pool slot or -1."""

    pages: torch.Tensor  # (P, B, B, B) float32 log-odds
    known: torch.Tensor  # (P, B, B, B) bool
    page_table: torch.Tensor  # (NB, NB, NB) int32, -1 = unallocated
    origin: torch.Tensor  # (3,) world position of the corner of cell (0, 0, 0)
    resolution: float
    page_size: int

    @staticmethod
    def create(resolution: float, center, device, page_size: int = 32, max_pages: int = 512,
               num_blocks: int = 64) -> "PagedGrid3D":
        shape = (max_pages, page_size, page_size, page_size)
        return PagedGrid3D(
            pages=torch.zeros(shape, dtype=torch.float32, device=device),
            known=torch.zeros(shape, dtype=torch.bool, device=device),
            page_table=torch.full((num_blocks,) * 3, -1, dtype=torch.int32, device=device),
            origin=to_device(_grid_origin(resolution, center, page_size, num_blocks), device),
            resolution=float(resolution), page_size=page_size)

    @property
    def max_pages(self) -> int:
        return self.pages.shape[0]

    @property
    def num_blocks(self) -> int:
        return self.page_table.shape[0]

    def world_to_cell(self, points: torch.Tensor) -> torch.Tensor:
        return torch.floor(true_div(points - self.origin, self.resolution)).to(torch.int32)

    def probability_at(self, points: torch.Tensor, unknown: float = 0.5) -> torch.Tensor:
        """Per-point cell probability (`unknown` where the cell is not known)."""
        lin, ok = _pool_index(self, self.world_to_cell(points),
                              torch.ones(points.shape[:-1], dtype=torch.bool,
                                         device=points.device))
        lin = lin.clamp(max=self.pages.numel() - 1)
        p = log_odds_to_probability(self.pages.reshape(-1)[lin])
        return torch.where(ok & self.known.reshape(-1)[lin], p, torch.full_like(p, unknown))


def _grid_origin(resolution, center, page_size, num_blocks) -> np.ndarray:
    extent = num_blocks * page_size * resolution
    return np.asarray(center, np.float32) - np.float32(0.5 * extent)


def _pool_index(grid: PagedGrid3D, cells: torch.Tensor, valid: torch.Tensor):
    """(..., 3) world cells -> (flat pool index, or the pool's size where
    the cell has no page; whether it has one)."""
    B, nb = grid.page_size, grid.num_blocks
    cells = cells.long()
    inb = valid & ((cells >= 0) & (cells < nb * B)).all(dim=-1)
    block = torch.div(cells, B, rounding_mode="floor").clamp(0, nb - 1)
    off = (cells - block * B).clamp(0, B - 1)
    page = grid.page_table[block[..., 0], block[..., 1], block[..., 2]].long()
    ok = inb & (page >= 0) & (page < grid.max_pages)
    lin = ((page.clamp(min=0) * B + off[..., 0]) * B + off[..., 1]) * B + off[..., 2]
    flat = grid.max_pages * B ** 3
    return torch.where(ok, lin, torch.full_like(lin, flat)), ok


# ---------------------------------------------------------------- K9 insert


def insert_paged_plain(grid: PagedGrid3D, origin, returns, mask, hit_probability,
                       miss_probability, num_free_space_voxels: int) -> None:
    """The plain twin of K9: the JAX program in PyTorch, sweeping the pool."""
    flat = grid.pages.numel()
    hit_cells = grid.world_to_cell(returns).long()
    hit_lin, _ = _pool_index(grid, hit_cells, mask)
    hit_mask = torch.zeros(flat + 1, dtype=torch.bool, device=returns.device)
    hit_mask[hit_lin] = True
    hit_mask = hit_mask[:flat]
    miss_mask = torch.zeros(flat, dtype=torch.bool, device=returns.device)
    if num_free_space_voxels > 0:
        origin_cell = grid.world_to_cell(origin).long()
        delta = hit_cells - origin_cell[None, :]
        num_samples = delta.abs().amax(dim=-1)
        ks = torch.arange(1, num_free_space_voxels + 1, device=returns.device)
        positions = (num_samples[:, None] - ks[None, :]).clamp(min=0)
        miss_cells = origin_cell[None, None, :] + torch.div(
            delta[:, None, :] * positions[:, :, None],
            num_samples.clamp(min=1)[:, None, None], rounding_mode="floor")
        miss_valid = (mask & (num_samples > 0))[:, None].expand(positions.shape)
        miss_lin, _ = _pool_index(grid, miss_cells.reshape(-1, 3), miss_valid.reshape(-1))
        miss_mask = torch.zeros(flat + 1, dtype=torch.bool, device=returns.device)
        miss_mask[miss_lin] = True
        miss_mask = miss_mask[:flat] & ~hit_mask
    hit_lo = probability_to_log_odds(hit_probability)
    miss_lo = probability_to_log_odds(miss_probability)
    pages = grid.pages.view(-1)
    zero = torch.zeros((), dtype=torch.float32, device=pages.device)
    updated = clamp_log_odds(pages + torch.where(hit_mask, hit_lo, zero)
                             + torch.where(miss_mask, miss_lo, zero))
    pages.copy_(updated)
    grid.known.view(-1).logical_or_(hit_mask | miss_mask)


def _insert_kernel(grid, origin, returns, mask, hit_probability, miss_probability,
                   num_free_space_voxels, scratch):
    n = returns.shape[0]
    P, B, nb = grid.max_pages, grid.page_size, grid.num_blocks
    cuda.check(grid.pages, "pages", torch.float32, (P, B, B, B))
    cuda.check(grid.known, "known", torch.bool, (P, B, B, B))
    cuda.check(grid.page_table, "page table", torch.int32, (nb, nb, nb))
    cuda.check(grid.origin, "grid origin", torch.float32, (3,))
    cuda.check(origin, "sensor origin", torch.float32, (3,))
    cuda.check(returns, "returns", torch.float32, (n, 3))
    cuda.check(mask, "mask", torch.bool, (n,))
    if B % 2:
        raise ValueError("paged insert: the page size must be even")
    cuda.check(scratch.state, "state", torch.uint8, (P * B ** 3,))
    per = num_free_space_voxels + 1
    if scratch.cells is None or scratch.cells.numel() < n * per:
        scratch.cells = torch.empty(n * per, dtype=torch.int64, device=returns.device)
    _INSERT_KERNEL(returns.device, grid.pages.data_ptr(), grid.known.data_ptr(),
                   grid.page_table.data_ptr(), grid.origin.data_ptr(), grid.resolution, B, nb,
                   P, origin.data_ptr(), returns.data_ptr(), mask.data_ptr(), n,
                   probability_to_log_odds(hit_probability),
                   probability_to_log_odds(miss_probability), int(num_free_space_voxels),
                   MIN_LOG_ODDS, MAX_LOG_ODDS, scratch.state.data_ptr(),
                   scratch.cells.data_ptr())


@dataclasses.dataclass
class InsertScratch:
    """Device scratch of K9: one state byte per pool cell, zero between
    calls, and the candidate cells' pool indices."""

    state: torch.Tensor
    cells: Optional[torch.Tensor] = None

    @staticmethod
    def create(grid: PagedGrid3D) -> "InsertScratch":
        return InsertScratch(torch.zeros(grid.pages.numel(), dtype=torch.uint8,
                                         device=grid.pages.device))


def insert_paged(grid: PagedGrid3D, origin: torch.Tensor, returns: torch.Tensor,
                 mask: torch.Tensor, hit_probability: float, miss_probability: float,
                 num_free_space_voxels: int, scratch: Optional[InsertScratch] = None) -> None:
    """RangeDataInserter3D::Insert against the page pool, in place: the hit
    cell of every masked return and `num_free_space_voxels` cells back along
    its ray from `origin`; each cell changes once, hits win over misses.
    Cells whose block has no page are dropped."""
    if returns.is_cuda:
        if scratch is None:
            scratch = InsertScratch.create(grid)
        _insert_kernel(grid, origin, returns, mask, hit_probability, miss_probability,
                       num_free_space_voxels, scratch)
    else:
        insert_paged_plain(grid, origin, returns, mask, hit_probability, miss_probability,
                           num_free_space_voxels)


# ---------------------------------------------------------------- K10 crop


def _crop_pools_plain(grid, pools, center: torch.Tensor, size: int):
    """Gather the block-aligned cover of the window page by page from each
    pool, assemble it and slice the window out; -> (dense windows, window
    origin)."""
    B, nb = grid.page_size, grid.num_blocks
    nblk = size // B + 2
    dev = grid.page_table.device
    window_start = grid.world_to_cell(center).long() - size // 2
    start_block = torch.div(window_start, B, rounding_mode="floor")
    r = torch.arange(nblk, device=dev)
    bidx = start_block[None, :] + torch.stack(
        torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    okb = ((bidx >= 0) & (bidx < nb)).all(dim=-1)
    bclip = bidx.clamp(0, nb - 1)
    page = grid.page_table[bclip[:, 0], bclip[:, 1], bclip[:, 2]].long()
    ok = okb & (page >= 0) & (page < grid.max_pages)
    off = window_start - start_block * B
    idx = [off[a] + torch.arange(size, device=dev) for a in range(3)]
    denses = []
    for pool in pools:
        gathered = torch.where(ok[:, None, None, None], pool[page.clamp(min=0)],
                               torch.zeros((), dtype=pool.dtype, device=dev))
        a = gathered.reshape(nblk, nblk, nblk, B, B, B).permute(0, 3, 1, 4, 2, 5)
        a = a.reshape(nblk * B, nblk * B, nblk * B)
        denses.append(a[idx[0][:, None, None], idx[1][None, :, None],
                        idx[2][None, None, :]].contiguous())
    return denses, grid.origin + window_start.to(torch.float32) * grid.resolution


def crop_dense_plain(grid: PagedGrid3D, center: torch.Tensor, size: int) -> Grid3D:
    """The plain twin of K10."""
    (dense, known), origin = _crop_pools_plain(grid, (grid.pages, grid.known), center, size)
    return Grid3D(dense, known, origin, grid.resolution)


def _crop_kernel(kernel, grid, pools, center, size: int):
    """K10 or K19 on the grid's two pools, given as (tensor, name, dtype)
    -> (dense windows, window origin)."""
    P, B, nb = grid.max_pages, grid.page_size, grid.num_blocks
    for pool, name, dtype in pools:
        cuda.check(pool, name, dtype, (P, B, B, B))
    cuda.check(grid.page_table, "page table", torch.int32, (nb, nb, nb))
    cuda.check(grid.origin, "grid origin", torch.float32, (3,))
    dev = grid.page_table.device
    denses = [torch.empty((size, size, size), dtype=dtype, device=dev) for _, _, dtype in pools]
    origin = torch.empty(3, dtype=torch.float32, device=dev)
    c = np.asarray(center, np.float32)
    kernel(dev, pools[0][0].data_ptr(), pools[1][0].data_ptr(), grid.page_table.data_ptr(),
           grid.origin.data_ptr(), grid.resolution, B, nb, P, float(c[0]), float(c[1]),
           float(c[2]), int(size), denses[0].data_ptr(), denses[1].data_ptr(),
           origin.data_ptr())
    return denses, origin


def crop_dense(grid: PagedGrid3D, center, size: int) -> Grid3D:
    """Dense size^3 Grid3D of the window centered at `center` (3 host
    floats): unallocated blocks and blocks outside the table read as
    0 / unknown."""
    if grid.pages.is_cuda:
        (dense, known), origin = _crop_kernel(
            _CROP_KERNEL, grid, ((grid.pages, "pages", torch.float32),
                                 (grid.known, "known", torch.bool)), center, size)
        return Grid3D(dense, known, origin, grid.resolution)
    return crop_dense_plain(grid, torch.from_numpy(np.asarray(center, np.float32).copy()),
                            size)


# ---------------------------------------------------------------- host allocation


def _allocate_blocks(slots: Dict[Tuple[int, int, int], int], page_table: np.ndarray,
                     block_keys: np.ndarray, max_pages: int):
    """Assign pool slots to the blocks of `block_keys` that have none, in
    `slots` and in the host mirror `page_table` (both mutated); returns the
    (n, 3) int64 indices and (n,) int32 slots of the new entries, or None.
    Raises MemoryError when the pool is exhausted."""
    new = [tuple(k) for k in block_keys if tuple(k) not in slots]
    if not new:
        return None
    if len(slots) + len(new) > max_pages:
        raise MemoryError(f"page pool exhausted ({max_pages} pages)")
    idx = np.asarray(new, np.int64)
    vals = np.arange(len(slots), len(slots) + len(new), dtype=np.int32)
    for key, s in zip(new, vals):
        slots[key] = int(s)
    page_table[idx[:, 0], idx[:, 1], idx[:, 2]] = vals
    return idx, vals


class _PagedAllocation:
    """The host's allocation state of one paged grid: the dict from block
    to pool slot and host mirrors of the table and origin, so an insert
    never waits for the device. `grid` is the device state."""

    def _init_allocation(self, resolution: float, center, page_size: int,
                         num_blocks: int) -> None:
        self._slots: Dict[Tuple[int, int, int], int] = {}
        self._origin_host = _grid_origin(resolution, center, page_size, num_blocks)
        self._table_host = np.full((num_blocks,) * 3, -1, np.int32)
        self.pages_allocated_last_insert = 0

    @property
    def num_allocated(self) -> int:
        return len(self._slots)

    def _allocate_cells(self, cells: np.ndarray) -> None:
        """Pool slots for the blocks of the (n, 3) world cells within the
        table that have none, in block order; the new table entries go to
        the device without waiting."""
        B, nb = self.grid.page_size, self.grid.num_blocks
        cells = cells[np.all((cells >= 0) & (cells < nb * B), axis=-1)] // B
        self.pages_allocated_last_insert = 0
        if not len(cells):
            return
        uniq = np.unique((cells[:, 0] * nb + cells[:, 1]) * nb + cells[:, 2])
        uniq = uniq[self._table_host.reshape(-1)[uniq] < 0]  # most blocks have a page
        keys = np.stack([uniq // (nb * nb), (uniq // nb) % nb, uniq % nb], -1)
        upd = _allocate_blocks(self._slots, self._table_host, keys, self.grid.max_pages)
        if upd is None:
            return
        idx, vals = upd
        dev = self.grid.page_table.device
        flat = (idx[:, 0] * nb + idx[:, 1]) * nb + idx[:, 2]
        self.grid.page_table.view(-1)[to_device(flat, dev)] = to_device(vals, dev)
        self.pages_allocated_last_insert = len(vals)

    def _cells(self, points: np.ndarray) -> np.ndarray:
        return np.floor((points - self._origin_host)
                        / np.float32(self.grid.resolution)).astype(np.int64)

    def _compacted_size(self) -> int:
        """The allocated pages, padded to a power of two."""
        n = max(1, 1 << math.ceil(math.log2(max(self.num_allocated, 1))))
        return min(n, self.grid.max_pages)

    def known_center(self) -> np.ndarray:
        """World center of the allocated blocks: where the dense crop of a
        finished submap is placed."""
        g = self.grid
        if not self._slots:
            return self._origin_host + np.float32(0.5 * g.num_blocks * g.page_size
                                                  * g.resolution)
        keys = np.asarray(list(self._slots.keys()), np.float64)
        mid = (keys.mean(axis=0) + 0.5) * g.page_size
        return self._origin_host + mid * g.resolution


class PagedSubmapGrid3D(_PagedAllocation):
    """Host wrapper of one PagedGrid3D."""

    def __init__(self, resolution: float, center, device, page_size: int = 32,
                 max_pages: int = 512, num_blocks: int = 64):
        self.grid = PagedGrid3D.create(resolution, center, device, page_size, max_pages,
                                       num_blocks)
        self._init_allocation(resolution, center, page_size, num_blocks)
        self._scratch: Optional[InsertScratch] = None

    def insert_range_data(self, origin, returns, mask, hit_probability: float = 0.55,
                          miss_probability: float = 0.49, num_free_space_voxels: int = 2,
                          device_tensors=None) -> None:
        """Host: the blocks the scan touches (hits and the free-space cells,
        all within `num_free_space_voxels` cells of a hit) get pool slots,
        and the new table entries go to the device without waiting. Device:
        K9 on `device_tensors` = (origin, returns, mask) where the caller
        holds them there already, else on uploads of the host arrays."""
        pts = np.asarray(returns, np.float32)
        m = np.asarray(mask, bool)
        cells = self._cells(pts[m])
        f = num_free_space_voxels
        self._allocate_cells(np.concatenate([cells - f, cells + f, cells]))
        dev = self.grid.pages.device
        if device_tensors is None:
            device_tensors = (to_device(np.asarray(origin, np.float32), dev),
                              to_device(pts, dev), to_device(m, dev))
        if dev.type == "cuda" and self._scratch is None:
            self._scratch = InsertScratch.create(self.grid)
        insert_paged(self.grid, *device_tensors, hit_probability, miss_probability,
                     num_free_space_voxels, self._scratch)

    def crop_dense(self, center, size: int) -> Grid3D:
        return crop_dense(self.grid, center, size)

    def compact(self) -> None:
        """Shrink the pool to the allocated pages, padded to a power of two,
        as a fresh tensor on the device; the full pool and K9's scratch are
        freed."""
        n = self._compacted_size()
        self.grid = dataclasses.replace(self.grid, pages=self.grid.pages[:n].clone(),
                                        known=self.grid.known[:n].clone())
        self._scratch = None

    def probability_at(self, points: torch.Tensor, unknown: float = 0.5) -> torch.Tensor:
        return self.grid.probability_at(points, unknown)


# ---------------------------------------------------------------- intensity pools


@dataclasses.dataclass(frozen=True)
class PagedIntensityGrid3D:
    """Page-pool running-average intensity grid: sums and counts pools
    behind one page table (the reference's IntensityHybridGrid, kept for
    the high-resolution grid of the active submaps)."""

    sums: torch.Tensor  # (P, B, B, B) float32
    counts: torch.Tensor  # (P, B, B, B) float32
    page_table: torch.Tensor  # (NB, NB, NB) int32, -1 = unallocated
    origin: torch.Tensor  # (3,)
    resolution: float
    page_size: int

    @staticmethod
    def create(resolution: float, center, device, page_size: int = 32, max_pages: int = 512,
               num_blocks: int = 64) -> "PagedIntensityGrid3D":
        shape = (max_pages, page_size, page_size, page_size)
        return PagedIntensityGrid3D(
            sums=torch.zeros(shape, dtype=torch.float32, device=device),
            counts=torch.zeros(shape, dtype=torch.float32, device=device),
            page_table=torch.full((num_blocks,) * 3, -1, dtype=torch.int32, device=device),
            origin=to_device(_grid_origin(resolution, center, page_size, num_blocks), device),
            resolution=float(resolution), page_size=page_size)

    @property
    def max_pages(self) -> int:
        return self.sums.shape[0]

    @property
    def num_blocks(self) -> int:
        return self.page_table.shape[0]

    def world_to_cell(self, points: torch.Tensor) -> torch.Tensor:
        return torch.floor(true_div(points - self.origin, self.resolution)).to(torch.int32)


def insert_intensity_paged_plain(grid: PagedIntensityGrid3D, returns, intensities, mask,
                                 threshold: float) -> None:
    """The plain twin of K18: the JAX program's scatter-add in PyTorch
    (entries that add nothing add 0 to the pool's last cell, as there)."""
    valid = mask & (intensities <= threshold)
    lin, ok = _pool_index(grid, grid.world_to_cell(returns), valid)
    lin = lin.clamp(max=grid.sums.numel() - 1)
    zero = torch.zeros_like(intensities)
    grid.sums.view(-1).index_add_(0, lin, torch.where(ok, intensities, zero))
    grid.counts.view(-1).index_add_(0, lin, torch.where(ok, torch.ones_like(zero), zero))


def insert_intensity_paged(grid: PagedIntensityGrid3D, returns: torch.Tensor,
                           intensities: torch.Tensor, mask: torch.Tensor,
                           threshold: float) -> None:
    """IntensityHybridGrid::AddIntensity for the masked returns whose
    intensity is at most `threshold`, in place; returns on blocks without a
    page add nothing. Each cell adds its returns in their order, on the card
    as in the CPU twin."""
    if not returns.is_cuda:
        insert_intensity_paged_plain(grid, returns, intensities, mask, threshold)
        return
    n = returns.shape[0]
    if n == 0:
        return
    P, B, nb = grid.max_pages, grid.page_size, grid.num_blocks
    cuda.check(grid.sums, "sums", torch.float32, (P, B, B, B))
    cuda.check(grid.counts, "counts", torch.float32, (P, B, B, B))
    cuda.check(grid.page_table, "page table", torch.int32, (nb, nb, nb))
    cuda.check(grid.origin, "grid origin", torch.float32, (3,))
    cuda.check(returns, "returns", torch.float32, (n, 3))
    cuda.check(intensities, "intensities", torch.float32, (n,))
    cuda.check(mask, "mask", torch.bool, (n,))
    _INTENSITY_INSERT_KERNEL(returns.device, grid.sums.data_ptr(), grid.counts.data_ptr(),
                             grid.page_table.data_ptr(), grid.origin.data_ptr(),
                             grid.resolution, B, nb, P, returns.data_ptr(),
                             intensities.data_ptr(), mask.data_ptr(), n, float(threshold),
                             in_order_scatter.radix_passes(grid.sums.numel()))


def crop_dense_intensity_plain(grid: PagedIntensityGrid3D, center: torch.Tensor,
                               size: int) -> IntensityGrid3D:
    """The plain twin of K19."""
    (sums, counts), origin = _crop_pools_plain(grid, (grid.sums, grid.counts), center, size)
    return IntensityGrid3D(sums, counts, origin, grid.resolution)


def crop_dense_intensity(grid: PagedIntensityGrid3D, center, size: int) -> IntensityGrid3D:
    """Dense size^3 IntensityGrid3D of the window centered at `center` (3
    host floats): zero sums and counts where a block has no page. With the
    occupancy grid's resolution, origin and page size it is the same window
    as `crop_dense`'s."""
    if grid.sums.is_cuda:
        (sums, counts), origin = _crop_kernel(
            _INTENSITY_CROP_KERNEL, grid, ((grid.sums, "sums", torch.float32),
                                           (grid.counts, "counts", torch.float32)),
            center, size)
        return IntensityGrid3D(sums, counts, origin, grid.resolution)
    return crop_dense_intensity_plain(
        grid, torch.from_numpy(np.asarray(center, np.float32).copy()), size)


class PagedIntensitySubmapGrid3D(_PagedAllocation):
    """Host wrapper of one PagedIntensityGrid3D, with its own slots and
    page table."""

    def __init__(self, resolution: float, center, device, page_size: int = 32,
                 max_pages: int = 512, num_blocks: int = 64):
        self.grid = PagedIntensityGrid3D.create(resolution, center, device, page_size,
                                                max_pages, num_blocks)
        self._init_allocation(resolution, center, page_size, num_blocks)

    def insert(self, returns, intensities, mask, intensity_threshold: float,
               device_tensors=None) -> None:
        """InsertIntensitiesIntoGrid (range_data_inserter_3d.cc): only the
        masked returns with intensity <= threshold contribute. Host: their
        blocks get pool slots. Device: K18 on `device_tensors` = (returns,
        intensities, mask) where the caller holds them there, else on
        uploads of the host arrays."""
        pts = np.asarray(returns, np.float32)
        intens = np.asarray(intensities, np.float32)
        m = np.asarray(mask, bool)
        valid = m & (intens <= intensity_threshold)
        self.pages_allocated_last_insert = 0
        if not valid.any():
            return
        self._allocate_cells(self._cells(pts[valid]))
        if device_tensors is None:
            dev = self.grid.sums.device
            device_tensors = (to_device(pts, dev), to_device(intens, dev), to_device(m, dev))
        insert_intensity_paged(self.grid, *device_tensors, intensity_threshold)

    def crop_dense(self, center, size: int) -> IntensityGrid3D:
        return crop_dense_intensity(self.grid, center, size)

    def compact(self) -> None:
        """Shrink both pools to the allocated pages, padded to a power of
        two, as fresh tensors on the device."""
        n = self._compacted_size()
        self.grid = dataclasses.replace(self.grid, sums=self.grid.sums[:n].clone(),
                                        counts=self.grid.counts[:n].clone())
