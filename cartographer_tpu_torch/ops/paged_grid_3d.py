"""Paged (sparse) 3D occupancy grid: a page pool behind a page table.

Counterpart of the JAX package's `ops/paged_grid_3d.py` (the reference's
unbounded HybridGrid, mapping/3d/hybrid_grid.h): a fixed pool of P dense
pages of B^3 voxels, a dense int32 page table over `num_blocks`^3 blocks,
allocation of pages on the host (a dict from block to pool slot, with a
host mirror of the table), and three device programs, all in
`csrc/paged_grid_3d.cu`:

  - `insert_paged_grids` (K9): hits and the trailing free-space cells of
    each ray, through the page table into the pool, in place (the JAX
    program returns a new pool), for up to 4 grids in one launch (a scan's
    high and low grids of the active submaps), their new page-table
    entries written in the same launch; `insert_paged` inserts into one;
  - `crop_windows` (K10 and K19): the pages that cover each of a scan's
    size^3 windows gathered into a dense `Grid3D` (occupancy pools) or
    `IntensityGrid3D` (intensity pools) for the matchers, every window in
    one launch; `crop_dense` and `crop_dense_intensity` crop one;
  - `insert_intensity_paged` (K18): the running-average intensity pools of
    the reference's IntensityHybridGrid (sums and counts behind their own
    page table), fed with the returns whose intensity is at most the
    threshold, in place, each cell's returns in their order, for scans of
    any size (`csrc/in_order_scatter.cuh`: one block up to 8,192 returns, a
    cluster of blocks above).

Each launches its CUDA kernel on CUDA tensors and runs the plain PyTorch
twin, the JAX program written in PyTorch, on CPU tensors.

`compact()` keeps the sliced pools on the device as fresh tensors, which
frees the full pools; the JAX package moves them to host memory instead.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import struct
from typing import Dict, Tuple

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
_INSERT_KERNEL = cuda.CudaKernel("paged_grid_3d.cu", "paged_insert_3d",
                                 [_P, _I, _P, _P, _I, _I, _F, _F, _F, _F])
_CROP_KERNEL = cuda.CudaKernel("paged_grid_3d.cu", "paged_crop_3d", [_P, _I])
_INTENSITY_INSERT_KERNEL = cuda.CudaKernel(
    "paged_grid_3d.cu", "paged_intensity_insert_3d",
    [_P, _P, _P, _P, _F, _I, _I, _I, _P, _P, _P, _I, _F, _I])
MAX_INSERT_GRIDS = 4  # grids an insert launch takes (csrc/paged_grid_3d.cu kMaxInsertGrids)
# One grid of an insert launch, `InsertGrid` of csrc/paged_grid_3d.cu: the
# pools, the table, the grid origin, the mask, the new table entries and the
# tables' device scratch (pointers); the resolution; the page size, blocks a
# side, pages, new entries and a pad.
_INSERT_GRID = struct.Struct("=7Qf5i")
MAX_CROP_WINDOWS = 4  # windows a crop launch takes (csrc/paged_grid_3d.cu kMaxWindows)
# One window of a crop launch, `CropWindow` of csrc/paged_grid_3d.cu: the two
# pools, the two dense outputs, the table, the grid's and the window's
# origins (pointers); center (3) and resolution; the pools' element bytes,
# page size, blocks a side, pages and window size.
_CROP_WINDOW = struct.Struct("=7Q4f6i")


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
                       miss_probability, num_free_space_voxels: int) -> torch.Tensor:
    """The plain twin of K9: the JAX program in PyTorch, sweeping the pool.
    -> the flat mask of the pool cells it touched."""
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
    touched = hit_mask | miss_mask
    grid.known.view(-1).logical_or_(touched)
    return touched


@functools.lru_cache(maxsize=None)
def _insert_scratch_bytes(n: int, free_voxels: int) -> int:
    """The kernel's own `paged_insert_3d_scratch_bytes`: a grid's tables in
    device memory, 0 where they fit in shared memory."""
    return cuda.host_function("paged_grid_3d.cu", "paged_insert_3d_scratch_bytes", [_I, _I],
                              ctypes.c_longlong)(n, free_voxels)


def _write_entries(grid, entries) -> None:
    """The page-table write of `entries` = (flat indices, pool slots), or
    None, to the grid's device without waiting."""
    if entries is not None:
        dev = grid.page_table.device
        grid.page_table.view(-1)[to_device(entries[0], dev)] = to_device(entries[1], dev)


def _insert_launch(jobs, origin, returns, hit_probability, miss_probability,
                   num_free_space_voxels):
    n = returns.shape[0]
    cuda.check(origin, "sensor origin", torch.float32, (3,))
    cuda.check(returns, "returns", torch.float32, (n, 3))
    dev = returns.device
    # The scan's new page-table entries of every grid: one upload.
    counts = [0 if e is None else len(e[0]) for _, _, e in jobs]
    entries = None
    if sum(counts):
        pairs = np.concatenate([np.stack([np.asarray(e[0], np.int32),
                                          np.asarray(e[1], np.int32)], -1)
                                for _, _, e in jobs if e is not None and len(e[0])])
        entries = to_device(pairs, dev)
    per_grid = _insert_scratch_bytes(n, int(num_free_space_voxels))
    scratch = (torch.empty(per_grid * len(jobs), dtype=torch.uint8, device=dev)
               if per_grid else None)
    descs, offset = [], 0
    for v, ((grid, mask, _), count) in enumerate(zip(jobs, counts)):
        P, B, nb = grid.max_pages, grid.page_size, grid.num_blocks
        cuda.check(grid.pages, "pages", torch.float32, (P, B, B, B))
        cuda.check(grid.known, "known", torch.bool, (P, B, B, B))
        cuda.check(grid.page_table, "page table", torch.int32, (nb, nb, nb))
        cuda.check(grid.origin, "grid origin", torch.float32, (3,))
        cuda.check(mask, "mask", torch.bool, (n,))
        if P * B ** 3 >= (1 << 30) - 1:
            raise ValueError("paged insert: a pool takes fewer than 2^30 - 1 cells")
        descs.append(_INSERT_GRID.pack(
            grid.pages.data_ptr(), grid.known.data_ptr(), grid.page_table.data_ptr(),
            grid.origin.data_ptr(), mask.data_ptr(),
            entries.data_ptr() + 8 * offset if count else 0,
            scratch.data_ptr() + v * per_grid if per_grid else 0,
            grid.resolution, B, nb, P, count, 0))
        offset += count
    _INSERT_KERNEL(dev, b"".join(descs), len(jobs), origin.data_ptr(), returns.data_ptr(), n,
                   int(num_free_space_voxels), probability_to_log_odds(hit_probability),
                   probability_to_log_odds(miss_probability), MIN_LOG_ODDS, MAX_LOG_ODDS)


def insert_paged_grids(jobs, origin: torch.Tensor, returns: torch.Tensor,
                       hit_probability: float, miss_probability: float,
                       num_free_space_voxels: int) -> None:
    """RangeDataInserter3D::Insert of one scan into up to MAX_INSERT_GRIDS
    paged grids, in place: `jobs` = [(grid, mask, entries), ...], their pools
    disjoint, `mask` the (N,) returns the grid takes and `entries` None or
    (flat table indices, pool slots), the grid's page-table entries that the
    host allocated for this scan and the device table does not hold yet.
    Each grid gets the hit cell of every masked return and
    `num_free_space_voxels` cells back along its ray from `origin`; each cell
    changes once, hits win over misses; cells whose block has no page are
    dropped. On the card one launch writes the entries and inserts into
    every grid."""
    if len(jobs) > MAX_INSERT_GRIDS:
        raise ValueError(f"an insert launch takes at most {MAX_INSERT_GRIDS} grids")
    if not jobs:
        return
    if len({id(grid.pages) for grid, _, _ in jobs}) < len(jobs):
        raise ValueError("paged insert: the grids' pools must be disjoint")
    if returns.is_cuda:
        _insert_launch(jobs, origin, returns, hit_probability, miss_probability,
                       num_free_space_voxels)
        return
    for grid, mask, entries in jobs:
        _write_entries(grid, entries)
        insert_paged_plain(grid, origin, returns, mask, hit_probability, miss_probability,
                           num_free_space_voxels)


def insert_paged(grid: PagedGrid3D, origin: torch.Tensor, returns: torch.Tensor,
                 mask: torch.Tensor, hit_probability: float, miss_probability: float,
                 num_free_space_voxels: int) -> None:
    """`insert_paged_grids` into one grid whose table holds the scan's
    pages already."""
    insert_paged_grids([(grid, mask, None)], origin, returns, hit_probability,
                       miss_probability, num_free_space_voxels)


# ---------------------------------------------------------------- K10 and K19 crop


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


def _crop_pools(grid):
    """The grid's two pools as (tensor, name, dtype), and its window type."""
    if isinstance(grid, PagedIntensityGrid3D):
        return (((grid.sums, "sums", torch.float32), (grid.counts, "counts", torch.float32)),
                IntensityGrid3D)
    return ((grid.pages, "pages", torch.float32), (grid.known, "known", torch.bool)), Grid3D


def _crop_launch(windows):
    """K10 and K19: one launch for every window -> their dense grids."""
    if len(windows) > MAX_CROP_WINDOWS:
        raise ValueError(f"a crop launch takes at most {MAX_CROP_WINDOWS} windows")
    descs, out = [], []
    for grid, center, size in windows:
        pools, window = _crop_pools(grid)
        P, B, nb = pools[0][0].shape[0], grid.page_size, grid.num_blocks
        for pool, name, dtype in pools:
            cuda.check(pool, name, dtype, (P, B, B, B))
        cuda.check(grid.page_table, "page table", torch.int32, (nb, nb, nb))
        cuda.check(grid.origin, "grid origin", torch.float32, (3,))
        dev = grid.page_table.device
        denses = [torch.empty((size,) * 3, dtype=dtype, device=dev) for _, _, dtype in pools]
        origin = torch.empty(3, dtype=torch.float32, device=dev)
        c = np.asarray(center, np.float32)
        descs.append(_CROP_WINDOW.pack(
            pools[0][0].data_ptr(), pools[1][0].data_ptr(), denses[0].data_ptr(),
            denses[1].data_ptr(), grid.page_table.data_ptr(), grid.origin.data_ptr(),
            origin.data_ptr(), float(c[0]), float(c[1]), float(c[2]), grid.resolution,
            pools[0][0].element_size(), pools[1][0].element_size(), B, nb, P, int(size)))
        out.append(window(*denses, origin, grid.resolution))
    _CROP_KERNEL(windows[0][0].page_table.device, b"".join(descs), len(windows))
    return out


def crop_windows(windows) -> list:
    """Dense windows [(grid, center, size), ...] of paged grids, occupancy
    (`PagedGrid3D` -> `Grid3D`) or intensity (`PagedIntensityGrid3D` ->
    `IntensityGrid3D`), each size^3 around its `center` (3 host floats);
    unallocated blocks and blocks outside the table read as zero. On the
    card one launch makes them all (at most MAX_CROP_WINDOWS)."""
    if len({grid.page_table.device for grid, _, _ in windows}) > 1:
        raise ValueError("crop windows: the grids lie on different devices")
    if not windows:
        return []
    if windows[0][0].page_table.is_cuda:
        return _crop_launch(windows)
    return [(crop_dense_intensity_plain if isinstance(grid, PagedIntensityGrid3D)
             else crop_dense_plain)(
                 grid, torch.from_numpy(np.asarray(center, np.float32).copy()), size)
            for grid, center, size in windows]


def crop_dense(grid: PagedGrid3D, center, size: int) -> Grid3D:
    """Dense size^3 Grid3D of the window centered at `center` (3 host
    floats): unallocated blocks and blocks outside the table read as
    0 / unknown."""
    return crop_windows([(grid, center, size)])[0]


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

    def _new_entries(self, cells: np.ndarray):
        """Pool slots for the blocks of the (n, 3) world cells within the
        table that have none, in block order, in the host's dict and
        mirror; -> the new table entries (flat indices, slots) that the
        device table lacks, or None."""
        B, nb = self.grid.page_size, self.grid.num_blocks
        cells = cells[np.all((cells >= 0) & (cells < nb * B), axis=-1)] // B
        self.pages_allocated_last_insert = 0
        if not len(cells):
            return None
        uniq = np.unique((cells[:, 0] * nb + cells[:, 1]) * nb + cells[:, 2])
        uniq = uniq[self._table_host.reshape(-1)[uniq] < 0]  # most blocks have a page
        keys = np.stack([uniq // (nb * nb), (uniq // nb) % nb, uniq % nb], -1)
        upd = _allocate_blocks(self._slots, self._table_host, keys, self.grid.max_pages)
        if upd is None:
            return None
        idx, vals = upd
        self.pages_allocated_last_insert = len(vals)
        return (idx[:, 0] * nb + idx[:, 1]) * nb + idx[:, 2], vals

    def _allocate_cells(self, cells: np.ndarray) -> None:
        """`_new_entries`, written to the device table without waiting."""
        _write_entries(self.grid, self._new_entries(cells))

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

    def allocate(self, returns, mask, num_free_space_voxels: int = 2):
        """Host: the blocks a scan touches (hits and the free-space cells,
        all within `num_free_space_voxels` cells of a hit) get pool slots.
        -> the new page-table entries, for `insert_paged_grids` to write."""
        cells = self._cells(np.asarray(returns, np.float32)[np.asarray(mask, bool)])
        f = num_free_space_voxels
        return self._new_entries(np.concatenate([cells - f, cells + f, cells]))

    def insert_range_data(self, origin, returns, mask, hit_probability: float = 0.55,
                          miss_probability: float = 0.49, num_free_space_voxels: int = 2,
                          device_tensors=None) -> None:
        """`allocate`, then K9 (one launch writing the new table entries and
        inserting) on `device_tensors` = (origin, returns, mask) where the
        caller holds them there already, else on uploads of the host
        arrays."""
        entries = self.allocate(returns, mask, num_free_space_voxels)
        if device_tensors is None:
            dev = self.grid.pages.device
            device_tensors = (to_device(np.asarray(origin, np.float32), dev),
                              to_device(np.asarray(returns, np.float32), dev),
                              to_device(np.asarray(mask, bool), dev))
        origin_t, returns_t, mask_t = device_tensors
        insert_paged_grids([(self.grid, mask_t, entries)], origin_t, returns_t,
                           hit_probability, miss_probability, num_free_space_voxels)

    def crop_dense(self, center, size: int) -> Grid3D:
        return crop_dense(self.grid, center, size)

    def compact(self) -> None:
        """Shrink the pool to the allocated pages, padded to a power of two,
        as a fresh tensor on the device; the full pool is freed."""
        n = self._compacted_size()
        self.grid = dataclasses.replace(self.grid, pages=self.grid.pages[:n].clone(),
                                        known=self.grid.known[:n].clone())

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
    return crop_windows([(grid, center, size)])[0]


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
