"""Voxel downsampling: the random, adaptive and edge voxel filters.

Counterpart of the JAX package's `sensor/voxel_filter.py`
(sensor/internal/voxel_filter.cc). The JAX filter draws its shuffle from
`jax.random.permutation`, which PyTorch cannot reproduce; here every filter
takes the permutation `perm` (N,) int32 as an argument, so the same
permutation gives the same mask in both packages.

The wrappers launch the CUDA kernel `csrc/voxel_filter.cu` (K2) on CUDA
tensors and run the plain PyTorch twin, the JAX algorithm written in
PyTorch (shuffle, stable sort by packed key, last point of each run), on
CPU tensors. The kernel takes clouds of any size: above one block's shared
memory its hash tables move to a device-memory scratch that the wrapper
passes. Clouds with a leading robot dimension (R, N, D), one permutation
row per robot, are one launch for every robot; `adaptive_voxel_filter_masks`
runs two adaptive filters over the same clouds in that one launch, and
`voxel_filter_masks` the random filter and up to two adaptive filters over
its output (the 2D step's three filters; one robot is its R = 1 case). The
fork's edge filter (`voxel_filter_edge`) keeps the points of sparsely
populated voxels: K31 in the same source on CUDA tensors, its plain twin
(the JAX program: sorted keys, run lengths) on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cartographer_tpu_torch.core.tensor import f32, true_div
from cartographer_tpu_torch.ops import cuda
from cartographer_tpu_torch.sensor.point_cloud import PointCloud

_COARSE_STEPS = 7  # max_length/2^7 < 1e-2*max_length stopping rule
_BISECT_STEPS = 5  # until (high-low)/low <= 10%
_PACK_BIAS = 1 << 15  # per-axis voxel indices packed as biased 16-bit fields
_SENTINEL = 1 << 62  # sorts after every packed key of a valid point

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_KERNEL = cuda.CudaKernel(
    "voxel_filter.cu", "voxel_filter",
    [_P, _I, _L, _P, _L, _P, _L, _I, _I, _F, _I, _I, _I, _F, _I, _F, _F, _I, _F, _P, _P, _L])
_MAX_FILTERS = 2  # kMaxFilters
_EDGE_KERNEL = cuda.CudaKernel(
    "voxel_filter.cu", "voxel_filter_edge",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])


# ---------------------------------------------------------------- plain twin


def _packed_voxel_keys(points: torch.Tensor, mask: torch.Tensor, resolution) -> torch.Tensor:
    """int64 voxel key: (ix << 16 | iy) in the low word, iz in the high word
    for 3D clouds; masked points get a sentinel that sorts last."""
    idx = torch.floor(true_div(points, resolution) + 0.5)
    idx = idx.clamp(-_PACK_BIAS, _PACK_BIAS - 2).to(torch.int64) + _PACK_BIAS
    key = idx[:, 0] * 65536 + idx[:, 1]
    if points.shape[-1] == 3:
        key = key + idx[:, 2] * (1 << 32)
    return torch.where(mask, key, torch.full_like(key, _SENTINEL))


def voxel_filter_mask_plain(points, mask, resolution, perm) -> torch.Tensor:
    perm = perm.long()
    keys = _packed_voxel_keys(points[perm], mask[perm], resolution)
    sorted_keys, order = torch.sort(keys, stable=True)
    is_last = torch.ones_like(mask)
    is_last[:-1] = sorted_keys[:-1] != sorted_keys[1:]
    keep = torch.zeros_like(mask)
    keep[perm[order]] = is_last
    return keep & mask


def adaptive_voxel_filter_mask_plain(points, mask, max_length, min_num_points,
                                     max_range, perm) -> torch.Tensor:
    """adaptive_voxel_filter's keep-mask, written with tensor selects only
    (no host synchronisation), as JAX traces it."""
    in_range = torch.linalg.norm(points, dim=-1) <= max_range
    base = mask & in_range
    num_base = base.sum()

    def count_at(length):
        return voxel_filter_mask_plain(points, base, length, perm).sum()

    lengths = true_div(
        torch.full((_COARSE_STEPS,), max_length, dtype=torch.float32, device=points.device),
        2.0 ** torch.arange(_COARSE_STEPS, dtype=torch.float32, device=points.device))
    ok = torch.stack([count_at(length) for length in lengths]) >= min_num_points
    first_ok = torch.argmax(ok.to(torch.int32))
    any_ok = ok.any()
    low = torch.where(any_ok, lengths[first_ok], lengths[-1])
    high = torch.where(first_ok > 0, lengths[(first_ok - 1).clamp(min=0)], lengths[0])
    for _ in range(_BISECT_STEPS):
        mid = 0.5 * (low + high)
        enough = count_at(mid) >= min_num_points
        low, high = torch.where(enough, mid, low), torch.where(enough, high, mid)
    chosen = torch.where(first_ok == 0, lengths[0], low)
    keep = torch.where(num_base <= min_num_points, base,
                       voxel_filter_mask_plain(points, base, chosen, perm))
    return torch.where((num_base > min_num_points) & ~any_ok,
                       voxel_filter_mask_plain(points, base, lengths[-1], perm), keep)


def voxel_filter_edge_plain(points, mask, resolution, voxel_edge_ratio) -> torch.Tensor:
    """The plain twin of K31: the JAX program's sort, run lengths and
    threshold int32(float32(max_count) * float32(ratio))."""
    n = points.shape[0]
    keys = _packed_voxel_keys(points, mask, resolution)
    sorted_keys, order = torch.sort(keys, stable=True)
    run_start = torch.ones_like(mask)
    run_start[1:] = sorted_keys[1:] != sorted_keys[:-1]
    run_id = torch.cumsum(run_start.to(torch.int64), 0) - 1
    counts = torch.bincount(run_id, minlength=n)
    per_point = torch.empty_like(counts)
    per_point[order] = counts[run_id]
    max_count = torch.where(mask, per_point, torch.zeros_like(per_point)).max()
    ratio = torch.tensor(voxel_edge_ratio, dtype=torch.float32, device=points.device)
    threshold = (max_count.to(torch.float32) * ratio).to(torch.int64)
    return mask & (per_point < threshold)


# ---------------------------------------------------------------- kernel


@functools.lru_cache(maxsize=None)
def scratch_bytes(n, robots, pre_dim, filters, dim, scan=False):
    """The kernel's own `voxel_filter_scratch_bytes`: 16 up to one block's
    shared memory, else a slice of device memory per block (`scan`: the 2D
    step's launch with K1 in it, `scan_pipeline_2d`)."""
    return cuda.host_function("voxel_filter.cu", "voxel_filter_scratch_bytes",
                              [_I] * 6, _L)(n, robots, pre_dim, filters, dim, int(scan))


def _launch(points, mask, perm, resolution, filters, dim):
    """K2 over a (N, D) cloud or R robots' (R, N, D) clouds, with masks and
    permutations of the clouds' leading shape: one launch. With a
    `resolution` the random filter over the D coordinates, then the
    len(filters) adaptive filters (each (max_length, min_num_points,
    max_range)) over the first `dim` coordinates of the points it keeps.
    -> keep-masks (outputs, N) or (outputs, R, N), the random filter's
    first."""
    robots = points.shape[0] if points.dim() == 3 else None
    n, width = points.shape[-2], points.shape[-1]
    if width not in (2, 3) or dim not in (2, 3) or dim > width or points.stride(-1) != 1:
        raise ValueError("points must be (..., N, 2) or (..., N, 3) with unit column stride")
    if points.dtype != torch.float32 or not points.is_cuda:
        raise ValueError("points must be a float32 CUDA tensor")
    if len(filters) > _MAX_FILTERS or (resolution is None and not filters):
        raise ValueError(f"one launch takes a random filter and up to {_MAX_FILTERS} adaptive "
                         f"filters, at least one of them: got {len(filters)} adaptive filters"
                         f"{'' if resolution is not None else ' and no random filter'}")
    mask_rs = cuda.robot_stride(mask, "mask", torch.bool, (n,), robots)
    perm_rs = cuda.robot_stride(perm, "perm", torch.int32, (n,), robots)
    pre_dim = 0 if resolution is None else width
    lead = () if robots is None else (robots,)
    keep = torch.empty(((resolution is not None) + len(filters), *lead, n), dtype=torch.bool,
                       device=points.device)
    scratch = torch.empty(scratch_bytes(n, robots or 1, pre_dim, len(filters), dim),
                          dtype=torch.uint8, device=points.device)
    (l0, m0, r0), (l1, m1, r1) = (filters[0], filters[-1]) if filters else ((0.0, 0, 0.0),) * 2
    _KERNEL(points.device, points.data_ptr(), points.stride(-2),
            points.stride(0) if robots is not None and robots > 1 else 0, mask.data_ptr(),
            mask_rs, perm.data_ptr(), perm_rs, n, robots or 1,
            0.0 if resolution is None else float(resolution), pre_dim, len(filters), dim,
            float(l0), int(m0), float(r0), float(l1), int(m1), float(r1), keep.data_ptr(),
            scratch.data_ptr(), scratch.numel())
    return keep


# ---------------------------------------------------------------- wrappers


def voxel_filter_mask(points: torch.Tensor, mask: torch.Tensor, resolution: float,
                      perm: torch.Tensor) -> torch.Tensor:
    """Keep-mask selecting one random point per occupied voxel of edge
    `resolution`: the point that comes last in the order `perm`. `points`
    (N, D), or (R, N, D) with `mask` and `perm` (R, N): R robots' clouds."""
    if points.is_cuda:
        return _launch(points, mask, perm, resolution, [], points.shape[-1])[0]
    if points.dim() == 2:
        return voxel_filter_mask_plain(points, mask, resolution, perm)
    return torch.stack([voxel_filter_mask_plain(p, m, resolution, q)
                        for p, m, q in zip(points, mask, perm)])


def adaptive_voxel_filter_masks(points: torch.Tensor, mask: torch.Tensor, filters,
                                perm: torch.Tensor):
    """The keep-masks of up to two adaptive filters (each `(max_length,
    min_num_points, max_range)`) over the same clouds: `points` (N, D) or
    (R, N, D), `mask` and `perm` (N,) or (R, N); one mask per filter, of
    `mask`'s shape. On CUDA tensors every filter and robot is one launch."""
    if points.is_cuda:
        return list(_launch(points, mask, perm, None, list(filters), points.shape[-1]))
    if points.dim() == 2:
        return [adaptive_voxel_filter_mask_plain(points, mask, length, num, max_range, perm)
                for length, num, max_range in filters]
    return [torch.stack([adaptive_voxel_filter_mask_plain(p, m, length, num, max_range, q)
                         for p, m, q in zip(points, mask, perm)])
            for length, num, max_range in filters]


def voxel_filter_masks(points: torch.Tensor, mask: torch.Tensor, resolution: float,
                       perm: torch.Tensor, adaptive_filters=(), adaptive_dim=None):
    """The random filter's keep-mask at `resolution` over all D coordinates
    of `points` ((N, D) or (R, N, D)), then the keep-masks of up to two
    adaptive filters (each `(max_length, min_num_points, max_range)`) over
    the first `adaptive_dim` (default D) coordinates of the points it keeps.
    -> [random, *adaptive], each of `mask`'s shape; one launch on CUDA
    tensors."""
    dim = points.shape[-1] if adaptive_dim is None else adaptive_dim
    if points.is_cuda:
        return list(_launch(points, mask, perm, resolution, list(adaptive_filters), dim))
    keep = voxel_filter_mask(points, mask, resolution, perm)
    if not adaptive_filters:
        return [keep]
    return [keep, *adaptive_voxel_filter_masks(points[..., 0:dim], keep, adaptive_filters, perm)]


def adaptive_voxel_filter(cloud: PointCloud, max_length: float, min_num_points: int,
                          max_range: float, perm: torch.Tensor) -> PointCloud:
    """sensor::AdaptiveVoxelFilter (voxel_filter.cc:38-75).

    1. Drop points beyond max_range of the cloud frame origin.
    2. If <= min_num_points remain, keep all.
    3. Else halve the edge length from max_length until enough points
       survive (7 steps), then bisect to within 10% (5 steps).
    """
    keep, = adaptive_voxel_filter_masks(cloud.points, cloud.mask,
                                        [(max_length, min_num_points, max_range)], perm)
    return cloud.filter_mask(keep)


def voxel_filter_edge_mask(points: torch.Tensor, mask: torch.Tensor, resolution: float,
                           voxel_edge_ratio: float = 0.5) -> torch.Tensor:
    """Keep-mask of the fork's edge filter (voxel_filter.cc
    EdgeVoxelFilterIndices): the valid points whose voxel of edge
    `resolution` holds fewer than `voxel_edge_ratio` x the largest voxel's
    population."""
    n, dim = points.shape
    if n == 0:
        return mask.clone()
    if not points.is_cuda:
        return voxel_filter_edge_plain(points, mask, resolution, voxel_edge_ratio)
    if dim not in (2, 3) or points.stride(1) != 1 or points.dtype != torch.float32:
        raise ValueError("points must be (N, 2) or (N, 3) float32 with unit column stride")
    cuda.check(mask, "mask", torch.bool, (n,))
    keep = torch.empty(n, dtype=torch.bool, device=points.device)
    keys = torch.empty(max(2, 1 << (n - 1).bit_length()), dtype=torch.int64,
                       device=points.device)
    counts = torch.empty(n + 1, dtype=torch.int32, device=points.device)
    _EDGE_KERNEL(points.device, points.data_ptr(), points.stride(0), dim, mask.data_ptr(), n,
                 f32(resolution), f32(voxel_edge_ratio), keep.data_ptr(), keys.data_ptr(),
                 counts.data_ptr())
    return keep


def voxel_filter_edge(cloud: PointCloud, resolution: float,
                      voxel_edge_ratio: float = 0.5) -> PointCloud:
    """The fork's edge-preserving filter: points on sparsely sampled
    structure (edges) survive."""
    return cloud.filter_mask(voxel_filter_edge_mask(cloud.points, cloud.mask, resolution,
                                                    voxel_edge_ratio))
