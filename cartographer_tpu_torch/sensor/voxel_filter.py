"""Voxel downsampling: the random voxel filter and the adaptive voxel filter.

Counterpart of the JAX package's `sensor/voxel_filter.py`
(sensor/internal/voxel_filter.cc). The JAX filter draws its shuffle from
`jax.random.permutation`, which PyTorch cannot reproduce; here every filter
takes the permutation `perm` (N,) int32 as an argument, so the same
permutation gives the same mask in both packages.

The wrappers launch the CUDA kernel `csrc/voxel_filter.cu` (K2) on CUDA
tensors and run the plain PyTorch twin, the JAX algorithm written in
PyTorch (shuffle, stable sort by packed key, last point of each run), on
CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from cartographer_tpu_torch.core.tensor import true_div
from cartographer_tpu_torch.ops import cuda
from cartographer_tpu_torch.sensor.point_cloud import PointCloud

_COARSE_STEPS = 7  # max_length/2^7 < 1e-2*max_length stopping rule
_BISECT_STEPS = 5  # until (high-low)/low <= 10%
_PACK_BIAS = 1 << 15  # per-axis voxel indices packed as biased 16-bit fields
_SENTINEL = 1 << 62  # sorts after every packed key of a valid point
_MAX_SHARED_BYTES = 232448

_KERNEL = cuda.CudaKernel(
    "voxel_filter.cu", "voxel_filter",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
     ctypes.c_float, ctypes.c_void_p])


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


# ---------------------------------------------------------------- kernel


def _launch(points, mask, perm, adaptive, length, min_num_points, max_range):
    n, dim = points.shape
    if dim not in (2, 3) or points.stride(1) != 1:
        raise ValueError("points must be (N, 2) or (N, 3) with unit column stride")
    if points.dtype != torch.float32 or not points.is_cuda:
        raise ValueError("points must be a float32 CUDA tensor")
    cuda.check(mask, "mask", torch.bool, (n,))
    cuda.check(perm, "perm", torch.int32, (n,))
    slots = 64
    while slots < 2 * n:
        slots *= 2
    if slots * 12 + n * 9 > _MAX_SHARED_BYTES:
        raise ValueError(f"voxel filter: {n} points exceed one block's shared memory")
    keep = torch.empty(n, dtype=torch.bool, device=points.device)
    _KERNEL(points.device, points.data_ptr(), points.stride(0), dim, mask.data_ptr(),
            perm.data_ptr(), n, slots, int(adaptive), float(length),
            int(min_num_points), float(max_range), keep.data_ptr())
    return keep


# ---------------------------------------------------------------- wrappers


def voxel_filter_mask(points: torch.Tensor, mask: torch.Tensor, resolution: float,
                      perm: torch.Tensor) -> torch.Tensor:
    """Keep-mask selecting one random point per occupied voxel of edge
    `resolution`: the point that comes last in the order `perm`."""
    if points.is_cuda:
        return _launch(points, mask, perm, False, resolution, 0, 0.0)
    return voxel_filter_mask_plain(points, mask, resolution, perm)


def adaptive_voxel_filter(cloud: PointCloud, max_length: float, min_num_points: int,
                          max_range: float, perm: torch.Tensor) -> PointCloud:
    """sensor::AdaptiveVoxelFilter (voxel_filter.cc:38-75).

    1. Drop points beyond max_range of the cloud frame origin.
    2. If <= min_num_points remain, keep all.
    3. Else halve the edge length from max_length until enough points
       survive (7 steps), then bisect to within 10% (5 steps).
    """
    if cloud.points.is_cuda:
        keep = _launch(cloud.points, cloud.mask, perm, True, max_length,
                       min_num_points, max_range)
    else:
        keep = adaptive_voxel_filter_mask_plain(cloud.points, cloud.mask, max_length,
                                                min_num_points, max_range, perm)
    return cloud.filter_mask(keep)
