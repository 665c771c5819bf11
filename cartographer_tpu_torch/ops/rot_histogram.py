"""Rotational scan histograms for 3D loop-closure yaw pruning.

Counterpart of `compute_rotational_histogram` and `rotate_histogram` in the
JAX package's `ops/rot_histogram.py` (rotational_scan_matcher.cc): the cloud
is cut into 0.2 m z-slices, each slice sorted by angle around its centroid,
and the directions between a point and its slice's running anchor are
accumulated, weighted by how perpendicular they are to the direction from
the centroid, into `histogram_size` bins over [0, pi). `match_histograms`
scores candidate yaws of the 3D loop closure: the cosine similarity of the
scan histogram rotated by each yaw against the submap's.

The histogram and its rotation launch the CUDA kernels of
`csrc/rot_histogram.cu` (K12), `match_histograms` its `rot_match` (K13), on
CUDA tensors; CPU tensors run the plain twins. The JAX program adds the
slice sums and the bins by scatter-add, whose order of additions a device
does not fix; kernel and twin both add in one fixed order, a pairwise
halving tree over the points (padded to a power of two), so they agree
where a last bit could flip a threshold or a bin edge. K13 sums the bins of
its dot product and norms in the same tree.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from cartographer_tpu_torch.core.tensor import true_div
from cartographer_tpu_torch.ops import cuda

_MIN_DISTANCE = 0.2
_MAX_DISTANCE = 0.9
_SLICE_HEIGHT = 0.2
_MAX_SLICES = 128
MAX_POINTS = 1024  # one block, one thread per point; 10 index bits in the sort key
MAX_BINS = 1024

_P, _I = ctypes.c_void_p, ctypes.c_int
_KERNEL = cuda.CudaKernel("rot_histogram.cu", "rot_histogram", [_P, _P, _I, _I, _I, _P])
_ROTATE_KERNEL = cuda.CudaKernel("rot_histogram.cu", "rot_histogram_rotate",
                                 [_P, _P, _I, _P])
_MATCH_KERNEL = cuda.CudaKernel("rot_histogram.cu", "rot_match", [_P, _P, _P, _I, _I, _I, _P])


def _padded_size(n: int) -> int:
    size = 32
    while size < n:
        size *= 2
    return size


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a power of two) as a pairwise halving tree:
    x[i] + x[i + n / 2], then the same on the result."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _ordered_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 in [0, 2^32) that sorts as the floats do."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where((b & 0x80000000) != 0, ~b & 0xFFFFFFFF, b | 0x80000000)


def rotational_histogram_plain(points: torch.Tensor, mask: torch.Tensor,
                               histogram_size: int = 120) -> torch.Tensor:
    dev = points.device
    n = _padded_size(points.shape[0])
    pad = n - points.shape[0]
    points = torch.cat([points, torch.zeros((pad, 3), dtype=points.dtype, device=dev)])
    mask = torch.cat([mask, torch.zeros(pad, dtype=torch.bool, device=dev)])
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    z = points[:, 2]
    zmin = torch.where(mask, z, torch.full_like(z, math.inf)).min()
    slice_idx = torch.floor(true_div(z - zmin, _SLICE_HEIGHT)).clamp(0, _MAX_SLICES - 1)
    slice_idx = torch.where(mask, slice_idx.long(),
                            torch.full_like(slice_idx, _MAX_SLICES, dtype=torch.int64))

    # Per-slice centroids: segment sums in the fixed tree order.
    member = slice_idx[None, :] == torch.arange(_MAX_SLICES + 1, device=dev)[:, None]
    member = member & mask[None, :]
    sums = torch.stack([_tree_sum(torch.where(member, points[None, :, a], zero))
                        for a in range(2)], dim=-1)
    counts = member.sum(dim=-1).to(torch.float32)
    centroids = sums / counts.clamp(min=1.0)[:, None]

    delta_c = points[:, 0:2] - centroids[slice_idx]
    angle_c = torch.atan2(delta_c[:, 1], delta_c[:, 0]) + 0.0  # -0.0 sorts as 0.0
    norm_c = torch.sqrt(delta_c[:, 0] * delta_c[:, 0] + delta_c[:, 1] * delta_c[:, 1])
    keep = mask & (norm_c >= _MIN_DISTANCE)
    sort_slice = torch.where(keep, slice_idx, torch.full_like(slice_idx, _MAX_SLICES))

    # Stable sort by (slice, angle): one key of slice, angle bits and index.
    key = (sort_slice << 42) | (_ordered_bits(angle_c) << 10) | torch.arange(n, device=dev)
    order = torch.sort(key).indices
    sp = points[order][:, 0:2]
    s_slice = sort_slice[order]
    direction = sp - centroids[s_slice]
    dirn = torch.sqrt(direction[:, 0] * direction[:, 0] + direction[:, 1] * direction[:, 1])
    valid = s_slice < _MAX_SLICES
    is_new = torch.ones(n, dtype=torch.bool, device=dev)
    is_new[1:] = s_slice[1:] != s_slice[:-1]

    # The anchor walk: sequential within a slice, the anchor resets where
    # the slice changes and advances past gaps above _MAX_DISTANCE.
    may_advance = valid & (dirn >= _MIN_DISTANCE)
    anchors = []
    last = sp[0]
    for i in range(n):
        last = torch.where(is_new[i], sp[i], last)
        anchors.append(last)
        d = sp[i] - last
        far = torch.sqrt(d[0] * d[0] + d[1] * d[1]) > _MAX_DISTANCE
        last = torch.where(may_advance[i] & far, sp[i], last)
    delta = sp - torch.stack(anchors)
    distance = torch.sqrt(delta[:, 0] * delta[:, 0] + delta[:, 1] * delta[:, 1])
    emit = (valid & ~is_new & (distance >= _MIN_DISTANCE) & (dirn >= _MIN_DISTANCE)
            & (distance <= _MAX_DISTANCE))
    angle = torch.atan2(delta[:, 1], delta[:, 0])
    u = delta / distance.clamp(min=1e-9)[:, None]
    v = direction / dirn.clamp(min=1e-9)[:, None]
    value = (1.0 - (u[:, 0] * v[:, 0] + u[:, 1] * v[:, 1]).abs()).clamp(min=0.0)
    value = torch.where(emit, value, zero)

    # Angles map to [0, pi): a direction and its opposite are the same.
    a = torch.remainder(angle, math.pi)
    bucket = torch.floor(true_div(histogram_size * a, math.pi) - 0.5 + 0.5)
    bucket = bucket.clamp(0, histogram_size - 1).long()
    in_bin = bucket[None, :] == torch.arange(histogram_size, device=dev)[:, None]
    return _tree_sum(torch.where(in_bin, value[None, :], zero))


def compute_rotational_histogram(points: torch.Tensor, mask: torch.Tensor,
                                 histogram_size: int = 120) -> torch.Tensor:
    """RotationalScanMatcher::ComputeHistogram of the masked (N, 3) cloud;
    returns (histogram_size,). An empty cloud gives zeros."""
    if not points.is_cuda:
        return rotational_histogram_plain(points, mask, histogram_size)
    n = points.shape[0]
    cuda.check(points, "points", torch.float32, (n, 3))
    cuda.check(mask, "mask", torch.bool, (n,))
    if n > MAX_POINTS or not 0 < histogram_size <= MAX_BINS:
        raise ValueError(f"rotational histogram: at most {MAX_POINTS} points and "
                         f"{MAX_BINS} bins, got {n} and {histogram_size}")
    hist = torch.empty(histogram_size, dtype=torch.float32, device=points.device)
    _KERNEL(points.device, points.data_ptr(), mask.data_ptr(), n, _padded_size(n),
            histogram_size, hist.data_ptr())
    return hist


def rotate_histogram_plain(histogram: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    size = histogram.shape[0]
    shift = true_div(angle * size, math.pi)
    lo = torch.floor(shift)
    frac = shift - lo
    upper = torch.remainder(torch.arange(size, device=histogram.device) - lo.long(), size)
    lower = torch.remainder(upper - 1, size)
    return (1.0 - frac) * histogram[upper] + frac * histogram[lower]


def rotate_histogram(histogram: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotate the histogram's content by +angle (a 0-dim tensor on the
    histogram's device) with linear interpolation between bins
    (RotationalScanMatcher::RotateHistogram): a feature at bin b moves to
    bin b + angle * size / pi."""
    if not histogram.is_cuda:
        return rotate_histogram_plain(histogram, angle)
    size = histogram.shape[0]
    cuda.check(histogram, "histogram", torch.float32, (size,))
    cuda.check(angle, "angle", torch.float32, ())
    out = torch.empty_like(histogram)
    _ROTATE_KERNEL(histogram.device, histogram.data_ptr(), angle.data_ptr(), size,
                   out.data_ptr())
    return out


def _rotated_rows(histogram: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """(A, size): the histogram rotated by each angle, as rotate_histogram."""
    size = histogram.shape[0]
    shift = true_div(angles * size, math.pi)[:, None]
    lo = torch.floor(shift)
    frac = shift - lo
    upper = torch.remainder(torch.arange(size, device=histogram.device)[None, :] - lo.long(), size)
    lower = torch.remainder(upper - 1, size)
    return (1.0 - frac) * histogram[upper] + frac * histogram[lower]


def match_histograms_plain(submap_histogram: torch.Tensor, scan_histogram: torch.Tensor,
                           angles: torch.Tensor) -> torch.Tensor:
    size = scan_histogram.shape[0]
    pad = _padded_size(size) - size
    rotated = F.pad(_rotated_rows(scan_histogram, angles), (0, pad))
    sub = F.pad(submap_histogram, (0, pad))[None, :]
    dot = _tree_sum(rotated * sub)
    denom = torch.sqrt(_tree_sum(rotated * rotated)) * torch.sqrt(_tree_sum(sub * sub))
    return dot / torch.clamp(denom, min=1e-9)


def match_histograms(submap_histogram: torch.Tensor, scan_histogram: torch.Tensor,
                     angles: torch.Tensor) -> torch.Tensor:
    """Cosine similarity of the scan histogram rotated by each of the angles
    (A,) against the submap histogram (RotationalScanMatcher::Match);
    returns (A,)."""
    if not angles.is_cuda:
        return match_histograms_plain(submap_histogram, scan_histogram, angles)
    size, a = scan_histogram.shape[0], angles.shape[0]
    cuda.check(scan_histogram, "scan_histogram", torch.float32, (size,))
    cuda.check(submap_histogram, "submap_histogram", torch.float32, (size,))
    cuda.check(angles, "angles", torch.float32, (a,))
    if not 0 < size <= MAX_BINS:
        raise ValueError(f"match_histograms: at most {MAX_BINS} bins, got {size}")
    out = torch.empty(a, dtype=torch.float32, device=angles.device)
    if a:
        _MATCH_KERNEL(angles.device, scan_histogram.data_ptr(), submap_histogram.data_ptr(),
                      angles.data_ptr(), a, size, _padded_size(size), out.data_ptr())
    return out
