"""Rotational scan histograms for 3D loop-closure yaw pruning.

Counterpart of `compute_rotational_histogram` and `rotate_histogram` in the
JAX package's `ops/rot_histogram.py` (rotational_scan_matcher.cc): the cloud
is cut into 0.2 m z-slices, each slice sorted by angle around its centroid,
and the directions between a point and its slice's running anchor are
accumulated, weighted by how perpendicular they are to the direction from
the centroid, into `histogram_size` bins over [0, pi). `match_histograms`
scores candidate yaws of the 3D loop closure: the cosine similarity of the
scan histogram rotated by each yaw against the submap's.

The histogram launches the CUDA kernel of `csrc/rot_histogram.cu` (K12),
the rotation its `rot_histogram_rotate`, `match_histograms` its `rot_match`
(K13), on CUDA tensors; CPU tensors run the plain twins. `scan_histograms`
is the 3D step's histogram of its cloud levelled by the gravity
quaternion and that histogram rotated by the matched yaw: one K12 launch,
which takes both quaternions from the device. The JAX program adds the
slice sums and the bins by scatter-add, in input order on the CPU; kernel
and twin add each slice's and each bin's members in that order
(`core/tensor.py:index_add_in_order_` for the twin), so they agree where a
last bit could flip a threshold or a bin edge. K13 sums the bins of its dot
product and norms in a pairwise halving tree over the bins, as its twin.
Both take any point and bin count: K12 keeps its arrays in one block's
shared memory up to some 3,400 points and in a device-memory scratch above.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from cartographer_tpu_torch.core.tensor import index_add_in_order_, true_div
from cartographer_tpu_torch.ops import cuda
from cartographer_tpu_torch.transform import quaternion as quat

_MIN_DISTANCE = 0.2
_MAX_DISTANCE = 0.9
_SLICE_HEIGHT = 0.2
_MAX_SLICES = 128
_INDEX_BITS = 22  # the point index in the twin's sort key

_P, _I = ctypes.c_void_p, ctypes.c_int
_KERNEL = cuda.CudaKernel("rot_histogram.cu", "rot_histogram",
                          [_P, _P, _I, _I, _P, _P, _P, _P, _P])
_ROTATE_KERNEL = cuda.CudaKernel("rot_histogram.cu", "rot_histogram_rotate",
                                 [_P, _P, _I, _P])
_MATCH_KERNEL = cuda.CudaKernel("rot_histogram.cu", "rot_match", [_P, _P, _P, _I, _I, _I, _P])
_scratch_bytes = None  # rot_histogram_scratch_bytes(n, bins), loaded at first use


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

    z = points[:, 2]
    zmin = torch.where(mask, z, torch.full_like(z, math.inf)).min()
    slice_idx = torch.floor(true_div(z - zmin, _SLICE_HEIGHT)).clamp(0, _MAX_SLICES - 1)
    slice_idx = torch.where(mask, slice_idx.long(),
                            torch.full_like(slice_idx, _MAX_SLICES, dtype=torch.int64))

    # Per-slice centroids: each slice's members added in input order.
    sums = index_add_in_order_(torch.zeros((_MAX_SLICES + 1, 2), device=dev),
                               slice_idx[mask], points[mask][:, 0:2])
    counts = torch.bincount(slice_idx[mask], minlength=_MAX_SLICES + 1).to(torch.float32)
    centroids = sums / counts.clamp(min=1.0)[:, None]

    delta_c = points[:, 0:2] - centroids[slice_idx]
    angle_c = torch.atan2(delta_c[:, 1], delta_c[:, 0]) + 0.0  # -0.0 sorts as 0.0
    norm_c = torch.sqrt(delta_c[:, 0] * delta_c[:, 0] + delta_c[:, 1] * delta_c[:, 1])
    keep = mask & (norm_c >= _MIN_DISTANCE)
    sort_slice = torch.where(keep, slice_idx, torch.full_like(slice_idx, _MAX_SLICES))

    # Stable sort by (slice, angle): one key of slice, angle bits and index.
    key = ((sort_slice << (32 + _INDEX_BITS)) | (_ordered_bits(angle_c) << _INDEX_BITS)
           | torch.arange(n, device=dev))
    order = torch.sort(key).indices
    sp = points[order][:, 0:2]
    s_slice = sort_slice[order]
    direction = sp - centroids[s_slice]
    dirn = torch.sqrt(direction[:, 0] * direction[:, 0] + direction[:, 1] * direction[:, 1])
    valid = s_slice < _MAX_SLICES
    is_new = torch.ones(n, dtype=torch.bool, device=dev)
    is_new[1:] = s_slice[1:] != s_slice[:-1]

    # The anchor walk: sequential within a slice, the anchor resets where
    # the slice changes and advances past gaps above _MAX_DISTANCE. The kept
    # points sort first; the rest emit nothing and keep their own place.
    may_advance = valid & (dirn >= _MIN_DISTANCE)
    anchors = []
    last = sp[0]
    for i in range(int(valid.sum())):
        last = torch.where(is_new[i], sp[i], last)
        anchors.append(last)
        d = sp[i] - last
        far = torch.sqrt(d[0] * d[0] + d[1] * d[1]) > _MAX_DISTANCE
        last = torch.where(may_advance[i] & far, sp[i], last)
    delta = sp - torch.cat([torch.stack(anchors) if anchors else sp[:0], sp[len(anchors):]])
    distance = torch.sqrt(delta[:, 0] * delta[:, 0] + delta[:, 1] * delta[:, 1])
    emit = (valid & ~is_new & (distance >= _MIN_DISTANCE) & (dirn >= _MIN_DISTANCE)
            & (distance <= _MAX_DISTANCE))
    angle = torch.atan2(delta[:, 1], delta[:, 0])
    u = delta / distance.clamp(min=1e-9)[:, None]
    v = direction / dirn.clamp(min=1e-9)[:, None]
    value = (1.0 - (u[:, 0] * v[:, 0] + u[:, 1] * v[:, 1]).abs()).clamp(min=0.0)

    # Angles map to [0, pi): a direction and its opposite are the same. Each
    # bin adds its emitted weights in sorted order (a zero adds nothing).
    a = torch.remainder(angle, math.pi)
    bucket = torch.floor(true_div(histogram_size * a, math.pi) - 0.5 + 0.5)
    bucket = bucket.clamp(0, histogram_size - 1).long()
    return index_add_in_order_(torch.zeros(histogram_size, device=dev), bucket[emit],
                               value[emit])


def _check_cloud(points, mask, histogram_size):
    n = points.shape[0]
    cuda.check(points, "points", torch.float32, (n, 3))
    cuda.check(mask, "mask", torch.bool, (n,))
    if _padded_size(n) > 1 << _INDEX_BITS or histogram_size < 1:
        raise ValueError(f"rotational histogram: at most {1 << _INDEX_BITS} points and at "
                         f"least one bin, got {n} and {histogram_size}")
    return n


def _scratch(n: int, bins: int, dev) -> Optional[torch.Tensor]:
    """K12's device-memory scratch, where its arrays outgrow shared memory."""
    global _scratch_bytes
    if _scratch_bytes is None:
        _scratch_bytes = cuda.host_function("rot_histogram.cu", "rot_histogram_scratch_bytes",
                                            [_I, _I], ctypes.c_longlong)
    nbytes = _scratch_bytes(n, bins)
    return torch.empty(nbytes, dtype=torch.uint8, device=dev) if nbytes else None


def _launch(points, mask, bins, gravity=None, est_q=None):
    n, dev = _check_cloud(points, mask, bins), points.device
    hist = torch.empty(bins, dtype=torch.float32, device=dev)
    rotated = torch.empty(bins, dtype=torch.float32, device=dev) if est_q is not None else None
    scratch = _scratch(n, bins, dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _KERNEL(dev, points.data_ptr(), mask.data_ptr(), n, bins, ptr(gravity), ptr(est_q),
            hist.data_ptr(), ptr(rotated), ptr(scratch))
    return hist, rotated


def compute_rotational_histogram(points: torch.Tensor, mask: torch.Tensor,
                                 histogram_size: int = 120) -> torch.Tensor:
    """RotationalScanMatcher::ComputeHistogram of the masked (N, 3) cloud;
    returns (histogram_size,). An empty cloud gives zeros."""
    if not points.is_cuda:
        return rotational_histogram_plain(points, mask, histogram_size)
    return _launch(points, mask, histogram_size)[0]


def level_quaternion(gravity: torch.Tensor) -> torch.Tensor:
    """The gravity alignment with its yaw taken out: from_yaw(-yaw(g)) * g."""
    return quat.multiply(quat.from_yaw(-quat.get_yaw(gravity)), gravity)


def scan_histograms_plain(points, mask, gravity, est_q, histogram_size: int = 120):
    """The twin of `scan_histograms`: the levelling, the histogram and its
    rotation by the plain functions."""
    levelled = quat.rotate_expanded(level_quaternion(gravity), points)
    hist = rotational_histogram_plain(levelled, mask, histogram_size)
    return hist, rotate_histogram_plain(hist, quat.get_yaw(est_q))


def scan_histograms(points: torch.Tensor, mask: torch.Tensor, gravity: torch.Tensor,
                    est_q: torch.Tensor, histogram_size: int = 120):
    """The 3D step's histograms: of the (N, 3) cloud levelled by the gravity
    quaternion with its yaw taken out, and that histogram rotated by the yaw
    of `est_q` (both quaternions (4,) on the cloud's device) -> (hist,
    rotated hist). One K12 launch on CUDA tensors."""
    if not points.is_cuda:
        return scan_histograms_plain(points, mask, gravity, est_q, histogram_size)
    cuda.check(gravity, "gravity", torch.float32, (4,))
    cuda.check(est_q, "est_q", torch.float32, (4,))
    return _launch(points, mask, histogram_size, gravity, est_q)


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
    if size < 1:
        raise ValueError("match_histograms: the histograms have no bins")
    out = torch.empty(a, dtype=torch.float32, device=angles.device)
    if a:
        _MATCH_KERNEL(angles.device, scan_histogram.data_ptr(), submap_histogram.data_ptr(),
                      angles.data_ptr(), a, size, _padded_size(size), out.data_ptr())
    return out
