"""Scan preprocessing for the 2D frontend.

Counterpart of the JAX package's `ops/scan_pipeline_2d.py`
(LocalTrajectoryBuilder2D::AddRangeData, local_trajectory_builder_2d.cc
:104-225): per-point motion unwarping between the scan-start and scan-end
poses (translation lerp + rotation slerp), range gating, missing-data ray
clamping, gravity alignment about the scan-end pose, z cropping and the
voxel filter.

On CUDA tensors `preprocess_and_filter_scan_2d`, the step's entry, is one
launch of `csrc/voxel_filter.cu` `scan_filter_2d`: the per-point pass (K1)
inside the voxel filter's launch (K2) with the step's two adaptive
filters; `align_scan` launches K1 alone (`csrc/scan_preprocess_2d.cu`, the
same per-point code: the fused launch's reference). On CPU tensors both
run their plain twins.
Every argument may carry a leading robot dimension R (the cross-robot
batched step): each kernel is then one launch for all R robots, and one
robot is its R = 1 case; the plain twins run robot by robot.
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct
from typing import Tuple

import numpy as np
import torch

from cartographer_tpu_torch.ops import cuda
from cartographer_tpu_torch.sensor.point_cloud import PointCloud, RangeData
from cartographer_tpu_torch.sensor.voxel_filter import scratch_bytes, voxel_filter_masks
from cartographer_tpu_torch.transform.interpolation import interpolate_rigid3
from cartographer_tpu_torch.transform.rigid import Rigid3

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_KERNEL = cuda.CudaKernel("scan_preprocess_2d.cu", "scan_preprocess_2d",
                          [_P] * 10 + [_I] * 2 + [_F] * 5 + [_P] * 5)
_SCAN_FILTER_KERNEL = cuda.CudaKernel(
    "voxel_filter.cu", "scan_filter_2d",
    [_P, _P, _L, _I, _I, _F, _I, _F, _I, _F, _F, _I, _F, _P, _P, _L])
# K1's inputs, robot strides, parameters and outputs, `scan2d::ScanArgs` of
# csrc/scan_preprocess_2d.cuh: nine input pointers, their nine strides, five
# parameters, five output pointers.
_SCAN_ARGS = struct.Struct("=9Q9q5f4x5Q")
_MAX_FILTERS = 2


@dataclasses.dataclass(frozen=True)
class ScanPreprocessParams2D:
    min_range: float = 0.0
    max_range: float = 30.0
    min_z: float = -0.8
    max_z: float = 2.0
    missing_data_ray_length: float = 5.0
    voxel_filter_size: float = 0.025


def align_scan_plain(points, times01, mask, origin, pose_start: Rigid3, pose_end: Rigid3,
                     gravity_rotation, params: ScanPreprocessParams2D):
    """Plain twin of K1: -> (hits (N, 3), misses (N, 2), is_return (N,),
    is_miss (N,), origin (3,)), all in the gravity-aligned frame."""
    poses = interpolate_rigid3(
        Rigid3(pose_start.translation[None], pose_start.rotation[None]),
        Rigid3(pose_end.translation[None], pose_end.rotation[None]), times01)
    hits_local = poses.apply(points)
    origins_local = poses.apply(origin)
    deltas = hits_local - origins_local
    ranges = torch.linalg.norm(deltas, dim=-1)
    is_return = mask & (ranges >= params.min_range) & (ranges <= params.max_range)
    is_miss = mask & (ranges > params.max_range)
    safe_ranges = torch.clamp(ranges, min=1e-6)
    scale = torch.full_like(safe_ranges, params.missing_data_ray_length) / safe_ranges
    miss_local = origins_local + deltas * scale[:, None]
    align = Rigid3(torch.zeros_like(pose_end.translation), gravity_rotation).compose(
        pose_end.inverse())
    hits = align.apply(hits_local)
    misses = align.apply(miss_local)
    origin_aligned = align.apply(pose_end.translation)
    is_return = is_return & (hits[:, 2] >= params.min_z) & (hits[:, 2] <= params.max_z)
    is_miss = is_miss & (misses[:, 2] >= params.min_z) & (misses[:, 2] <= params.max_z)
    return hits, misses[:, 0:2].contiguous(), is_return, is_miss, origin_aligned


def _k1_launch_args(points, times01, mask, origin, pose_start, pose_end, gravity_rotation):
    """K1's inputs checked: -> (robots or None, n, the nine tensors, their
    robot strides (elements), the outputs (hits, misses, is_return,
    is_miss, origin))."""
    robots = points.shape[0] if points.dim() == 3 else None
    n = points.shape[-2]
    inputs = (("points", points, torch.float32, (n, 3)),
              ("times01", times01, torch.float32, (n,)),
              ("mask", mask, torch.bool, (n,)),
              ("origins", origin, torch.float32, (n, 3)),
              ("pose_start.translation", pose_start.translation, torch.float32, (3,)),
              ("pose_start.rotation", pose_start.rotation, torch.float32, (4,)),
              ("pose_end.translation", pose_end.translation, torch.float32, (3,)),
              ("pose_end.rotation", pose_end.rotation, torch.float32, (4,)),
              ("gravity_rotation", gravity_rotation, torch.float32, (4,)))
    strides = [cuda.robot_stride(t, name, dtype, inner, robots)
               for name, t, dtype, inner in inputs]
    device, lead = points.device, (() if robots is None else (robots,))
    outputs = (torch.empty((*lead, n, 3), dtype=torch.float32, device=device),
               torch.empty((*lead, n, 2), dtype=torch.float32, device=device),
               torch.empty((*lead, n), dtype=torch.bool, device=device),
               torch.empty((*lead, n), dtype=torch.bool, device=device),
               torch.empty((*lead, 3), dtype=torch.float32, device=device))
    return robots, n, [t for _, t, _, _ in inputs], strides, outputs


def _align_kernel(points, times01, mask, origin, pose_start, pose_end, gravity_rotation,
                  params):
    robots, n, inputs, strides, outputs = _k1_launch_args(
        points, times01, mask, origin, pose_start, pose_end, gravity_rotation)
    strides = np.array(strides, np.int64)
    _KERNEL(points.device, *(t.data_ptr() for t in inputs), strides.ctypes.data,
            robots or 1, n, float(params.min_range), float(params.max_range),
            float(params.min_z), float(params.max_z), float(params.missing_data_ray_length),
            *(t.data_ptr() for t in outputs))
    return outputs


def _scan_filter_kernel(points, times01, mask, origin, pose_start, pose_end, gravity_rotation,
                        params, perm, adaptive_filters):
    """K1 and K2 in one launch: -> (K1's five outputs, [random filter's
    keep-mask, one per adaptive filter])."""
    robots, n, inputs, strides, outputs = _k1_launch_args(
        points, times01, mask, origin, pose_start, pose_end, gravity_rotation)
    if len(adaptive_filters) > _MAX_FILTERS:
        raise ValueError(f"one launch takes up to {_MAX_FILTERS} adaptive filters")
    perm_rs = cuda.robot_stride(perm, "perm", torch.int32, (n,), robots)
    device, lead = points.device, (() if robots is None else (robots,))
    keep = torch.empty((1 + len(adaptive_filters), *lead, n), dtype=torch.bool, device=device)
    scratch = torch.empty(scratch_bytes(n, robots or 1, 3, len(adaptive_filters), 2, True),
                          dtype=torch.uint8, device=device)
    scan = _SCAN_ARGS.pack(
        *(t.data_ptr() for t in inputs), *strides, float(params.min_range),
        float(params.max_range), float(params.min_z), float(params.max_z),
        float(params.missing_data_ray_length), *(t.data_ptr() for t in outputs))
    filters = list(adaptive_filters)
    (l0, m0, r0), (l1, m1, r1) = (filters[0], filters[-1]) if filters else ((0.0, 0, 0.0),) * 2
    _SCAN_FILTER_KERNEL(device, scan, perm.data_ptr(), perm_rs, n, robots or 1,
                        float(params.voxel_filter_size), len(filters), float(l0), int(m0),
                        float(r0), float(l1), int(m1), float(r1), keep.data_ptr(),
                        scratch.data_ptr(), scratch.numel())
    return outputs, list(keep)


def align_scan(points, times01, mask, origin, pose_start, pose_end, gravity_rotation,
               params):
    """K1: unwarp, gate, clamp misses, gravity-align and z-crop a scan:
    `points` (N, 3), or (R, N, 3) with every argument's leading R for R
    robots' scans."""
    if points.is_cuda:
        return _align_kernel(points, times01, mask, origin, pose_start, pose_end,
                             gravity_rotation, params)
    if points.dim() == 2:
        return align_scan_plain(points, times01, mask, origin, pose_start, pose_end,
                                gravity_rotation, params)
    rows = [align_scan_plain(points[r], times01[r], mask[r], origin[r],
                             Rigid3(pose_start.translation[r], pose_start.rotation[r]),
                             Rigid3(pose_end.translation[r], pose_end.rotation[r]),
                             gravity_rotation[r], params)
            for r in range(points.shape[0])]
    return tuple(torch.stack(t) for t in zip(*rows))


def preprocess_scan_2d(
    points: torch.Tensor,  # (N, 3) in sensor/tracking frame
    times01: torch.Tensor,  # (N,) in [0, 1]: fraction between start and end pose
    mask: torch.Tensor,  # (N,)
    origin: torch.Tensor,  # (N, 3) per-point sensor origins in tracking frame
    pose_start: Rigid3,  # tracking -> local at first point
    pose_end: Rigid3,  # tracking -> local at last point
    gravity_rotation: torch.Tensor,  # (4,) gravity orientation estimate
    params: ScanPreprocessParams2D,
    perm: torch.Tensor,  # (N,) int32 voxel-filter permutation
) -> Tuple[RangeData, torch.Tensor]:
    """Returns (gravity-aligned 2D RangeData, sensor origin in that frame).

    The RangeData is centred at the scan-end sensor position, with z dropped
    after cropping; the returns are voxel-filtered in 3D cells. With a
    leading robot dimension on every argument, every field of the result
    has it too."""
    rd, origin_aligned, _ = preprocess_and_filter_scan_2d(
        points, times01, mask, origin, pose_start, pose_end, gravity_rotation, params, perm, ())
    return rd, origin_aligned


def preprocess_and_filter_scan_2d(points, times01, mask, origin, pose_start, pose_end,
                                  gravity_rotation, params, perm, adaptive_filters):
    """preprocess_scan_2d and the keep-masks of up to two adaptive voxel
    filters (each `(max_length, min_num_points, max_range)`) over its
    returns' x and y: -> (RangeData, origin, [one mask per filter]). On the
    card K1, the random filter and the adaptive ones are one launch."""
    if points.is_cuda:
        (hits, misses, is_return, is_miss, origin_aligned), (keep, *adaptive) = \
            _scan_filter_kernel(points, times01, mask, origin, pose_start, pose_end,
                                gravity_rotation, params, perm, adaptive_filters)
    else:
        hits, misses, is_return, is_miss, origin_aligned = align_scan(
            points, times01, mask, origin, pose_start, pose_end, gravity_rotation, params)
        keep, *adaptive = voxel_filter_masks(hits, is_return, params.voxel_filter_size, perm,
                                             adaptive_filters, 2)
    zeros = torch.zeros(points.shape[:-1], dtype=torch.float32, device=points.device)
    returns = PointCloud(points=hits[..., 0:2], mask=keep, intensities=zeros)
    miss_cloud = PointCloud(points=misses, mask=is_miss, intensities=zeros)
    return RangeData(origin=origin_aligned[..., 0:2], returns=returns, misses=miss_cloud), \
        origin_aligned, adaptive
