"""2D local SLAM frontend.

Counterpart of the JAX package's `mapping/local_trajectory_builder_2d.py`
(mapping/internal/2d/local_trajectory_builder_2d.cc). The host class owns
the sequential state (pose extrapolator, submap window, sensor collation)
and runs one per-scan device step, `_fused_step`:

  1. preprocess: unwarp, gate, gravity-align, voxel filter (K1, K2)
  2. the two adaptive voxel filters (K2), the online correlative search
     when `use_online_correlative_scan_matching` is set (K5) and the LM
     refine (K3)
  3. the motion filter decision, on the device
  4. the conditional raycast insertion into both active submaps (K4)

With `submaps.grid_type = "TSDF"` the submaps are TSDF grids: the search
scores their score surface (K5's TSDF form), the refine is the TSDF matcher
(K22) and the insertion the TSDF inserter (K20's normals, then K21).

Each scan makes one host-to-device copy of its inputs and exactly one
blocking device-to-host copy: the packed result vector. The correlative
search's data-dependent angular step and argmax, the LM loop's early exit,
the adaptive filters' searches and the insertion's do_insert gate stay on
the device.

Cross-robot batching and the IMU-based extrapolator (which the JAX
package's 2D builder never reads) raise NotImplementedError. On a CUDA
device, a capacity option above the size a one-block kernel takes raises
ValueError at construction (`check_kernel_limits`).
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, List, Optional

import numpy as np
import torch

from cartographer_tpu_torch import metrics
from cartographer_tpu_torch.core.config import TrajectoryBuilder2DOptions
from cartographer_tpu_torch.core.tensor import to_device
from cartographer_tpu_torch.core.time import Time, from_seconds
from cartographer_tpu_torch.mapping.motion_filter import MotionFilter
from cartographer_tpu_torch.mapping.pose_extrapolator import PoseExtrapolator
from cartographer_tpu_torch.mapping.range_data_collator import RangeDataCollator
from cartographer_tpu_torch.mapping.submap_2d import ActiveSubmaps2D, Submap2D
from cartographer_tpu_torch.ops import bnb_2d, correlative_2d
from cartographer_tpu_torch.ops.correlative_2d import (
    CorrelativeSearchParams,
    real_time_correlative_match,
)
from cartographer_tpu_torch.ops.scan_matcher_2d import GaussNewtonMatcherParams2D, lm_match_2d
from cartographer_tpu_torch.ops.scan_pipeline_2d import (
    ScanPreprocessParams2D,
    preprocess_scan_2d,
)
from cartographer_tpu_torch.ops.tsdf_2d import lm_match_tsdf_2d
from cartographer_tpu_torch.sensor.data import ImuData, OdometryData, TimedPointCloudData
from cartographer_tpu_torch.sensor.point_cloud import PointCloud, RangeData
from cartographer_tpu_torch.sensor.voxel_filter import adaptive_voxel_filter
from cartographer_tpu_torch.transform import nquat
from cartographer_tpu_torch.transform import quaternion as quat
from cartographer_tpu_torch.transform.rigid import Rigid2, Rigid3

# Layout of the per-scan scalar block uploaded with the scan.
_PS_T, _PS_Q, _PE_T, _PE_Q, _GRAVITY, _PRED = (
    slice(0, 3), slice(3, 7), slice(7, 10), slice(10, 14), slice(14, 18), slice(18, 21))
_MF_T, _MF_Q, _MF_DT, _HAS_GRID, _MF_FIRST, _ACTIVE = (
    slice(21, 24), slice(24, 28), 28, 29, 30, slice(31, 33))
_SMALL = 33

PermutationFn = Callable[[int, int], np.ndarray]


@dataclasses.dataclass
class InsertionResult:
    """Node data + the submaps it was inserted into (trajectory_builder_interface.h)."""

    time: Time
    gravity_alignment: np.ndarray  # (4,) quaternion
    filtered_gravity_aligned_point_cloud: PointCloud  # for loop closure
    local_pose_translation: np.ndarray  # (3,) node pose in local frame
    local_pose_rotation: np.ndarray  # (4,)
    insertion_submaps: List[Submap2D]
    finished_submaps: List[Submap2D]


@dataclasses.dataclass
class MatchingResult:
    time: Time
    local_pose_translation: np.ndarray
    local_pose_rotation: np.ndarray
    range_data_in_local: RangeData
    insertion_result: Optional[InsertionResult]


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def check_kernel_limits(options: TrajectoryBuilder2DOptions) -> None:
    """Raise ValueError where a capacity option makes a cloud larger than
    the one-block CUDA kernel that takes it (the plain path takes any size)."""
    tpu = options.tpu
    if options.use_online_correlative_scan_matching:
        n = _pow2(min(tpu.matcher_capacity, tpu.scan_capacity))
        if n > correlative_2d.MAX_POINTS:
            raise ValueError(
                f"tpu.matcher_capacity = {tpu.matcher_capacity}: the online correlative search "
                f"(K5) takes at most {correlative_2d.MAX_POINTS} points on the card")
    n = _pow2(max(min(tpu.loop_closure_capacity, tpu.scan_capacity), 16))
    if n > bnb_2d.MAX_POINTS:
        raise ValueError(
            f"tpu.loop_closure_capacity = {tpu.loop_closure_capacity}: the loop-closure "
            f"scorer (K7) takes at most {bnb_2d.MAX_POINTS} points (padded to a power of two) "
            f"on the card")


class LocalTrajectoryBuilder2D:
    def __init__(self, options: TrajectoryBuilder2DOptions,
                 expected_range_sensor_ids: List[str], device="cuda", batcher=None,
                 permutation_fn: Optional[PermutationFn] = None):
        """`device` is where the per-scan step runs; a CUDA device must be
        present when it is one (the default). `permutation_fn(seed, n)`
        replaces the voxel filters' on-device permutation (tests inject the
        JAX package's permutation through it)."""
        if batcher is not None:
            raise NotImplementedError("cross-robot scan batching is not ported")
        if options.pose_extrapolator.use_imu_based:
            raise NotImplementedError("the IMU-based extrapolator is not ported to 2D")
        self._device = torch.device(device)
        if self._device.type == "cuda":
            check_kernel_limits(options)
            if not torch.cuda.is_available():
                raise RuntimeError("LocalTrajectoryBuilder2D: no CUDA device is available; "
                                   "pass device='cpu' to run the plain PyTorch path")
        self._options = options
        self._active_submaps = ActiveSubmaps2D(options.submaps, options.tpu, self._device)
        self._motion_filter = MotionFilter(options.motion_filter)
        self._extrapolator: Optional[PoseExtrapolator] = None
        self._range_data_collator = RangeDataCollator(expected_range_sensor_ids)
        self._seed_counter = 0
        self._permutation_fn = permutation_fn
        self._generator = torch.Generator(device=self._device)
        capacity = options.tpu.scan_capacity
        # Pinned staging for the per-scan upload. Reusing it is safe: the
        # blocking fetch at the end of each scan drains the stream.
        self._staging = torch.empty(8 * capacity + _SMALL, dtype=torch.float32,
                                    pin_memory=self._device.type == "cuda")

        self._pre_params = ScanPreprocessParams2D(
            min_range=options.min_range, max_range=options.max_range,
            min_z=options.min_z, max_z=options.max_z,
            missing_data_ray_length=options.missing_data_ray_length,
            voxel_filter_size=options.voxel_filter_size)
        corr = options.real_time_correlative_scan_matcher
        self._corr_params = CorrelativeSearchParams(
            linear_search_window=corr.linear_search_window,
            angular_search_window=corr.angular_search_window,
            translation_delta_cost_weight=corr.translation_delta_cost_weight,
            rotation_delta_cost_weight=corr.rotation_delta_cost_weight,
            max_scan_range=options.max_range)
        gn = options.ceres_scan_matcher
        self._gn_params = GaussNewtonMatcherParams2D(
            occupied_space_weight=gn.occupied_space_weight,
            translation_weight=gn.translation_weight,
            rotation_weight=gn.rotation_weight,
            num_iterations=gn.max_num_iterations,
            use_nonmonotonic_steps=gn.use_nonmonotonic_steps)
        # One step and one blocking fetch per scan; host/device_seconds
        # split the per-scan wall time into host work and the step + fetch.
        self.device_fetches = 0
        self.device_seconds = 0.0
        self.host_seconds = 0.0
        self.lm_iterations: List[int] = []  # the LM refine's iterations, per scan
        self._mf_last = None

        factory = metrics.GLOBAL_FACTORY
        self._metric_latency = factory.new_gauge_family(
            "mapping_2d_local_trajectory_builder_latency",
            "Duration from first incoming point to last processed point [s]").add({})
        self._metric_real_time_ratio = factory.new_gauge_family(
            "mapping_2d_local_trajectory_builder_real_time_ratio",
            "sensor time per wall time, multiplied by 100").add({})
        self._metric_scans = factory.new_counter_family(
            "mapping_2d_local_trajectory_builder_scans",
            "Number of processed scans").add({})
        self._last_wall_time = None
        self._last_sensor_time = None

    # ------------------------------------------------------------------ sensors

    def add_imu_data(self, imu_data: ImuData) -> None:
        if not self._options.use_imu_data:
            return
        if self._extrapolator is None:
            cv = self._options.pose_extrapolator.constant_velocity
            self._extrapolator = PoseExtrapolator.initialize_with_imu(
                from_seconds(cv.pose_queue_duration), cv.imu_gravity_time_constant, imu_data)
        else:
            self._extrapolator.add_imu_data(imu_data)

    def add_odometry_data(self, odometry_data: OdometryData) -> None:
        if self._extrapolator is None:
            return  # until the extrapolator is initialized odometry cannot be added
        self._extrapolator.add_odometry_data(odometry_data)

    # ------------------------------------------------------------------ scans

    def add_range_data(self, sensor_id: str, data: TimedPointCloudData
                       ) -> Optional[MatchingResult]:
        result = None
        for batch in self._range_data_collator.add_range_data(sensor_id, data):
            r = self._process_scan(batch)
            if r is not None:
                result = r
        return result

    def _initialize_extrapolator(self, time: Time) -> None:
        if self._extrapolator is not None:
            return
        cv = self._options.pose_extrapolator.constant_velocity
        self._extrapolator = PoseExtrapolator(
            from_seconds(cv.pose_queue_duration), cv.imu_gravity_time_constant)
        self._extrapolator.add_pose(time, np.zeros(3), nquat.IDENTITY.copy())

    def _process_scan(self, data: TimedPointCloudData) -> Optional[MatchingResult]:
        host_t0 = _time.monotonic()
        try:
            return self._process_scan_inner(data)
        finally:
            self.host_seconds += _time.monotonic() - host_t0

    def _permutation(self, seed: int, n: int) -> torch.Tensor:
        if self._permutation_fn is not None:
            return to_device(np.asarray(self._permutation_fn(seed, n), np.int32),
                             self._device)
        self._generator.manual_seed(seed)
        return torch.randperm(n, generator=self._generator, device=self._device,
                              dtype=torch.int32)

    def _fused_step(self, upload: torch.Tensor, perm: torch.Tensor):
        """The per-scan device step; returns (packed result, range data in
        the local frame). Updates the active grids in place, where the JAX
        program donates them and returns new ones."""
        opts = self._options
        n = opts.tpu.scan_capacity
        points = upload[0:3 * n].view(n, 3)
        origins = upload[3 * n:6 * n].view(n, 3)
        t01 = upload[6 * n:7 * n]
        mask = upload[7 * n:8 * n] > 0.5
        small = upload[8 * n:]
        gravity_q = small[_GRAVITY]
        pred = small[_PRED]
        has_grid = small[_HAS_GRID] > 0.5

        rd_aligned, _ = preprocess_scan_2d(
            points, t01, mask, origins, Rigid3(small[_PS_T], small[_PS_Q]),
            Rigid3(small[_PE_T], small[_PE_Q]), gravity_q, self._pre_params, perm)
        avf = opts.adaptive_voxel_filter
        filtered = adaptive_voxel_filter(rd_aligned.returns, avf.max_length,
                                         avf.min_num_points, avf.max_range, perm)
        if opts.tpu.matcher_capacity < n:
            filtered = filtered.compact(opts.tpu.matcher_capacity)
        # The loop-closure node cloud is a separate, coarser filter.
        lc = opts.loop_closure_adaptive_voxel_filter
        lc_cloud = adaptive_voxel_filter(rd_aligned.returns, lc.max_length,
                                         lc.min_num_points, lc.max_range, perm)
        if opts.tpu.loop_closure_capacity < n:
            lc_cloud = lc_cloud.compact(opts.tpu.loop_closure_capacity)
        grid = self._active_submaps.matching_grid
        initial = pred
        if opts.use_online_correlative_scan_matching:
            _, initial = real_time_correlative_match(grid, filtered.points, filtered.mask, pred,
                                                     self._corr_params)
        # The translation penalty pulls toward the prediction, the rotation
        # penalty toward the correlative estimate (ceres_scan_matcher_2d.cc).
        match = lm_match_tsdf_2d if opts.submaps.grid_type == "TSDF" else lm_match_2d
        pose_m, cost, iterations = match(grid, filtered.points, filtered.mask, initial,
                                         pred[0:2], self._gn_params)
        finite = torch.isfinite(pose_m).all() & has_grid
        pose_vec = torch.where(finite, pose_m, pred)

        # Motion filter on the device (motion_filter.cc IsSimilar).
        mf = opts.motion_filter
        est_q = quat.normalize(quat.multiply(quat.from_yaw(pose_vec[2]), gravity_q))
        est_t = torch.cat([pose_vec[0:2], torch.zeros_like(pose_vec[0:1])])
        dist = torch.linalg.norm(est_t - small[_MF_T])
        dangle = 2.0 * torch.arccos(torch.clamp(
            torch.abs(torch.sum(est_q * small[_MF_Q])), 0.0, 1.0))
        moved = ((small[_MF_FIRST] > 0.5) | (small[_MF_DT] > mf.max_time_seconds)
                 | (dist > mf.max_distance_meters) | (dangle > mf.max_angle_radians))
        ok = finite | ~has_grid  # the first scan (no grid) still inserts
        do_insert = moved & ok

        rd_local = rd_aligned.transform(Rigid2.from_vector(pose_vec))
        self._active_submaps.insert(rd_local, small[_ACTIVE] > 0.5, do_insert)
        packed = torch.cat([
            pose_vec, est_q,
            torch.stack([cost, do_insert.to(torch.float32), ok.to(torch.float32),
                         iterations.to(torch.float32)]),
            lc_cloud.mask.to(torch.float32), lc_cloud.points.reshape(-1)])
        return packed, rd_local

    def _process_scan_inner(self, data: TimedPointCloudData) -> Optional[MatchingResult]:
        if self._options.use_imu_data and self._extrapolator is None:
            return None  # waiting for the first IMU message
        self._initialize_extrapolator(data.time)

        last_pose_time = self._extrapolator.get_last_pose_time()
        if data.time < last_pose_time:
            return None  # cannot extrapolate backwards
        n = data.ranges.shape[0]
        if n == 0:
            return None
        time_first = data.time + from_seconds(float(data.times.min()))
        t0 = max(time_first, last_pose_time)
        t1 = data.time

        pose_start = self._extrapolator.extrapolate_pose(t0)
        pose_end = self._extrapolator.extrapolate_pose(t1)
        gravity_q = self._extrapolator.estimate_gravity_orientation(t1)

        capacity = self._options.tpu.scan_capacity
        abs_times = data.time + (data.times * 1e6).astype(np.int64)
        denom = max(t1 - t0, 1)
        times01 = np.clip((abs_times - t0) / denom, 0.0, 1.0).astype(np.float32)
        npts = min(n, capacity)

        pred_2d = _project_2d_host(pose_end[0], pose_end[1], gravity_q)
        # Window management before the step (counters are known from
        # previous fetches); a new grid centers at the predicted pose.
        had_grid = bool(self._active_submaps.submaps)
        active = self._active_submaps.prepare(np.asarray(pred_2d[:2], np.float32))
        if self._mf_last is None:
            mf_t, mf_q, mf_dt, mf_first = np.zeros(3), np.array([1.0, 0, 0, 0]), 0.0, True
        else:
            lt, mf_t, mf_q = self._mf_last
            mf_dt, mf_first = (data.time - lt) * 1e-6, False

        staging = self._staging.numpy()
        staging.fill(0.0)
        staging[0:3 * npts] = (data.ranges[:npts, :3] if data.ranges.shape[1] >= 3 else
                               np.pad(data.ranges[:npts], ((0, 0), (0, 1)))).reshape(-1)
        staging[3 * capacity:3 * capacity + 3 * npts] = \
            data.per_point_origins(3)[:npts].reshape(-1)
        staging[6 * capacity:6 * capacity + npts] = times01[:npts]
        staging[7 * capacity:7 * capacity + npts] = 1.0
        small = staging[8 * capacity:]
        small[_PS_T], small[_PS_Q] = pose_start
        small[_PE_T], small[_PE_Q] = pose_end
        small[_GRAVITY] = gravity_q
        small[_PRED] = pred_2d
        small[_MF_T], small[_MF_Q] = mf_t, mf_q
        small[_MF_DT] = mf_dt
        small[_HAS_GRID] = had_grid
        small[_MF_FIRST] = mf_first
        small[_ACTIVE] = active

        dev_t0 = _time.monotonic()
        self._seed_counter += 1
        seed = self._seed_counter & 0x7FFFFFFF
        upload = self._staging.to(self._device, non_blocking=True, copy=True)
        packed, rd_local = self._fused_step(upload, self._permutation(seed, capacity))
        packed = packed.cpu().numpy()  # the single blocking transfer
        self.device_fetches += 1
        self.device_seconds += _time.monotonic() - dev_t0

        lc_cap = (packed.shape[0] - 11) // 3
        pose_2d = np.asarray(packed[:3], np.float64)
        est_q = np.asarray(packed[3:7], np.float64)
        inserted = bool(packed[8] > 0.5)
        ok = bool(packed[9] > 0.5)
        self.lm_iterations.append(int(packed[10]))
        lc_mask = packed[11:11 + lc_cap] > 0.5
        lc_points = packed[11 + lc_cap:].reshape(lc_cap, 2)
        if not ok and had_grid:
            # Non-finite match: drop the scan (the insertion was suppressed
            # on the device too).
            self._active_submaps.commit(False)
            return None
        est_t = np.array([pose_2d[0], pose_2d[1], 0.0])
        self._extrapolator.add_pose(data.time, est_t, est_q)

        insertion_result = None
        finished = self._active_submaps.commit(inserted)
        if inserted:
            self._mf_last = (data.time, est_t.astype(np.float32), est_q.astype(np.float32))
            filtered = PointCloud(points=torch.from_numpy(lc_points.copy()),
                                  mask=torch.from_numpy(lc_mask),
                                  intensities=torch.zeros(lc_cap))
            insertion_result = InsertionResult(
                time=data.time,
                gravity_alignment=gravity_q,
                filtered_gravity_aligned_point_cloud=filtered,
                local_pose_translation=est_t,
                local_pose_rotation=est_q,
                insertion_submaps=list(self._active_submaps.submaps),
                finished_submaps=finished,
            )
        wall = _time.monotonic()
        if self._last_wall_time is not None and wall > self._last_wall_time:
            sensor_dt = (data.time - self._last_sensor_time) * 1e-6
            self._metric_real_time_ratio.set(
                100.0 * sensor_dt / (wall - self._last_wall_time))
        self._last_wall_time = wall
        self._last_sensor_time = data.time
        self._metric_scans.increment()
        self._metric_latency.set(float(t1 - time_first) * 1e-6)

        return MatchingResult(
            time=data.time,
            local_pose_translation=est_t,
            local_pose_rotation=est_q,
            range_data_in_local=rd_local,
            insertion_result=insertion_result,
        )

    def finish(self) -> List[Submap2D]:
        return self._active_submaps.finish_all()


def _project_2d_host(translation, rotation_q, gravity_q) -> np.ndarray:
    """Project2D(pose * gravity_alignment^-1) -> [x, y, theta] (numpy)."""
    q = nquat.multiply(rotation_q, nquat.conjugate(gravity_q))
    return np.array([translation[0], translation[1], nquat.get_yaw(q)])
