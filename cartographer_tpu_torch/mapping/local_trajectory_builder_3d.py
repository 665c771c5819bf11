"""3D local SLAM frontend.

Counterpart of the JAX package's `mapping/local_trajectory_builder_3d.py`
(mapping/internal/3d/local_trajectory_builder_3d.cc). IMU data is mandatory:
the pose extrapolator (constant-velocity, or with
`pose_extrapolator.use_imu_based` the sliding-window ImuBasedPoseExtrapolator)
is created from the first IMU message, and scans before it are dropped. Per
scan the host crops dense matching windows from the paged grids of the
matching submap around the predicted pose (K10, and with intensities the
intensity pools' window, K19) and runs one device step, `_fused_step`:

  1. unwarp between the extrapolated start and end poses, the range gate
     on each point's own ray, the voxel filter (K2, 3D keys)
  2. the high- and the low-resolution adaptive voxel filters (K2)
  3. with `use_online_correlative_scan_matching`, the real-time correlative
     search of the high-resolution cloud on the high window around the
     prediction (K17), whose best pose starts the LM
  4. the SE(3) LM match on both windows (K11; with `use_intensities` also
     the intensity rows of the high cloud), its translation pulled toward
     the prediction, guarded against non-finite results on the device
  5. the rotational histogram of the levelled high-resolution cloud (K12;
     the gravity alignment without its yaw) and its rotation by the matched
     yaw
  6. the scan in the local frame and the high-resolution range gate

Each scan makes one host-to-device copy of its inputs (points, origins,
times and intensities), from pinned memory, and exactly one blocking
device-to-host copy: the packed result vector. After it the host decides
the motion filter, allocates pages for the blocks the scan touches and
launches the paged insertions (K9, and with intensities K18) into the
grids of both active submaps on the tensors the step left on the device,
without waiting.

Scan accumulation (`num_accumulated_range_data`, which the JAX package's 3D
builder never reads) is not ported.

As in the JAX package, the intensity residual takes its Huber scale and
threshold from the matcher's defaults (0.3, 40), not from
`intensity_cost_function_options_0`, whose weight alone is read.

Known departure from the JAX package: step 5 levels the cloud without the
IMU tracker's yaw, as the reference does (submap_3d.cc InsertData), where
the JAX builder takes the histogram of the gravity-aligned cloud, so the
two scan histograms differ by a rotation of yaw(gravity_alignment) and the
submap histograms differ with it. The JAX form counts the IMU yaw twice and
smears the submap histogram, and with it the 3D loop closure's rotational
pre-filter rejected every pair of the simulated hall.
`tests/test_torch_local_slam_3d.py::test_scan_histogram_departs_from_jax_by_the_imu_yaw`
pins the difference at a turning yaw rate.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, List, Optional

import numpy as np
import torch

from cartographer_tpu_torch import metrics
from cartographer_tpu_torch.core.config import TrajectoryBuilder3DOptions
from cartographer_tpu_torch.core.tensor import to_device
from cartographer_tpu_torch.core.time import Time, from_seconds
from cartographer_tpu_torch.mapping.imu_based_pose_extrapolator import (
    ImuBasedPoseExtrapolator,
)
from cartographer_tpu_torch.mapping.motion_filter import MotionFilter
from cartographer_tpu_torch.mapping.pose_extrapolator import PoseExtrapolator
from cartographer_tpu_torch.mapping.range_data_collator import RangeDataCollator
from cartographer_tpu_torch.mapping.submap_3d import ActiveSubmaps3D, Submap3D
from cartographer_tpu_torch.ops import rot_histogram
from cartographer_tpu_torch.ops.grid_3d import Grid3D, IntensityGrid3D
from cartographer_tpu_torch.ops.rot_histogram import (
    compute_rotational_histogram,
    rotate_histogram,
)
from cartographer_tpu_torch.ops.scan_matcher_3d import (
    CorrelativeSearchParams3D,
    GaussNewtonMatcherParams3D,
    correlative_match_3d,
    lm_match_3d,
)
from cartographer_tpu_torch.sensor.data import ImuData, OdometryData, TimedPointCloudData
from cartographer_tpu_torch.sensor.point_cloud import PointCloud
from cartographer_tpu_torch.sensor.voxel_filter import adaptive_voxel_filter, voxel_filter_mask
from cartographer_tpu_torch.transform import nquat
from cartographer_tpu_torch.transform import quaternion as quat
from cartographer_tpu_torch.transform.interpolation import interpolate_rigid3
from cartographer_tpu_torch.transform.rigid import Rigid3

# Layout of the per-scan scalar block uploaded with the scan.
_PS_T, _PS_Q, _PE_T, _PE_Q, _GRAVITY, _HAS_GRID = (
    slice(0, 3), slice(3, 7), slice(7, 10), slice(10, 14), slice(14, 18), 18)
_SMALL = 19
_HEAD = 10  # est_t (3), est_q (4), cost, ok, LM iterations

PermutationFn = Callable[[int, int], np.ndarray]


def unpack_step_result(packed, bins: int, caps, intensities: bool = False):
    """The fields of the per-scan packed result (a numpy array or a tensor),
    as views: the pose, the match's cost, ok flag and iterations, the scan
    histogram and its rotation into the submap frame, the scan in the local
    frame with its masks (and, with `intensities`, its intensities), and the
    two matching clouds."""
    cap, cap_high, cap_low = caps
    out = {"translation": packed[0:3], "rotation": packed[3:7], "cost": packed[7],
           "ok": packed[8], "iterations": packed[9]}
    o = _HEAD
    for name, size, shape in (
            ("histogram", bins, None), ("rotated_histogram", bins, None),
            ("local_points", 3 * cap, (cap, 3)), ("local_mask", cap, bool),
            ("high_range_mask", cap, bool),
            *((("local_intensities", cap, None),) if intensities else ()),
            ("high_points", 3 * cap_high, (cap_high, 3)),
            ("high_mask", cap_high, bool), ("low_points", 3 * cap_low, (cap_low, 3)),
            ("low_mask", cap_low, bool)):
        field = packed[o:o + size]
        out[name] = field > 0.5 if shape is bool else field if shape is None \
            else field.reshape(shape)
        o += size
    return out


@dataclasses.dataclass
class InsertionResult3D:
    time: Time
    gravity_alignment: np.ndarray
    high_res_cloud: np.ndarray  # (n, 3) filtered cloud in the tracking frame
    low_res_cloud: np.ndarray
    scan_histogram: np.ndarray
    local_pose_translation: np.ndarray
    local_pose_rotation: np.ndarray
    insertion_submaps: List[Submap3D]
    finished_submaps: List[Submap3D]


@dataclasses.dataclass
class MatchingResult3D:
    time: Time
    local_pose_translation: np.ndarray
    local_pose_rotation: np.ndarray
    insertion_result: Optional[InsertionResult3D]


def check_kernel_limits(options: TrajectoryBuilder3DOptions) -> None:
    """Raise ValueError where a capacity option makes a cloud larger than
    the one-block CUDA kernel that takes it (the plain path takes any size).
    The high-resolution cloud feeds the rotational histogram (K12, at most
    1,024 points) and the online correlative search (K17, at most 2,048), so
    K12's limit holds both; the loop-closure scorer (K15) takes the
    constraint builder's fixed 256 and 512 points."""
    tpu = options.tpu
    high = min(tpu.filtered_capacity_high, tpu.scan_capacity)
    if high > rot_histogram.MAX_POINTS:
        raise ValueError(
            f"tpu.filtered_capacity_high = {tpu.filtered_capacity_high}: the rotational "
            f"histogram (K12) and the online correlative search (K17) take at most "
            f"{rot_histogram.MAX_POINTS} points on the card")
    if not 0 < options.rotational_histogram_size <= rot_histogram.MAX_BINS:
        raise ValueError(
            f"rotational_histogram_size = {options.rotational_histogram_size}: the rotational "
            f"histogram (K12) takes 1 to {rot_histogram.MAX_BINS} bins on the card")


class LocalTrajectoryBuilder3D:
    def __init__(self, options: TrajectoryBuilder3DOptions,
                 expected_range_sensor_ids: List[str], device="cuda",
                 permutation_fn: Optional[PermutationFn] = None):
        """`device` is where the per-scan step and the submaps live; a CUDA
        device must be present when it is one (the default).
        `permutation_fn(seed, n)` replaces the voxel filters' on-device
        permutation (tests inject the JAX package's permutation through it)."""
        self._device = torch.device(device)
        if self._device.type == "cuda":
            check_kernel_limits(options)
            if not torch.cuda.is_available():
                raise RuntimeError("LocalTrajectoryBuilder3D: no CUDA device is available; "
                                   "pass device='cpu' to run the plain PyTorch path")
        self._options = options
        self._active_submaps = ActiveSubmaps3D(
            options.submaps, options.tpu, self._device, options.rotational_histogram_size,
            use_intensities=options.use_intensities)
        self._motion_filter = MotionFilter(options.motion_filter)
        self._extrapolator = None  # a PoseExtrapolator or an ImuBasedPoseExtrapolator
        self._range_data_collator = RangeDataCollator(expected_range_sensor_ids)
        self._seed_counter = 0
        self._last_imu_accel: Optional[np.ndarray] = None
        self._permutation_fn = permutation_fn
        self._generator = torch.Generator(device=self._device)

        gn = options.ceres_scan_matcher
        self._gn_params = GaussNewtonMatcherParams3D(
            occupied_space_weight_0=gn.occupied_space_weight_0,
            occupied_space_weight_1=gn.occupied_space_weight_1,
            intensity_weight=(gn.intensity_cost_function_options_0.weight
                              if options.use_intensities else 0.0),
            translation_weight=gn.translation_weight,
            rotation_weight=gn.rotation_weight,
            only_optimize_yaw=gn.only_optimize_yaw,
            num_iterations=gn.max_num_iterations,
            use_nonmonotonic_steps=gn.use_nonmonotonic_steps)
        rt = options.real_time_correlative_scan_matcher
        self._corr_params = CorrelativeSearchParams3D(
            linear_search_window=rt.linear_search_window,
            angular_search_window=rt.angular_search_window,
            translation_delta_cost_weight=rt.translation_delta_cost_weight,
            rotation_delta_cost_weight=rt.rotation_delta_cost_weight,
            max_scan_range=options.max_range)
        cap = options.tpu.scan_capacity
        self._caps = (cap, min(options.tpu.filtered_capacity_high, cap),
                      min(options.tpu.filtered_capacity_low, cap))
        # Pinned staging for the per-scan upload. Reusing it is safe: the
        # blocking fetch at the end of each scan drains the stream.
        self._staging = torch.empty(9 * cap + _SMALL, dtype=torch.float32,
                                    pin_memory=self._device.type == "cuda")
        # One step and one blocking fetch per scan; host_seconds is all of
        # add_range_data, device_seconds the step and its fetch inside it,
        # allocator_seconds the host's page allocation and insert launches.
        self.device_fetches = 0
        self.device_seconds = 0.0
        self.host_seconds = 0.0
        self.allocator_seconds = 0.0
        self.pages_allocated = 0
        self.lm_iterations: List[int] = []
        self._register_metrics()

    def _register_metrics(self) -> None:
        """RegisterMetrics (local_trajectory_builder_3d.cc:935-948)."""
        factory = metrics.GLOBAL_FACTORY
        self._metric_latency = factory.new_gauge_family(
            "mapping_3d_local_trajectory_builder_latency",
            "Duration from first incoming point to last processed point [s]").add({})
        self._metric_real_time_ratio = factory.new_gauge_family(
            "mapping_3d_local_trajectory_builder_real_time_ratio",
            "sensor time per wall time, multiplied by 100").add({})
        self._metric_scans = factory.new_counter_family(
            "mapping_3d_local_trajectory_builder_scans",
            "Number of processed scans").add({})
        fractions = factory.new_gauge_family(
            "mapping_3d_local_trajectory_builder_fraction",
            "Fraction of total scan-processing wall time per stage")
        self._metric_frac_filter = fractions.add({"stage": "voxel_filter"})
        self._metric_frac_match = fractions.add({"stage": "scan_matcher"})
        self._metric_frac_insert = fractions.add({"stage": "insert"})
        self._metric_cost = factory.new_histogram_family(
            "mapping_3d_scan_matcher_final_cost", "Scan matcher final cost",
            metrics.exponential_boundaries(0.01, 2.0, 12)).add({})
        self._last_wall_time = None
        self._last_sensor_time = None

    # ------------------------------------------------------------------ sensors

    def add_imu_data(self, imu_data: ImuData) -> None:
        if self._extrapolator is None:
            # PoseExtrapolatorInterface::CreateWithImuData.
            pe = self._options.pose_extrapolator
            if pe.use_imu_based:
                self._extrapolator = ImuBasedPoseExtrapolator.initialize_with_imu(
                    pe.imu_based, [imu_data])
            else:
                cv = pe.constant_velocity
                self._extrapolator = PoseExtrapolator.initialize_with_imu(
                    from_seconds(cv.pose_queue_duration), cv.imu_gravity_time_constant,
                    imu_data)
        else:
            self._extrapolator.add_imu_data(imu_data)
        self._last_imu_accel = np.asarray(imu_data.linear_acceleration)

    def add_odometry_data(self, odometry_data: OdometryData) -> None:
        if self._extrapolator is None:
            return
        self._extrapolator.add_odometry_data(odometry_data)

    def add_range_data(self, sensor_id: str, data: TimedPointCloudData
                       ) -> Optional[MatchingResult3D]:
        result = None
        t0 = _time.monotonic()
        try:
            for batch in self._range_data_collator.add_range_data(sensor_id, data):
                r = self._process_scan(batch)
                if r is not None:
                    result = r
        finally:
            self.host_seconds += _time.monotonic() - t0
        return result

    # ------------------------------------------------------------------ the step

    def _permutation(self, seed: int, n: int) -> torch.Tensor:
        if self._permutation_fn is not None:
            return to_device(np.asarray(self._permutation_fn(seed, n), np.int32),
                             self._device)
        self._generator.manual_seed(seed)
        return torch.randperm(n, generator=self._generator, device=self._device,
                              dtype=torch.int32)

    def _blank_grids(self, center):
        """Blank dense windows for the first scan: the step always matches,
        and `has_grid` gates the result on the device."""
        t, sub = self._options.tpu, self._options.submaps
        dev = self._device
        return (Grid3D.create(t.high_grid_size, sub.high_resolution, center, dev),
                Grid3D.create(t.low_grid_size, sub.low_resolution, center, dev),
                IntensityGrid3D.create(t.high_grid_size, sub.high_resolution, center, dev)
                if self._options.use_intensities else None)

    def _fused_step(self, high_grid: Grid3D, low_grid: Grid3D,
                    intensity_grid: Optional[IntensityGrid3D], upload: torch.Tensor,
                    perm: torch.Tensor):
        """The per-scan device step; returns (packed result, the tensors the
        insertion reads: origin, local points, mask, high-resolution mask,
        intensities)."""
        opts = self._options
        n, cap_high, cap_low = self._caps
        points = upload[0:3 * n].view(n, 3)
        origins = upload[3 * n:6 * n].view(n, 3)
        t01 = upload[6 * n:7 * n]
        mask = upload[7 * n:8 * n] > 0.5
        intensities = upload[8 * n:9 * n]
        small = upload[9 * n:]
        pose_start = Rigid3(small[_PS_T], small[_PS_Q])
        pose_end = Rigid3(small[_PE_T], small[_PE_Q])
        has_grid = small[_HAS_GRID] > 0.5

        poses = interpolate_rigid3(Rigid3(pose_start.translation[None], pose_start.rotation[None]),
                                   Rigid3(pose_end.translation[None], pose_end.rotation[None]),
                                   t01)
        local = poses.apply(points)
        origins_local = poses.apply(origins)
        tracking = pose_end.inverse().apply(local)
        # The range of each point from its own sensor origin.
        r = torch.linalg.norm(local - origins_local, dim=-1)
        keep = mask & (r >= opts.min_range) & (r <= opts.max_range)
        keep = keep & voxel_filter_mask(tracking, keep, opts.voxel_filter_size, perm)
        cloud = PointCloud(tracking, keep, intensities)
        hi = opts.high_resolution_adaptive_voxel_filter
        lo = opts.low_resolution_adaptive_voxel_filter
        high = adaptive_voxel_filter(cloud, hi.max_length, hi.min_num_points, hi.max_range,
                                     perm).compact(cap_high)
        low = adaptive_voxel_filter(cloud, lo.max_length, lo.min_num_points, lo.max_range,
                                    perm).compact(cap_low)

        # The LM starts from the correlative search's best pose (when it
        # runs) and its rotation penalty pulls toward it; its translation
        # penalty pulls toward the prediction.
        prediction = torch.cat([pose_end.translation, pose_end.rotation])
        x0 = prediction
        if opts.use_online_correlative_scan_matching:
            _, x0 = correlative_match_3d(high_grid, high.points, high.mask, prediction,
                                         self._corr_params)
        pose_m, cost, iterations = lm_match_3d(
            high_grid, low_grid, high.points, high.mask, low.points, low.mask, x0,
            pose_end.translation, self._gn_params, intensity_grid, high.intensities)
        finite = torch.isfinite(pose_m).all() & has_grid
        est = torch.where(finite, pose_m, prediction)
        est_t = est[0:3]
        est_q = quat.normalize(est[3:7])
        ok = finite | ~has_grid

        # The histogram of the cloud levelled by the gravity alignment with
        # the IMU tracker's yaw taken out, so the histogram's yaw is the
        # tracking frame's: rotated by the matched yaw it lands in the submap
        # frame, and a loop closure rotates it by the node's yaw in the
        # submap. The reference rotates the gravity-frame histogram by the
        # yaw of local_pose * gravity^-1 (submap_3d.cc InsertData), the same
        # thing; rotating it by the matched yaw alone, as the JAX package
        # does, counts the IMU's yaw twice and smears the submap histogram.
        gravity = small[_GRAVITY]
        level = quat.multiply(quat.from_yaw(-quat.get_yaw(gravity)), gravity)
        hist = compute_rotational_histogram(quat.rotate(level, high.points), high.mask,
                                            opts.rotational_histogram_size)
        # Rotated into the submap frame here, so the scan keeps one fetch.
        hist_rot = rotate_histogram(hist, quat.get_yaw(est_q))
        local_points = Rigid3(est_t, est_q).apply(tracking)
        in_high = keep & (torch.linalg.norm(local_points - est_t, dim=-1)
                          <= opts.submaps.high_resolution_max_range)

        packed = torch.cat([
            est_t, est_q,
            torch.stack([cost, ok.to(torch.float32), iterations.to(torch.float32)]),
            hist, hist_rot,
            local_points.reshape(-1), keep.to(torch.float32), in_high.to(torch.float32),
            *((intensities,) if opts.use_intensities else ()),
            high.points.reshape(-1), high.mask.to(torch.float32),
            low.points.reshape(-1), low.mask.to(torch.float32)])
        return packed, (est_t, local_points, keep, in_high, intensities)

    def _process_scan(self, data: TimedPointCloudData) -> Optional[MatchingResult3D]:
        if self._extrapolator is None:
            return None  # 3D needs IMU data before any scan is usable
        # Skip scans under high acceleration (gravity-removed magnitude).
        if self._options.max_accel_skip > 0.0 and self._last_imu_accel is not None:
            accel = abs(float(np.linalg.norm(self._last_imu_accel)) - 9.806)
            if accel > self._options.max_accel_skip:
                return None
        last_pose_time = self._extrapolator.get_last_pose_time()
        if data.time < last_pose_time:
            return None
        n = data.ranges.shape[0]
        if n == 0:
            return None

        time_first = data.time + from_seconds(float(data.times.min()))
        t0 = max(time_first, last_pose_time)
        t1 = data.time
        pose_start = self._extrapolator.extrapolate_pose(t0)
        pose_end = self._extrapolator.extrapolate_pose(t1)
        gravity_q = self._extrapolator.estimate_gravity_orientation(t1)

        capacity, cap_high, cap_low = self._caps
        abs_times = data.time + (data.times * 1e6).astype(np.int64)
        denom = max(t1 - t0, 1)
        times01 = np.clip((abs_times - t0) / denom, 0.0, 1.0).astype(np.float32)
        npts = min(n, capacity)

        staging = self._staging.numpy()
        staging.fill(0.0)
        staging[0:3 * npts] = data.ranges[:npts, :3].reshape(-1)
        staging[3 * capacity:3 * capacity + 3 * npts] = \
            data.per_point_origins(3)[:npts].reshape(-1)
        staging[6 * capacity:6 * capacity + npts] = times01[:npts]
        staging[7 * capacity:7 * capacity + npts] = 1.0
        if data.intensities is not None:
            staging[8 * capacity:8 * capacity + npts] = data.intensities[:npts]
        small = staging[9 * capacity:]
        small[_PS_T], small[_PS_Q] = pose_start
        small[_PE_T], small[_PE_Q] = pose_end
        small[_GRAVITY] = gravity_q

        stage_t0 = _time.monotonic()
        # Dense matching windows around the predicted pose: tracking never
        # walks out of a fixed box.
        center = np.asarray(pose_end[0], np.float32)
        grids = self._active_submaps.matching_grids_at(center)
        had_grid = grids is not None
        if grids is None:
            grids = self._blank_grids(center)
        small[_HAS_GRID] = had_grid
        stage_t1 = _time.monotonic()

        self._seed_counter += 1
        seed = self._seed_counter & 0x7FFFFFFF
        upload = self._staging.to(self._device, non_blocking=True, copy=True)
        packed_device, device_tensors = self._fused_step(*grids, upload,
                                                         self._permutation(seed, capacity))
        packed = packed_device.cpu().numpy()  # the single blocking transfer
        del grids
        self.device_fetches += 1
        self.device_seconds += _time.monotonic() - stage_t1

        u = unpack_step_result(packed, self._options.rotational_histogram_size, self._caps,
                               self._options.use_intensities)
        est_t = np.asarray(u["translation"], np.float64)
        est_q = nquat.normalize(np.asarray(u["rotation"], np.float64))
        cost, ok = float(u["cost"]), bool(u["ok"] > 0.5)
        self.lm_iterations.append(int(u["iterations"]))
        scan_hist = np.asarray(u["histogram"], np.float64)
        hist_rotated = np.asarray(u["rotated_histogram"], np.float64)
        local_points, local_mask = u["local_points"], u["local_mask"]
        high_range_mask = u["high_range_mask"]
        high_pts, high_mask = u["high_points"], u["high_mask"]
        low_pts, low_mask = u["low_points"], u["low_mask"]
        if not ok:
            return None  # non-finite match: drop the scan
        if had_grid:
            self._metric_cost.observe(cost)
        stage_t2 = _time.monotonic()

        self._extrapolator.add_pose(data.time, est_t, est_q)

        insertion_result = None
        if not self._motion_filter.is_similar(data.time, est_t, est_q):
            # Everything the insertion needs came back in the packed fetch
            # or stayed on the device: no further blocking transfer.
            insert_t0 = _time.monotonic()
            finished = self._active_submaps.insert_range_data(
                np.asarray(est_t, np.float32), local_points, local_mask, scan_hist,
                nquat.get_yaw(est_q), rotated_histogram=hist_rotated,
                high_mask=high_range_mask, device_tensors=device_tensors,
                intensities=u.get("local_intensities"))
            self.allocator_seconds += _time.monotonic() - insert_t0
            self.pages_allocated += self._active_submaps.pages_allocated_last_insert
            insertion_result = InsertionResult3D(
                time=data.time,
                gravity_alignment=gravity_q,
                high_res_cloud=np.asarray(high_pts[high_mask], np.float64),
                low_res_cloud=np.asarray(low_pts[low_mask], np.float64),
                scan_histogram=scan_hist,
                local_pose_translation=np.asarray(est_t),
                local_pose_rotation=np.asarray(est_q),
                insertion_submaps=list(self._active_submaps.submaps),
                finished_submaps=finished,
            )
        stage_t3 = _time.monotonic()
        total = max(stage_t3 - stage_t0, 1e-9)
        self._metric_frac_filter.set((stage_t1 - stage_t0) / total)
        self._metric_frac_match.set((stage_t2 - stage_t1) / total)
        self._metric_frac_insert.set((stage_t3 - stage_t2) / total)
        self._metric_scans.increment()
        self._metric_latency.set(float(t1 - time_first) * 1e-6)
        if self._last_wall_time is not None and stage_t3 > self._last_wall_time:
            sensor_dt = (data.time - self._last_sensor_time) * 1e-6
            self._metric_real_time_ratio.set(
                100.0 * sensor_dt / (stage_t3 - self._last_wall_time))
        self._last_wall_time = stage_t3
        self._last_sensor_time = data.time

        return MatchingResult3D(
            time=data.time,
            local_pose_translation=np.asarray(est_t),
            local_pose_rotation=np.asarray(est_q),
            insertion_result=insertion_result,
        )

    def finish(self) -> List[Submap3D]:
        return self._active_submaps.finish_all()
