"""SLAM options with the reference's default values.

The subset of the JAX package's `core/config.py` that the port's modules
read: nested frozen dataclasses whose defaults replicate the reference's
trajectory_builder_2d.lua, trajectory_builder_3d.lua, pose_graph.lua and
map_builder.lua, plus the static capacities the device pipeline is sized by
(`TpuOptions2D`, `TpuOptions3D`, kept under their original names so that the
`dataclasses.asdict` trees of the two packages share their keys). Options of
features the port does not have are left out; the switches the constructors
must refuse (`batch_scan_dispatch`, the trimmers and the 2D
`pose_extrapolator.use_imu_based`) stay.
"""

from __future__ import annotations

import dataclasses
import math
import typing
from typing import Any, Dict, Optional


def _d(factory):
    return dataclasses.field(default_factory=factory)


@dataclasses.dataclass(frozen=True)
class TpuOptions2D:
    """Static capacities for the 2D pipeline."""

    scan_capacity: int = 2048  # max raw points per accumulated scan
    submap_grid_size: int = 1024  # cells per side (x resolution -> extent)
    ray_samples: int = 800  # free-space samples per ray (>= 2*max_range/res)
    # Capacity of the adaptively-filtered matching cloud; must exceed the
    # adaptive filter's worst-case survivor count (~2x min_num_points).
    matcher_capacity: int = 512
    # Capacity of the loop-closure node cloud (~100 points kept).
    loop_closure_capacity: int = 128


@dataclasses.dataclass(frozen=True)
class AdaptiveVoxelFilterOptions:
    max_length: float = 0.5
    min_num_points: int = 200
    max_range: float = 50.0


@dataclasses.dataclass(frozen=True)
class RealTimeCorrelativeScanMatcherOptions:
    linear_search_window: float = 0.1
    angular_search_window: float = math.radians(20.0)
    translation_delta_cost_weight: float = 1e-1
    rotation_delta_cost_weight: float = 1e-1


@dataclasses.dataclass(frozen=True)
class CeresScanMatcherOptions2D:
    occupied_space_weight: float = 1.0
    translation_weight: float = 10.0
    rotation_weight: float = 40.0
    max_num_iterations: int = 20
    use_nonmonotonic_steps: bool = False


@dataclasses.dataclass(frozen=True)
class MotionFilterOptions:
    max_time_seconds: float = 5.0
    max_distance_meters: float = 0.2
    max_angle_radians: float = math.radians(1.0)


@dataclasses.dataclass(frozen=True)
class ConstantVelocityExtrapolatorOptions:
    imu_gravity_time_constant: float = 10.0
    pose_queue_duration: float = 0.001


@dataclasses.dataclass(frozen=True)
class ImuBasedExtrapolatorOptions:
    """trajectory_builder_3d.lua pose_extrapolator.imu_based defaults."""
    pose_queue_duration: float = 5.0
    gravity_constant: float = 9.806
    pose_translation_weight: float = 1.0
    pose_rotation_weight: float = 1.0
    imu_acceleration_weight: float = 1.0
    imu_rotation_weight: float = 1.0
    odometry_translation_weight: float = 1.0
    odometry_rotation_weight: float = 1.0
    max_num_iterations: int = 10


@dataclasses.dataclass(frozen=True)
class PoseExtrapolatorOptions:
    use_imu_based: bool = False  # 3D only: the 2D builder refuses it
    constant_velocity: ConstantVelocityExtrapolatorOptions = _d(ConstantVelocityExtrapolatorOptions)
    imu_based: ImuBasedExtrapolatorOptions = _d(ImuBasedExtrapolatorOptions)


@dataclasses.dataclass(frozen=True)
class ProbabilityGridRangeDataInserterOptions2D:
    insert_free_space: bool = True
    hit_probability: float = 0.55
    miss_probability: float = 0.49


@dataclasses.dataclass(frozen=True)
class TsdfRangeDataInserterOptions2D:
    """trajectory_builder_2d.lua tsdf_range_data_inserter. The JAX inserter
    reads neither update_free_space, num_normal_samples nor sample_radius
    (its normals always take 4 samples); they are carried, not read."""
    truncation_distance: float = 0.3
    maximum_weight: float = 10.0
    update_free_space: bool = False
    num_normal_samples: int = 4
    sample_radius: float = 0.5
    project_sdf_distance_to_scan_normal: bool = True
    update_weight_range_exponent: int = 0
    update_weight_angle_scan_normal_to_ray_kernel_bandwidth: float = 0.5
    update_weight_distance_cell_to_hit_kernel_bandwidth: float = 0.5


@dataclasses.dataclass(frozen=True)
class SubmapsOptions2D:
    num_range_data: int = 90
    grid_type: str = "PROBABILITY_GRID"  # or "TSDF"
    resolution: float = 0.05
    # Carried as the JAX options carry it; the builders read grid_type.
    range_data_inserter_type: str = "PROBABILITY_GRID_INSERTER_2D"
    probability_grid_range_data_inserter: ProbabilityGridRangeDataInserterOptions2D = _d(
        ProbabilityGridRangeDataInserterOptions2D)
    tsdf_range_data_inserter: TsdfRangeDataInserterOptions2D = _d(TsdfRangeDataInserterOptions2D)


@dataclasses.dataclass(frozen=True)
class TrajectoryBuilder2DOptions:
    use_imu_data: bool = True
    min_range: float = 0.0
    max_range: float = 30.0
    min_z: float = -0.8
    max_z: float = 2.0
    missing_data_ray_length: float = 5.0
    voxel_filter_size: float = 0.025
    adaptive_voxel_filter: AdaptiveVoxelFilterOptions = _d(AdaptiveVoxelFilterOptions)
    loop_closure_adaptive_voxel_filter: AdaptiveVoxelFilterOptions = _d(
        lambda: AdaptiveVoxelFilterOptions(max_length=0.9, min_num_points=100, max_range=50.0))
    use_online_correlative_scan_matching: bool = False
    real_time_correlative_scan_matcher: RealTimeCorrelativeScanMatcherOptions = _d(
        RealTimeCorrelativeScanMatcherOptions)
    ceres_scan_matcher: CeresScanMatcherOptions2D = _d(CeresScanMatcherOptions2D)
    motion_filter: MotionFilterOptions = _d(MotionFilterOptions)
    pose_extrapolator: PoseExtrapolatorOptions = _d(PoseExtrapolatorOptions)
    submaps: SubmapsOptions2D = _d(SubmapsOptions2D)
    tpu: TpuOptions2D = _d(TpuOptions2D)


# ------------------------------------------------------- trajectory_builder_3d.lua

MAX_3D_RANGE = 60.0
INTENSITY_THRESHOLD = 40.0


@dataclasses.dataclass(frozen=True)
class TpuOptions3D:
    """Static capacities for the 3D pipeline."""

    scan_capacity: int = 4096
    filtered_capacity_high: int = 512
    filtered_capacity_low: int = 1024
    # Dense crop windows (cells per side) gathered from the paged grids for
    # the matcher; they do not bound the submap's addressable extent.
    high_grid_size: int = 256
    low_grid_size: int = 192
    # Paged submap grids: a pool of max_pages pages of page_size^3 voxels
    # behind a page table of num_blocks^3 slots (128 * 16 * 0.1 m = 204.8 m
    # addressable per side for the high-resolution grid).
    page_size: int = 16
    max_pages: int = 2048
    num_blocks: int = 128


@dataclasses.dataclass(frozen=True)
class IntensityCostFunctionOptions:
    weight: float = 0.5
    huber_scale: float = 0.3
    intensity_threshold: float = INTENSITY_THRESHOLD


@dataclasses.dataclass(frozen=True)
class CeresScanMatcherOptions3D:
    occupied_space_weight_0: float = 1.0
    occupied_space_weight_1: float = 6.0
    # The frontend reads only `weight` (with use_intensities); the matcher's
    # Huber scale and threshold stay at 0.3 and 40, as in the JAX package.
    intensity_cost_function_options_0: IntensityCostFunctionOptions = _d(
        IntensityCostFunctionOptions)
    translation_weight: float = 5.0
    rotation_weight: float = 4e2
    only_optimize_yaw: bool = False
    max_num_iterations: int = 12
    use_nonmonotonic_steps: bool = False


@dataclasses.dataclass(frozen=True)
class RangeDataInserterOptions3D:
    hit_probability: float = 0.55
    miss_probability: float = 0.49
    num_free_space_voxels: int = 2
    intensity_threshold: float = INTENSITY_THRESHOLD


@dataclasses.dataclass(frozen=True)
class SubmapsOptions3D:
    high_resolution: float = 0.10
    high_resolution_max_range: float = 20.0
    low_resolution: float = 0.45
    num_range_data: int = 160
    range_data_inserter: RangeDataInserterOptions3D = _d(RangeDataInserterOptions3D)


@dataclasses.dataclass(frozen=True)
class TrajectoryBuilder3DOptions:
    min_range: float = 1.0
    max_range: float = MAX_3D_RANGE
    voxel_filter_size: float = 0.15
    high_resolution_adaptive_voxel_filter: AdaptiveVoxelFilterOptions = _d(
        lambda: AdaptiveVoxelFilterOptions(max_length=2.0, min_num_points=150, max_range=15.0))
    low_resolution_adaptive_voxel_filter: AdaptiveVoxelFilterOptions = _d(
        lambda: AdaptiveVoxelFilterOptions(max_length=4.0, min_num_points=200,
                                           max_range=MAX_3D_RANGE))
    use_online_correlative_scan_matching: bool = False
    real_time_correlative_scan_matcher: RealTimeCorrelativeScanMatcherOptions = _d(
        lambda: RealTimeCorrelativeScanMatcherOptions(
            linear_search_window=0.15, angular_search_window=math.radians(1.0)))
    ceres_scan_matcher: CeresScanMatcherOptions3D = _d(CeresScanMatcherOptions3D)
    motion_filter: MotionFilterOptions = _d(
        lambda: MotionFilterOptions(max_time_seconds=0.5, max_distance_meters=0.1,
                                    max_angle_radians=0.004))
    rotational_histogram_size: int = 120
    pose_extrapolator: PoseExtrapolatorOptions = _d(PoseExtrapolatorOptions)
    submaps: SubmapsOptions3D = _d(SubmapsOptions3D)
    use_intensities: bool = False
    # Skip scans whose gravity-removed IMU acceleration exceeds this
    # [m/s^2]; 0 = off.
    max_accel_skip: float = 0.0
    tpu: TpuOptions3D = _d(TpuOptions3D)


# ---------------------------------------------------------------- pose_graph.lua


@dataclasses.dataclass(frozen=True)
class FastCorrelativeScanMatcherOptions2D:
    linear_search_window: float = 7.0
    angular_search_window: float = math.radians(30.0)
    branch_and_bound_depth: int = 7
    # Static bound of the angular candidate count (worst-case scan radius)
    # and the beam width of the level-synchronous search.
    max_scan_range: float = 30.0
    beam_width: int = 4096


@dataclasses.dataclass(frozen=True)
class FastCorrelativeScanMatcherOptions3D:
    branch_and_bound_depth: int = 8
    full_resolution_depth: int = 3
    min_rotational_score: float = 0.77
    min_low_resolution_score: float = 0.55
    linear_xy_search_window: float = 5.0
    linear_z_search_window: float = 1.0
    angular_search_window: float = math.radians(15.0)


@dataclasses.dataclass(frozen=True)
class ConstraintBuilderOptions:
    sampling_ratio: float = 0.3
    max_constraint_distance: float = 15.0
    min_score: float = 0.55
    global_localization_min_score: float = 0.6
    loop_closure_translation_weight: float = 1.1e4
    loop_closure_rotation_weight: float = 1e5
    fast_correlative_scan_matcher: FastCorrelativeScanMatcherOptions2D = _d(
        FastCorrelativeScanMatcherOptions2D)
    ceres_scan_matcher: CeresScanMatcherOptions2D = _d(
        lambda: CeresScanMatcherOptions2D(occupied_space_weight=20.0, translation_weight=10.0,
                                          rotation_weight=1.0, max_num_iterations=10,
                                          use_nonmonotonic_steps=True))
    fast_correlative_scan_matcher_3d: FastCorrelativeScanMatcherOptions3D = _d(
        FastCorrelativeScanMatcherOptions3D)
    ceres_scan_matcher_3d: CeresScanMatcherOptions3D = _d(
        lambda: CeresScanMatcherOptions3D(occupied_space_weight_0=5.0,
                                          occupied_space_weight_1=30.0, translation_weight=10.0,
                                          rotation_weight=1.0, only_optimize_yaw=False,
                                          max_num_iterations=10))


@dataclasses.dataclass(frozen=True)
class OptimizationProblemOptions:
    huber_scale: float = 1e1
    acceleration_weight: float = 1.1e2
    rotation_weight: float = 1.6e4
    local_slam_pose_translation_weight: float = 1e5
    local_slam_pose_rotation_weight: float = 1e5
    odometry_translation_weight: float = 1e5
    odometry_rotation_weight: float = 1e5
    fixed_frame_pose_translation_weight: float = 1e1
    fixed_frame_pose_rotation_weight: float = 1e2
    fixed_frame_pose_use_tolerant_loss: bool = False
    use_online_imu_extrinsics_in_3d: bool = True
    fix_z_in_3d: bool = False
    max_num_iterations: int = 50


@dataclasses.dataclass(frozen=True)
class PoseGraphOptions:
    optimize_every_n_nodes: int = 90
    constraint_builder: ConstraintBuilderOptions = _d(ConstraintBuilderOptions)
    matcher_translation_weight: float = 5e2
    matcher_rotation_weight: float = 1.6e3
    optimization_problem: OptimizationProblemOptions = _d(OptimizationProblemOptions)
    max_num_final_iterations: int = 200
    global_sampling_ratio: float = 0.003
    global_constraint_search_after_n_seconds: float = 10.0
    overlapping_submaps_trimmer_2d: Optional[Any] = None  # not ported: must stay None


# ------------------------------------------------ trajectory_builder.lua, map_builder.lua


@dataclasses.dataclass(frozen=True)
class TrajectoryBuilderOptions:
    trajectory_builder_2d: TrajectoryBuilder2DOptions = _d(TrajectoryBuilder2DOptions)
    trajectory_builder_3d: TrajectoryBuilder3DOptions = _d(TrajectoryBuilder3DOptions)
    pure_localization_trimmer: Optional[Any] = None  # not ported: must stay None


@dataclasses.dataclass(frozen=True)
class MapBuilderOptions:
    use_trajectory_builder_2d: bool = False
    use_trajectory_builder_3d: bool = False
    num_background_threads: int = 4
    pose_graph: PoseGraphOptions = _d(PoseGraphOptions)
    collate_by_trajectory: bool = False
    # Loop-closure searches on num_background_threads and the solves on an
    # optimizer thread while the frontend continues (the reference's
    # pipelined work queue, pose_graph_2d.cc:520-544); False runs them
    # inline, deterministically.
    async_constraint_search: bool = True
    batch_scan_dispatch: bool = False  # not ported: must stay False


def replace_tree(options, path: str, value):
    """Copy of the nested frozen dataclass with `path` (dot-separated)
    replaced by `value`: replace_tree(opts, 'submaps.num_range_data', 10)."""
    keys = path.split(".")
    if len(keys) == 1:
        return dataclasses.replace(options, **{keys[0]: value})
    child = getattr(options, keys[0])
    return dataclasses.replace(
        options, **{keys[0]: replace_tree(child, ".".join(keys[1:]), value)})


def apply_overrides(options, overrides: Dict[str, Any]):
    for path, value in overrides.items():
        options = replace_tree(options, path, value)
    return options


def from_dict(cls, d: Dict[str, Any]):
    """Build the dataclass `cls` from a nested dict such as
    `dataclasses.asdict` returns; unknown keys raise TypeError."""
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for key, value in d.items():
        field_type = hints.get(key)
        if dataclasses.is_dataclass(field_type) and isinstance(value, dict):
            value = from_dict(field_type, value)
        kwargs[key] = value
    return cls(**kwargs)
