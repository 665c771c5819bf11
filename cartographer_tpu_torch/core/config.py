"""2D trajectory-builder options with the reference's default values.

The subset of the JAX package's `core/config.py` that the 2D local-SLAM
frontend reads: nested frozen dataclasses whose defaults replicate the
reference's trajectory_builder_2d.lua, plus the static capacities the
device pipeline is sized by (`TpuOptions2D`, kept under its original name so
that the `dataclasses.asdict` trees of the two packages share their keys).
Options of features the port does not have are left out; the two switches
the builder must refuse (`use_online_correlative_scan_matching`,
`submaps.grid_type`) stay.
"""

from __future__ import annotations

import dataclasses
import math
import typing
from typing import Any, Dict


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
class PoseExtrapolatorOptions:
    constant_velocity: ConstantVelocityExtrapolatorOptions = _d(ConstantVelocityExtrapolatorOptions)


@dataclasses.dataclass(frozen=True)
class ProbabilityGridRangeDataInserterOptions2D:
    insert_free_space: bool = True
    hit_probability: float = 0.55
    miss_probability: float = 0.49


@dataclasses.dataclass(frozen=True)
class SubmapsOptions2D:
    num_range_data: int = 90
    grid_type: str = "PROBABILITY_GRID"  # "TSDF" is not ported
    resolution: float = 0.05
    probability_grid_range_data_inserter: ProbabilityGridRangeDataInserterOptions2D = _d(
        ProbabilityGridRangeDataInserterOptions2D)


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
    ceres_scan_matcher: CeresScanMatcherOptions2D = _d(CeresScanMatcherOptions2D)
    motion_filter: MotionFilterOptions = _d(MotionFilterOptions)
    pose_extrapolator: PoseExtrapolatorOptions = _d(PoseExtrapolatorOptions)
    submaps: SubmapsOptions2D = _d(SubmapsOptions2D)
    tpu: TpuOptions2D = _d(TpuOptions2D)


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
