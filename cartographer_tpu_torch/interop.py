"""Carry state between the JAX package and the port as numpy arrays.

With these a test builds a submap, a precomputation pyramid or a pose-graph
problem with one package and runs it through the other; the port itself
never imports the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Tuple

import numpy as np

import torch

from cartographer_tpu_torch.core.config import (
    MapBuilderOptions,
    TrajectoryBuilder2DOptions,
    TrajectoryBuilder3DOptions,
    TrajectoryBuilderOptions,
    from_dict,
)
from cartographer_tpu_torch.core.tensor import to_device
from cartographer_tpu_torch.ops.bnb_3d import PrecomputationStack3D
from cartographer_tpu_torch.ops.grid_2d import Grid2D
from cartographer_tpu_torch.ops.grid_3d import Grid3D, IntensityGrid3D
from cartographer_tpu_torch.ops.paged_grid_3d import (
    PagedGrid3D,
    PagedIntensityGrid3D,
    PagedIntensitySubmapGrid3D,
    PagedSubmapGrid3D,
)
from cartographer_tpu_torch.ops.tsdf_2d import TsdfGrid2D
from cartographer_tpu_torch.parallel.schur_spa import SchurSpaProblem2D
from cartographer_tpu_torch.parallel.schur_spa_3d import SchurSpaProblem3D


def grid2d_from_numpy(log_odds: np.ndarray, known: np.ndarray, origin: np.ndarray,
                      resolution: float, device) -> Grid2D:
    return Grid2D(to_device(np.asarray(log_odds, np.float32), device),
                  to_device(np.asarray(known, bool), device),
                  to_device(np.asarray(origin, np.float32), device), float(resolution))


def grid2d_to_numpy(grid: Grid2D) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """-> (log_odds, known, origin, resolution)."""
    return (grid.log_odds.cpu().numpy(), grid.known.cpu().numpy(),
            grid.origin.cpu().numpy(), grid.resolution)


def tsdf_grid2d_from_numpy(tsd: np.ndarray, weight: np.ndarray, origin: np.ndarray,
                           resolution: float, truncation_distance: float, max_weight: float,
                           device) -> TsdfGrid2D:
    """A TsdfGrid2D holding the JAX package's TsdfGrid2D fields."""
    return TsdfGrid2D(to_device(np.asarray(tsd, np.float32), device),
                      to_device(np.asarray(weight, np.float32), device),
                      to_device(np.asarray(origin, np.float32), device), float(resolution),
                      float(truncation_distance), float(max_weight))


def tsdf_grid2d_to_numpy(grid: TsdfGrid2D):
    """-> (tsd, weight, origin, resolution, truncation_distance, max_weight)."""
    return (grid.tsd.cpu().numpy(), grid.weight.cpu().numpy(), grid.origin.cpu().numpy(),
            grid.resolution, grid.truncation_distance, grid.max_weight)


# Switches of the JAX package's 2D options that select features the port
# does not have, each with the value that leaves the feature off.
UNPORTED_SWITCHES = {
    "num_accumulated_range_data": 1,
    "pose_extrapolator.use_imu_based": False,
}
# Options that only unported features read (the IMU-based extrapolator) or
# that the 2D frontend never reads.
UNREAD_OPTIONS = (
    "pose_extrapolator.imu_based",
    "tpu.filtered_capacity",
    "imu_gravity_time_constant",
)


def _pop(d: Dict[str, Any], path: str, default):
    *parents, key = path.split(".")
    for parent in parents:
        d = d.get(parent, {})
    return d.pop(key, default)


def _strip(d: Dict[str, Any], switches: Dict[str, Any], unread) -> Dict[str, Any]:
    d = copy.deepcopy(d)
    for path, off in switches.items():
        value = _pop(d, path, off)
        if value != off:
            raise NotImplementedError(f"{path} = {value!r} is not ported")
    for path in unread:
        _pop(d, path, None)
    return d


def options_from_dict(d: Dict[str, Any]) -> TrajectoryBuilder2DOptions:
    """TrajectoryBuilder2DOptions from `dataclasses.asdict` of the JAX
    package's options of the same name. A switch of UNPORTED_SWITCHES that
    turns its feature on raises NotImplementedError; UNREAD_OPTIONS are
    dropped."""
    return from_dict(TrajectoryBuilder2DOptions,
                     _strip(d, UNPORTED_SWITCHES, UNREAD_OPTIONS))


# The JAX package's 3D options: the switch of scan accumulation, which the
# JAX package's 3D builder never reads, and options that no 3D code reads.
UNPORTED_3D_SWITCHES = {
    "num_accumulated_range_data": 1,
}
UNREAD_3D_OPTIONS = (
    "imu_gravity_time_constant",
    "tpu.ray_samples",
)


def options_3d_from_dict(d: Dict[str, Any]) -> TrajectoryBuilder3DOptions:
    """TrajectoryBuilder3DOptions from `dataclasses.asdict` of the JAX
    package's options of the same name (the online correlative search,
    intensities and the IMU-based extrapolator among them); a switch of
    UNPORTED_3D_SWITCHES that turns its feature on raises
    NotImplementedError."""
    return from_dict(TrajectoryBuilder3DOptions,
                     _strip(d, UNPORTED_3D_SWITCHES, UNREAD_3D_OPTIONS))


def grid3d_from_numpy(log_odds: np.ndarray, known: np.ndarray, origin: np.ndarray,
                      resolution: float, device) -> Grid3D:
    return Grid3D(to_device(np.asarray(log_odds, np.float32), device),
                  to_device(np.asarray(known, bool), device),
                  to_device(np.asarray(origin, np.float32), device), float(resolution))


def intensity_grid3d_from_numpy(sums: np.ndarray, counts: np.ndarray, origin: np.ndarray,
                                resolution: float, device) -> IntensityGrid3D:
    return IntensityGrid3D(to_device(np.asarray(sums, np.float32), device),
                           to_device(np.asarray(counts, np.float32), device),
                           to_device(np.asarray(origin, np.float32), device), float(resolution))


def _with_allocation(paged, page_table: np.ndarray, origin: np.ndarray, slots):
    paged._slots = {tuple(int(v) for v in k): int(s) for k, s in slots.items()}
    paged._origin_host = np.asarray(origin, np.float32).copy()
    paged._table_host = page_table.copy()
    paged.pages_allocated_last_insert = 0
    return paged


def paged_grid_from_numpy(pages: np.ndarray, known: np.ndarray, page_table: np.ndarray,
                          origin: np.ndarray, resolution: float, page_size: int,
                          slots: Dict[Tuple[int, int, int], int], device
                          ) -> PagedSubmapGrid3D:
    """A PagedSubmapGrid3D holding the JAX package's pool, table and
    allocation state (`PagedSubmapGrid3D.grid` fields and `_slots`)."""
    page_table = np.asarray(page_table, np.int32)
    paged = PagedSubmapGrid3D.__new__(PagedSubmapGrid3D)
    paged.grid = PagedGrid3D(
        to_device(np.asarray(pages, np.float32), device), to_device(np.asarray(known, bool), device),
        to_device(page_table.copy(), device), to_device(np.asarray(origin, np.float32), device),
        float(resolution), int(page_size))
    paged._scratch = None
    return _with_allocation(paged, page_table, origin, slots)


def paged_intensity_grid_from_numpy(sums: np.ndarray, counts: np.ndarray,
                                    page_table: np.ndarray, origin: np.ndarray,
                                    resolution: float, page_size: int,
                                    slots: Dict[Tuple[int, int, int], int], device
                                    ) -> PagedIntensitySubmapGrid3D:
    """A PagedIntensitySubmapGrid3D holding the JAX package's pools, table
    and allocation state (`PagedIntensitySubmapGrid3D.grid` fields and
    `_slots`)."""
    page_table = np.asarray(page_table, np.int32)
    paged = PagedIntensitySubmapGrid3D.__new__(PagedIntensitySubmapGrid3D)
    paged.grid = PagedIntensityGrid3D(
        to_device(np.asarray(sums, np.float32), device),
        to_device(np.asarray(counts, np.float32), device), to_device(page_table.copy(), device),
        to_device(np.asarray(origin, np.float32), device), float(resolution), int(page_size))
    return _with_allocation(paged, page_table, origin, slots)


def paged_grid_to_numpy(paged: PagedSubmapGrid3D):
    """-> (pages, known, page_table, origin, resolution, page_size, slots)."""
    g = paged.grid
    return (g.pages.cpu().numpy(), g.known.cpu().numpy(), g.page_table.cpu().numpy(),
            g.origin.cpu().numpy(), g.resolution, g.page_size, dict(paged._slots))


# The same for the trajectory and map-builder trees: switches of unported
# features (cross-robot batching, the trimmers) and options that only
# unported features read (multi-chip meshes, logs, tolerant-loss shapes).
UNPORTED_MAP_BUILDER_SWITCHES = {
    "batch_scan_dispatch": False,
    "pose_graph.overlapping_submaps_trimmer_2d": None,
}
UNREAD_MAP_BUILDER_OPTIONS = (
    "use_device_mesh",
    "pose_graph.log_residual_histograms",
    "pose_graph.max_nodes",
    "pose_graph.max_submaps",
    "pose_graph.max_constraints",
    "pose_graph.constraint_builder.log_matches",
    "pose_graph.optimization_problem.fixed_frame_pose_tolerant_loss_param_a",
    "pose_graph.optimization_problem.fixed_frame_pose_tolerant_loss_param_b",
    "pose_graph.optimization_problem.log_solver_summary",
    "pose_graph.optimization_problem.use_nonmonotonic_steps",
    "pose_graph.optimization_problem.num_threads",
)
UNPORTED_TRAJECTORY_SWITCHES = {"pure_localization_trimmer": None}
UNREAD_TRAJECTORY_OPTIONS = ("collate_fixed_frame", "collate_landmarks")


def map_builder_options_from_dict(d: Dict[str, Any]) -> MapBuilderOptions:
    """MapBuilderOptions from `dataclasses.asdict` of the JAX package's."""
    return from_dict(MapBuilderOptions, _strip(d, UNPORTED_MAP_BUILDER_SWITCHES,
                                               UNREAD_MAP_BUILDER_OPTIONS))


def trajectory_builder_options_from_dict(d: Dict[str, Any]) -> TrajectoryBuilderOptions:
    """TrajectoryBuilderOptions (with the 2D tree through options_from_dict,
    the 3D tree through options_3d_from_dict) from `dataclasses.asdict` of
    the JAX package's."""
    d = _strip(d, UNPORTED_TRAJECTORY_SWITCHES, UNREAD_TRAJECTORY_OPTIONS)
    tb2 = options_from_dict(d.pop("trajectory_builder_2d", {}))
    tb3 = options_3d_from_dict(d.pop("trajectory_builder_3d", {}))
    return TrajectoryBuilderOptions(trajectory_builder_2d=tb2, trajectory_builder_3d=tb3, **d)


def pyramid_from_numpy(pyramid: np.ndarray, device) -> torch.Tensor:
    """(depth, S, S) precomputation pyramid of the JAX package's
    `build_precomputation_pyramid`."""
    return to_device(np.asarray(pyramid, np.float32), device)


def schur_problem_from_numpy(arrays: Dict[str, np.ndarray], device) -> SchurSpaProblem2D:
    """SchurSpaProblem2D from the JAX problem's fields as numpy arrays
    (`{f.name: np.asarray(getattr(problem, f.name))}`). Unary node terms are
    not ported (the 2D pose graph never fills them): any valid one raises."""
    if np.any(np.asarray(arrays.get("u_valid", np.zeros(0, bool)))):
        raise NotImplementedError("unary node terms of the Schur SPA are not ported")
    return _problem_from_numpy(SchurSpaProblem2D, arrays, device)


def _problem_from_numpy(cls, arrays: Dict[str, np.ndarray], device):
    """`cls` from its fields as numpy arrays: integers as int32, floats as
    float32, booleans as they are."""
    fields = {}
    for name in (f.name for f in dataclasses.fields(cls)):
        a = np.asarray(arrays[name])
        a = a.astype(np.int32) if a.dtype.kind in "iu" else a
        fields[name] = to_device(a.astype(np.float32) if a.dtype.kind == "f" else a, device)
    return cls(**fields)


def stack3d_from_numpy(full: np.ndarray, coarse: np.ndarray, depth: int,
                       full_resolution_depth: int, device) -> PrecomputationStack3D:
    """PrecomputationStack3D of the JAX package's
    `build_precomputation_stack_3d` (its `full` and `coarse` uint8 levels)."""
    return PrecomputationStack3D(to_device(np.asarray(full, np.uint8), device),
                                 to_device(np.asarray(coarse, np.uint8), device), int(depth),
                                 int(full_resolution_depth))


def schur_problem_3d_from_numpy(arrays: Dict[str, np.ndarray], device) -> SchurSpaProblem3D:
    """SchurSpaProblem3D from the JAX problem's fields as numpy arrays
    (`{f.name: np.asarray(getattr(problem, f.name))}`)."""
    return _problem_from_numpy(SchurSpaProblem3D, arrays, device)
