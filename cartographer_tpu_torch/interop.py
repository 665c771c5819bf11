"""Carry state between the JAX package and the port as numpy arrays.

With these a test builds a submap with one package and matches or inserts
on it with the other; the port itself never imports the JAX package.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Tuple

import numpy as np

from cartographer_tpu_torch.core.config import TrajectoryBuilder2DOptions, from_dict
from cartographer_tpu_torch.core.tensor import to_device
from cartographer_tpu_torch.ops.grid_2d import Grid2D


def grid2d_from_numpy(log_odds: np.ndarray, known: np.ndarray, origin: np.ndarray,
                      resolution: float, device) -> Grid2D:
    return Grid2D(to_device(np.asarray(log_odds, np.float32), device),
                  to_device(np.asarray(known, bool), device),
                  to_device(np.asarray(origin, np.float32), device), float(resolution))


def grid2d_to_numpy(grid: Grid2D) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """-> (log_odds, known, origin, resolution)."""
    return (grid.log_odds.cpu().numpy(), grid.known.cpu().numpy(),
            grid.origin.cpu().numpy(), grid.resolution)


# Switches of the JAX package's 2D options that select features the port
# does not have, each with the value that leaves the feature off.
UNPORTED_SWITCHES = {
    "num_accumulated_range_data": 1,
    "pose_extrapolator.use_imu_based": False,
    "submaps.range_data_inserter_type": "PROBABILITY_GRID_INSERTER_2D",
}
# Options that only unported features read (the correlative matcher, the
# IMU-based extrapolator, TSDF submaps) or that the 2D frontend never reads.
UNREAD_OPTIONS = (
    "real_time_correlative_scan_matcher",
    "pose_extrapolator.imu_based",
    "submaps.tsdf_range_data_inserter",
    "tpu.filtered_capacity",
    "imu_gravity_time_constant",
)


def _pop(d: Dict[str, Any], path: str, default):
    *parents, key = path.split(".")
    for parent in parents:
        d = d.get(parent, {})
    return d.pop(key, default)


def options_from_dict(d: Dict[str, Any]) -> TrajectoryBuilder2DOptions:
    """TrajectoryBuilder2DOptions from `dataclasses.asdict` of the JAX
    package's options of the same name. A switch of UNPORTED_SWITCHES that
    turns its feature on raises NotImplementedError; UNREAD_OPTIONS are
    dropped."""
    d = copy.deepcopy(d)
    for path, off in UNPORTED_SWITCHES.items():
        value = _pop(d, path, off)
        if value != off:
            raise NotImplementedError(f"{path} = {value!r} is not ported")
    for path in UNREAD_OPTIONS:
        _pop(d, path, None)
    return from_dict(TrajectoryBuilder2DOptions, d)
