"""Per-trajectory time-sorted data maps with trimming.

Reference: sensor/map_by_time.h — holds IMU/odometry streams inside the
optimization problem, supports appending (time-ordered per trajectory),
range iteration, and trimming entries older than a given node time.
"""

from __future__ import annotations

import bisect
from typing import Dict, Generic, List, Optional, Tuple, TypeVar

from cartographer_tpu_torch.core.time import Time

T = TypeVar("T")


class MapByTime(Generic[T]):
    def __init__(self) -> None:
        self._data: Dict[int, List[Tuple[Time, T]]] = {}

    def append(self, trajectory_id: int, time: Time, data: T) -> None:
        traj = self._data.setdefault(trajectory_id, [])
        if traj and time <= traj[-1][0]:
            raise ValueError("MapByTime requires strictly increasing times")
        traj.append((time, data))

    def has_trajectory(self, trajectory_id: int) -> bool:
        return trajectory_id in self._data

    def trajectory(self, trajectory_id: int) -> List[Tuple[Time, T]]:
        return self._data.get(trajectory_id, [])

    def earliest_time(self, trajectory_id: int) -> Optional[Time]:
        traj = self._data.get(trajectory_id)
        return traj[0][0] if traj else None

    def lower_bound(self, trajectory_id: int, time: Time) -> int:
        """Index of the first entry with entry_time >= time."""
        traj = self._data.get(trajectory_id, [])
        return bisect.bisect_left(traj, (time,))

    def trim(self, trajectory_id: int, keep_after: Time) -> None:
        """Drop entries strictly older than `keep_after`, keeping one entry
        before it for interpolation (MapByTime::Trim semantics)."""
        traj = self._data.get(trajectory_id)
        if not traj:
            return
        i = bisect.bisect_left(traj, (keep_after,))
        cut = max(0, i - 1)
        self._data[trajectory_id] = traj[cut:]

    def trajectory_ids(self) -> List[int]:
        return sorted(self._data.keys())

    def delete_trajectory(self, trajectory_id: int) -> None:
        self._data.pop(trajectory_id, None)
