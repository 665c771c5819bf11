"""ID space for nodes and submaps.

Reference: cartographer/mapping/id.h — NodeId/SubmapId{trajectory_id, index}
and MapById, a sorted container with per-trajectory range iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Generic, Iterator, List, Optional, Tuple, TypeVar

T = TypeVar("T")


@dataclasses.dataclass(frozen=True, order=True)
class NodeId:
    trajectory_id: int
    node_index: int


@dataclasses.dataclass(frozen=True, order=True)
class SubmapId:
    trajectory_id: int
    submap_index: int


class MapById(Generic[T]):
    """Sorted (trajectory_id, index) -> data map (mapping/id.h MapById)."""

    def __init__(self) -> None:
        self._data: Dict[int, Dict[int, T]] = {}

    def insert(self, id_, data: T) -> None:
        traj = self._data.setdefault(id_.trajectory_id, {})
        if self._index(id_) in traj:
            raise KeyError(f"duplicate id {id_}")
        traj[self._index(id_)] = data

    def append(self, trajectory_id: int, data: T):
        """Append with the next free index; returns the new id-index."""
        traj = self._data.setdefault(trajectory_id, {})
        index = max(traj.keys()) + 1 if traj else 0
        traj[index] = data
        return index

    @staticmethod
    def _index(id_) -> int:
        return id_.node_index if isinstance(id_, NodeId) else id_.submap_index

    def __getitem__(self, id_) -> T:
        return self._data[id_.trajectory_id][self._index(id_)]

    def get(self, id_) -> Optional[T]:
        return self._data.get(id_.trajectory_id, {}).get(self._index(id_))

    def __contains__(self, id_) -> bool:
        return self._index(id_) in self._data.get(id_.trajectory_id, {})

    def __delitem__(self, id_) -> None:
        del self._data[id_.trajectory_id][self._index(id_)]
        if not self._data[id_.trajectory_id]:
            del self._data[id_.trajectory_id]

    def __len__(self) -> int:
        return sum(len(t) for t in self._data.values())

    def empty(self) -> bool:
        return len(self) == 0

    def trajectory_ids(self) -> List[int]:
        return sorted(self._data.keys())

    def trajectory(self, trajectory_id: int) -> List[Tuple[int, T]]:
        """Sorted (index, data) pairs for one trajectory."""
        return sorted(self._data.get(trajectory_id, {}).items())

    def items(self) -> Iterator[Tuple[Tuple[int, int], T]]:
        """All ((trajectory_id, index), data), globally sorted."""
        for traj_id in sorted(self._data):
            for index in sorted(self._data[traj_id]):
                yield (traj_id, index), self._data[traj_id][index]

    def size_of_trajectory(self, trajectory_id: int) -> int:
        return len(self._data.get(trajectory_id, {}))

    def last_index_of_trajectory(self, trajectory_id: int) -> Optional[int]:
        traj = self._data.get(trajectory_id)
        return max(traj.keys()) if traj else None
