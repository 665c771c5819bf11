"""Trajectory connectivity with last-connection times [HOST].

Reference: mapping/internal/trajectory_connectivity_state.{h,cc} +
connected_components.cc — union-find over trajectories joined by
inter-trajectory constraints, plus a per-pair last-connection-time map used
by ComputeConstraint to pick a windowed local search over a full global one
when two trajectories were connected recently (pose_graph_2d.cc:277-289).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from cartographer_tpu_torch.core.time import Time


class TrajectoryConnectivityState:
    def __init__(self) -> None:
        self._parent: Dict[int, int] = {}
        # (min_tid, max_tid) -> last direct-connection time
        # (trajectory_connectivity_state.h:66-71).
        self._last_connection_time: Dict[Tuple[int, int], Time] = {}

    def add(self, trajectory_id: int) -> None:
        self._parent.setdefault(trajectory_id, trajectory_id)

    def _find(self, t: int) -> int:
        self.add(t)
        while self._parent[t] != t:
            self._parent[t] = self._parent[self._parent[t]]
            t = self._parent[t]
        return t

    def transitively_connected(self, a: int, b: int) -> bool:
        return a == b or self._find(a) == self._find(b)

    def components(self) -> List[List[int]]:
        groups: Dict[int, List[int]] = {}
        for t in self._parent:
            groups.setdefault(self._find(t), []).append(t)
        return [sorted(v) for v in groups.values()]

    def component(self, trajectory_id: int) -> List[int]:
        root = self._find(trajectory_id)
        return sorted(t for t in self._parent if self._find(t) == root)

    def connect(self, a: int, b: int, time: Time) -> None:
        """Connect two trajectories at `time`
        (trajectory_connectivity_state.cc:26-55): when joining two components,
        stamp every bipartite pair so the whole merged component switches to
        windowed local search immediately."""
        if self.transitively_connected(a, b):
            key = (min(a, b), max(a, b))
            if self._last_connection_time.get(key, 0) < time:
                self._last_connection_time[key] = time
        else:
            for ta in self.component(a):
                for tb in self.component(b):
                    self._last_connection_time[(min(ta, tb), max(ta, tb))] = time
        ra, rb = self._find(a), self._find(b)
        if ra != rb:
            self._parent[ra] = rb

    def last_connection_time(self, a: int, b: int) -> Optional[Time]:
        return self._last_connection_time.get((min(a, b), max(a, b)))
