"""Deterministic time-ordered sensor dispatch [HOST].

Reference equivalents: sensor/internal/ordered_multi_queue.{h,cc} (merge-sort
dispatch across per-(trajectory, sensor) queues), collator.{h,cc} (one queue
set across all trajectories — deterministic global ordering) and
trajectory_collator.{h,cc} (independent per-trajectory ordering).

Host-side control flow, copied from the JAX package's `sensor/collator.py`
without its optional native queue.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, List, Optional

from cartographer_tpu_torch.core.time import Time


@dataclasses.dataclass(frozen=True, order=True)
class QueueKey:
    trajectory_id: int
    sensor_id: str


class _Queue:
    def __init__(self, callback: Callable):
        self.items: collections.deque = collections.deque()
        self.callback = callback
        self.finished = False


class OrderedMultiQueue:
    """Merges per-key FIFO queues into one globally time-ordered stream.

    Dispatch blocks (returns without dispatching) while any unfinished queue
    is empty, so ordering is deterministic across sensors, matching
    sensor/internal/ordered_multi_queue.cc. Items are (time, data) pairs;
    each dispatched item is passed to its queue's callback.
    """

    def __init__(self) -> None:
        self._queues: Dict[QueueKey, _Queue] = {}
        self._last_dispatched_time: Optional[Time] = None
        self.blocker: Optional[QueueKey] = None

    def add_queue(self, key: QueueKey, callback: Callable) -> None:
        if key in self._queues:
            raise KeyError(f"queue {key} already exists")
        self._queues[key] = _Queue(callback)

    def mark_queue_as_finished(self, key: QueueKey) -> None:
        self._queues[key].finished = True
        self._dispatch()

    def add(self, key: QueueKey, time: Time, data) -> None:
        q = self._queues.get(key)
        if q is None:
            # Reference logs and drops data for unknown queues.
            return
        q.items.append((time, data))
        self._dispatch()

    def flush(self) -> None:
        for key in list(self._queues):
            self._queues[key].finished = True
        self._dispatch()

    def _dispatch(self) -> None:
        while True:
            best_key = None
            best_time = None
            for key, q in self._queues.items():
                if not q.items:
                    if not q.finished:
                        self.blocker = key
                        return  # blocked: an unfinished queue is empty
                    continue
                t = q.items[0][0]
                if best_time is None or t < best_time:
                    best_time, best_key = t, key
            if best_key is None:
                # All queues finished and empty: drop them.
                self._queues.clear()
                return
            q = self._queues[best_key]
            time, data = q.items.popleft()
            if self._last_dispatched_time is not None and time < self._last_dispatched_time:
                raise ValueError(
                    f"out-of-order dispatch from queue {best_key}: "
                    f"{time} < {self._last_dispatched_time}")
            self._last_dispatched_time = time
            q.callback(time, data)
            if not self._queues:  # callback may have triggered teardown
                return


class Collator:
    """One OrderedMultiQueue across ALL trajectories (sensor::Collator):
    deterministic global time ordering at the cost of cross-trajectory
    blocking."""

    def __init__(self) -> None:
        self._queue = OrderedMultiQueue()
        self._queue_keys: Dict[int, List[QueueKey]] = {}

    def add_trajectory(self, trajectory_id: int, expected_sensor_ids,
                       callback: Callable) -> None:
        for sensor_id in expected_sensor_ids:
            key = QueueKey(trajectory_id, sensor_id)
            self._queue.add_queue(key, lambda t, d, k=key: callback(k.trajectory_id, k.sensor_id, t, d))
            self._queue_keys.setdefault(trajectory_id, []).append(key)

    def finish_trajectory(self, trajectory_id: int) -> None:
        for key in self._queue_keys.get(trajectory_id, []):
            self._queue.mark_queue_as_finished(key)

    def add_sensor_data(self, trajectory_id: int, sensor_id: str, time: Time, data) -> None:
        self._queue.add(QueueKey(trajectory_id, sensor_id), time, data)

    def flush(self) -> None:
        self._queue.flush()

    def get_blocking_trajectory_id(self) -> Optional[int]:
        if self._queue.blocker is not None:
            return self._queue.blocker.trajectory_id
        return None


class TrajectoryCollator:
    """Per-trajectory OrderedMultiQueues (sensor::TrajectoryCollator): no
    cross-trajectory blocking, non-deterministic interleaving across
    trajectories."""

    def __init__(self) -> None:
        self._queues: Dict[int, OrderedMultiQueue] = {}
        self._keys: Dict[int, List[QueueKey]] = {}

    def add_trajectory(self, trajectory_id: int, expected_sensor_ids,
                       callback: Callable) -> None:
        if trajectory_id in self._queues:
            raise KeyError(f"trajectory {trajectory_id} already added")
        q = OrderedMultiQueue()
        self._queues[trajectory_id] = q
        for sensor_id in expected_sensor_ids:
            key = QueueKey(trajectory_id, sensor_id)
            q.add_queue(key, lambda t, d, k=key: callback(k.trajectory_id, k.sensor_id, t, d))
            self._keys.setdefault(trajectory_id, []).append(key)

    def finish_trajectory(self, trajectory_id: int) -> None:
        for key in self._keys.get(trajectory_id, []):
            self._queues[trajectory_id].mark_queue_as_finished(key)

    def add_sensor_data(self, trajectory_id: int, sensor_id: str, time: Time, data) -> None:
        self._queues[trajectory_id].add(QueueKey(trajectory_id, sensor_id), time, data)

    def flush(self) -> None:
        for q in self._queues.values():
            q.flush()

    def get_blocking_trajectory_id(self) -> Optional[int]:
        return None
