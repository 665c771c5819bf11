"""2D submaps and the two-submap active window.

Counterpart of the JAX package's `mapping/submap_2d.py`
(mapping/2d/submap_2d.cc): ActiveSubmaps2D keeps the older submap (slot 0,
used for matching) and a newer one (slot 1); a new submap starts every
`num_range_data` inserted scans and the older one is finished after
2 * num_range_data. Both grids live in one batched Grid2D whose leading
dimension is the slot, so one insertion updates both; `prepare` and
`commit` split the window bookkeeping around the device step so that the
step needs no extra host round-trip.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from cartographer_tpu_torch.core.config import SubmapsOptions2D, TpuOptions2D
from cartographer_tpu_torch.core.tensor import to_device
from cartographer_tpu_torch.ops.grid_2d import Grid2D, InsertScratch, insert_into_slots
from cartographer_tpu_torch.sensor.point_cloud import RangeData

_SLOTS = 2


@dataclasses.dataclass
class Submap2D:
    """Host-side submap handle; `grid` is set (a device copy) on finish."""

    local_pose_translation: np.ndarray  # (3,) pose of submap origin in local frame
    local_pose_rotation: np.ndarray  # (4,) quaternion
    num_range_data: int = 0
    insertion_finished: bool = False
    grid: Optional[Grid2D] = None


class ActiveSubmaps2D:
    """The reference's ActiveSubmaps2D with both grids on the device.

    Slot 0 is the matching (older) submap, slot 1 the initializing one.
    """

    def __init__(self, options: SubmapsOptions2D, tpu: TpuOptions2D, device):
        if options.grid_type == "TSDF":
            raise NotImplementedError("TSDF submaps are not ported")
        self._options = options
        self._tpu = tpu
        self._device = torch.device(device)
        self.submaps: List[Submap2D] = []
        self._grids: Optional[Grid2D] = None  # batched (2, S, S)
        self._scratch = (InsertScratch.create(_SLOTS, tpu.submap_grid_size, self._device)
                         if self._device.type == "cuda" else None)

    def _blank_grid(self, center_xy: np.ndarray) -> Grid2D:
        return Grid2D.create(self._tpu.submap_grid_size, self._options.resolution,
                             center_xy, self._device)

    @property
    def matching_grid(self) -> Optional[Grid2D]:
        return None if self._grids is None else self._grids.slot(0)

    @property
    def grids(self) -> Optional[Grid2D]:
        return self._grids

    def _set_slot(self, slot: int, grid: Grid2D) -> None:
        if self._grids is None:
            self._grids = Grid2D(
                torch.stack([grid.log_odds] * _SLOTS), torch.stack([grid.known] * _SLOTS),
                torch.stack([grid.origin] * _SLOTS), grid.resolution)
            return
        target = self._grids.slot(slot)
        target.log_odds.copy_(grid.log_odds)
        target.known.copy_(grid.known)
        target.origin.copy_(grid.origin)

    def prepare(self, origin_xy: np.ndarray) -> np.ndarray:
        """Window management before an insertion: start a submap when the
        newest one has num_range_data scans; returns the active-slot mask."""
        if not self.submaps or (
                self.submaps[-1].num_range_data == self._options.num_range_data):
            self._add_submap(origin_xy)
        return np.asarray([True, len(self.submaps) > 1], dtype=bool)

    def commit(self, inserted: bool) -> List[Submap2D]:
        """Counter bookkeeping after a (possibly skipped) insertion; returns
        the newly finished submaps."""
        finished: List[Submap2D] = []
        if not inserted:
            return finished
        for submap in self.submaps:
            submap.num_range_data += 1
        front = self.submaps[0]
        if (not front.insertion_finished
                and front.num_range_data == 2 * self._options.num_range_data):
            front.insertion_finished = True
            # A copy: the slots are overwritten in place later.
            front.grid = self._grids.slot(0).clone()
            finished.append(front)
        return finished

    def insert(self, range_data: RangeData, active: torch.Tensor,
               do_insert: torch.Tensor) -> None:
        """Insert a gravity-aligned local-frame scan into the active slots
        when `do_insert` (0-d bool, may live on the device) holds."""
        ins = self._options.probability_grid_range_data_inserter
        insert_into_slots(self._grids, range_data, active, do_insert, ins.hit_probability,
                          ins.miss_probability, ins.insert_free_space,
                          self._tpu.ray_samples, self._scratch)

    def insert_range_data(self, range_data_2d: RangeData,
                          origin_xy: np.ndarray) -> List[Submap2D]:
        """ActiveSubmaps2D::InsertRangeData: prepare, insert, commit."""
        active = to_device(self.prepare(origin_xy), self._device)
        self.insert(range_data_2d, active,
                    torch.ones((), dtype=torch.bool, device=self._device))
        return self.commit(True)

    def _add_submap(self, origin_xy: np.ndarray) -> None:
        """Start a new submap at `origin_xy`; evicts the (finished) oldest."""
        if len(self.submaps) == _SLOTS:
            self.submaps.pop(0)
            self._set_slot(0, self._grids.slot(1))
        self.submaps.append(Submap2D(
            local_pose_translation=np.array([origin_xy[0], origin_xy[1], 0.0]),
            local_pose_rotation=np.array([1.0, 0.0, 0.0, 0.0])))
        blank = self._blank_grid(np.asarray(origin_xy))
        self._set_slot(len(self.submaps) - 1, blank)
        if len(self.submaps) == 1:
            self._set_slot(1, blank)  # slot 1 stays blank until a second submap

    def finish_all(self) -> List[Submap2D]:
        """Snapshot every active submap (used on trajectory finish)."""
        finished = []
        for i, submap in enumerate(self.submaps):
            if not submap.insertion_finished:
                submap.insertion_finished = True
                submap.grid = self._grids.slot(i).clone()
                finished.append(submap)
        return finished
