"""2D submaps and the two-submap active window.

Counterpart of the JAX package's `mapping/submap_2d.py`
(mapping/2d/submap_2d.cc): ActiveSubmaps2D keeps the older submap (slot 0,
used for matching) and a newer one (slot 1); a new submap starts every
`num_range_data` inserted scans and the older one is finished after
2 * num_range_data. Both grids live in one batched Grid2D (or TsdfGrid2D,
with `grid_type = "TSDF"`) whose leading dimension is the slot, so one
insertion updates both; `prepare` and `commit` split the window bookkeeping
around the device step so that the step needs no extra host round-trip.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from cartographer_tpu_torch.core.config import SubmapsOptions2D, TpuOptions2D
from cartographer_tpu_torch.core.tensor import to_device
from cartographer_tpu_torch.ops.grid_2d import Grid2D, InsertScratch, insert_into_slots
from cartographer_tpu_torch.ops.tsdf_2d import (
    TsdfGrid2D,
    TsdfInserterParams,
    insert_into_slots_tsdf,
)
from cartographer_tpu_torch.sensor.point_cloud import RangeData

_SLOTS = 2


@dataclasses.dataclass
class Submap2D:
    """Host-side submap handle; `grid` is set (a device copy) on finish."""

    local_pose_translation: np.ndarray  # (3,) pose of submap origin in local frame
    local_pose_rotation: np.ndarray  # (4,) quaternion
    num_range_data: int = 0
    insertion_finished: bool = False
    grid: Optional[Grid2D] = None  # or a TsdfGrid2D


class ActiveSubmaps2D:
    """The reference's ActiveSubmaps2D with both grids on the device.

    Slot 0 is the matching (older) submap, slot 1 the initializing one.
    """

    def __init__(self, options: SubmapsOptions2D, tpu: TpuOptions2D, device):
        self._options = options
        self._tpu = tpu
        self._device = torch.device(device)
        self._tsdf = options.grid_type == "TSDF"
        self.submaps: List[Submap2D] = []
        self._grids = None  # batched (2, S, S) Grid2D or TsdfGrid2D
        self._scratch = None  # K4's bitmaps of marked cells
        if self._device.type == "cuda" and not self._tsdf:
            self._scratch = InsertScratch.create(_SLOTS, tpu.submap_grid_size, self._device)
        t = options.tsdf_range_data_inserter
        self._tsdf_params = TsdfInserterParams(
            t.update_weight_range_exponent,
            t.update_weight_angle_scan_normal_to_ray_kernel_bandwidth,
            t.update_weight_distance_cell_to_hit_kernel_bandwidth,
            t.project_sdf_distance_to_scan_normal) if self._tsdf else None

    def _blank_grid(self, center_xy: np.ndarray):
        if self._tsdf:
            t = self._options.tsdf_range_data_inserter
            return TsdfGrid2D.create(self._tpu.submap_grid_size, self._options.resolution,
                                     center_xy, self._device, t.truncation_distance,
                                     t.maximum_weight)
        return Grid2D.create(self._tpu.submap_grid_size, self._options.resolution,
                             center_xy, self._device)

    @property
    def matching_grid(self):
        return None if self._grids is None else self._grids.slot(0)

    @property
    def grids(self):
        return self._grids

    def _set_slot(self, slot: int, grid) -> None:
        names = ("tsd", "weight", "origin") if self._tsdf else ("log_odds", "known", "origin")
        if self._grids is None:
            self._grids = dataclasses.replace(
                grid, **{k: torch.stack([getattr(grid, k)] * _SLOTS) for k in names})
            return
        target = self._grids.slot(slot)
        for k in names:
            getattr(target, k).copy_(getattr(grid, k))

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
        if self._tsdf:
            insert_into_slots_tsdf(self._grids, range_data, active, do_insert,
                                   self._tsdf_params)
            return
        ins = self._options.probability_grid_range_data_inserter
        insert_into_slots(self._grids, range_data, active, do_insert, ins.hit_probability,
                          ins.miss_probability, ins.insert_free_space,
                          self._tpu.ray_samples, self._scratch)

    @staticmethod
    def insert_batch(windows: Sequence["ActiveSubmaps2D"], range_data: RangeData,
                     active: torch.Tensor, do_insert: torch.Tensor) -> None:
        """Insert R robots' scans (every field of `range_data` with a leading
        R; `active` (R, 2), `do_insert` (R,)) into each robot's own active
        slots: one launch of K4 for all R on the card, or for TSDF windows
        one launch of K20 and one of K21."""
        w0 = windows[0]
        if w0._tsdf:
            insert_into_slots_tsdf([w._grids for w in windows], range_data, active, do_insert,
                                   w0._tsdf_params)
            return
        ins = w0._options.probability_grid_range_data_inserter
        insert_into_slots([w._grids for w in windows], range_data, active, do_insert,
                          ins.hit_probability, ins.miss_probability, ins.insert_free_space,
                          w0._tpu.ray_samples,
                          None if w0._scratch is None else [w._scratch for w in windows])

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

