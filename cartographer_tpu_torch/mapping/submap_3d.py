"""3D submaps: dual-resolution paged grids and a rotational histogram.

Counterpart of the JAX package's `mapping/submap_3d.py`
(mapping/3d/submap_3d.{h,cc}): each submap holds a high-resolution paged
grid (points within `high_resolution_max_range`), a low-resolution one and
a rotational histogram accumulated per scan; `ActiveSubmaps3D` keeps the
two-submap window (a new submap every `num_range_data` insertions, finish
at twice that). The matcher reads dense windows cropped around the
predicted pose every scan; a finished submap's pools are compacted and its
content-centered dense crops are made on first access.

With intensities on, each submap also keeps a paged running-average
intensity pool at the high resolution (the reference's
IntensityHybridGrid), fed with the points within
`high_resolution_max_range` whose intensity is at most
`range_data_inserter.intensity_threshold` and cropped with the high
window; unlike the reference, a finished submap keeps its compacted pool.

The insertion runs on the device tensors the caller already holds (the
frontend's per-scan step); the host arrays only drive the page allocation.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from cartographer_tpu_torch.core.config import SubmapsOptions3D, TpuOptions3D
from cartographer_tpu_torch.core.tensor import to_device
from cartographer_tpu_torch.ops.grid_3d import Grid3D, IntensityGrid3D
from cartographer_tpu_torch.ops.paged_grid_3d import (
    PagedIntensitySubmapGrid3D,
    PagedSubmapGrid3D,
)
from cartographer_tpu_torch.ops.rot_histogram import rotate_histogram


class Submap3D:
    """One 3D submap: paged grids plus lazy content-centered dense crops
    (`high_grid`, `low_grid`, `intensity_grid`), which loop closure and
    serialization read."""

    def __init__(self, local_pose_translation, local_pose_rotation, num_range_data: int = 0,
                 insertion_finished: bool = False,
                 high_paged: Optional[PagedSubmapGrid3D] = None,
                 low_paged: Optional[PagedSubmapGrid3D] = None,
                 high_grid: Optional[Grid3D] = None, low_grid: Optional[Grid3D] = None,
                 histogram: Optional[np.ndarray] = None,
                 crop_sizes: Tuple[int, int] = (256, 192),
                 intensity_paged: Optional[PagedIntensitySubmapGrid3D] = None):
        self.local_pose_translation = local_pose_translation
        self.local_pose_rotation = local_pose_rotation
        self.num_range_data = num_range_data
        self.insertion_finished = insertion_finished
        self.high_paged = high_paged
        self.low_paged = low_paged
        self._high_grid = high_grid
        self._low_grid = low_grid
        self.histogram = histogram
        self._crop_sizes = crop_sizes
        self.intensity_paged = intensity_paged  # None without intensities
        self._intensity_grid: Optional[IntensityGrid3D] = None

    def _crop(self, cached, paged, size: int, center_of=None):
        if cached is None and self.insertion_finished and paged is not None:
            return paged.crop_dense((paged if center_of is None else center_of).known_center(),
                                    size)
        return cached

    @property
    def high_grid(self) -> Optional[Grid3D]:
        self._high_grid = self._crop(self._high_grid, self.high_paged, self._crop_sizes[0])
        return self._high_grid

    @high_grid.setter
    def high_grid(self, grid) -> None:
        self._high_grid = grid

    @property
    def low_grid(self) -> Optional[Grid3D]:
        self._low_grid = self._crop(self._low_grid, self.low_paged, self._crop_sizes[1])
        return self._low_grid

    @low_grid.setter
    def low_grid(self, grid) -> None:
        self._low_grid = grid

    @property
    def intensity_grid(self) -> Optional[IntensityGrid3D]:
        """The crop of the intensity pool in `high_grid`'s window."""
        if self.high_paged is not None:
            self._intensity_grid = self._crop(self._intensity_grid, self.intensity_paged,
                                              self._crop_sizes[0], self.high_paged)
        return self._intensity_grid

    @intensity_grid.setter
    def intensity_grid(self, grid) -> None:
        self._intensity_grid = grid


class ActiveSubmaps3D:
    def __init__(self, options: SubmapsOptions3D, tpu: TpuOptions3D, device,
                 histogram_size: int = 120, use_intensities: bool = False):
        self._options = options
        self._tpu = tpu
        self._histogram_size = histogram_size
        self._use_intensities = use_intensities
        self._device = torch.device(device)
        self.submaps: List[Submap3D] = []
        self._histograms: List[np.ndarray] = []
        self.pages_allocated_last_insert = 0

    def _new_paged(self, resolution: float, center: np.ndarray, cls=PagedSubmapGrid3D):
        t = self._tpu
        return cls(resolution, center, self._device, page_size=t.page_size,
                   max_pages=t.max_pages, num_blocks=t.num_blocks)

    def matching_grids_at(self, center) -> Optional[
            Tuple[Grid3D, Grid3D, Optional[IntensityGrid3D]]]:
        """Dense (high, low, intensity or None) crops of the matching
        (oldest active) submap around `center`, the scan's predicted
        position, so the matching window follows the robot and not the
        submap's origin. The intensity crop is the high crop's window."""
        if not self.submaps:
            return None
        s = self.submaps[0]
        size = self._tpu.high_grid_size
        intensity = (s.intensity_paged.crop_dense(center, size)
                     if s.intensity_paged is not None else None)
        return (s.high_paged.crop_dense(center, size),
                s.low_paged.crop_dense(center, self._tpu.low_grid_size), intensity)

    @property
    def matching_histogram(self) -> np.ndarray:
        return self._histograms[0]

    def insert_range_data(self, origin_local, points_local, mask, scan_histogram: np.ndarray,
                          scan_yaw_in_local: float,
                          rotated_histogram: Optional[np.ndarray] = None,
                          high_mask=None, device_tensors=None,
                          intensities=None) -> List[Submap3D]:
        """Insert a local-frame scan into both active submaps; returns the
        newly finished submaps (ActiveSubmaps3D::InsertData).

        `origin_local`, `points_local`, `mask` (and `intensities`, which the
        intensity pools take when they are kept) are host arrays.
        `high_mask` is the mask of the points within
        `high_resolution_max_range` of the origin, computed here when not
        given. `device_tensors` = (origin, points, mask, high_mask[,
        intensities]) are the same values on the device, when the caller
        holds them there; otherwise they are uploaded."""
        finished: List[Submap3D] = []
        if not self.submaps or (
                self.submaps[-1].num_range_data == self._options.num_range_data):
            self._add_submap(np.asarray(origin_local))

        ins = self._options.range_data_inserter
        origin_np = np.asarray(origin_local, np.float32)
        points_np = np.asarray(points_local, np.float32)
        mask_np = np.asarray(mask, bool)
        if high_mask is None:
            high_mask = mask_np & (np.linalg.norm(points_np - origin_np[None, :], axis=-1)
                                   <= self._options.high_resolution_max_range)
        high_np = np.asarray(high_mask, bool)
        if device_tensors is None:
            dev = self._device
            device_tensors = (to_device(origin_np, dev), to_device(points_np, dev),
                              to_device(mask_np, dev), to_device(high_np, dev))
        origin_t, points_t, mask_t, high_t = device_tensors[:4]
        if rotated_histogram is None:
            rotated_histogram = rotate_histogram(
                torch.from_numpy(np.asarray(scan_histogram, np.float32)),
                torch.tensor(scan_yaw_in_local, dtype=torch.float32)).numpy()
        rotated = np.asarray(rotated_histogram, np.float64)
        kwargs = dict(hit_probability=ins.hit_probability,
                      miss_probability=ins.miss_probability,
                      num_free_space_voxels=ins.num_free_space_voxels)
        self.pages_allocated_last_insert = 0
        for i, submap in enumerate(self.submaps):
            submap.high_paged.insert_range_data(
                origin_np, points_np, high_np, device_tensors=(origin_t, points_t, high_t),
                **kwargs)
            submap.low_paged.insert_range_data(
                origin_np, points_np, mask_np, device_tensors=(origin_t, points_t, mask_t),
                **kwargs)
            self.pages_allocated_last_insert += (
                submap.high_paged.pages_allocated_last_insert
                + submap.low_paged.pages_allocated_last_insert)
            if submap.intensity_paged is not None and intensities is not None:
                # The high-resolution range gate, as the occupancy's high grid.
                dev_intens = (device_tensors[4] if len(device_tensors) > 4
                              else to_device(np.asarray(intensities, np.float32), self._device))
                submap.intensity_paged.insert(
                    points_np, intensities, high_np, ins.intensity_threshold,
                    device_tensors=(points_t, dev_intens, high_t))
                self.pages_allocated_last_insert += (
                    submap.intensity_paged.pages_allocated_last_insert)
            submap.num_range_data += 1
            # The scan histogram rotated into the submap frame (submaps are
            # yaw-anchored at identity, so the scan's yaw is the rotation).
            self._histograms[i] += rotated

        front = self.submaps[0]
        if (not front.insertion_finished
                and front.num_range_data == 2 * self._options.num_range_data):
            self._finish(0)
            finished.append(front)
        return finished

    def _finish(self, i: int) -> None:
        """Finish a submap: compact its page pools and stamp the histogram;
        the dense crops are made on first use."""
        submap = self.submaps[i]
        submap.insertion_finished = True
        submap.high_paged.compact()
        submap.low_paged.compact()
        if submap.intensity_paged is not None:
            submap.intensity_paged.compact()
        submap.histogram = self._histograms[i].copy()

    def _add_submap(self, origin: np.ndarray) -> None:
        if len(self.submaps) == 2:
            self.submaps.pop(0)
            self._histograms.pop(0)
        center = np.asarray(origin, np.float32)
        high = self._options.high_resolution
        self.submaps.append(Submap3D(
            local_pose_translation=np.asarray(origin, float),
            local_pose_rotation=np.array([1.0, 0, 0, 0]),
            high_paged=self._new_paged(high, center),
            low_paged=self._new_paged(self._options.low_resolution, center),
            crop_sizes=(self._tpu.high_grid_size, self._tpu.low_grid_size),
            intensity_paged=(self._new_paged(high, center, PagedIntensitySubmapGrid3D)
                             if self._use_intensities else None)))
        self._histograms.append(np.zeros(self._histogram_size))

    def finish_all(self) -> List[Submap3D]:
        finished = []
        for i, submap in enumerate(self.submaps):
            if not submap.insertion_finished:
                self._finish(i)
                finished.append(submap)
        return finished
