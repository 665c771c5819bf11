"""Per-trajectory merge of multiple range sensors [HOST].

Reference: mapping/internal/range_data_collator.{h,cc} — at most one pending
message per range sensor; when a new message for a sensor arrives while one is
pending, the pending window is cropped and emitted so data leaves in time
order across sensors. Single-sensor setups pass through directly.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from cartographer_tpu_torch.core.time import Time
from cartographer_tpu_torch.sensor.data import TimedPointCloudData


class RangeDataCollator:
    def __init__(self, expected_range_sensor_ids: List[str]):
        self._expected = set(expected_range_sensor_ids)
        self._id_to_pending: Dict[str, TimedPointCloudData] = {}
        self._current_start: Optional[Time] = None
        self._current_end: Optional[Time] = None

    def add_range_data(self, sensor_id: str, data: TimedPointCloudData
                       ) -> List[TimedPointCloudData]:
        """Returns zero or more merged, time-cropped batches ready to process."""
        assert sensor_id in self._expected, sensor_id
        if len(self._expected) == 1:
            return [data]
        out: List[TimedPointCloudData] = []
        if sensor_id in self._id_to_pending:
            # Second message for a sensor: flush up to the new message start.
            self._current_end = self._id_to_pending[sensor_id].time
            out.extend(self._crop_and_merge())
        self._id_to_pending[sensor_id] = data
        if set(self._id_to_pending.keys()) == self._expected:
            self._current_end = min(d.time for d in self._id_to_pending.values())
            out.extend(self._crop_and_merge())
        return out

    def _crop_and_merge(self) -> List[TimedPointCloudData]:
        """Emit points with absolute time in (current_start, current_end]."""
        end = self._current_end
        start = self._current_start
        merged: List[TimedPointCloudData] = []
        for sensor_id in sorted(self._id_to_pending.keys()):
            data = self._id_to_pending[sensor_id]
            abs_times = data.time + (data.times * 1e6).astype(np.int64)
            keep = abs_times <= end
            if start is not None:
                keep &= abs_times > start
            if not keep.any():
                if data.time <= end:
                    del self._id_to_pending[sensor_id]
                continue
            n_keep = int(keep.sum())
            # Missing intensities are filled with kDefaultIntensityValue=0
            # (range_data_collator.h:41-44, .cc CropAndMerge).
            intensities = (data.intensities[keep] if data.intensities is not None
                           else np.zeros(n_keep, np.float32))
            cropped = TimedPointCloudData(
                time=end,
                origin=data.origin,
                ranges=data.ranges[keep],
                times=(abs_times[keep] - end) * 1e-6,
                intensities=intensities,
                origins=np.broadcast_to(
                    np.asarray(data.origin, np.float32)[None, :],
                    (n_keep, data.origin.shape[0])).copy(),
            )
            merged.append(cropped)
            if data.time <= end:
                del self._id_to_pending[sensor_id]
        self._current_start = end
        if not merged:
            return []
        # Concatenate all sensors into one batch stamped at `end`, carrying
        # per-point origins (≙ TimedPointCloudOriginData origin_index, here
        # pre-gathered into a dense array for static-shape device kernels).
        first = merged[0]
        times = np.concatenate([m.times for m in merged])
        order = np.argsort(times, kind="stable")  # range_data_collator.cc:124
        return [TimedPointCloudData(
            time=end,
            origin=first.origin,
            ranges=np.concatenate([m.ranges for m in merged])[order],
            times=times[order],
            intensities=np.concatenate([m.intensities for m in merged])[order],
            origins=np.concatenate([m.origins for m in merged])[order],
        )]
