"""MapBuilder: the entry point of 2D and 3D SLAM, wiring trajectory builders
to the pose graph.

Counterpart of the JAX package's `mapping/map_builder.py` (map_builder.cc,
global_trajectory_builder.cc) on one device: sensor data goes through the
collator to each trajectory's local builder, and every inserted scan becomes
a pose-graph node. With `use_trajectory_builder_3d` the trajectories are 3D
(LocalTrajectoryBuilder3D, PoseGraph3D; IMU data also feeds the pose
graph's IMU terms), else 2D. The device flows down to the frontends, the
constraint builders and the solvers; it is the card unless the caller asks
for the CPU, and the constructor raises when there is no card.

`serialize_state` writes the pose graph to a pbstream in the native format
or the reference's proto schema (`io/serialization.py`,
`io/carto_pbstream.py`); `load_state` reads either, with its grids on the
builder's device, frozen by default, so that a new trajectory localizes
against the loaded map.

With `batch_scan_dispatch` the 2D trajectories share one `ScanBatcher`
(`mapping/scan_batcher.py`): their frontends' steps run in cross-robot
ticks, one launch per kernel and one fetch per tick, on probability-grid
or TSDF submaps. As in the JAX package the batcher takes one step
configuration: a trajectory whose 2D options differ from the first one's
raises ValueError at its first scan.

Not ported, and refused with NotImplementedError: the trimmers (pure
localization among them), landmark observations, pose-graph-only
(uplinked) trajectories, and a device mesh or multihost process group.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from cartographer_tpu_torch import metrics
from cartographer_tpu_torch.core.config import MapBuilderOptions, TrajectoryBuilderOptions
from cartographer_tpu_torch.core.time import Time
from cartographer_tpu_torch.io.carto_pbstream import (
    is_carto_stream,
    load_carto_state,
    write_carto_state,
)
from cartographer_tpu_torch.io.pbstream import ProtoStreamReader, ProtoStreamWriter
from cartographer_tpu_torch.io.serialization import load_state, serialize_state
from cartographer_tpu_torch.mapping.local_trajectory_builder_2d import (
    LocalTrajectoryBuilder2D,
    MatchingResult,
    PermutationFn,
)
from cartographer_tpu_torch.mapping.local_trajectory_builder_3d import LocalTrajectoryBuilder3D
from cartographer_tpu_torch.mapping.pose_graph_2d import PoseGraph2D, TrajectoryNode
from cartographer_tpu_torch.mapping.pose_graph_3d import PoseGraph3D, TrajectoryNode3D
from cartographer_tpu_torch.mapping.scan_batcher import ScanBatcher
from cartographer_tpu_torch.sensor.collator import Collator, TrajectoryCollator
from cartographer_tpu_torch.sensor.data import (
    FixedFramePoseData,
    ImuData,
    LandmarkData,
    OdometryData,
    TimedPointCloudData,
)

# LocalSlamResultCallback(trajectory_id, time, local translation, local rotation, result)
LocalSlamResultCallback = Callable[[int, Time, np.ndarray, np.ndarray, MatchingResult], None]


class GlobalTrajectoryBuilder:
    """Forwards sensor data to local SLAM and its results into the pose
    graph (global_trajectory_builder.cc:36-145)."""

    def __init__(self, trajectory_id: int, local_builder: LocalTrajectoryBuilder2D,
                 pose_graph: PoseGraph2D,
                 local_slam_result_callback: Optional[LocalSlamResultCallback] = None):
        self.trajectory_id = trajectory_id
        self._local = local_builder
        self._pose_graph = pose_graph
        self._callback = local_slam_result_callback
        self._metric_results = metrics.GLOBAL_FACTORY.new_counter_family(
            "mapping_global_trajectory_builder_local_slam_results",
            "Local SLAM results").add({})

    def add_range_data(self, sensor_id: str, data: TimedPointCloudData) -> None:
        result = self._local.add_range_data(sensor_id, data)
        if result is None:
            return
        self._metric_results.increment()
        if result.insertion_result is not None:
            ir = result.insertion_result
            self._pose_graph.add_node(self.trajectory_id, self._node(ir), ir.insertion_submaps,
                                      ir.finished_submaps)
        if self._callback is not None:
            self._callback(self.trajectory_id, result.time, result.local_pose_translation,
                           result.local_pose_rotation, result)

    def _node(self, ir) -> TrajectoryNode:
        """The pose graph's node for a local insertion."""
        cloud = ir.filtered_gravity_aligned_point_cloud
        return TrajectoryNode(
            time=ir.time, gravity_alignment=ir.gravity_alignment,
            filtered_points=cloud.points[cloud.mask].numpy().astype(np.float64),
            local_pose_translation=ir.local_pose_translation,
            local_pose_rotation=ir.local_pose_rotation)

    def add_imu_data(self, imu_data: ImuData) -> None:
        self._local.add_imu_data(imu_data)

    def add_odometry_data(self, odometry_data: OdometryData) -> None:
        self._local.add_odometry_data(odometry_data)
        self._pose_graph.add_odometry_data(self.trajectory_id, odometry_data)

    def add_fixed_frame_pose_data(self, data: FixedFramePoseData) -> None:
        self._pose_graph.add_fixed_frame_pose_data(self.trajectory_id, data)

    def finish(self):
        return self._local.finish()


class GlobalTrajectoryBuilder3D(GlobalTrajectoryBuilder):
    """The 3D glue: local SLAM results into PoseGraph3D, IMU data into both
    (global_trajectory_builder.cc, templated over 2D and 3D there)."""

    def _node(self, ir) -> TrajectoryNode3D:
        return TrajectoryNode3D(
            time=ir.time, gravity_alignment=ir.gravity_alignment,
            high_res_cloud=ir.high_res_cloud, low_res_cloud=ir.low_res_cloud,
            scan_histogram=ir.scan_histogram,
            local_pose_translation=ir.local_pose_translation,
            local_pose_rotation=ir.local_pose_rotation)

    def add_imu_data(self, imu_data: ImuData) -> None:
        self._local.add_imu_data(imu_data)
        self._pose_graph.add_imu_data(self.trajectory_id, imu_data)


class MapBuilder:
    """MapBuilderInterface (map_builder.cc)."""

    def __init__(self, options: MapBuilderOptions, device="cuda", mesh=None,
                 multihost: bool = False):
        if mesh is not None or multihost:
            raise NotImplementedError("multi-device SLAM (a mesh or multihost) is not ported")
        if not options.use_trajectory_builder_2d and not options.use_trajectory_builder_3d:
            raise ValueError("one of use_trajectory_builder_2d/3d must be set")
        if options.pose_graph.overlapping_submaps_trimmer_2d is not None:
            raise NotImplementedError("the overlapping-submaps trimmer is not ported")
        self._device = torch.device(device)
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("MapBuilder: no CUDA device is available; "
                               "pass device='cpu' to run the plain PyTorch path")
        self._options = options
        threads = options.num_background_threads if options.async_constraint_search else 0
        graph = PoseGraph3D if options.use_trajectory_builder_3d else PoseGraph2D
        self.pose_graph = graph(options.pose_graph, num_background_threads=threads,
                                device=self._device)
        self._collator = TrajectoryCollator() if options.collate_by_trajectory else Collator()
        self._builders: Dict[int, GlobalTrajectoryBuilder] = {}
        self._frozen: List[int] = []  # trajectory ids loaded by load_state
        self._scan_batcher: Optional[ScanBatcher] = None  # shared by the 2D trajectories

    def add_trajectory_builder(
            self, expected_sensor_ids: List[str], trajectory_options: TrajectoryBuilderOptions,
            local_slam_result_callback: Optional[LocalSlamResultCallback] = None,
            local_slam_results: bool = False,
            permutation_fn: Optional[PermutationFn] = None) -> int:
        """A new trajectory (3D when the map builder is); returns its id.
        `permutation_fn` replaces the voxel filters' on-device permutation
        (tests inject the JAX package's through it)."""
        if local_slam_results:
            raise NotImplementedError("pose-graph-only (uplinked) trajectories are not ported")
        if trajectory_options.pure_localization_trimmer is not None:
            raise NotImplementedError("the pure-localization trimmer is not ported")
        trajectory_id = len(self._builders) + len(self._frozen)
        range_ids = [s for s in expected_sensor_ids
                     if s.startswith("range") or "laser" in s or "points" in s]
        if self._options.use_trajectory_builder_3d:
            local = LocalTrajectoryBuilder3D(trajectory_options.trajectory_builder_3d,
                                             range_ids or expected_sensor_ids,
                                             device=self._device, permutation_fn=permutation_fn)
            glue = GlobalTrajectoryBuilder3D
        else:
            batcher = None
            if self._options.batch_scan_dispatch:
                if self._scan_batcher is None:
                    self._scan_batcher = ScanBatcher()
                batcher = self._scan_batcher
            local = LocalTrajectoryBuilder2D(trajectory_options.trajectory_builder_2d,
                                             range_ids or expected_sensor_ids,
                                             device=self._device, batcher=batcher,
                                             permutation_fn=permutation_fn)
            glue = GlobalTrajectoryBuilder
        self._builders[trajectory_id] = glue(trajectory_id, local, self.pose_graph,
                                             local_slam_result_callback)
        self._collator.add_trajectory(trajectory_id, expected_sensor_ids, self._dispatch)
        return trajectory_id

    def _dispatch(self, trajectory_id: int, sensor_id: str, time: Time, data) -> None:
        builder = self._builders[trajectory_id]
        if isinstance(data, TimedPointCloudData):
            builder.add_range_data(sensor_id, data)
        elif isinstance(data, ImuData):
            builder.add_imu_data(data)
        elif isinstance(data, OdometryData):
            builder.add_odometry_data(data)
        elif isinstance(data, FixedFramePoseData):
            builder.add_fixed_frame_pose_data(data)
        elif isinstance(data, LandmarkData):
            raise NotImplementedError("landmarks are not ported")
        else:
            raise TypeError(f"unknown sensor data type {type(data)}")

    def add_sensor_data(self, trajectory_id: int, sensor_id: str, data) -> None:
        self._collator.add_sensor_data(trajectory_id, sensor_id, data.time, data)

    def finish_trajectory(self, trajectory_id: int) -> None:
        self._collator.finish_trajectory(trajectory_id)
        self.pose_graph.finish_trajectory(trajectory_id)
        finished_submaps = self._builders[trajectory_id].finish()
        for _, entry in self.pose_graph.submap_data.items():
            if any(entry.submap is s for s in finished_submaps):
                entry.finished = True

    def num_trajectory_builders(self) -> int:
        return len(self._builders)

    def get_trajectory_builder(self, trajectory_id: int) -> GlobalTrajectoryBuilder:
        return self._builders[trajectory_id]

    def serialize_state(self, writer_or_path, include_unfinished_submaps: bool = True,
                        format: str = "native") -> None:
        """MapBuilder::SerializeState (map_builder.cc:213-225), once the
        background searches and solves have drained. `format` "native"
        writes the MessagePack records the JAX package writes, "carto" the
        reference's proto schema."""
        if format not in ("native", "carto"):
            raise ValueError(f"unknown pbstream format {format!r}")
        self.pose_graph.wait_for_optimization()
        self.pose_graph.wait_for_all_computations()
        writer = (writer_or_path if isinstance(writer_or_path, ProtoStreamWriter)
                  else ProtoStreamWriter(writer_or_path))
        write = write_carto_state if format == "carto" else serialize_state
        write(self.pose_graph, writer, include_unfinished_submaps)
        writer.close()

    def load_state(self, reader_or_path, load_frozen_state: bool = True) -> Dict[int, int]:
        """MapBuilder::LoadState (map_builder.cc:227-395) of a native or a
        reference-schema pbstream; returns the trajectory id remapping. The
        loaded trajectories count toward the ids of new ones."""
        reader = (reader_or_path if isinstance(reader_or_path, ProtoStreamReader)
                  else ProtoStreamReader(reader_or_path))
        records = list(reader)
        reader.close()
        load = load_carto_state if records and is_carto_stream(records[0]) else load_state
        remapping = load(records, self.pose_graph, frozen=load_frozen_state)
        self._frozen.extend(sorted(set(remapping.values())))
        return remapping
