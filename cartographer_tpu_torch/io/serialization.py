"""Versioned, ordered SLAM-state serialization into pbstream: the native
format.

Counterpart of the JAX package's `io/serialization.py`
(mapping_state_serialization.cc): SerializationHeader{format_version} ->
PoseGraph -> AllTrajectoryBuilderOptions -> Submap* -> Node* ->
TrajectoryData, each record a MessagePack map (`io/msgpack_wire.py`, byte
for byte what the JAX package's `msgpack.packb(use_bin_type=True)` writes),
version 2 with the v1 -> v2 migration. Node clouds go through
`sensor/compression.py`'s block compression (1 mm), grids as float16
log-odds and packed known bits.

The records are built from the same numpy dtypes and Python types as the
JAX package's (grid tensors are fetched as float32 and rounded by numpy,
poses are lists of Python floats), so a state carried across gives the same
bytes in both packages and a stream written by either loads in the other.
Loaded grids go to the pose graph's device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from cartographer_tpu_torch.core.tensor import to_device
from cartographer_tpu_torch.io.msgpack_wire import packb, unpackb
from cartographer_tpu_torch.io.pbstream import ProtoStreamReader, ProtoStreamWriter
from cartographer_tpu_torch.mapping.constraint_builder_2d import Constraint
from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
from cartographer_tpu_torch.mapping.pose_graph_2d import SubmapDataEntry, TrajectoryNode
from cartographer_tpu_torch.mapping.pose_graph_3d import (
    Constraint3D,
    PoseGraph3D,
    SubmapDataEntry3D,
    TrajectoryNode3D,
)
from cartographer_tpu_torch.mapping.submap_2d import Submap2D
from cartographer_tpu_torch.mapping.submap_3d import Submap3D
from cartographer_tpu_torch.ops.grid_2d import Grid2D
from cartographer_tpu_torch.ops.grid_3d import Grid3D, IntensityGrid3D
from cartographer_tpu_torch.sensor.compression import compress_cloud, decompress_cloud

SERIALIZATION_FORMAT_VERSION = 2
_CLOUD_QUANT = 1000.0  # legacy mm quantization (v2 streams of the JAX package's first round)


def _nd(a: np.ndarray) -> Dict[str, Any]:
    a = np.ascontiguousarray(a)
    return {"__nd__": True, "shape": list(a.shape), "dtype": str(a.dtype),
            "data": a.tobytes()}


def _un_nd(d) -> np.ndarray:
    return np.frombuffer(d["data"], dtype=np.dtype(d["dtype"])).reshape(d["shape"]).copy()


def _host(t) -> np.ndarray:
    """A device tensor (or array) as numpy."""
    return t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)


def _floats(a) -> List[float]:
    return list(map(float, _host(a)))


def _quantize_cloud(points: np.ndarray) -> Dict[str, Any]:
    return compress_cloud(np.asarray(points, np.float64))


def _dequantize_cloud(d) -> np.ndarray:
    if isinstance(d, dict) and d.get("__nd__"):  # legacy int16 mm payloads
        return _un_nd(d).astype(np.float64) / _CLOUD_QUANT
    return decompress_cloud(d)


def serialize_state(pose_graph, writer: ProtoStreamWriter,
                    include_unfinished_submaps: bool = True) -> None:
    """WritePbStream (mapping_state_serialization.cc:31-36) of a
    PoseGraph2D or PoseGraph3D."""
    if isinstance(pose_graph, PoseGraph3D):
        return _serialize_state_3d(pose_graph, writer, include_unfinished_submaps)
    writer.write(packb({"type": "header", "format_version": SERIALIZATION_FORMAT_VERSION}))
    constraints = [{
        "submap_id": [c.submap_id.trajectory_id, c.submap_id.submap_index],
        "node_id": [c.node_id.trajectory_id, c.node_id.node_index],
        "rel": _floats(c.rel),
        "translation_weight": c.translation_weight,
        "rotation_weight": c.rotation_weight,
        "tag": c.tag,
    } for c in pose_graph.constraints]
    writer.write(packb({
        "type": "pose_graph",
        "constraints": constraints,
        "submap_poses": [{"id": [t, i], "pose": _floats(e.global_pose_2d)}
                         for (t, i), e in pose_graph.submap_data.items()],
        "node_poses": [{"id": [t, i], "pose": _floats(n.global_pose_2d)}
                       for (t, i), n in pose_graph.nodes.items()],
        "landmark_poses": {lid: _floats(np.atleast_1d(p))
                           for lid, p in pose_graph.landmark_poses.items()},
        "frozen_landmarks": sorted(pose_graph._frozen_landmarks),
        "fixed_frame_origins": {str(tid): _floats(o)
                                for tid, o in pose_graph.fixed_frame_origin.items()},
    }))
    writer.write(packb({"type": "trajectory_builder_options", "options": {}}))
    for (t, i), entry in pose_graph.submap_data.items():
        submap = entry.submap
        if submap.grid is None and not include_unfinished_submaps:
            continue
        record = {
            "type": "submap",
            "id": [t, i],
            "num_range_data": submap.num_range_data,
            "finished": submap.insertion_finished,
            "local_pose_translation": _floats(submap.local_pose_translation),
            "local_pose_rotation": _floats(submap.local_pose_rotation),
        }
        if submap.grid is not None:
            record["grid"] = grid2d_record(submap.grid)
        writer.write(packb(record))
    for (t, i), node in pose_graph.nodes.items():
        writer.write(packb({
            "type": "node",
            "id": [t, i],
            "time": node.time,
            "gravity_alignment": _floats(node.gravity_alignment),
            "local_pose_translation": _floats(node.local_pose_translation),
            "local_pose_rotation": _floats(node.local_pose_rotation),
            "cloud": _quantize_cloud(node.filtered_points),
        }))
    writer.write(packb({"type": "trajectory_data"}))


def grid2d_record(grid: Grid2D) -> Dict[str, Any]:
    """The record of a 2D grid: float16 log-odds and packed known bits."""
    known = _host(grid.known)
    return {
        "log_odds": _nd(_host(grid.log_odds).astype(np.float16)),
        "known": _nd(np.packbits(known)),
        "known_shape": list(known.shape),
        "origin": _floats(grid.origin),
        "resolution": grid.resolution,
    }


def un_grid2d(g, device) -> Grid2D:
    known = np.unpackbits(_un_nd(g["known"]))[
        : int(np.prod(g["known_shape"]))].reshape(g["known_shape"]).astype(bool)
    return Grid2D(log_odds=to_device(_un_nd(g["log_odds"]).astype(np.float32), device),
                  known=to_device(known, device),
                  origin=to_device(np.asarray(g["origin"], np.float32), device),
                  resolution=g["resolution"])


def _grid3d_record(grid: Grid3D) -> Dict[str, Any]:
    known = _host(grid.known)
    return {
        "log_odds": _nd(_host(grid.log_odds).astype(np.float16)),
        "known": _nd(np.packbits(known)),
        "shape": list(known.shape),
        "origin": _floats(grid.origin),
        "resolution": grid.resolution,
    }


def _un_grid3d(g, device) -> Grid3D:
    known = np.unpackbits(_un_nd(g["known"]))[: int(np.prod(g["shape"]))].reshape(
        g["shape"]).astype(bool)
    return Grid3D(log_odds=to_device(_un_nd(g["log_odds"]).astype(np.float32), device),
                  known=to_device(known, device),
                  origin=to_device(np.asarray(g["origin"], np.float32), device),
                  resolution=g["resolution"])


def _intensity3d_record(grid: IntensityGrid3D) -> Dict[str, Any]:
    """Sparse record of an intensity crop: the flat indices of the populated
    voxels and their sums and counts (the reference forgets intensity grids
    when a submap retires; keeping them is the JAX package's extension)."""
    sums = _host(grid.sums).astype(np.float32)
    counts = _host(grid.counts).astype(np.float32)
    idx = np.flatnonzero(counts.reshape(-1) > 0)
    return {
        "shape": list(sums.shape),
        "idx": _nd(idx.astype(np.int64)),
        "sums": _nd(sums.reshape(-1)[idx]),
        "counts": _nd(counts.reshape(-1)[idx].astype(np.uint16)),
        "origin": _floats(grid.origin),
        "resolution": grid.resolution,
    }


def _un_intensity3d(g, device) -> IntensityGrid3D:
    shape = tuple(g["shape"])
    sums = np.zeros(int(np.prod(shape)), np.float32)
    counts = np.zeros(int(np.prod(shape)), np.float32)
    idx = _un_nd(g["idx"])
    sums[idx] = _un_nd(g["sums"])
    counts[idx] = _un_nd(g["counts"]).astype(np.float32)
    return IntensityGrid3D(sums=to_device(sums.reshape(shape), device),
                           counts=to_device(counts.reshape(shape), device),
                           origin=to_device(np.asarray(g["origin"], np.float32), device),
                           resolution=g["resolution"])


def _serialize_state_3d(pose_graph, writer: ProtoStreamWriter,
                        include_unfinished_submaps: bool = True) -> None:
    writer.write(packb({"type": "header", "dim": 3,
                        "format_version": SERIALIZATION_FORMAT_VERSION}))
    writer.write(packb({
        "type": "pose_graph",
        "constraints": [{
            "submap_id": [c.submap_id.trajectory_id, c.submap_id.submap_index],
            "node_id": [c.node_id.trajectory_id, c.node_id.node_index],
            "rel_t": _floats(c.rel_t),
            "rel_q": _floats(c.rel_q),
            "translation_weight": c.translation_weight,
            "rotation_weight": c.rotation_weight,
            "tag": c.tag,
        } for c in pose_graph.constraints],
        "submap_poses": [{"id": [t, i], "t": _floats(e.global_t), "q": _floats(e.global_q)}
                         for (t, i), e in pose_graph.submap_data.items()],
        "node_poses": [{"id": [t, i], "t": _floats(n.global_t), "q": _floats(n.global_q)}
                       for (t, i), n in pose_graph.nodes.items()],
        "landmark_poses": {lid: _floats(np.atleast_1d(p))
                           for lid, p in pose_graph.landmark_poses.items()},
        "frozen_landmarks": sorted(pose_graph._frozen_landmarks),
    }))
    writer.write(packb({"type": "trajectory_builder_options", "options": {}}))
    for (t, i), entry in pose_graph.submap_data.items():
        submap = entry.submap
        high = submap.high_grid
        if high is None and not include_unfinished_submaps:
            continue
        record = {
            "type": "submap3d", "id": [t, i],
            "num_range_data": submap.num_range_data,
            "finished": submap.insertion_finished,
            "local_pose_translation": _floats(submap.local_pose_translation),
            "local_pose_rotation": _floats(submap.local_pose_rotation),
        }
        if high is not None:
            record["high_grid"] = _grid3d_record(high)
            record["low_grid"] = _grid3d_record(submap.low_grid)
            record["histogram"] = _nd(np.asarray(submap.histogram, np.float32))
            if submap.intensity_grid is not None:
                record["intensity_grid"] = _intensity3d_record(submap.intensity_grid)
        writer.write(packb(record))
    for (t, i), node in pose_graph.nodes.items():
        writer.write(packb({
            "type": "node3d", "id": [t, i], "time": node.time,
            "gravity_alignment": _floats(node.gravity_alignment),
            "local_pose_translation": _floats(node.local_pose_translation),
            "local_pose_rotation": _floats(node.local_pose_rotation),
            "high_cloud": _quantize_cloud(node.high_res_cloud),
            "low_cloud": _quantize_cloud(node.low_res_cloud),
            "histogram": _nd(np.asarray(node.scan_histogram, np.float32)),
        }))
    # TrajectoryData (optimization_problem_3d.h): the learned gravity
    # constant, IMU calibration and fixed-frame origin per trajectory.
    entries = []
    for tid, td in pose_graph.trajectory_data.items():
        e = {"trajectory_id": tid}
        if "gravity_constant" in td:
            e["gravity_constant"] = float(td["gravity_constant"])
            e["imu_calibration"] = _floats(td["imu_calibration"])
        if "fixed_frame_origin" in td:
            o_t, o_q = td["fixed_frame_origin"]
            e["fixed_frame_origin_t"] = _floats(o_t)
            e["fixed_frame_origin_q"] = _floats(o_q)
        entries.append(e)
    writer.write(packb({"type": "trajectory_data", "entries": entries}))


def _trajectory_mapper(pose_graph, trajectory_remapping):
    """-> (remap dict, map_traj): stream trajectory ids onto fresh ids after
    the graph's own, in order of first appearance."""
    remap: Dict[int, int] = dict(trajectory_remapping or {})
    used = set(pose_graph.nodes.trajectory_ids()) | set(pose_graph.submap_data.trajectory_ids())
    next_id = [(max(used) + 1) if used else 0]

    def map_traj(t: int) -> int:
        if t not in remap:
            remap[t] = next_id[0]
            next_id[0] += 1
        return remap[t]

    return remap, map_traj


def _link_intra_nodes(pose_graph) -> None:
    """Rebuild submap -> node membership from the INTRA constraints
    (map_builder.cc LoadState AddNodeToSubmap, :371-392)."""
    for c in pose_graph.constraints:
        if c.tag == "INTRA_SUBMAP":
            entry = pose_graph.submap_data.get(c.submap_id)
            if entry is not None:
                entry.node_ids.add(c.node_id)


def _load_state_3d(records, pose_graph, trajectory_remapping, frozen):
    device = pose_graph.device
    remap, map_traj = _trajectory_mapper(pose_graph, trajectory_remapping)
    pg_record = next(r for r in records if r["type"] == "pose_graph")
    submap_poses = {tuple(e["id"]): e for e in pg_record["submap_poses"]}
    node_poses = {tuple(e["id"]): e for e in pg_record["node_poses"]}
    for r in records:
        if r["type"] == "submap3d":
            t, i = r["id"]
            nt = map_traj(t)
            submap = Submap3D(
                local_pose_translation=np.asarray(r["local_pose_translation"]),
                local_pose_rotation=np.asarray(r["local_pose_rotation"]),
                num_range_data=r["num_range_data"],
                insertion_finished=r["finished"],
                high_grid=_un_grid3d(r["high_grid"], device) if "high_grid" in r else None,
                low_grid=_un_grid3d(r["low_grid"], device) if "low_grid" in r else None,
                histogram=_un_nd(r["histogram"]) if "histogram" in r else None)
            if "intensity_grid" in r:
                submap.intensity_grid = _un_intensity3d(r["intensity_grid"], device)
            sp = submap_poses[(t, i)]
            pose_graph.submap_data.insert(SubmapId(nt, i), SubmapDataEntry3D(
                submap=submap, global_t=np.asarray(sp["t"]), global_q=np.asarray(sp["q"]),
                finished=r["finished"]))
        elif r["type"] == "node3d":
            t, i = r["id"]
            nt = map_traj(t)
            npose = node_poses[(t, i)]
            pose_graph.nodes.insert(NodeId(nt, i), TrajectoryNode3D(
                time=r["time"],
                gravity_alignment=np.asarray(r["gravity_alignment"]),
                high_res_cloud=_dequantize_cloud(r["high_cloud"]),
                low_res_cloud=_dequantize_cloud(r["low_cloud"]),
                scan_histogram=_un_nd(r["histogram"]),
                local_pose_translation=np.asarray(r["local_pose_translation"]),
                local_pose_rotation=np.asarray(r["local_pose_rotation"]),
                global_t=np.asarray(npose["t"]),
                global_q=np.asarray(npose["q"])))
    for c in pg_record["constraints"]:
        st, si = c["submap_id"]
        nt, ni = c["node_id"]
        pose_graph.constraints.append(Constraint3D(
            submap_id=SubmapId(map_traj(st), si), node_id=NodeId(map_traj(nt), ni),
            rel_t=np.asarray(c["rel_t"]), rel_q=np.asarray(c["rel_q"]),
            translation_weight=c["translation_weight"],
            rotation_weight=c["rotation_weight"], tag=c["tag"]))
    _link_intra_nodes(pose_graph)
    for lid, p in pg_record.get("landmark_poses", {}).items():
        pose_graph.landmark_poses[lid] = np.asarray(p, np.float64)
    pose_graph._frozen_landmarks.update(pg_record.get("frozen_landmarks", []))
    td_record = next((r for r in records if r["type"] == "trajectory_data"), None)
    if td_record is not None:
        for e in td_record.get("entries", []):
            entry = {}
            if "gravity_constant" in e:
                entry["gravity_constant"] = e["gravity_constant"]
                entry["imu_calibration"] = np.asarray(e["imu_calibration"])
            if "fixed_frame_origin_t" in e:
                entry["fixed_frame_origin"] = (np.asarray(e["fixed_frame_origin_t"]),
                                               np.asarray(e["fixed_frame_origin_q"]))
            if entry:
                pose_graph.trajectory_data[map_traj(e.get("trajectory_id", 0))] = entry
    if frozen:
        for t in set(remap.values()):
            pose_graph.freeze_trajectory(t)
    return remap


def _migrate_v1(records: List[dict]) -> List[dict]:
    """v1 -> v2 (serialization_format_migration.cc): v1 lacked per-submap
    finished flags; default them."""
    for r in records:
        if r.get("type") == "submap":
            r.setdefault("finished", True)
    return records


def load_state(reader: ProtoStreamReader, pose_graph,
               trajectory_remapping: Optional[Dict[int, int]] = None,
               frozen: bool = False) -> Dict[int, int]:
    """MapBuilder::LoadState (map_builder.cc:227-395): submaps, nodes and
    constraints into `pose_graph` (grids on its device), the stream's
    trajectory ids remapped past the graph's own; optionally frozen.
    `reader` yields the raw records (a ProtoStreamReader or a list).
    Returns the trajectory id remapping used."""
    records = [unpackb(r) for r in reader]
    if not records or records[0].get("type") != "header":
        raise ValueError("missing serialization header")
    version = records[0]["format_version"]
    if version == 1:
        records = _migrate_v1(records)
    elif version != SERIALIZATION_FORMAT_VERSION:
        raise ValueError(f"unsupported format version {version}")
    if records[0].get("dim") == 3:
        return _load_state_3d(records, pose_graph, trajectory_remapping, frozen)

    device = pose_graph.device
    remap, map_traj = _trajectory_mapper(pose_graph, trajectory_remapping)
    pg_record = next(r for r in records if r["type"] == "pose_graph")
    submap_poses = {tuple(e["id"]): np.asarray(e["pose"]) for e in pg_record["submap_poses"]}
    node_poses = {tuple(e["id"]): np.asarray(e["pose"]) for e in pg_record["node_poses"]}
    for r in records:
        if r["type"] == "submap":
            t, i = r["id"]
            nt = map_traj(t)
            submap = Submap2D(
                local_pose_translation=np.asarray(r["local_pose_translation"]),
                local_pose_rotation=np.asarray(r["local_pose_rotation"]),
                num_range_data=r["num_range_data"],
                insertion_finished=r["finished"],
                grid=un_grid2d(r["grid"], device) if "grid" in r else None)
            pose_graph.submap_data.insert(SubmapId(nt, i), SubmapDataEntry(
                submap=submap, global_pose_2d=submap_poses[(t, i)], finished=r["finished"],
                frozen=frozen))
        elif r["type"] == "node":
            t, i = r["id"]
            nt = map_traj(t)
            pose_graph.nodes.insert(NodeId(nt, i), TrajectoryNode(
                time=r["time"],
                gravity_alignment=np.asarray(r["gravity_alignment"]),
                filtered_points=_dequantize_cloud(r["cloud"]),
                local_pose_translation=np.asarray(r["local_pose_translation"]),
                local_pose_rotation=np.asarray(r["local_pose_rotation"]),
                global_pose_2d=node_poses[(t, i)]))
    for c in pg_record["constraints"]:
        st, si = c["submap_id"]
        nt, ni = c["node_id"]
        pose_graph.constraints.append(Constraint(
            submap_id=SubmapId(map_traj(st), si), node_id=NodeId(map_traj(nt), ni),
            rel=np.asarray(c["rel"]), translation_weight=c["translation_weight"],
            rotation_weight=c["rotation_weight"], tag=c["tag"]))
    _link_intra_nodes(pose_graph)
    for lid, p in pg_record.get("landmark_poses", {}).items():
        pose_graph.landmark_poses[lid] = np.asarray(p, np.float64)
    pose_graph._frozen_landmarks.update(pg_record.get("frozen_landmarks", []))
    for tid_s, o in pg_record.get("fixed_frame_origins", {}).items():
        pose_graph.fixed_frame_origin[map_traj(int(tid_s))] = np.asarray(o, np.float64)
    if frozen:
        for t in set(remap.values()):
            pose_graph.freeze_trajectory(t)
    return remap
