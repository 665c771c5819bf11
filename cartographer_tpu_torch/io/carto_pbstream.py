"""Reference-compatible `.pbstream` state serialization.

Counterpart of the JAX package's `io/carto_pbstream.py`. Writes and reads the reference's actual proto payloads (schema:
io/carto_protos.py, stream order: io/internal/mapping_state_serialization.cc
— SerializationHeader{format_version=2}, PoseGraph,
AllTrajectoryBuilderOptions, Submap*, Node*, TrajectoryData*, sensor data)
over the existing byte-compatible container framing (io/pbstream.py). A map
produced by the C++ reference loads here and vice versa.

Grid semantics (mapping/2d/map_limits.h:69-81, grid_2d.h:113-116): the
reference indexes 2D grids from the MAX corner — cell (rx, ry) with
rx = S-1-j (our y index) and ry = S-1-i (our x index), flattened
num_x_cells * ry + rx — i.e. our array reversed along both axes then
transposed. Cell values are uint16 correspondence costs in [1, 32767] over
[0.1, 0.9] (probability_values.h:30-95); 0 = unknown. Our f32 log-odds
convert through probability.

3D hybrid grids serialize sparse (x, y, z, value) lists of PROBABILITY
values; the reference's cells sit at centers index*resolution while ours
sit at origin + (i+0.5)*resolution, so export shifts by the nearest whole
cell (sub-half-cell placement error, comparable to the f16 native format's
quantization).

Loaded grids go to the pose graph's device; the v1 migration rotates the
node histograms there (`ops/rot_histogram.py:rotate_histogram`, kernel K12's
rotation on a CUDA device).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from cartographer_tpu_torch.core.tensor import to_device
from cartographer_tpu_torch.io import carto_protos as cp
from cartographer_tpu_torch.io.pbstream import ProtoStreamReader, ProtoStreamWriter
from cartographer_tpu_torch.io.proto_wire import decode_message, encode_message
from cartographer_tpu_torch.mapping.constraint_builder_2d import Constraint
from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
from cartographer_tpu_torch.mapping.pose_graph_2d import SubmapDataEntry, TrajectoryNode
from cartographer_tpu_torch.mapping.pose_graph_3d import (
    Constraint3D,
    SubmapDataEntry3D,
    TrajectoryNode3D,
)
from cartographer_tpu_torch.mapping.submap_2d import Submap2D
from cartographer_tpu_torch.mapping.submap_3d import Submap3D
from cartographer_tpu_torch.ops.grid_2d import Grid2D
from cartographer_tpu_torch.ops.grid_3d import Grid3D
from cartographer_tpu_torch.ops.rot_histogram import rotate_histogram
from cartographer_tpu_torch.sensor.compression import (
    from_carto_point_data,
    to_carto_point_data,
)
from cartographer_tpu_torch.transform import nquat

CARTO_FORMAT_VERSION = 2

_MIN_COST = 0.1
_MAX_COST = 0.9


# --------------------------------------------------------------- primitives

def _rigid3d(t, q) -> dict:
    t = np.asarray(t, np.float64)
    q = np.asarray(q, np.float64)
    return {"translation": {"x": float(t[0]), "y": float(t[1]),
                            "z": float(t[2]) if len(t) > 2 else 0.0},
            "rotation": {"w": float(q[0]), "x": float(q[1]),
                         "y": float(q[2]), "z": float(q[3])}}


def _rigid3d_2d(pose2d) -> dict:
    q = nquat.from_yaw(float(pose2d[2]))
    return _rigid3d(np.array([pose2d[0], pose2d[1], 0.0]), q)


def _un_rigid3d(msg) -> tuple:
    tr = msg.get("translation", {})
    ro = msg.get("rotation", {})
    t = np.array([tr.get("x", 0.0), tr.get("y", 0.0), tr.get("z", 0.0)])
    q = np.array([ro.get("w", 0.0), ro.get("x", 0.0), ro.get("y", 0.0),
                  ro.get("z", 0.0)])
    if not np.any(q):
        q = np.array([1.0, 0, 0, 0])
    return t, q


def _un_rigid3d_2d(msg) -> np.ndarray:
    t, q = _un_rigid3d(msg)
    return np.array([t[0], t[1], nquat.get_yaw(q)])


def _compress(points: np.ndarray, dim: int) -> dict:
    pts = np.asarray(points, np.float64).reshape(-1, dim)
    if dim == 2:
        pts = np.concatenate([pts, np.zeros((len(pts), 1))], axis=1)
    data = to_carto_point_data(pts)
    return {"num_points": int(len(pts)), "point_data": data.tolist()}


def _decompress(msg, dim: int) -> np.ndarray:
    n = msg.get("num_points", 0)
    pts = from_carto_point_data(n, msg.get("point_data", []))
    return pts[:, :dim]


# ----------------------------------------------------------------- 2D grids

def _host(t) -> np.ndarray:
    """A device tensor (or array) as numpy."""
    return t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)


def _grid2d_to_proto(grid) -> dict:
    """Our Grid2D -> reference proto::Grid2D dict."""
    log_odds = _host(grid.log_odds)
    known = _host(grid.known)
    S0, S1 = log_odds.shape
    p = 1.0 / (1.0 + np.exp(-log_odds))  # probability
    cost = np.clip(1.0 - p, _MIN_COST, _MAX_COST)
    values = (np.round((cost - _MIN_COST) * (32766.0 / (_MAX_COST - _MIN_COST)))
              .astype(np.int32) + 1)
    values = np.where(known, values, 0)
    # Our (i=x asc, j=y asc) -> reference (ry=S0-1-i rows, rx=S1-1-j cols),
    # flat = num_x * ry + rx: reverse both axes, x-major rows.
    ref = values[::-1, ::-1]  # ref[ry, rx]
    origin = np.asarray(_host(grid.origin), np.float64)
    res = float(grid.resolution)
    max_xy = origin + np.array([S0, S1]) * res
    out = {
        "limits": {"resolution": res,
                   "max": {"x": float(max_xy[0]), "y": float(max_xy[1])},
                   "cell_limits": {"num_x_cells": int(S1),
                                   "num_y_cells": int(S0)}},
        "cells": ref.reshape(-1).tolist(),
        "probability_grid_2d": {},
        "min_correspondence_cost": _MIN_COST,
        "max_correspondence_cost": _MAX_COST,
    }
    if known.any():
        ii, jj = np.nonzero(known)
        rx = S1 - 1 - jj
        ry = S0 - 1 - ii
        out["known_cells_box"] = {
            "min_x": int(rx.min()), "max_x": int(rx.max()),
            "min_y": int(ry.min()), "max_y": int(ry.max())}
    return out


def _grid2d_from_proto(msg, device):
    """Reference proto::Grid2D dict -> our Grid2D on `device`."""
    limits = msg["limits"]
    res = float(limits["resolution"])
    num_x = int(limits["cell_limits"]["num_x_cells"])
    num_y = int(limits["cell_limits"]["num_y_cells"])
    max_x = float(limits["max"].get("x", 0.0))
    max_y = float(limits["max"].get("y", 0.0))
    cells = np.asarray(msg.get("cells", []), np.int64).reshape(num_y, num_x)
    ours = cells[::-1, ::-1]  # -> (i=x asc, j=y asc)
    known = ours != 0
    cost = _MIN_COST + (np.maximum(ours, 1) - 1) * (
        (_MAX_COST - _MIN_COST) / 32766.0)
    p = np.clip(1.0 - cost, 1e-4, 1 - 1e-4)
    log_odds = np.where(known, np.log(p / (1.0 - p)), 0.0).astype(np.float32)
    # max corner maps to origin + (num_y, num_x)*res in our frame: our x
    # count = num_y_cells.
    origin = np.array([max_x - num_y * res, max_y - num_x * res], np.float32)
    return Grid2D(log_odds=to_device(log_odds, device), known=to_device(known, device),
                  origin=to_device(origin, device), resolution=res)


# ----------------------------------------------------------------- 3D grids

def _grid3d_to_proto(grid) -> dict:
    log_odds = _host(grid.log_odds)
    known = _host(grid.known)
    res = float(grid.resolution)
    origin = np.asarray(_host(grid.origin), np.float64)
    shift = np.round(origin / res + 0.5).astype(np.int64)  # our i -> ref idx
    ii, jj, kk = np.nonzero(known)
    p = 1.0 / (1.0 + np.exp(-log_odds[ii, jj, kk]))
    values = (np.round((np.clip(p, _MIN_COST, _MAX_COST) - _MIN_COST)
                       * (32766.0 / (_MAX_COST - _MIN_COST))).astype(np.int32)
              + 1)
    return {
        "resolution": res,
        "x_indices": (ii + shift[0]).tolist(),
        "y_indices": (jj + shift[1]).tolist(),
        "z_indices": (kk + shift[2]).tolist(),
        "values": values.tolist(),
    }


def _grid3d_from_proto(msg, device, size: int = 256):
    res = float(msg.get("resolution", 0.1))
    xs = np.asarray(msg.get("x_indices", []), np.int64)
    ys = np.asarray(msg.get("y_indices", []), np.int64)
    zs = np.asarray(msg.get("z_indices", []), np.int64)
    vals = np.asarray(msg.get("values", []), np.int64)
    if len(xs) == 0:
        return Grid3D.create(size, res, np.zeros(3, np.float32), device)
    lo = np.array([xs.min(), ys.min(), zs.min()])
    hi = np.array([xs.max(), ys.max(), zs.max()])
    span = int((hi - lo).max()) + 1
    size = max(size, 1 << int(np.ceil(np.log2(max(span, 2)))))
    center_idx = (lo + hi) // 2
    start = center_idx - size // 2
    origin = (start.astype(np.float64) - 0.5) * res
    i = xs - start[0]
    j = ys - start[1]
    k = zs - start[2]
    ok = ((i >= 0) & (i < size) & (j >= 0) & (j < size)
          & (k >= 0) & (k < size))
    p = _MIN_COST + (np.maximum(vals, 1) - 1) * ((_MAX_COST - _MIN_COST) / 32766.0)
    p = np.clip(p, 1e-4, 1 - 1e-4)
    lo_arr = np.zeros((size, size, size), np.float32)
    known = np.zeros((size, size, size), bool)
    lo_arr[i[ok], j[ok], k[ok]] = np.log(p / (1 - p))[ok].astype(np.float32)
    known[i[ok], j[ok], k[ok]] = True
    return Grid3D(log_odds=to_device(lo_arr, device), known=to_device(known, device),
                  origin=to_device(np.asarray(origin, np.float32), device), resolution=res)


# ------------------------------------------------------------------- writer

def _pack_serialized(field: str, msg: dict) -> bytes:
    return encode_message(cp.SERIALIZED_DATA, {field: msg})


def write_carto_state(pose_graph, writer: ProtoStreamWriter,
                      include_unfinished_submaps: bool = True) -> None:
    """Serialize a PoseGraph2D/3D in the reference's pbstream schema."""
    is_3d = hasattr(pose_graph, "trajectory_data")

    writer.write(encode_message(cp.SERIALIZATION_HEADER,
                                {"format_version": CARTO_FORMAT_VERSION}))

    # PoseGraph: constraints + per-trajectory node/submap global poses.
    constraints = []
    for c in pose_graph.constraints:
        if is_3d:
            rel = _rigid3d(c.rel_t, c.rel_q)
        else:
            rel = _rigid3d_2d(c.rel)
        constraints.append({
            "submap_id": {"trajectory_id": c.submap_id.trajectory_id,
                          "submap_index": c.submap_id.submap_index},
            "node_id": {"trajectory_id": c.node_id.trajectory_id,
                        "node_index": c.node_id.node_index},
            "relative_pose": rel,
            "translation_weight": float(c.translation_weight),
            "rotation_weight": float(c.rotation_weight),
            "tag": 1 if c.tag == "INTER_SUBMAP" else 0,
        })
    trajectories: Dict[int, dict] = {}
    for (t, i), entry in pose_graph.submap_data.items():
        traj = trajectories.setdefault(t, {"trajectory_id": t, "node": [],
                                           "submap": []})
        pose = (_rigid3d(entry.global_t, entry.global_q) if is_3d
                else _rigid3d_2d(entry.global_pose_2d))
        traj["submap"].append({"submap_index": i, "pose": pose})
    for (t, i), node in pose_graph.nodes.items():
        traj = trajectories.setdefault(t, {"trajectory_id": t, "node": [],
                                           "submap": []})
        pose = (_rigid3d(node.global_t, node.global_q) if is_3d
                else _rigid3d_2d(node.global_pose_2d))
        traj["node"].append({"node_index": i, "timestamp": int(node.time),
                             "pose": pose})
    pg_msg = {"constraint": constraints,
              "trajectory": [trajectories[t] for t in sorted(trajectories)]}
    if getattr(pose_graph, "landmark_poses", None):
        pg_msg["landmark_poses"] = [
            {"landmark_id": lid,
             "global_pose": _rigid3d_2d(p) if len(np.atleast_1d(p)) == 3
             else _rigid3d(p[:3], p[3:])}
            for lid, p in pose_graph.landmark_poses.items()]
    writer.write(_pack_serialized("pose_graph", pg_msg))

    # AllTrajectoryBuilderOptions: one (empty) entry per trajectory, as the
    # reference deserializer checks the count.
    writer.write(_pack_serialized("all_trajectory_builder_options", {
        "options_with_sensor_ids": [
            {"trajectory_builder_options": {}} for _ in sorted(trajectories)]}))

    for (t, i), entry in pose_graph.submap_data.items():
        submap = entry.submap
        sid = {"trajectory_id": t, "submap_index": i}
        if is_3d:
            if submap.high_grid is None and not include_unfinished_submaps:
                continue
            body = {"local_pose": _rigid3d(submap.local_pose_translation,
                                           submap.local_pose_rotation),
                    "num_range_data": submap.num_range_data,
                    "finished": submap.insertion_finished}
            if submap.high_grid is not None:
                body["high_resolution_hybrid_grid"] = _grid3d_to_proto(
                    submap.high_grid)
                body["low_resolution_hybrid_grid"] = _grid3d_to_proto(
                    submap.low_grid)
                if submap.histogram is not None:
                    body["rotational_scan_matcher_histogram"] = [
                        float(x) for x in np.asarray(submap.histogram)]
            writer.write(_pack_serialized(
                "submap", {"submap_id": sid, "submap_3d": body}))
        else:
            if submap.grid is None and not include_unfinished_submaps:
                continue
            body = {"local_pose": _rigid3d(submap.local_pose_translation,
                                           submap.local_pose_rotation),
                    "num_range_data": submap.num_range_data,
                    "finished": submap.insertion_finished}
            if submap.grid is not None:
                body["grid"] = _grid2d_to_proto(submap.grid)
            writer.write(_pack_serialized(
                "submap", {"submap_id": sid, "submap_2d": body}))

    for (t, i), node in pose_graph.nodes.items():
        nid = {"trajectory_id": t, "node_index": i}
        data = {"timestamp": int(node.time),
                "gravity_alignment": {
                    "w": float(node.gravity_alignment[0]),
                    "x": float(node.gravity_alignment[1]),
                    "y": float(node.gravity_alignment[2]),
                    "z": float(node.gravity_alignment[3])},
                "local_pose": _rigid3d(node.local_pose_translation,
                                       node.local_pose_rotation)}
        if is_3d:
            data["high_resolution_point_cloud"] = _compress(
                node.high_res_cloud, 3)
            data["low_resolution_point_cloud"] = _compress(
                node.low_res_cloud, 3)
            if node.scan_histogram is not None:
                data["rotational_scan_matcher_histogram"] = [
                    float(x) for x in np.asarray(node.scan_histogram)]
        else:
            data["filtered_gravity_aligned_point_cloud"] = _compress(
                node.filtered_points, 2)
        writer.write(_pack_serialized("node", {"node_id": nid,
                                               "node_data": data}))

    if is_3d:
        for tid, td in pose_graph.trajectory_data.items():
            calib = np.asarray(
                td.get("imu_calibration", [1.0, 0, 0, 0]), np.float64)
            msg = {
                "trajectory_id": tid,
                "gravity_constant": float(td.get("gravity_constant", 9.8)),
                "imu_calibration": {"w": float(calib[0]), "x": float(calib[1]),
                                    "y": float(calib[2]), "z": float(calib[3])},
            }
            if "fixed_frame_origin" in td:
                o_t, o_q = td["fixed_frame_origin"]
                msg["fixed_frame_origin_in_map"] = _rigid3d(o_t, o_q)
            writer.write(_pack_serialized("trajectory_data", msg))


# ------------------------------------------------------------------- reader

def is_carto_stream(first_record: bytes) -> bool:
    """SerializationHeader (proto: tag 0x08 varint) vs our msgpack header
    (fixmap 0x80-0x8f first byte)."""
    if not first_record:
        return False
    if first_record[0] == 0x08:
        try:
            msg = decode_message(cp.SERIALIZATION_HEADER, first_record)
            return 0 < msg.get("format_version", 0) <= 4
        except Exception:  # noqa: BLE001
            return False
    return False


def load_carto_state(reader: ProtoStreamReader, pose_graph,
                     trajectory_remapping: Optional[Dict[int, int]] = None,
                     frozen: bool = False) -> Dict[int, int]:
    """MapBuilder::LoadState over a reference-schema pbstream."""
    records: List[bytes] = list(reader)
    header = decode_message(cp.SERIALIZATION_HEADER, records[0])
    version = header.get("format_version", 0)
    if version not in (1, 2):
        raise ValueError(f"unsupported pbstream format version {version}")

    payloads = [decode_message(cp.SERIALIZED_DATA, r) for r in records[1:]]
    pg_msg = next(p["pose_graph"] for p in payloads if "pose_graph" in p)

    is_3d = hasattr(pose_graph, "trajectory_data")
    device = pose_graph.device
    remap: Dict[int, int] = dict(trajectory_remapping or {})
    used = set(pose_graph.nodes.trajectory_ids()) | set(
        pose_graph.submap_data.trajectory_ids())
    next_id = (max(used) + 1) if used else 0

    def map_traj(t: int) -> int:
        nonlocal next_id
        if t not in remap:
            remap[t] = next_id
            next_id += 1
        return remap[t]

    submap_poses = {}
    node_poses = {}
    node_times = {}
    for traj in pg_msg.get("trajectory", []):
        t = traj.get("trajectory_id", 0)
        for s in traj.get("submap", []):
            submap_poses[(t, s.get("submap_index", 0))] = _un_rigid3d(
                s.get("pose", {}))
        for n in traj.get("node", []):
            node_poses[(t, n.get("node_index", 0))] = _un_rigid3d(
                n.get("pose", {}))
            node_times[(t, n.get("node_index", 0))] = n.get("timestamp", 0)

    for p in payloads:
        if "submap" in p:
            sm = p["submap"]
            sid = sm.get("submap_id", {})
            t = sid.get("trajectory_id", 0)
            i = sid.get("submap_index", 0)
            nt = map_traj(t)
            gp = submap_poses.get((t, i), (np.zeros(3), np.array([1.0, 0, 0, 0])))
            if is_3d and "submap_3d" in sm:
                body = sm["submap_3d"]
                lt, lq = _un_rigid3d(body.get("local_pose", {}))
                high = (None if "high_resolution_hybrid_grid" not in body
                        else _grid3d_from_proto(body["high_resolution_hybrid_grid"], device))
                low = (None if "low_resolution_hybrid_grid" not in body
                       else _grid3d_from_proto(body["low_resolution_hybrid_grid"], device))
                hist = np.asarray(
                    body.get("rotational_scan_matcher_histogram", []),
                    np.float32)
                submap = Submap3D(
                    local_pose_translation=lt, local_pose_rotation=lq,
                    num_range_data=body.get("num_range_data", 0),
                    insertion_finished=body.get("finished", version == 1),
                    high_grid=high, low_grid=low,
                    histogram=hist if len(hist) else None)
                pose_graph.submap_data.insert(SubmapId(nt, i), SubmapDataEntry3D(
                    submap=submap, global_t=gp[0], global_q=gp[1],
                    finished=body.get("finished", version == 1)))
            elif not is_3d and "submap_2d" in sm:
                body = sm["submap_2d"]
                lt, lq = _un_rigid3d(body.get("local_pose", {}))
                grid = (_grid2d_from_proto(body["grid"], device)
                        if "grid" in body else None)
                submap = Submap2D(
                    local_pose_translation=lt, local_pose_rotation=lq,
                    num_range_data=body.get("num_range_data", 0),
                    insertion_finished=body.get("finished", version == 1),
                    grid=grid)
                gp2d = np.array([gp[0][0], gp[0][1], nquat.get_yaw(gp[1])])
                pose_graph.submap_data.insert(SubmapId(nt, i), SubmapDataEntry(
                    submap=submap, global_pose_2d=gp2d,
                    finished=body.get("finished", version == 1),
                    frozen=frozen))
        elif "node" in p:
            nd = p["node"]
            nid = nd.get("node_id", {})
            t = nid.get("trajectory_id", 0)
            i = nid.get("node_index", 0)
            nt = map_traj(t)
            data = nd.get("node_data", {})
            ga = data.get("gravity_alignment", {})
            gravity = np.array([ga.get("w", 1.0), ga.get("x", 0.0),
                                ga.get("y", 0.0), ga.get("z", 0.0)])
            lt, lq = _un_rigid3d(data.get("local_pose", {}))
            gp = node_poses.get((t, i), (np.zeros(3), np.array([1.0, 0, 0, 0])))
            if is_3d:
                pose_graph.nodes.insert(NodeId(nt, i), TrajectoryNode3D(
                    time=data.get("timestamp", 0),
                    gravity_alignment=gravity,
                    high_res_cloud=_decompress(
                        data.get("high_resolution_point_cloud", {}), 3),
                    low_res_cloud=_decompress(
                        data.get("low_resolution_point_cloud", {}), 3),
                    scan_histogram=np.asarray(
                        data.get("rotational_scan_matcher_histogram", []),
                        np.float32),
                    local_pose_translation=lt, local_pose_rotation=lq,
                    global_t=gp[0], global_q=gp[1]))
            else:
                gp2d = np.array([gp[0][0], gp[0][1], nquat.get_yaw(gp[1])])
                pose_graph.nodes.insert(NodeId(nt, i), TrajectoryNode(
                    time=data.get("timestamp", 0),
                    gravity_alignment=gravity,
                    filtered_points=_decompress(
                        data.get("filtered_gravity_aligned_point_cloud", {}),
                        2),
                    local_pose_translation=lt, local_pose_rotation=lq,
                    global_pose_2d=gp2d))
        elif "trajectory_data" in p and is_3d:
            td = p["trajectory_data"]
            calib = td.get("imu_calibration", {})
            entry = {
                "gravity_constant": td.get("gravity_constant", 9.8),
                "imu_calibration": np.array([
                    calib.get("w", 1.0), calib.get("x", 0.0),
                    calib.get("y", 0.0), calib.get("z", 0.0)]),
            }
            if "fixed_frame_origin_in_map" in td:
                entry["fixed_frame_origin"] = _un_rigid3d(
                    td["fixed_frame_origin_in_map"])
            pose_graph.trajectory_data[map_traj(td.get("trajectory_id", 0))] = entry

    # Constraints last (both endpoints known).
    for c in pg_msg.get("constraint", []):
        sid = c.get("submap_id", {})
        nid = c.get("node_id", {})
        st = map_traj(sid.get("trajectory_id", 0))
        nt2 = map_traj(nid.get("trajectory_id", 0))
        tag = "INTER_SUBMAP" if c.get("tag", 0) == 1 else "INTRA_SUBMAP"
        rel_t, rel_q = _un_rigid3d(c.get("relative_pose", {}))
        if is_3d:
            pose_graph.constraints.append(Constraint3D(
                submap_id=SubmapId(st, sid.get("submap_index", 0)),
                node_id=NodeId(nt2, nid.get("node_index", 0)),
                rel_t=rel_t, rel_q=rel_q,
                translation_weight=c.get("translation_weight", 0.0),
                rotation_weight=c.get("rotation_weight", 0.0), tag=tag))
        else:
            rel = np.array([rel_t[0], rel_t[1], nquat.get_yaw(rel_q)])
            pose_graph.constraints.append(Constraint(
                submap_id=SubmapId(st, sid.get("submap_index", 0)),
                node_id=NodeId(nt2, nid.get("node_index", 0)),
                rel=rel,
                translation_weight=c.get("translation_weight", 0.0),
                rotation_weight=c.get("rotation_weight", 0.0), tag=tag))

    # Rebuild submap->node membership from INTRA constraints
    # (map_builder.cc LoadState AddNodeToSubmap, :371-392).
    for c in pose_graph.constraints:
        if c.tag == "INTRA_SUBMAP":
            entry = pose_graph.submap_data.get(c.submap_id)
            if entry is not None:
                entry.node_ids.add(c.node_id)

    if version == 1 and is_3d:
        migrate_v1_submap_histograms(pose_graph)
    if frozen:
        for t in set(remap.values()):
            pose_graph.freeze_trajectory(t)
    return remap


def migrate_v1_submap_histograms(pose_graph) -> None:
    """Format-version 1 -> 2: v1 3D submaps carry no rotational histograms;
    rebuild them by rotating each INTRA-constrained node's gravity-frame
    histogram into the submap frame and accumulating
    (io/serialization_format_migration.cc MigrateSubmapFormatVersion1ToVersion2)."""
    device = pose_graph.device
    for c in pose_graph.constraints:
        if c.tag != "INTRA_SUBMAP":
            continue
        entry = pose_graph.submap_data.get(c.submap_id)
        node = pose_graph.nodes.get(c.node_id)
        if entry is None or node is None:
            continue
        hist = np.asarray(node.scan_histogram, np.float32)
        if hist.size == 0:
            continue
        submap = entry.submap
        # yaw of submap_local_pose^-1 * node_local_pose * gravity^-1.
        q = nquat.multiply(
            nquat.multiply(nquat.conjugate(submap.local_pose_rotation),
                           node.local_pose_rotation),
            nquat.conjugate(node.gravity_alignment))
        rotated = rotate_histogram(
            to_device(hist, device),
            torch.tensor(nquat.get_yaw(q), dtype=torch.float32, device=device)).cpu().numpy()
        if submap.histogram is None or len(np.asarray(submap.histogram)) == 0:
            submap.histogram = rotated.copy()
        else:
            submap.histogram = np.asarray(submap.histogram) + rotated
