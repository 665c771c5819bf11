"""3D global SLAM backend.

Counterpart of the JAX package's `mapping/pose_graph_3d.py`
(pose_graph_3d.cc, optimization_problem_3d.cc) on one device: node and
submap bookkeeping with SE(3) poses as (translation, quaternion) numpy
pairs, INTRA_SUBMAP constraints, loop-closure searches through
ConstraintBuilder3D (local window when recently connected, globally sampled
full-submap search otherwise), and the SE(3) Schur SPA (K16) every
`optimize_every_n_nodes` nodes over the submap-node constraints, the
consecutive local-SLAM chains (and odometry under `fix_z_in_3d`), the IMU
gyro and acceleration terms with a per-trajectory gravity and calibration
slot, and the fixed-frame fixes with a yaw-only origin per trajectory.

With `num_background_threads` > 0 the searches run on a thread pool and the
solves on one optimizer thread while the frontend keeps adding nodes;
pending pairs coalesce across nodes. The IMU integration starts its walk at
the first sample after the interval's start (a bisection), where the JAX
module walks the queue from its first sample, and keeps each interval's
result for later solves. A frozen trajectory (a loaded map) stays fixed in
every solve. Landmark poses are kept as state only, so that a saved map
passes through unchanged; landmark observations and the trimmers are not
ported and raise.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from cartographer_tpu_torch import metrics
from cartographer_tpu_torch.core.config import PoseGraphOptions
from cartographer_tpu_torch.core.sampler import FixedRatioSampler
from cartographer_tpu_torch.core.tensor import to_device
from cartographer_tpu_torch.core.time import Time, from_seconds
from cartographer_tpu_torch.mapping.connectivity import TrajectoryConnectivityState
from cartographer_tpu_torch.mapping.constraint_builder_3d import ConstraintBuilder3D
from cartographer_tpu_torch.mapping.id import MapById, NodeId, SubmapId
from cartographer_tpu_torch.mapping.pose_graph_2d import _interpolate_fixed_frame, _np_interpolate
from cartographer_tpu_torch.mapping.submap_3d import Submap3D
from cartographer_tpu_torch.parallel.schur_spa_3d import (
    WEIGHTS,
    SchurSpaProblem3D,
    solve_spa_3d_schur,
)
from cartographer_tpu_torch.sensor.map_by_time import MapByTime
from cartographer_tpu_torch.transform import nquat

_IDENTITY = np.array([1.0, 0.0, 0.0, 0.0])


@dataclasses.dataclass
class Constraint3D:
    submap_id: SubmapId
    node_id: NodeId
    rel_t: np.ndarray  # (3,)
    rel_q: np.ndarray  # (4,)
    translation_weight: float
    rotation_weight: float
    tag: str  # "INTRA_SUBMAP" | "INTER_SUBMAP"


@dataclasses.dataclass
class TrajectoryNode3D:
    time: Time
    gravity_alignment: np.ndarray
    high_res_cloud: np.ndarray  # (n, 3) tracking frame
    low_res_cloud: np.ndarray
    scan_histogram: np.ndarray
    local_pose_translation: np.ndarray
    local_pose_rotation: np.ndarray
    global_t: np.ndarray = None
    global_q: np.ndarray = None


@dataclasses.dataclass
class SubmapDataEntry3D:
    submap: Submap3D
    global_t: np.ndarray
    global_q: np.ndarray
    node_ids: Set[NodeId] = dataclasses.field(default_factory=set)
    finished: bool = False


def _compose(ta, qa, tb, qb):
    return ta + nquat.rotate(qa, tb), nquat.normalize(nquat.multiply(qa, qb))


def _inverse(t, q):
    iq = nquat.conjugate(q)
    return nquat.rotate(iq, -t), iq


class PoseGraph3D:
    # Pairs per coalesced search call of the background drain.
    _DRAIN_SLURP = 128

    def __init__(self, options: PoseGraphOptions, num_background_threads: int = 0,
                 device="cuda"):
        self._options = options
        self._device = torch.device(device)
        self._constraint_builder = ConstraintBuilder3D(options.constraint_builder, device)
        self._executor = None
        self._optimizer_executor = None
        self._optimization_future = None
        self._pending_futures: List = []
        self._pending_pairs: List = []
        self._drain_active = False
        self._result_lock = threading.Lock()
        self._futures_lock = threading.Lock()
        if num_background_threads > 0:
            self._executor = ThreadPoolExecutor(max_workers=num_background_threads,
                                                thread_name_prefix="constraint3d")
            self._optimizer_executor = ThreadPoolExecutor(max_workers=1,
                                                          thread_name_prefix="optimizer3d")
        factory = metrics.GLOBAL_FACTORY
        counts = factory.new_counter_family("mapping_3d_pose_graph_constraints",
                                            "Constraints added to the 3D pose graph")
        self._metric_intra = counts.add({"tag": "intra_submap"})
        self._metric_inter = counts.add({"tag": "inter_submap"})
        self._metric_optimizations = factory.new_counter_family(
            "mapping_3d_pose_graph_optimizations", "3D pose graph optimization runs").add({})
        self._metric_pending = factory.new_gauge_family(
            "mapping_3d_pose_graph_work_queue_depth",
            "Pending background constraint searches").add({})
        self._global_samplers: Dict[int, FixedRatioSampler] = {}
        self.nodes: MapById[TrajectoryNode3D] = MapById()
        self.submap_data: MapById[SubmapDataEntry3D] = MapById()
        self.constraints: List[Constraint3D] = []
        self._num_nodes_since_last_optimization = 0
        self._frozen_trajectories: Set[int] = set()
        self._connectivity = TrajectoryConnectivityState()
        self._imu_data = MapByTime()
        self._imu_integrals: Dict = {}  # (trajectory, t_start, t_end) -> integral
        self._odometry_data = MapByTime()
        self._fixed_frame_data = MapByTime()
        # Per-trajectory learned variables (OptimizationProblem3D
        # TrajectoryData): gravity constant, IMU calibration quaternion and
        # fixed-frame origin, carried across optimizations.
        self.trajectory_data: Dict[int, Dict] = {}
        # Landmark poses [t (3) | q (4)] and the frozen ones, carried by
        # saved maps (no observation adds to them here).
        self.landmark_poses: Dict[str, np.ndarray] = {}
        self._frozen_landmarks: Set[str] = set()
        # PoseGraphInterface::TrajectoryState (ACTIVE/FINISHED/FROZEN).
        self.trajectory_states: Dict[int, str] = {}
        # Solves run, their wall seconds (snapshot, upload, solve, fetch) and
        # the host seconds of their problem snapshots.
        self.solves = 0
        self.solve_seconds = 0.0
        self.snapshot_seconds = 0.0

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def constraint_builder(self) -> ConstraintBuilder3D:
        return self._constraint_builder

    # ---------------------------------------------------------- sensor intake

    def add_imu_data(self, trajectory_id: int, imu_data) -> None:
        try:
            self._imu_data.append(trajectory_id, imu_data.time, imu_data)
        except ValueError:
            pass  # duplicate or out-of-order IMU times are dropped

    def add_odometry_data(self, trajectory_id: int, odometry_data) -> None:
        try:
            self._odometry_data.append(trajectory_id, odometry_data.time, odometry_data)
        except ValueError:
            pass

    def add_fixed_frame_pose_data(self, trajectory_id: int, data) -> None:
        if data.pose_translation is None:
            return  # an invalid fix
        with self._result_lock:
            self._fixed_frame_data.append(trajectory_id, data.time, data)

    def add_landmark_data(self, trajectory_id: int, data) -> None:
        raise NotImplementedError("landmarks are not ported")

    def add_trimmer(self, trimmer) -> None:
        raise NotImplementedError("pose-graph trimmers are not ported")

    def trim_submap(self, submap_id: SubmapId) -> None:
        raise NotImplementedError("pose-graph trimmers are not ported")

    def _odometry_poses_at_3d(self, trajectory_id: int, times):
        """Interpolated odometry poses (t, q) at the sorted node times; None
        where the odometry does not bracket the time
        (optimization_problem_3d.cc:608)."""
        traj = self._odometry_data.trajectory(trajectory_id)
        out = [None] * len(times)
        if len(traj) < 2:
            return out
        tlist = [e[0] for e in traj]
        for k, t in enumerate(times):
            if t < tlist[0] or t > tlist[-1]:
                continue
            i = int(np.searchsorted(tlist, t))
            if tlist[i] == t or i == 0:
                d = traj[min(i, len(traj) - 1)][1]
                out[k] = (np.asarray(d.pose_translation, np.float64),
                          np.asarray(d.pose_rotation, np.float64))
                continue
            f = (t - tlist[i - 1]) / (tlist[i] - tlist[i - 1])
            a, b = traj[i - 1][1], traj[i][1]
            out[k] = _np_interpolate(
                np.asarray(a.pose_translation, np.float64), np.asarray(a.pose_rotation, np.float64),
                np.asarray(b.pose_translation, np.float64), np.asarray(b.pose_rotation, np.float64),
                f)
        return out

    def _integrate_imu(self, trajectory_id: int, t_start, t_end):
        """Gyro and accelerometer integrated over [t_start, t_end]: (delta_q,
        delta_v in the t_start body frame, dt seconds), or None without IMU
        coverage (imu_integration.h). The walk starts at the first sample at
        or after t_start; earlier ones contribute nothing. Once the IMU
        covers an interval its samples there are final (times only grow), so
        results are kept for later solves."""
        key = (trajectory_id, t_start, t_end)
        cached = self._imu_integrals.get(key)
        if cached is not None:
            return cached
        traj = self._imu_data.trajectory(trajectory_id)
        if len(traj) < 2 or traj[0][0] > t_start or traj[-1][0] < t_end:
            return None
        q = _IDENTITY.copy()
        v = np.zeros(3)
        prev_t = t_start
        for k in range(self._imu_data.lower_bound(trajectory_id, t_start), len(traj)):
            time_, sample = traj[k]
            if time_ <= t_start:
                continue
            t = min(time_, t_end)
            dt = (t - prev_t) * 1e-6
            if dt > 0:
                v = v + nquat.rotate(q, sample.linear_acceleration) * dt
                q = nquat.normalize(nquat.multiply(
                    q, nquat.from_axis_angle(sample.angular_velocity * dt)))
            prev_t = t
            if time_ >= t_end:
                break
        self._imu_integrals[key] = (q, v, (t_end - t_start) * 1e-6)
        return self._imu_integrals[key]

    # ---------------------------------------------------------- connectivity

    def transitively_connected(self, a: int, b: int) -> bool:
        return self._connectivity.transitively_connected(a, b)

    def _global_sampler_for(self, trajectory_id: int) -> FixedRatioSampler:
        if trajectory_id not in self._global_samplers:
            self._global_samplers[trajectory_id] = FixedRatioSampler(
                self._options.global_sampling_ratio)
        return self._global_samplers[trajectory_id]

    # ---------------------------------------------------------- node intake

    def add_node(self, trajectory_id: int, node: TrajectoryNode3D,
                 insertion_submaps: List[Submap3D], finished_submaps: List[Submap3D]) -> NodeId:
        """PoseGraph3D::AddNode + ComputeConstraintsForNode."""
        with self._result_lock:
            self._connectivity.add(trajectory_id)
            self.trajectory_states.setdefault(trajectory_id, "ACTIVE")
            node_id = NodeId(trajectory_id, self.nodes.append(trajectory_id, node))
            submap_ids = self._register_insertion_submaps(trajectory_id, insertion_submaps)
            for sid in submap_ids:
                self.submap_data[sid].node_ids.add(node_id)
            first = self.submap_data[submap_ids[0]]
            rel_t = node.local_pose_translation - first.submap.local_pose_translation
            node.global_t, node.global_q = _compose(first.global_t, first.global_q, rel_t,
                                                    node.local_pose_rotation)
            for sid in submap_ids:
                entry = self.submap_data[sid]
                self.constraints.append(Constraint3D(
                    submap_id=sid, node_id=node_id,
                    rel_t=node.local_pose_translation - entry.submap.local_pose_translation,
                    rel_q=np.array(node.local_pose_rotation, np.float64),
                    translation_weight=self._options.matcher_translation_weight,
                    rotation_weight=self._options.matcher_rotation_weight,
                    tag="INTRA_SUBMAP"))
                self._metric_intra.increment()
            newly_finished: List[SubmapId] = []
            for submap in finished_submaps:
                for (tid, sindex), entry in self.submap_data.items():
                    if entry.submap is submap and not entry.finished:
                        entry.finished = True
                        newly_finished.append(SubmapId(tid, sindex))
            # This node against every finished submap, every older node
            # against the newly finished ones.
            pairs = [(node_id, SubmapId(tid, sindex))
                     for (tid, sindex), entry in self.submap_data.items()
                     if entry.finished and node_id not in entry.node_ids]
            for sid in newly_finished:
                entry = self.submap_data[sid]
                pairs += [(NodeId(tid, nindex), sid) for (tid, nindex), _ in self.nodes.items()
                          if NodeId(tid, nindex) not in entry.node_ids]
        self._schedule_constraints(pairs)
        self._num_nodes_since_last_optimization += 1
        if (self._options.optimize_every_n_nodes > 0
                and self._num_nodes_since_last_optimization
                >= self._options.optimize_every_n_nodes):
            self._schedule_optimization()
        return node_id

    def _register_insertion_submaps(self, trajectory_id: int,
                                    insertion_submaps: List[Submap3D]) -> List[SubmapId]:
        """Match submap objects to graph entries, appending new ones; a new
        submap's global pose is the last one's moved by the difference of
        their local anchors (submaps are yaw-anchored at identity)."""
        existing = {id(e.submap): SubmapId(t, i)
                    for (t, i), e in self.submap_data.items() if t == trajectory_id}
        ids = []
        for submap in insertion_submaps:
            if id(submap) in existing:
                ids.append(existing[id(submap)])
                continue
            anchor_t = np.asarray(submap.local_pose_translation, float)
            if self.submap_data.size_of_trajectory(trajectory_id) == 0:
                g_t, g_q = anchor_t.copy(), _IDENTITY.copy()
            else:
                last = self.submap_data[SubmapId(
                    trajectory_id, self.submap_data.last_index_of_trajectory(trajectory_id))]
                d_t = anchor_t - np.asarray(last.submap.local_pose_translation, float)
                g_t, g_q = _compose(last.global_t, last.global_q, d_t, _IDENTITY)
            index = self.submap_data.append(
                trajectory_id, SubmapDataEntry3D(submap=submap, global_t=g_t, global_q=g_q))
            ids.append(SubmapId(trajectory_id, index))
        return ids

    # ---------------------------------------------------------- loop closure

    def _schedule_constraints(self, pairs) -> None:
        """Search (node, submap) pairs inline, or queue them for the
        background drain, which takes everything queued in large calls."""
        if not pairs:
            return
        if self._executor is None:
            self._compute_constraints_batch(pairs)
            return
        with self._futures_lock:
            self._pending_pairs.extend(pairs)
            if not self._drain_active:
                self._drain_active = True
                self._pending_futures.append(self._executor.submit(self._drain_pending_pairs))
            self._metric_pending.set(len(self._pending_pairs))

    def _drain_pending_pairs(self) -> None:
        while True:
            with self._futures_lock:
                chunk = self._pending_pairs[:self._DRAIN_SLURP]
                self._pending_pairs = self._pending_pairs[self._DRAIN_SLURP:]
                if not chunk:
                    self._drain_active = False
                    return
                self._metric_pending.set(len(self._pending_pairs))
            self._compute_constraints_batch(chunk)

    def wait_for_all_computations(self) -> None:
        while True:
            with self._futures_lock:
                futures, self._pending_futures = self._pending_futures, []
            if not futures:
                break
            for f in futures:
                f.result()

    def _schedule_optimization(self) -> None:
        if self._optimizer_executor is None:
            self.run_optimization()
            return
        if self._optimization_future is not None and not self._optimization_future.done():
            return  # one solve at a time; the next cadence triggers again
        self._num_nodes_since_last_optimization = 0
        self._optimization_future = self._optimizer_executor.submit(self.run_optimization)

    def wait_for_optimization(self) -> None:
        future, self._optimization_future = self._optimization_future, None
        if future is not None:
            future.result()

    def _compute_constraints_batch(self, pairs) -> None:
        """ComputeConstraint (pose_graph_3d.cc:285-305) over a batch of
        pairs: a local-window search when the trajectories are the same or
        recently connected, else a globally sampled full-submap search.

        Grids live in the trajectory-local frame and each submap's SPA frame
        is anchored at its origin (a pure translation): the grid-frame pose
        is anchor + rel and the constraint is rel = grid pose - anchor."""
        requests, anchors, node_times = [], {}, {}
        for node_id, submap_id in pairs:
            with self._result_lock:
                node = self.nodes.get(node_id)
                entry = self.submap_data.get(submap_id)
                if node is None or entry is None:
                    continue
                anchor_t = np.asarray(entry.submap.local_pose_translation, float)
                inv_t, inv_q = _inverse(entry.global_t, entry.global_q)
                rel_t, rel_q = _compose(inv_t, inv_q, node.global_t, node.global_q)
                last = self._connectivity.last_connection_time(node_id.trajectory_id,
                                                               submap_id.trajectory_id)
                recent = last is not None and node.time < last + from_seconds(
                    self._options.global_constraint_search_after_n_seconds)
                is_local = node_id.trajectory_id == submap_id.trajectory_id or recent
                global_pulse = (not is_local
                                and self._global_sampler_for(node_id.trajectory_id).pulse())
            if is_local:
                req = self._constraint_builder.begin_constraint(
                    submap_id, entry.submap, node_id, node.high_res_cloud, node.low_res_cloud,
                    node.scan_histogram, anchor_t + rel_t, rel_q,
                    relative_distance=float(np.linalg.norm(rel_t)))
            elif global_pulse:
                req = self._constraint_builder.begin_global_constraint(
                    submap_id, entry.submap, node_id, node.high_res_cloud, node.low_res_cloud,
                    node.scan_histogram, rel_q)
            else:
                req = None
            if req is not None:
                requests.append(req)
                anchors[(node_id, submap_id)] = anchor_t
                node_times[node_id] = node.time
        for res in self._constraint_builder.compute_constraints(requests):
            anchor_t = anchors[(res.node_id, res.submap_id)]
            with self._result_lock:
                if res.submap_id not in self.submap_data or res.node_id not in self.nodes:
                    continue
                cb = self._options.constraint_builder
                self.constraints.append(Constraint3D(
                    submap_id=res.submap_id, node_id=res.node_id, rel_t=res.grid_t - anchor_t,
                    rel_q=nquat.normalize(res.grid_q),
                    translation_weight=cb.loop_closure_translation_weight,
                    rotation_weight=cb.loop_closure_rotation_weight, tag="INTER_SUBMAP"))
                self._connectivity.connect(res.node_id.trajectory_id,
                                           res.submap_id.trajectory_id, node_times[res.node_id])
            self._metric_inter.increment()

    # ---------------------------------------------------------- optimization

    def run_optimization(self, num_iterations: Optional[int] = None) -> None:
        """Build the SE(3) SPA problem (run_optimization, l.521-835) and
        solve it with the Schur solver (K16)."""
        self.wait_for_all_computations()
        self._metric_optimizations.increment()
        if self.submap_data.empty() or not self.constraints:
            self._num_nodes_since_last_optimization = 0
            return
        t0 = time.monotonic()
        num_iterations = num_iterations or self._options.optimization_problem.max_num_iterations
        with self._result_lock:
            snap = self._snapshot()
        t_snap = time.monotonic() - t0
        s_t, s_q, n_t, n_q = self._solve(snap, num_iterations)
        with self._result_lock:
            self._write_back(snap, s_t, s_q, n_t, n_q)
            self._num_nodes_since_last_optimization = 0
            self.solves += 1
            self.snapshot_seconds += t_snap
            self.solve_seconds += time.monotonic() - t0

    def _snapshot(self) -> Dict:
        """The problem in host arrays, taken under the graph lock."""
        op = self._options.optimization_problem
        submap_slots: Dict[SubmapId, int] = {}
        node_slots: Dict[NodeId, int] = {}
        sub_ts, sub_qs, sub_free, grav_clamp = [], [], [], []
        nod_ts, nod_qs, nod_free = [], [], []
        free6 = np.array([True, True, not op.fix_z_in_3d, True, True, True])
        for (tid, sindex), entry in self.submap_data.items():
            submap_slots[SubmapId(tid, sindex)] = len(sub_ts)
            sub_ts.append(entry.global_t)
            sub_qs.append(entry.global_q)
            frozen = tid in self._frozen_trajectories or len(sub_ts) == 1
            sub_free.append(np.zeros(6, bool) if frozen else free6)
            grav_clamp.append(False)
        for (tid, nindex), node in self.nodes.items():
            node_slots[NodeId(tid, nindex)] = len(nod_ts)
            nod_ts.append(node.global_t)
            nod_qs.append(node.global_q)
            nod_free.append(np.zeros(6, bool) if tid in self._frozen_trajectories else free6)
        tail_anchor = {tid: SubmapId(tid, sindex) for (tid, sindex), _ in self.submap_data.items()}
        anchor_old = {tid: (self.submap_data[sid].global_t.copy(),
                            self.submap_data[sid].global_q.copy())
                      for tid, sid in tail_anchor.items()}

        # Binary reduced-node constraints (INTRA/INTER).
        binary = {k: [] for k in ("a_idx", "b_idx", "rel_t", "rel_q", "trans_weight",
                                  "rot_weight", "use_huber")}

        def add_binary(a, b, rt, rq, tw, rw, huber):
            for key, value in zip(binary, (a, b, rt, rq, tw, rw, huber)):
                binary[key].append(value)

        for c in self.constraints:
            if c.submap_id in submap_slots and c.node_id in node_slots:
                add_binary(submap_slots[c.submap_id], node_slots[c.node_id], c.rel_t, c.rel_q,
                           c.translation_weight, c.rotation_weight, c.tag == "INTER_SUBMAP")

        # Consecutive-node chains and the IMU terms
        # (optimization_problem_3d.cc:365-487).
        chain = {k: [] for k in ("j_idx", "nn_rel_t", "nn_rel_q", "nn_trans_weight",
                                 "nn_rot_weight")}
        rot = {k: [] for k in ("rot_i", "rot_traj", "rot_delta_q", "rot_weight_c")}
        acc = {k: [] for k in ("acc_i", "acc_traj", "acc_delta_v", "acc_dt1", "acc_dt2",
                               "acc_weight")}
        traj_slots: Dict[int, int] = {}

        def traj_slot_of(tid):
            # The trajectory's IMU block: gravity in t[0], the calibration
            # quaternion in q; gravity is clamped non-negative.
            if tid not in traj_slots:
                td = self.trajectory_data.get(tid, {})
                traj_slots[tid] = len(sub_ts)
                sub_ts.append(np.array([float(td.get("gravity_constant", 9.8)), 0.0, 0.0]))
                sub_qs.append(np.asarray(td.get("imu_calibration", _IDENTITY), np.float64))
                learn_c = bool(op.use_online_imu_extrinsics_in_3d)
                sub_free.append(np.array([True, False, False] + [learn_c] * 3))
                grav_clamp.append(True)
            return traj_slots[tid]

        def add_chain(j, rt, rq, tw, rw):
            for key, value in zip(chain, (j, rt, rq, tw, rw)):
                chain[key].append(value)

        for tid in self.nodes.trajectory_ids():
            if tid in self._frozen_trajectories:
                continue
            items = self.nodes.trajectory(tid)
            odo = (self._odometry_poses_at_3d(tid, [n.time for _, n in items])
                   if op.fix_z_in_3d else None)
            for k, ((i1, n1), (i2, n2)) in enumerate(zip(items, items[1:])):
                if i2 != i1 + 1:
                    continue
                slot = node_slots[NodeId(tid, i1)]
                r_t, r_q = _compose(*_inverse(n1.local_pose_translation, n1.local_pose_rotation),
                                    n2.local_pose_translation, n2.local_pose_rotation)
                add_chain(slot, r_t, r_q, op.local_slam_pose_translation_weight,
                          op.local_slam_pose_rotation_weight)
                if op.fix_z_in_3d:
                    if odo[k] is not None and odo[k + 1] is not None:
                        o_t, o_q = _compose(*_inverse(*odo[k]), *odo[k + 1])
                        add_chain(slot, o_t, o_q, op.odometry_translation_weight,
                                  op.odometry_rotation_weight)
                    continue  # no IMU terms with fix_z
                dt12 = max((n2.time - n1.time) * 1e-6, 1e-3)
                imu = self._integrate_imu(tid, n1.time, n2.time)
                if imu is not None:
                    for key, value in zip(rot, (slot, traj_slot_of(tid), imu[0],
                                                op.rotation_weight / dt12)):
                        rot[key].append(value)
            if op.fix_z_in_3d:
                continue
            # Acceleration triplets: delta_v between the interval midpoints in
            # the IMU frame at the middle node (optimization_problem_3d.cc:398-431).
            for (i1, n1), (i2, n2), (i3, n3) in zip(items, items[1:], items[2:]):
                if i2 != i1 + 1 or i3 != i2 + 1:
                    continue
                c1 = n1.time + (n2.time - n1.time) // 2
                c2 = n2.time + (n3.time - n2.time) // 2
                full = self._integrate_imu(tid, n1.time, n2.time)
                to_c1 = self._integrate_imu(tid, n1.time, c1)
                c1_to_c2 = self._integrate_imu(tid, c1, c2)
                if full is None or to_c1 is None or c1_to_c2 is None:
                    continue
                q_2_to_c1 = nquat.multiply(nquat.conjugate(full[0]), to_c1[0])
                dt1 = max((n2.time - n1.time) * 1e-6, 1e-3)
                dt2 = max((n3.time - n2.time) * 1e-6, 1e-3)
                for key, value in zip(acc, (node_slots[NodeId(tid, i1)], traj_slot_of(tid),
                                            nquat.rotate(q_2_to_c1, c1_to_c2[1]), dt1, dt2,
                                            op.acceleration_weight / (dt1 + dt2))):
                    acc[key].append(value)

        # Fixed-frame fixes: a learned yaw-only origin per trajectory
        # (optimization_problem_3d.cc:505-560).
        ff_origin_slots: Dict[int, int] = {}
        for tid in self.nodes.trajectory_ids():
            traj_ff = self._fixed_frame_data.trajectory(tid)
            if not traj_ff:
                continue
            ff_times = [t for t, _ in traj_ff]
            for nindex, node in self.nodes.trajectory(tid):
                fix = _interpolate_fixed_frame(traj_ff, ff_times, node.time)
                if fix is None:
                    continue
                fix_t, fix_q, has_rotation = fix
                if tid not in ff_origin_slots:
                    td = self.trajectory_data.get(tid, {})
                    if "fixed_frame_origin" in td:
                        o_t, o_q = td["fixed_frame_origin"]
                    else:
                        o_t, o_q = _compose(node.global_t, node.global_q,
                                            *_inverse(fix_t, fix_q))
                        o_q = nquat.from_yaw(nquat.get_yaw(o_q))
                    ff_origin_slots[tid] = len(sub_ts)
                    sub_ts.append(np.asarray(o_t, np.float64))
                    sub_qs.append(np.asarray(o_q, np.float64))
                    sub_free.append(np.array([True, True, True, False, False, True]))
                    grav_clamp.append(False)
                add_binary(ff_origin_slots[tid], node_slots[NodeId(tid, nindex)], fix_t, fix_q,
                           op.fixed_frame_pose_translation_weight,
                           op.fixed_frame_pose_rotation_weight if has_rotation else 0.0,
                           op.fixed_frame_pose_use_tolerant_loss)

        return dict(submap_slots=submap_slots, node_slots=node_slots, traj_slots=traj_slots,
                    ff_origin_slots=ff_origin_slots, tail_anchor=tail_anchor,
                    anchor_old=anchor_old, sub=(sub_ts, sub_qs, sub_free, grav_clamp),
                    nod=(nod_ts, nod_qs, nod_free), binary=binary, chain=chain, rot=rot,
                    acc=acc)

    def _solve(self, snap: Dict, num_iterations: int):
        """Upload the problem in one copy per array, solve (K16) and fetch the
        state in one copy: (s_t, s_q, n_t, n_q) float64 numpy."""
        sub_ts, sub_qs, sub_free, grav_clamp = snap["sub"]
        nod_ts, nod_qs, nod_free = snap["nod"]
        S, N = len(sub_ts), len(nod_ts)

        def arr(values, dtype, width=None):
            shape = (len(values),) if width is None else (len(values), width)
            return np.asarray(values, dtype).reshape(shape)

        host = dict(sub_t=arr(sub_ts, np.float32, 3), sub_q=arr(sub_qs, np.float32, 4),
                    node_t=arr(nod_ts, np.float32, 3), node_q=arr(nod_qs, np.float32, 4),
                    sub_free=arr(sub_free, bool, 6), node_free=arr(nod_free, bool, 6),
                    grav_clamp=arr(grav_clamp, bool))
        widths = {"rel_t": 3, "nn_rel_t": 3, "acc_delta_v": 3, "rel_q": 4, "nn_rel_q": 4,
                  "rot_delta_q": 4}
        for group, valid in ((snap["binary"], "valid"), (snap["chain"], "nn_valid"),
                             (snap["rot"], "rot_valid"), (snap["acc"], "acc_valid")):
            n = 0
            for key, values in group.items():
                n = len(values)
                dtype = (np.int32 if key in ("a_idx", "b_idx", "j_idx", "rot_i", "rot_traj",
                                             "acc_i", "acc_traj")
                         else bool if key == "use_huber" else np.float32)
                host[key] = arr(values, dtype, widths.get(key))
            host[valid] = np.ones(n, bool)
        wmax = max([float(host[w].max()) for _, w in WEIGHTS if host[w].size] + [1e-12])
        problem = SchurSpaProblem3D(**{k: to_device(v, self._device) for k, v in host.items()})
        s_t, s_q, n_t, n_q = solve_spa_3d_schur(
            problem, num_iterations=num_iterations,
            huber_scale=self._options.optimization_problem.huber_scale, wmax=wmax)
        flat = torch.cat([s_t.reshape(-1), s_q.reshape(-1), n_t.reshape(-1),
                          n_q.reshape(-1)]).cpu().numpy().astype(np.float64)  # one copy
        o = 0
        parts = []
        for rows, width in ((S, 3), (S, 4), (N, 3), (N, 4)):
            parts.append(flat[o:o + rows * width].reshape(rows, width))
            o += rows * width
        return tuple(parts)

    def _write_back(self, snap: Dict, s_t, s_q, n_t, n_q) -> None:
        for tid, slot in snap["traj_slots"].items():
            td = self.trajectory_data.setdefault(tid, {})
            td["gravity_constant"] = float(s_t[slot][0])
            td["imu_calibration"] = s_q[slot].copy()
        for tid, slot in snap["ff_origin_slots"].items():
            self.trajectory_data.setdefault(tid, {})["fixed_frame_origin"] = (
                s_t[slot].copy(), s_q[slot].copy())
        for sid, slot in snap["submap_slots"].items():
            if sid in self.submap_data:
                self.submap_data[sid].global_t = s_t[slot]
                self.submap_data[sid].global_q = s_q[slot]
        for nid, slot in snap["node_slots"].items():
            if nid in self.nodes:
                self.nodes[nid].global_t = n_t[slot]
                self.nodes[nid].global_q = n_q[slot]
        # Entries appended while the solve ran move with their trajectory's
        # anchor submap: new_anchor * old_anchor^-1.
        corrections = {}
        for tid, sid in snap["tail_anchor"].items():
            if sid in self.submap_data:
                e = self.submap_data[sid]
                corrections[tid] = _compose(e.global_t, e.global_q,
                                            *_inverse(*snap["anchor_old"][tid]))
        for (tid, sindex), entry in self.submap_data.items():
            if SubmapId(tid, sindex) not in snap["submap_slots"] and tid in corrections:
                entry.global_t, entry.global_q = _compose(*corrections[tid], entry.global_t,
                                                          entry.global_q)
        for (tid, nindex), node in self.nodes.items():
            if NodeId(tid, nindex) not in snap["node_slots"] and tid in corrections:
                node.global_t, node.global_q = _compose(*corrections[tid], node.global_t,
                                                        node.global_q)

    def run_final_optimization(self) -> None:
        self.wait_for_optimization()
        self.run_optimization(self._options.max_num_final_iterations)

    # ---------------------------------------------------------- trajectories

    def freeze_trajectory(self, trajectory_id: int) -> None:
        self._frozen_trajectories.add(trajectory_id)
        self.trajectory_states[trajectory_id] = "FROZEN"
        self._connectivity.add(trajectory_id)

    def finish_trajectory(self, trajectory_id: int) -> None:
        """The trajectory is finished once its pending searches and any
        solve in flight have drained."""
        if self.trajectory_states.get(trajectory_id) != "FROZEN":
            self.trajectory_states[trajectory_id] = "FINISHED"
        self.wait_for_all_computations()
        self.wait_for_optimization()

    def num_inter_constraints(self) -> int:
        return sum(1 for c in self.constraints if c.tag == "INTER_SUBMAP")

    def node_global_poses(self) -> Dict[NodeId, tuple]:
        return {NodeId(t, i): (n.global_t, n.global_q) for (t, i), n in self.nodes.items()}

    def local_to_global(self, trajectory_id: int):
        """The local SLAM frame in the global frame (t, q): the offset of the
        trajectory's last submap, global * local^-1; the identity before any
        submap exists (ComputeLocalToGlobalTransform)."""
        last = None
        for (t, i), entry in self.submap_data.items():
            if t == trajectory_id and (last is None or i > last[0]):
                last = (i, entry)
        if last is None:
            return np.zeros(3), _IDENTITY.copy()
        entry = last[1]
        it, iq = _inverse(np.asarray(entry.submap.local_pose_translation, float),
                          np.asarray(entry.submap.local_pose_rotation, float))
        return _compose(entry.global_t, entry.global_q, it, iq)
