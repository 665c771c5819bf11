"""2D global SLAM backend.

Counterpart of the JAX package's `mapping/pose_graph_2d.py`
(pose_graph_2d.cc, optimization_problem_2d.cc) on one device: node and
submap bookkeeping, INTRA_SUBMAP constraints, loop-closure searches through
ConstraintBuilder2D (local window when recently connected, sampled
full-submap search otherwise), and the Schur-complement SPA (K8) every
`optimize_every_n_nodes` nodes over the submap-node constraints, the
consecutive local-SLAM and odometry terms and the fixed-frame fixes (each
trajectory's fixed-frame origin is a submap-side slot).

With `num_background_threads` > 0 the searches run on a thread pool and the
solves on one optimizer thread while the frontend keeps adding nodes (the
reference's work queue, pose_graph_2d.cc:520-544); pending pairs coalesce
across nodes. Landmarks and the trimmers are not ported.
"""

from __future__ import annotations

import bisect
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
from cartographer_tpu_torch.mapping.constraint_builder_2d import Constraint, ConstraintBuilder2D
from cartographer_tpu_torch.mapping.id import MapById, NodeId, SubmapId
from cartographer_tpu_torch.mapping.submap_2d import Submap2D
from cartographer_tpu_torch.parallel.schur_spa import SchurSpaProblem2D, solve_spa_2d_schur
from cartographer_tpu_torch.sensor.map_by_time import MapByTime
from cartographer_tpu_torch.transform import nquat


@dataclasses.dataclass
class TrajectoryNode:
    """Node data kept by the pose graph (trajectory_node.h)."""

    time: Time
    gravity_alignment: np.ndarray  # (4,)
    filtered_points: np.ndarray  # (n, 2) gravity-aligned scan for loop closure
    local_pose_translation: np.ndarray  # (3,)
    local_pose_rotation: np.ndarray  # (4,)
    global_pose_2d: np.ndarray = None  # (3,) [x, y, theta], optimized


@dataclasses.dataclass
class SubmapDataEntry:
    submap: Submap2D
    global_pose_2d: np.ndarray  # (3,)
    node_ids: Set[NodeId] = dataclasses.field(default_factory=set)
    finished: bool = False


def _pose2d_of_node(node: TrajectoryNode) -> np.ndarray:
    """Gravity-aligned 2D local pose of a node: Project2D(pose * g^-1)."""
    q = nquat.multiply(node.local_pose_rotation, nquat.conjugate(node.gravity_alignment))
    return np.array([node.local_pose_translation[0], node.local_pose_translation[1],
                     nquat.get_yaw(q)])


def _compose2d(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a * b of [x, y, theta] poses (..., 3)."""
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    return np.stack([a[..., 0] + c * b[..., 0] - s * b[..., 1],
                     a[..., 1] + s * b[..., 0] + c * b[..., 1], a[..., 2] + b[..., 2]], -1)


def _inverse2d(a: np.ndarray) -> np.ndarray:
    """a^-1 of [x, y, theta] poses (..., 3)."""
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    return np.stack([-(c * a[..., 0] + s * a[..., 1]), -(-s * a[..., 0] + c * a[..., 1]),
                     -a[..., 2]], -1)


def _np_interpolate(start_t, start_q, end_t, end_q, factor):
    """Translation lerp and rotation slerp of two poses (numpy)."""
    t = start_t + factor * (end_t - start_t)
    if np.dot(start_q, end_q) < 0:
        end_q = -end_q
    theta = np.arccos(np.clip(abs(float(np.dot(start_q, end_q))), -1.0, 1.0))
    if np.sin(theta) < 1e-6:
        q = (1 - factor) * start_q + factor * end_q
    else:
        q = (np.sin((1 - factor) * theta) * start_q
             + np.sin(factor * theta) * end_q) / np.sin(theta)
    return t, q / np.linalg.norm(q)


def _interpolate_fixed_frame(traj_ff, ff_times, time_):
    """Time-interpolated fixed-frame pose at `time_`, or None outside the
    fixes' range (optimization_problem.cc Interpolate over MapByTime).
    Returns (t (3,), q (4,), has_rotation); a fix without rotation gives the
    identity and has_rotation=False."""
    if not traj_ff or time_ < ff_times[0] or time_ > ff_times[-1]:
        return None
    i = bisect.bisect_left(ff_times, time_)
    if ff_times[i] == time_:
        lo = hi = traj_ff[i][1]
    else:
        lo, hi = traj_ff[i - 1][1], traj_ff[i][1]
    factor = 0.0 if hi.time == lo.time else (time_ - lo.time) / (hi.time - lo.time)
    has_rot = lo.pose_rotation is not None and hi.pose_rotation is not None
    q_lo = np.asarray(lo.pose_rotation if lo.pose_rotation is not None else nquat.IDENTITY,
                      np.float64)
    q_hi = np.asarray(hi.pose_rotation if hi.pose_rotation is not None else nquat.IDENTITY,
                      np.float64)
    t, q = _np_interpolate(np.asarray(lo.pose_translation, np.float64), q_lo,
                           np.asarray(hi.pose_translation, np.float64), q_hi, factor)
    return t, q, has_rot


class PoseGraph2D:
    # Pairs per coalesced search call of the background drain.
    _DRAIN_SLURP = 512

    def __init__(self, options: PoseGraphOptions, num_background_threads: int = 0,
                 device="cuda"):
        self._options = options
        self._device = torch.device(device)
        self._constraint_builder = ConstraintBuilder2D(options.constraint_builder, device)
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
                                                thread_name_prefix="constraint")
            self._optimizer_executor = ThreadPoolExecutor(max_workers=1,
                                                          thread_name_prefix="optimizer")
        factory = metrics.GLOBAL_FACTORY
        counts = factory.new_counter_family("mapping_2d_pose_graph_constraints",
                                            "Constraints added to the pose graph")
        self._metric_intra = counts.add({"tag": "intra_submap"})
        self._metric_inter = counts.add({"tag": "inter_submap"})
        self._metric_optimizations = factory.new_counter_family(
            "mapping_2d_pose_graph_optimizations", "Pose graph optimization runs").add({})
        self._metric_pending = factory.new_gauge_family(
            "mapping_2d_pose_graph_work_queue_depth",
            "Pending background constraint searches").add({})
        self.nodes: MapById[TrajectoryNode] = MapById()
        self.submap_data: MapById[SubmapDataEntry] = MapById()
        self.constraints: List[Constraint] = []
        self._num_nodes_since_last_optimization = 0
        self._global_samplers: Dict[int, FixedRatioSampler] = {}
        self._connectivity = TrajectoryConnectivityState()
        self._odometry_data = MapByTime()
        self._fixed_frame_data = MapByTime()
        # Learned fixed-frame origin in the map per trajectory, [x, y, theta].
        self.fixed_frame_origin: Dict[int, np.ndarray] = {}
        # Solves run and their wall seconds (problem build, solve, fetch).
        self.solves = 0
        self.solve_seconds = 0.0

    @property
    def constraint_builder(self) -> ConstraintBuilder2D:
        return self._constraint_builder

    def _global_sampler_for(self, trajectory_id: int) -> FixedRatioSampler:
        if trajectory_id not in self._global_samplers:
            self._global_samplers[trajectory_id] = FixedRatioSampler(
                self._options.global_sampling_ratio)
        return self._global_samplers[trajectory_id]

    # ------------------------------------------------------------ node intake

    def add_node(self, trajectory_id: int, node: TrajectoryNode,
                 insertion_submaps: List[Submap2D], finished_submaps: List[Submap2D]) -> NodeId:
        """PoseGraph2D::AddNode + ComputeConstraintsForNode
        (pose_graph_2d.cc:126-170, 312-402)."""
        with self._result_lock:
            self._connectivity.add(trajectory_id)
            node_id = NodeId(trajectory_id, self.nodes.append(trajectory_id, node))
            submap_ids = self._register_insertion_submaps(trajectory_id, insertion_submaps)
            for sid in submap_ids:
                self.submap_data[sid].node_ids.add(node_id)
            node_pose_2d = _pose2d_of_node(node)
            first = self.submap_data[submap_ids[0]]
            node.global_pose_2d = _compose2d(
                first.global_pose_2d,
                _compose2d(_inverse2d(self._submap_local_pose_2d(first.submap)), node_pose_2d))
            for sid in submap_ids:
                entry = self.submap_data[sid]
                self.constraints.append(Constraint(
                    submap_id=sid, node_id=node_id,
                    rel=_compose2d(_inverse2d(self._submap_local_pose_2d(entry.submap)),
                                   node_pose_2d),
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

    def _schedule_optimization(self) -> None:
        """The solve on the optimizer thread in background mode (the
        frontend goes on; poses added meanwhile are extrapolated at
        write-back), inline otherwise."""
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

    def _submap_local_pose_2d(self, submap: Submap2D) -> np.ndarray:
        return np.array([submap.local_pose_translation[0], submap.local_pose_translation[1],
                         nquat.get_yaw(submap.local_pose_rotation)])

    def _register_insertion_submaps(self, trajectory_id: int,
                                    insertion_submaps: List[Submap2D]) -> List[SubmapId]:
        """Match submap objects to graph entries, appending new ones
        (InitializeGlobalSubmapPoses, pose_graph_2d.cc:204-259)."""
        existing = {id(entry.submap): SubmapId(tid, sindex)
                    for (tid, sindex), entry in self.submap_data.items() if tid == trajectory_id}
        ids = []
        for submap in insertion_submaps:
            if id(submap) in existing:
                ids.append(existing[id(submap)])
                continue
            local = self._submap_local_pose_2d(submap)
            if self.submap_data.size_of_trajectory(trajectory_id) == 0:
                global_pose = local.copy()
            else:  # global = last_global * last_local^-1 * local
                last = self.submap_data[SubmapId(
                    trajectory_id, self.submap_data.last_index_of_trajectory(trajectory_id))]
                global_pose = _compose2d(last.global_pose_2d, _compose2d(
                    _inverse2d(self._submap_local_pose_2d(last.submap)), local))
            index = self.submap_data.append(
                trajectory_id, SubmapDataEntry(submap=submap, global_pose_2d=global_pose))
            ids.append(SubmapId(trajectory_id, index))
        return ids

    # ------------------------------------------------------------ sensor intake

    def add_odometry_data(self, trajectory_id: int, odometry_data) -> None:
        self._odometry_data.append(trajectory_id, odometry_data.time, odometry_data)

    def add_fixed_frame_pose_data(self, trajectory_id: int, data) -> None:
        if data.pose_translation is None:
            return  # an invalid fix
        self._fixed_frame_data.append(trajectory_id, data.time, data)

    def _odometry_poses_at(self, trajectory_id: int, times):
        """Interpolated odometry poses [x, y, theta] at the sorted node
        times; None where the odometry does not bracket the time."""
        traj = self._odometry_data.trajectory(trajectory_id)
        out = [None] * len(times)
        if len(traj) < 2:
            return out
        tlist = [e[0] for e in traj]

        def pose_of(d):
            return np.array([d.pose_translation[0], d.pose_translation[1],
                             nquat.get_yaw(d.pose_rotation)])

        for k, t in enumerate(times):
            if t < tlist[0] or t > tlist[-1]:
                continue
            i = bisect.bisect_left(tlist, t)
            if tlist[i] == t or i == 0:
                out[k] = pose_of(traj[min(i, len(traj) - 1)][1])
                continue
            f = (t - tlist[i - 1]) / (tlist[i] - tlist[i - 1])
            ta, tb = pose_of(traj[i - 1][1]), pose_of(traj[i][1])
            dth = (tb[2] - ta[2] + np.pi) % (2.0 * np.pi) - np.pi  # the shorter arc
            out[k] = np.array([ta[0] + f * (tb[0] - ta[0]), ta[1] + f * (tb[1] - ta[1]),
                               ta[2] + f * dth])
        return out

    # ------------------------------------------------------------ loop closure

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
        """Drain the pending background searches (pose_graph_2d.cc:546+)."""
        while True:
            with self._futures_lock:
                futures, self._pending_futures = self._pending_futures, []
            if not futures:
                break
            for f in futures:
                f.result()

    def _compute_constraints_batch(self, pairs) -> None:
        """ComputeConstraint (pose_graph_2d.cc:261-310) over a batch of pairs.

        Grids live in the trajectory-local frame; each submap's SPA frame is
        anchored at the submap origin A, so the grid-frame pose is A * rel
        and the constraint is rel = A^-1 * grid_pose."""
        requests, anchors, node_times = [], {}, {}
        for node_id, submap_id in pairs:
            node = self.nodes.get(node_id)
            entry = self.submap_data.get(submap_id)
            if node is None or entry is None or entry.submap.grid is None:
                continue
            if node.filtered_points is None or len(node.filtered_points) == 0:
                continue
            anchor = self._submap_local_pose_2d(entry.submap)
            with self._result_lock:
                # Local window only when the trajectories were directly
                # connected recently (pose_graph_2d.cc:277-289).
                last = self._connectivity.last_connection_time(node_id.trajectory_id,
                                                               submap_id.trajectory_id)
                recent = last is not None and node.time < last + from_seconds(
                    self._options.global_constraint_search_after_n_seconds)
                is_local = node_id.trajectory_id == submap_id.trajectory_id or recent
                global_pulse = (not is_local
                                and self._global_sampler_for(node_id.trajectory_id).pulse())
            req = None
            if is_local:
                rel_est = _compose2d(_inverse2d(entry.global_pose_2d), node.global_pose_2d)
                req = self._constraint_builder.begin_constraint(
                    submap_id, entry.submap.grid, node_id, node.filtered_points,
                    _compose2d(anchor, rel_est),
                    relative_distance=float(np.linalg.norm(rel_est[:2])))
            elif global_pulse:
                req = self._constraint_builder.begin_global_constraint(
                    submap_id, entry.submap.grid, node_id, node.filtered_points)
            if req is not None:
                requests.append(req)
                anchors[(node_id, submap_id)] = anchor
                node_times[node_id] = node.time
        for constraint in self._constraint_builder.compute_constraints(requests):
            anchor = anchors[(constraint.node_id, constraint.submap_id)]
            constraint.rel = _compose2d(_inverse2d(anchor), constraint.rel)
            with self._result_lock:
                if (constraint.submap_id not in self.submap_data
                        or constraint.node_id not in self.nodes):
                    continue
                self.constraints.append(constraint)
                self._connectivity.connect(constraint.node_id.trajectory_id,
                                           constraint.submap_id.trajectory_id,
                                           node_times[constraint.node_id])
            self._metric_inter.increment()

    # ------------------------------------------------------------ optimization

    def run_optimization(self, num_iterations: Optional[int] = None) -> None:
        """Build the SPA problem and solve it (HandleWorkQueue +
        RunOptimization, pose_graph_2d.cc:444-518, 861-908)."""
        self.wait_for_all_computations()
        self._metric_optimizations.increment()
        if self.submap_data.empty() or not self.constraints:
            self._num_nodes_since_last_optimization = 0
            return
        t0 = time.monotonic()
        num_iterations = num_iterations or self._options.optimization_problem.max_num_iterations
        op = self._options.optimization_problem
        # Snapshot under the graph lock; the solve runs without it while the
        # frontend keeps appending (the tail is extrapolated at write-back).
        with self._result_lock:
            submap_slots: Dict[SubmapId, int] = {}
            node_slots: Dict[NodeId, int] = {}
            sub_poses, sub_fixed, node_poses, node_fixed = [], [], [], []
            for (tid, sindex), entry in self.submap_data.items():
                submap_slots[SubmapId(tid, sindex)] = len(sub_poses)
                sub_poses.append(entry.global_pose_2d)
                sub_fixed.append(len(sub_poses) == 1)  # the first submap anchors the map
            for (tid, nindex), node in self.nodes.items():
                node_slots[NodeId(tid, nindex)] = len(node_poses)
                node_poses.append(node.global_pose_2d)
                node_fixed.append(False)
            tail_anchor = {tid: SubmapId(tid, sindex)
                           for (tid, sindex), _ in self.submap_data.items()}
            anchor_old = {tid: self.submap_data[sid].global_pose_2d.copy()
                          for tid, sid in tail_anchor.items()}
            a_idx, b_idx, rels, tws, rws, hubers = [], [], [], [], [], []
            for c in self.constraints:
                if c.submap_id not in submap_slots or c.node_id not in node_slots:
                    continue
                a_idx.append(submap_slots[c.submap_id])
                b_idx.append(node_slots[c.node_id])
                rels.append(c.rel)
                tws.append(c.translation_weight)
                rws.append(c.rotation_weight)
                hubers.append(c.tag == "INTER_SUBMAP")
            # Consecutive-node terms from local SLAM and odometry
            # (optimization_problem_2d.cc:304-349).
            j_idx, nn_rels, nn_tws, nn_rws = [], [], [], []
            for tid in self.nodes.trajectory_ids():
                items = self.nodes.trajectory(tid)
                odo = self._odometry_poses_at(tid, [n.time for _, n in items])
                for k, ((i1, n1), (i2, n2)) in enumerate(zip(items, items[1:])):
                    if i2 != i1 + 1:
                        continue
                    s1 = node_slots[NodeId(tid, i1)]
                    j_idx.append(s1)
                    nn_rels.append(_compose2d(_inverse2d(_pose2d_of_node(n1)),
                                              _pose2d_of_node(n2)))
                    nn_tws.append(op.local_slam_pose_translation_weight)
                    nn_rws.append(op.local_slam_pose_rotation_weight)
                    if odo[k] is not None and odo[k + 1] is not None:
                        j_idx.append(s1)
                        nn_rels.append(_compose2d(_inverse2d(odo[k]), odo[k + 1]))
                        nn_tws.append(op.odometry_translation_weight)
                        nn_rws.append(op.odometry_rotation_weight)
            # Fixed-frame fixes with a learned origin per trajectory, a
            # submap-side slot coupled to every node within the fixes' time
            # range (optimization_problem_2d.cc:351-394).
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
                    fix2d = np.array([fix_t[0], fix_t[1], nquat.get_yaw(fix_q)])
                    if tid not in ff_origin_slots:
                        origin = (np.asarray(self.fixed_frame_origin[tid], np.float64)
                                  if tid in self.fixed_frame_origin
                                  else _compose2d(node.global_pose_2d, _inverse2d(fix2d)))
                        ff_origin_slots[tid] = len(sub_poses)
                        sub_poses.append(origin)
                        sub_fixed.append(False)
                    a_idx.append(ff_origin_slots[tid])
                    b_idx.append(node_slots[NodeId(tid, nindex)])
                    rels.append(fix2d)
                    tws.append(op.fixed_frame_pose_translation_weight)
                    rws.append(op.fixed_frame_pose_rotation_weight if has_rotation else 0.0)
                    hubers.append(op.fixed_frame_pose_use_tolerant_loss)

        sub_solved, node_solved = self._solve_schur(
            sub_poses, sub_fixed, node_poses, node_fixed, (a_idx, b_idx, rels, tws, rws, hubers),
            (j_idx, nn_rels, nn_tws, nn_rws), num_iterations)

        with self._result_lock:
            for sid, slot in submap_slots.items():
                if sid in self.submap_data:
                    self.submap_data[sid].global_pose_2d = sub_solved[slot].astype(np.float64)
            for nid, slot in node_slots.items():
                if nid in self.nodes:
                    self.nodes[nid].global_pose_2d = node_solved[slot].astype(np.float64)
            for tid, slot in ff_origin_slots.items():
                self.fixed_frame_origin[tid] = sub_solved[slot].astype(np.float64)
            # Submaps and nodes appended during the solve move with their
            # trajectory's anchor submap: new_anchor * old_anchor^-1.
            corrections = {tid: _compose2d(self.submap_data[sid].global_pose_2d,
                                           _inverse2d(anchor_old[tid]))
                           for tid, sid in tail_anchor.items() if sid in self.submap_data}
            for (tid, sindex), entry in self.submap_data.items():
                if SubmapId(tid, sindex) not in submap_slots and tid in corrections:
                    entry.global_pose_2d = _compose2d(corrections[tid], entry.global_pose_2d)
            for (tid, nindex), node in self.nodes.items():
                if NodeId(tid, nindex) not in node_slots and tid in corrections:
                    node.global_pose_2d = _compose2d(corrections[tid], node.global_pose_2d)
            self._num_nodes_since_last_optimization = 0
            self.solves += 1
            self.solve_seconds += time.monotonic() - t0

    def _solve_schur(self, sub_poses, sub_fixed, node_poses, node_fixed, sn_terms, nn_terms,
                     num_iterations):
        """Pad the problem to power-of-two sizes, upload it, solve (K8) and
        fetch the poses in one copy: (sub (S, 3), nodes (N, 3)) numpy."""
        a_idx, b_idx, rels, tws, rws, hubers = sn_terms
        j_idx, nn_rels, nn_tws, nn_rws = nn_terms
        S, N = len(sub_poses), len(node_poses)
        Sp = 1 << int(np.ceil(np.log2(max(S, 2))))
        Np = 1 << int(np.ceil(np.log2(max(N, 2))))

        def cap_of(n):
            return 1 << int(np.ceil(np.log2(max(n, 16))))

        def pad(values, cap, dtype, width=None):
            out = np.zeros((cap,) if width is None else (cap, width), dtype)
            if len(values):
                out[:len(values)] = values
            return out

        def fixed(flags, cap):
            out = np.ones(cap, bool)
            out[:len(flags)] = flags
            return out

        C, D = len(a_idx), len(j_idx)
        Cc, Dc = cap_of(C), cap_of(D)
        host = dict(
            submap_poses=pad(sub_poses, Sp, np.float32, 3),
            node_poses=pad(node_poses, Np, np.float32, 3),
            a_idx=pad(a_idx, Cc, np.int32), b_idx=pad(b_idx, Cc, np.int32),
            rel=pad(rels, Cc, np.float32, 3), trans_weight=pad(tws, Cc, np.float32),
            rot_weight=pad(rws, Cc, np.float32), use_huber=pad(hubers, Cc, bool),
            valid=np.arange(Cc) < C, j_idx=pad(j_idx, Dc, np.int32),
            nn_rel=pad(nn_rels, Dc, np.float32, 3), nn_trans_weight=pad(nn_tws, Dc, np.float32),
            nn_rot_weight=pad(nn_rws, Dc, np.float32), nn_valid=np.arange(Dc) < D,
            submap_fixed=fixed(sub_fixed, Sp), node_fixed=fixed(node_fixed, Np))
        wmax = float(max(host["trans_weight"][:C].max(initial=0.0),
                         host["rot_weight"][:C].max(initial=0.0),
                         host["nn_trans_weight"][:D].max(initial=0.0),
                         host["nn_rot_weight"][:D].max(initial=0.0), 1e-12))
        problem = SchurSpaProblem2D(**{k: to_device(v, self._device) for k, v in host.items()})
        sub, nod = solve_spa_2d_schur(problem, num_iterations=num_iterations,
                                      huber_scale=self._options.optimization_problem.huber_scale,
                                      wmax=wmax)
        out = torch.cat([sub, nod]).cpu().numpy()  # the solve's one blocking copy
        return out[:Sp], out[Sp:]

    def run_final_optimization(self) -> None:
        self.wait_for_optimization()
        self.run_optimization(self._options.max_num_final_iterations)

    # ------------------------------------------------------------ queries

    def add_trimmer(self, trimmer) -> None:
        raise NotImplementedError("pose-graph trimmers are not ported")

    def add_landmark_data(self, trajectory_id: int, data) -> None:
        raise NotImplementedError("landmarks are not ported")

    def finish_trajectory(self, trajectory_id: int) -> None:
        """The trajectory is finished once its pending searches and any
        solve in flight have drained (pose_graph_2d.cc:546+)."""
        self.wait_for_all_computations()
        self.wait_for_optimization()

    def transitively_connected(self, a: int, b: int) -> bool:
        """Whether loop closures join trajectories a and b."""
        return self._connectivity.transitively_connected(a, b)

    def num_inter_constraints(self) -> int:
        return sum(1 for c in self.constraints if c.tag == "INTER_SUBMAP")

    def node_global_poses(self) -> Dict[NodeId, np.ndarray]:
        return {NodeId(t, i): n.global_pose_2d for (t, i), n in self.nodes.items()}

