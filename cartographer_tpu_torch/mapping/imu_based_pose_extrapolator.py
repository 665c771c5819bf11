"""IMU-based pose extrapolator: sliding-window batch optimization on the host.

Counterpart of the JAX package's `mapping/imu_based_pose_extrapolator.py`
(numpy only there as here), numerically the same: the same float64
Levenberg-Marquardt with the same forward-difference Jacobian. Each column
of that Jacobian recomputes only the residual blocks that depend on the
perturbed variable; the other rows of a forward difference are exactly 0,
so the Jacobian is the JAX module's to the bit, at a fraction of the host
time (the window of a 5 s pose queue holds some 300 variables).

Equivalent of mapping::ImuBasedPoseExtrapolator
(cartographer/mapping/internal/imu_based_pose_extrapolator.cc): instead of
constant-velocity prediction, every extrapolation solves a small nonlinear
least-squares problem over the recent pose queue with

  * pose priors        — SPA residuals tying each optimized node to its scan-
                         match pose through a shared `gravity_from_local`
                         transform (imu_based_pose_extrapolator.cc:213-223),
  * IMU rotation       — preintegrated gyro delta between consecutive nodes
                         (rotation_cost_function_3d.h:40-56),
  * IMU acceleration   — center-to-center preintegrated velocity triplets
                         (acceleration_cost_function_3d.h:45-74,
                         assembly imu_based_pose_extrapolator.cc:241-283),
  * odometry           — interpolated relative poses between consecutive nodes
                         (imu_based_pose_extrapolator.cc:290-317).

The reference solves with Ceres; this build uses a host-side
Levenberg-Marquardt with tangent-space (chordal) parameterization and
numeric Jacobians — the window holds a handful of poses (~6x(N+2) params),
far below the threshold where a device solve pays off. Deviations:
`gravity_constant` is always held fixed (the reference frees it only when
configured <= 0, which no shipped config does), and the last scan-match
node's constant-yaw parameterization is realized by zeroing the tangent
z-component (reference uses ConstantYawQuaternionPlus,
imu_based_pose_extrapolator.cc:168-173).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Sequence, Tuple

import numpy as np

from cartographer_tpu_torch.core.time import Duration, Time, from_seconds, to_seconds
from cartographer_tpu_torch.sensor.data import ImuData, OdometryData
from cartographer_tpu_torch.transform import nquat


@dataclasses.dataclass
class _TimedPose:
    time: Time
    translation: np.ndarray  # (3,)
    rotation: np.ndarray  # (4,) wxyz quaternion


def _integrate_imu(imu_data: Sequence[ImuData], t_start: Time, t_end: Time,
                   start_idx: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Preintegrate gyro/accel over [t_start, t_end] (imu_integration.h:41-85).

    `start_idx` must point at the sample with time <= t_start whose successor
    (if any) is > t_start. Returns (delta_rotation q, delta_velocity,
    delta_translation, new_idx) in the IMU frame at t_start.
    """
    it = start_idx
    current = t_start
    delta_q = np.array([1.0, 0.0, 0.0, 0.0])
    delta_v = np.zeros(3)
    delta_t = np.zeros(3)
    while current < t_end:
        next_imu = imu_data[it + 1].time if it + 1 < len(imu_data) else None
        nxt = t_end if next_imu is None else min(next_imu, t_end)
        dt = to_seconds(nxt - current)
        sample = imu_data[it]
        delta_q = nquat.normalize(nquat.multiply(
            delta_q, nquat.from_axis_angle(np.asarray(sample.angular_velocity) * dt)))
        delta_v = delta_v + nquat.rotate(
            delta_q, np.asarray(sample.linear_acceleration) * dt)
        delta_t = delta_t + dt * delta_v
        current = nxt
        if next_imu is not None and current == next_imu:
            it += 1
    return delta_q, delta_v, delta_t, it


def _spa_error(ti, qi, tj, qj, zbar_t, zbar_q, tw, rw) -> np.ndarray:
    """6-dim SPA residual (spa_cost_function_3d.h:47-56)."""
    qi_inv = nquat.conjugate(qi)
    h_t = nquat.rotate(qi_inv, tj - ti)
    # h_rotation_inverse * zbar.rotation
    h_rot_inv = nquat.multiply(nquat.conjugate(qj), qi)
    aa = nquat.to_axis_angle(nquat.multiply(h_rot_inv, zbar_q))
    return np.concatenate([tw * (h_t - zbar_t), rw * aa])


class ImuBasedPoseExtrapolator:
    def __init__(self, options) -> None:
        self._options = options
        self._pose_queue_duration: Duration = from_seconds(options.pose_queue_duration)
        self._timed_pose_queue: Deque[_TimedPose] = deque()
        self._imu_data: Deque[ImuData] = deque()
        self._odometry_data: Deque[OdometryData] = deque()
        self._previous_solution: Deque[_TimedPose] = deque()
        self._gravity_from_local_t = np.zeros(3)
        self._gravity_from_local_q = np.array([1.0, 0.0, 0.0, 0.0])
        self._last_extrapolated_time: Optional[Time] = None

    # -- Construction (imu_based_pose_extrapolator.cc:49-72) -----------------

    @staticmethod
    def initialize_with_imu(options, imu_data: List[ImuData],
                            initial_poses=()) -> "ImuBasedPoseExtrapolator":
        assert imu_data
        e = ImuBasedPoseExtrapolator(options)
        e._imu_data.extend(imu_data)
        for time, translation, rotation in initial_poses:
            if time > imu_data[0].time:
                e.add_pose(time, translation, rotation)
        if not e._timed_pose_queue:
            last = imu_data[-1]
            q = nquat.from_two_vectors(
                np.asarray(last.linear_acceleration), np.array([0.0, 0.0, 1.0]))
            e.add_pose(last.time, np.zeros(3), q)
        return e

    # -- Queue maintenance (imu_based_pose_extrapolator.cc:85-118) -----------

    def get_last_pose_time(self) -> Optional[Time]:
        return self._timed_pose_queue[-1].time if self._timed_pose_queue else None

    def get_last_extrapolated_time(self) -> Optional[Time]:
        return self._last_extrapolated_time

    def add_pose(self, time: Time, translation: np.ndarray, rotation: np.ndarray) -> None:
        self._timed_pose_queue.append(_TimedPose(
            time, np.asarray(translation, float), nquat.normalize(np.asarray(rotation, float))))
        while (len(self._timed_pose_queue) > 3
               and self._timed_pose_queue[1].time <= time - self._pose_queue_duration):
            if self._previous_solution:
                self._previous_solution.popleft()
            self._timed_pose_queue.popleft()
        self._trim(self._imu_data)

    def add_imu_data(self, imu_data: ImuData) -> None:
        if self._timed_pose_queue and imu_data.time < self._timed_pose_queue[-1].time:
            return  # out-of-order sample; the reference CHECK-fails here
        self._imu_data.append(imu_data)
        self._trim(self._imu_data)

    def add_odometry_data(self, odometry_data: OdometryData) -> None:
        if self._timed_pose_queue and odometry_data.time < self._timed_pose_queue[-1].time:
            return
        self._odometry_data.append(odometry_data)
        self._trim(self._odometry_data)

    def _trim(self, data: Deque) -> None:
        while (len(data) > 1 and self._timed_pose_queue
               and data[1].time <= self._timed_pose_queue[0].time):
            data.popleft()

    # -- Odometry interpolation (imu_based_pose_extrapolator.cc:411-441) -----

    def _has_odometry_for(self, time: Time) -> bool:
        return (len(self._odometry_data) >= 2
                and self._odometry_data[0].time < time < self._odometry_data[-1].time)

    def _interpolate_odometry(self, time: Time) -> Tuple[np.ndarray, np.ndarray]:
        data = list(self._odometry_data)
        hi = next(i for i, d in enumerate(data) if time < d.time)
        a, b = data[hi - 1], data[hi]
        f = to_seconds(time - a.time) / to_seconds(b.time - a.time)
        t = (1 - f) * np.asarray(a.pose_translation) + f * np.asarray(b.pose_translation)
        # slerp via tangent interpolation
        qa, qb = np.asarray(a.pose_rotation), np.asarray(b.pose_rotation)
        dq = nquat.multiply(nquat.conjugate(qa), qb)
        q = nquat.multiply(qa, nquat.from_axis_angle(f * nquat.to_axis_angle(dq)))
        return t, q

    # -- The sliding-window solve (imu_based_pose_extrapolator.cc:120-352) ---

    def extrapolate_poses_with_gravity(self, times: List[Time]):
        time = times[-1]
        newest = self._timed_pose_queue[-1]
        assert time >= newest.time
        self._last_extrapolated_time = time

        if (len(self._timed_pose_queue) < 3
                or to_seconds(time - newest.time) < 1e-6):
            poses = [(newest.translation.copy(), newest.rotation.copy())
                     for _ in times]
            return poses, np.zeros(3), newest.rotation.copy()

        opts = self._options
        queue = list(self._timed_pose_queue)
        m = len(queue)
        node_times = [p.time for p in queue]

        # Initial node values in the gravity frame.
        nodes_t, nodes_q = [], []
        prev = list(self._previous_solution)
        for i, tp in enumerate(queue):
            if prev and i < m - 1 and i < len(prev) and prev[i].time == tp.time:
                nodes_t.append(prev[i].translation.copy())
                nodes_q.append(prev[i].rotation.copy())
            else:
                nodes_t.append(self._gravity_from_local_t
                               + nquat.rotate(self._gravity_from_local_q, tp.translation))
                nodes_q.append(nquat.normalize(
                    nquat.multiply(self._gravity_from_local_q, tp.rotation)))

        gravity_constant = opts.gravity_constant if opts.gravity_constant > 0 else 9.8
        imu = list(self._imu_data)

        # IMU-extrapolated initial estimate for the new node
        # (imu_integration.h:136-159, call site imu_based...cc:188-210).
        idx = 0
        while idx + 1 < len(imu) and imu[idx + 1].time <= queue[-1].time:
            idx += 1
        prev_dt = to_seconds(node_times[-1] - node_times[-2])
        prev_vel_tracking = nquat.rotate(
            nquat.conjugate(nodes_q[-1]), (nodes_t[-1] - nodes_t[-2])) / prev_dt
        dq, dv, dtr, _ = _integrate_imu(imu, node_times[-1], time, idx)
        dt_new = to_seconds(time - node_times[-1])
        gravity_vec = gravity_constant * np.array([0.0, 0.0, 1.0])
        init_t = (nodes_t[-1]
                  + nquat.rotate(nodes_q[-1], dt_new * prev_vel_tracking + dtr)
                  - 0.5 * dt_new * dt_new * gravity_vec)
        init_q = nquat.normalize(nquat.multiply(nodes_q[-1], dq))
        nodes_t.append(init_t)
        nodes_q.append(init_q)
        node_times.append(time)
        n_nodes = m + 1

        # Preintegrate IMU segments shared by all LM iterations.
        rot_deltas = []  # per consecutive pair
        acc_terms = []  # (i, delta_velocity, dt1, dt2) for triplets
        it = 0
        if len(imu) > 1:
            assert imu[0].time <= node_times[0]
        for i in range(1, n_nodes):
            t_first, t_second = node_times[i - 1], node_times[i]
            it2 = it
            dq_i, _, _, it = _integrate_imu(imu, t_first, t_second, it)
            rot_deltas.append(dq_i)
            if i + 1 < n_nodes:
                t_third = node_times[i + 1]
                dur1 = t_second - t_first
                dur2 = t_third - t_second
                c1 = t_first + dur1 // 2
                c2 = t_second + dur2 // 2
                dq_fc, _, _, it2 = _integrate_imu(imu, t_first, c1, it2)
                _, dv_cc, _, it2 = _integrate_imu(imu, c1, c2, it2)
                delta_velocity = nquat.rotate(
                    nquat.multiply(nquat.conjugate(dq_i), dq_fc), dv_cc)
                acc_terms.append((i, delta_velocity,
                                  to_seconds(dur1), to_seconds(dur2)))

        # Odometry relative poses between consecutive nodes.
        odo_terms = []
        last_odo = None
        last_odo_time = None
        for i in range(1, n_nodes):
            t_first, t_second = node_times[i - 1], node_times[i]
            if self._has_odometry_for(t_first) and self._has_odometry_for(t_second):
                if last_odo is None or last_odo_time != t_first:
                    last_odo = self._interpolate_odometry(t_first)
                cur = self._interpolate_odometry(t_second)
                rel_q = nquat.multiply(nquat.conjugate(last_odo[1]), cur[1])
                rel_t = nquat.rotate(nquat.conjugate(last_odo[1]),
                                     cur[0] - last_odo[0])
                odo_terms.append((i, rel_t, nquat.normalize(rel_q)))
                last_odo, last_odo_time = cur, t_second

        # --- LM over tangent-space increments -------------------------------
        # State layout: [gravity_from_local(6)] + per-node(6). Node m-1 (last
        # scan-match pose): translation fixed, tangent-z zeroed (constant yaw).
        g_t = self._gravity_from_local_t.copy()
        g_q = self._gravity_from_local_q.copy()

        # The residual blocks in order, each with the variables it reads:
        # "g" (gravity_from_local) or a node index.
        blocks = []
        for i, tp in enumerate(queue):
            blocks.append((("g", i), lambda g_t, g_q, nodes_t, nodes_q, i=i, tp=tp: _spa_error(
                g_t, g_q, nodes_t[i], nodes_q[i], tp.translation, tp.rotation,
                opts.pose_translation_weight, opts.pose_rotation_weight)))
        for i in range(1, n_nodes):
            def rotation_block(g_t, g_q, nodes_t, nodes_q, i=i):
                err = nquat.multiply(
                    nquat.multiply(nquat.conjugate(nodes_q[i]), nodes_q[i - 1]),
                    rot_deltas[i - 1])
                return opts.imu_rotation_weight * err[1:]
            blocks.append(((i - 1, i), rotation_block))
        for (i, dvel, dt1, dt2) in acc_terms:
            def acceleration_block(g_t, g_q, nodes_t, nodes_q, i=i, dvel=dvel, dt1=dt1,
                                   dt2=dt2):
                imu_dv = (nquat.rotate(nodes_q[i], dvel)
                          - gravity_constant * 0.5 * (dt1 + dt2)
                          * np.array([0.0, 0.0, 1.0]))
                sv = (nodes_t[i] - nodes_t[i - 1]) / dt1
                ev = (nodes_t[i + 1] - nodes_t[i]) / dt2
                return opts.imu_acceleration_weight * (imu_dv - (ev - sv))
            blocks.append(((i - 1, i, i + 1), acceleration_block))
        for (i, rel_t, rel_q) in odo_terms:
            blocks.append(((i - 1, i), lambda g_t, g_q, nodes_t, nodes_q, i=i, rel_t=rel_t,
                           rel_q=rel_q: _spa_error(
                               nodes_t[i - 1], nodes_q[i - 1], nodes_t[i], nodes_q[i],
                               rel_t, rel_q, opts.odometry_translation_weight,
                               opts.odometry_rotation_weight)))

        def residuals(g_t, g_q, nodes_t, nodes_q) -> np.ndarray:
            return np.concatenate([fn(g_t, g_q, nodes_t, nodes_q) for _, fn in blocks])

        free = []  # (kind, node_index, dof) — dof indexes into 6-dim tangent
        for d in range(6):
            free.append(("g", -1, d))
        for i in range(n_nodes):
            if i == m - 1:  # last scan-match node: rotation roll/pitch only
                free.append(("n", i, 3))
                free.append(("n", i, 4))
            else:
                for d in range(6):
                    free.append(("n", i, d))

        def apply(dx):
            gt2, gq2 = g_t.copy(), g_q.copy()
            nt2 = [t.copy() for t in nodes_t]
            nq2 = [q.copy() for q in nodes_q]
            for val, (kind, i, d) in zip(dx, free):
                if val == 0.0:
                    continue
                if kind == "g":
                    if d < 3:
                        gt2[d] += val
                    else:
                        aa = np.zeros(3)
                        aa[d - 3] = val
                        gq2 = nquat.normalize(
                            nquat.multiply(gq2, nquat.from_axis_angle(aa)))
                else:
                    if d < 3:
                        nt2[i][d] += val
                    else:
                        aa = np.zeros(3)
                        aa[d - 3] = val
                        nq2[i] = nquat.normalize(
                            nquat.multiply(nq2[i], nquat.from_axis_angle(aa)))
            return gt2, gq2, nt2, nq2

        lam = 1e-6
        r0 = residuals(g_t, g_q, nodes_t, nodes_q)
        cost = float(r0 @ r0)
        max_iters = getattr(opts, "max_num_iterations", 10)
        eps = 1e-7
        rows, offset = [], 0
        for _, fn in blocks:
            size = fn(g_t, g_q, nodes_t, nodes_q).shape[0]
            rows.append(slice(offset, offset + size))
            offset += size
        depending = {}  # variable -> the blocks that read it
        for b, (variables, _) in enumerate(blocks):
            for v in variables:
                depending.setdefault(v, []).append(b)

        def perturbed(kind, i, d):
            """apply(dx) for dx = eps at the variable (kind, i, d), sharing
            the untouched arrays."""
            gt2, gq2, nt2, nq2 = g_t, g_q, list(nodes_t), list(nodes_q)
            aa = np.zeros(3)
            if d >= 3:
                aa[d - 3] = eps
            if kind == "g":
                if d < 3:
                    gt2 = g_t.copy()
                    gt2[d] += eps
                else:
                    gq2 = nquat.normalize(nquat.multiply(g_q, nquat.from_axis_angle(aa)))
            elif d < 3:
                nt2[i] = nodes_t[i].copy()
                nt2[i][d] += eps
            else:
                nq2[i] = nquat.normalize(nquat.multiply(nodes_q[i], nquat.from_axis_angle(aa)))
            return gt2, gq2, nt2, nq2

        for _ in range(max_iters):
            J = np.zeros((r0.shape[0], len(free)))
            for k, (kind, i, d) in enumerate(free):
                state = perturbed(kind, i, d)
                for b in depending.get("g" if kind == "g" else i, ()):
                    J[rows[b], k] = (blocks[b][1](*state) - r0[rows[b]]) / eps
            JtJ = J.T @ J
            g = J.T @ r0
            accepted = False
            for _try in range(5):
                try:
                    dx = np.linalg.solve(
                        JtJ + lam * np.diag(np.maximum(np.diag(JtJ), 1e-12)), -g)
                except np.linalg.LinAlgError:
                    lam *= 10
                    continue
                cand = apply(dx)
                r_new = residuals(*cand)
                c_new = float(r_new @ r_new)
                if c_new < cost:
                    g_t, g_q, nodes_t, nodes_q = cand
                    r0, cost = r_new, c_new
                    lam = max(lam * 0.3, 1e-9)
                    accepted = True
                    break
                lam *= 10
            if not accepted or float(np.abs(dx).max()) < 1e-10:
                break

        # --- Extract results (imu_based_pose_extrapolator.cc:325-352) -------
        gravity_estimate = nodes_q[-1].copy()
        last_pose = queue[-1]
        # extrapolated = last_pose * nodes[-2]^-1 * nodes[-1]
        rel_q = nquat.multiply(nquat.conjugate(nodes_q[-2]), nodes_q[-1])
        rel_t = nquat.rotate(nquat.conjugate(nodes_q[-2]), nodes_t[-1] - nodes_t[-2])
        ext_q = nquat.normalize(nquat.multiply(last_pose.rotation, rel_q))
        ext_t = last_pose.translation + nquat.rotate(last_pose.rotation, rel_t)

        self._gravity_from_local_t, self._gravity_from_local_q = g_t, g_q
        self._previous_solution = deque(
            _TimedPose(node_times[i], nodes_t[i], nodes_q[i])
            for i in range(n_nodes))

        velocity = (ext_t - last_pose.translation) / to_seconds(time - last_pose.time)

        # Interpolate intermediate poses between last pose and extrapolation
        # (imu_based_pose_extrapolator.cc:354-380); the reference returns
        # times.size()-1 interpolants + current pose, we return one per time.
        poses = []
        dq = nquat.multiply(nquat.conjugate(last_pose.rotation), ext_q)
        aa = nquat.to_axis_angle(dq)
        scale = 1.0 / to_seconds(time - last_pose.time)
        for t in times[:-1]:
            f = min(max(to_seconds(t - last_pose.time) * scale, 0.0), 1.0)
            poses.append((last_pose.translation
                          + f * (ext_t - last_pose.translation),
                          nquat.normalize(nquat.multiply(
                              last_pose.rotation, nquat.from_axis_angle(f * aa)))))
        poses.append((ext_t, ext_q))
        return poses, velocity, gravity_estimate

    def extrapolate_pose(self, time: Time) -> Tuple[np.ndarray, np.ndarray]:
        poses, _, _ = self.extrapolate_poses_with_gravity([time])
        return poses[-1]

    def estimate_gravity_orientation(self, time: Time) -> np.ndarray:
        _, _, gravity = self.extrapolate_poses_with_gravity([time])
        return gravity
