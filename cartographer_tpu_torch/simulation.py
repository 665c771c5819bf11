"""A simulated LiDAR robot in a multi-room floor plan (numpy only): a 2D
scanner, and a spinning multi-ring 3D sensor with an IMU in the same plan
extruded to a hall.

Used to drive the frontends end to end where no recorded data is at
hand: a floor plan of wall segments, a closed smooth path through its
rooms driven with a speed ramp from rest, and a rotating range sensor whose
beams are fired at successive times along the path (so scans carry the
motion distortion the frontend's unwarp removes).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


def floor_plan(scale: float = 1.0) -> np.ndarray:
    """Wall segments (W, 4) [x0, y0, x1, y1] of a 36 m x 20 m floor (times
    `scale`): outer walls, a central block of rooms, dividing walls with
    doorways where the path crosses them, and pillars."""
    walls: List[Tuple[float, float, float, float]] = []

    def box(x0, y0, x1, y1):
        walls.extend([(x0, y0, x1, y0), (x1, y0, x1, y1), (x1, y1, x0, y1), (x0, y1, x0, y0)])

    box(-18.0, -10.0, 18.0, 10.0)
    box(-7.0, -2.5, 7.0, 2.5)
    for x in (-6.0, 0.0, 6.0):  # room dividers with doorways at |y| in [4, 8]
        walls.extend([(x, -10.0, x, -8.0), (x, -4.0, x, 4.0), (x, 8.0, x, 10.0)])
    for y in (-3.0, 3.0):  # side rooms at both ends
        walls.extend([(-18.0, y, -16.0, y), (16.0, y, 18.0, y)])
    rng = np.random.RandomState(7)
    for cx, cy in ((-12.0, 8.5), (-3.0, -9.0), (3.0, 9.0), (12.0, -8.5), (-16.5, 0.0),
                   (16.5, 0.0), (-9.5, -8.5), (9.5, 8.5)):
        s = 0.2 + 0.2 * rng.rand()
        box(cx - s, cy - s, cx + s, cy + s)
    return scale * np.asarray(walls, np.float64)


@dataclasses.dataclass
class Path:
    """A closed smooth path (superellipse) reparameterized by arc length."""

    xy: np.ndarray  # (M, 2) dense samples
    arc: np.ndarray  # (M,) cumulative arc length
    heading: np.ndarray  # (M,) unwrapped tangent direction

    @staticmethod
    def superellipse(a: float = 11.0, b: float = 7.0, n: float = 2.5,
                     samples: int = 20000) -> "Path":
        phi = np.linspace(0.0, 2.0 * np.pi, samples)
        c, s = np.cos(phi), np.sin(phi)
        xy = np.stack([a * np.sign(c) * np.abs(c) ** (2.0 / n),
                       b * np.sign(s) * np.abs(s) ** (2.0 / n)], -1)
        seg = np.linalg.norm(np.diff(xy, axis=0), axis=1)
        arc = np.concatenate([[0.0], np.cumsum(seg)])
        d = np.gradient(xy, axis=0)
        heading = np.unwrap(np.arctan2(d[:, 1], d[:, 0]))
        return Path(xy, arc, heading)

    def pose_at(self, s: np.ndarray):
        """-> (xy (..., 2), yaw (...)) at arc lengths s (wrapping around)."""
        length = self.arc[-1]
        laps, s = np.divmod(np.asarray(s, np.float64), length)
        x = np.interp(s, self.arc, self.xy[:, 0])
        y = np.interp(s, self.arc, self.xy[:, 1])
        turn = self.heading[-1] - self.heading[0]
        yaw = np.interp(s, self.arc, self.heading) + laps * turn
        return np.stack([x, y], -1), yaw


@dataclasses.dataclass
class Robot:
    """Speed ramp from rest to `speed` m/s over `ramp` seconds along `path`,
    starting `start` metres of arc into it."""

    path: Path
    speed: float
    ramp: float
    start: float = 0.0

    def arc_at(self, t: np.ndarray) -> np.ndarray:
        t = np.maximum(np.asarray(t, np.float64), 0.0)
        ramping = 0.5 * self.speed / self.ramp * t * t
        cruising = 0.5 * self.speed * self.ramp + self.speed * (t - self.ramp)
        return self.start + np.where(t < self.ramp, ramping, cruising)

    def pose_at(self, t):
        return self.path.pose_at(self.arc_at(t))


def raycast(walls: np.ndarray, origins: np.ndarray, angles: np.ndarray,
            max_range: float) -> np.ndarray:
    """Range of the first wall hit by each ray (inf where none within
    max_range). origins (K, 2), angles (K,)."""
    d = np.stack([np.cos(angles), np.sin(angles)], -1)[:, None, :]  # (K, 1, 2)
    p = walls[None, :, 0:2]
    e = walls[None, :, 2:4] - p  # (1, W, 2)
    o = origins[:, None, :]
    denom = d[..., 0] * e[..., 1] - d[..., 1] * e[..., 0]
    w = p - o
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (w[..., 0] * e[..., 1] - w[..., 1] * e[..., 0]) / denom
        u = (w[..., 0] * d[..., 1] - w[..., 1] * d[..., 0]) / denom
    hit = (np.abs(denom) > 1e-12) & (t > 1e-6) & (u >= 0.0) & (u <= 1.0) & (t <= max_range)
    return np.where(hit, t, np.inf).min(axis=1)


def simulate_scans(num_scans: int, beams: int = 1081, period: float = 0.1,
                   speed: float = 2.1, ramp: float = 6.0, max_range: float = 30.0,
                   fov: float = 2.0 * np.pi, noise: float = 0.005, seed: int = 0):
    """Scans of the floor plan along the path.

    Returns a list of (time [s] of the last beam, points (beams, 3), each in
    the sensor frame at its own beam time, beam times (beams,) relative to
    the last beam) and the ground-truth poses (num_scans, 3) [x, y, yaw] at
    each scan's time. Beams without a wall within max_range
    come back at max_range + 1 m, so the frontend treats them as misses.
    """
    rng = np.random.RandomState(seed)
    walls = floor_plan()
    robot = Robot(Path.superellipse(), speed, ramp)
    rel = np.linspace(-period, 0.0, beams)  # beam times relative to the scan time
    beam_angles = -0.5 * fov + fov * np.arange(beams) / beams
    scans, truth = [], []
    for i in range(num_scans):
        t_scan = (i + 1) * period
        xy, yaw = robot.pose_at(t_scan + rel)
        ranges = raycast(walls, xy, yaw + beam_angles, max_range)
        ranges = np.where(np.isfinite(ranges),
                          ranges + noise * rng.randn(beams), max_range + 1.0)
        points = np.zeros((beams, 3), np.float32)
        points[:, 0] = ranges * np.cos(beam_angles)
        points[:, 1] = ranges * np.sin(beam_angles)
        scans.append((t_scan, points, rel.astype(np.float32)))
        truth.append([xy[-1, 0], xy[-1, 1], yaw[-1]])
    return scans, np.asarray(truth)


def relative_to_first(truth: np.ndarray) -> np.ndarray:
    """Ground-truth poses expressed in the frame of the first one, which is
    the frontend's local frame."""
    x0, y0, a0 = truth[0]
    c, s = np.cos(-a0), np.sin(-a0)
    dx, dy = truth[:, 0] - x0, truth[:, 1] - y0
    return np.stack([c * dx - s * dy, s * dx + c * dy, truth[:, 2] - a0], -1)


def synthetic_pose_graph(num_submaps: int, num_nodes: int, constraint_slots: int,
                         seed: int = 0, outlier_share: float = 0.05, pose_noise: float = 0.1):
    """A pose-graph problem in the fields of the Schur SPA
    (`parallel.schur_spa.SchurSpaProblem2D`) as numpy arrays, with its truth.

    Nodes lie on a loop of laps; node n belongs to submap n * S // N and is
    tied to it and to the next submap (INTRA, the pose graph's weights);
    the remaining constraint slots are Huber-weighted loop closures between
    random nodes and submaps, `outlier_share` of them wrong by a metre; the
    consecutive nodes are tied by local-SLAM terms. Submap 0 is frozen. The
    initial poses are the truth plus `pose_noise` of Gaussian noise.
    Returns (arrays, truth_submaps (S, 3), truth_nodes (N, 3))."""
    from cartographer_tpu_torch.mapping.pose_graph_2d import _compose2d, _inverse2d

    rng = np.random.RandomState(seed)
    S, N = num_submaps, num_nodes
    t = np.linspace(0.0, 2.0 * np.pi * max(1, N // 300), N, endpoint=False)
    truth_n = np.stack([11.0 * np.cos(t), 7.0 * np.sin(t), t + np.pi / 2], -1)
    truth_s = truth_n[(np.arange(S) * N) // S] + np.array([0.3, -0.2, 0.05])
    owner = np.arange(N) * S // N
    a_intra = np.concatenate([owner, np.minimum(owner + 1, S - 1)])
    b_intra = np.concatenate([np.arange(N), np.arange(N)])
    n_inter = max(constraint_slots - a_intra.shape[0], 0)
    a = np.concatenate([a_intra, rng.randint(0, S, n_inter)])[:constraint_slots]
    b = np.concatenate([b_intra, rng.randint(0, N, n_inter)])[:constraint_slots]
    C = a.shape[0]
    inter = np.arange(C) >= a_intra.shape[0]
    rel = _compose2d(_inverse2d(truth_s[a]), truth_n[b]) + rng.normal(0.0, 0.01, (C, 3))
    wrong = inter & (rng.rand(C) < outlier_share)
    rel[wrong] += np.array([1.0, -0.7, 0.2])
    nn_rel = (_compose2d(_inverse2d(truth_n[:-1]), truth_n[1:])
              + rng.normal(0.0, 0.005, (N - 1, 3)))
    sub_fixed = np.zeros(S, bool)
    sub_fixed[0] = True
    arrays = dict(
        submap_poses=(truth_s + pose_noise * rng.normal(size=(S, 3)) * ~sub_fixed[:, None]
                      ).astype(np.float32),
        node_poses=(truth_n + pose_noise * rng.normal(size=(N, 3))).astype(np.float32),
        a_idx=a.astype(np.int32), b_idx=b.astype(np.int32), rel=rel.astype(np.float32),
        trans_weight=np.where(inter, 1.1e4, 5e2).astype(np.float32),
        rot_weight=np.where(inter, 1e5, 1.6e3).astype(np.float32),
        use_huber=inter, valid=np.ones(C, bool), j_idx=np.arange(N - 1, dtype=np.int32),
        nn_rel=nn_rel.astype(np.float32), nn_trans_weight=np.full(N - 1, 1e5, np.float32),
        nn_rot_weight=np.full(N - 1, 1e5, np.float32), nn_valid=np.ones(N - 1, bool),
        submap_fixed=sub_fixed, node_fixed=np.zeros(N, bool))
    return arrays, truth_s, truth_n


# ---------------------------------------------------------------- 3D

WALL_HEIGHT = 3.0  # the floor plan's walls and pillars, floor to ceiling
SENSOR_HEIGHT = 1.0  # the spinning sensor above the floor
GRAVITY = 9.81


def simulate_scans_3d(num_scans: int, rings: int = 16, azimuths: int = 256,
                      period: float = 0.1, speed: float = 1.4, ramp: float = 6.0,
                      max_range: float = 60.0, elevation: float = np.radians(15.0),
                      noise: float = 0.01, imu_rate: float = 100.0, scale: float = 0.5,
                      start: float = 3.0, seed: int = 0, intensities: bool = False):
    """A spinning multi-ring LiDAR and an IMU carried through the floor
    plan extruded to a hall `WALL_HEIGHT` high with floor and ceiling.

    The sensor, level and `SENSOR_HEIGHT` above the floor, turns once per
    `period`; at each of `azimuths` steps all `rings` beams (elevations from
    -`elevation` to +`elevation`) fire at the same time, so a scan has
    rings * azimuths returns with per-point times. The robot follows the
    closed path from rest up to `speed`, from `start` metres into it: in the
    path's first bend, where its heading, and with it the local frame of a
    frontend that starts there, is oblique to the walls. (Walls along the
    axes of the voxel grid put every return of a wall at the same offset
    within its cell, which biases the interpolated match toward the cell
    centers.) `scale` shrinks the floor plan: at half scale walls are near
    enough to dominate the returns. At full size (`scale=1.0`) most returns
    are rings on the floor and ceiling, which move with the sensor, and the
    default frontend (LM refinement of a constant-velocity prediction, no
    correlative search) falls behind the robot along the corridors, in this
    port as in the reference (tests/test_torch_local_slam_3d.py).

    Returns (scans, imu, truth): scans as (time [s] of the last beam, points
    (rings * azimuths, 3) each in the sensor frame at its own firing time,
    times relative to the last beam); imu as (time, linear acceleration
    (3,), angular velocity (3,)) at `imu_rate` from 0.05 s before the first
    beam, carrying gravity and the path's yaw rate; truth (num_scans, 3)
    [x, y, yaw] at each scan's time. Beams that hit nothing within
    max_range come back at max_range + 1 m.

    With `intensities`, each scan also carries a per-return intensity
    (rings * azimuths,) as its fourth element, drawn from its own seeded
    generator so the ranges stay those of the call without it: along the
    walls 22.5 + 12.5 sin(2 pi (x + y) / 1.5 m) of the hit's world
    position (10 to 35, a texture that pins the position along a
    corridor), 20 on the floor and 30 on the ceiling, 70 on the
    retro-reflective markers (the wall stretches where
    sin(2 pi (x - y) / 5.3 m) > 0.97), 0 for beams without a return; plus
    Gaussian noise of 0.5."""
    rng = np.random.RandomState(seed)
    intensity_rng = np.random.RandomState(seed + 1)
    walls = floor_plan(scale)
    robot = Robot(Path.superellipse(11.0 * scale, 7.0 * scale), speed, ramp, start)
    step = np.repeat(np.arange(azimuths), rings)
    rel = (-period + period * (step + 1) / azimuths)  # firing times, the last at 0
    azimuth = -np.pi + 2.0 * np.pi * step / azimuths
    elev = np.tile(np.linspace(-elevation, elevation, rings), azimuths)
    cos_e, sin_e, tan_e = np.cos(elev), np.sin(elev), np.tan(elev)
    scans, truth = [], []
    for i in range(num_scans):
        t_scan = (i + 1) * period
        xy, yaw = robot.pose_at(t_scan + rel)
        horizontal = raycast(walls, xy, yaw + azimuth, max_range)  # to the first wall
        wall_z = SENSOR_HEIGHT + horizontal * tan_e
        with np.errstate(divide="ignore"):
            ranges = np.where(wall_z < 0.0, SENSOR_HEIGHT / -sin_e,
                              np.where(wall_z > WALL_HEIGHT,
                                       (WALL_HEIGHT - SENSOR_HEIGHT) / sin_e,
                                       horizontal / cos_e))
        ranges = np.where(np.isfinite(ranges) & (ranges <= max_range),
                          ranges + noise * rng.randn(ranges.shape[0]), max_range + 1.0)
        points = np.stack([ranges * cos_e * np.cos(azimuth), ranges * cos_e * np.sin(azimuth),
                           ranges * sin_e], -1).astype(np.float32)
        scan = (t_scan, points, rel.astype(np.float32))
        if intensities:
            hit = xy + horizontal[:, None] * np.stack([np.cos(yaw + azimuth),
                                                       np.sin(yaw + azimuth)], -1)
            with np.errstate(invalid="ignore"):  # beams without a wall: inf
                wall = 22.5 + 12.5 * np.sin(2.0 * np.pi * (hit[:, 0] + hit[:, 1]) / 1.5)
                marker = np.sin(2.0 * np.pi * (hit[:, 0] - hit[:, 1]) / 5.3) > 0.97
            value = np.where(wall_z < 0.0, 20.0, np.where(wall_z > WALL_HEIGHT, 30.0,
                                                            np.where(marker, 70.0, wall)))
            value = np.where(ranges <= max_range, value, 0.0)
            scan += ((value + 0.5 * intensity_rng.randn(value.shape[0])).astype(np.float32),)
        scans.append(scan)
        truth.append([xy[-1, 0], xy[-1, 1], yaw[-1]])
    imu = []
    dt = 1.0 / imu_rate
    for k in range(int(round((num_scans * period + 0.05) * imu_rate)) + 1):
        t = -0.05 + k * dt
        (_, yaw0), (_, yaw1) = robot.pose_at(t - 0.5 * dt), robot.pose_at(t + 0.5 * dt)
        imu.append((t, np.array([0.0, 0.0, GRAVITY]),
                    np.array([0.0, 0.0, float(yaw1 - yaw0) / dt])))
    return scans, imu, np.asarray(truth)


def synthetic_pose_graph_3d(num_slots: int, num_nodes: int, constraint_slots: int,
                            seed: int = 0, outlier_share: float = 0.05,
                            pose_noise: float = 0.05, dt: float = 0.1):
    """An SE(3) pose-graph problem with IMU terms in the fields of the 3D
    Schur SPA (`parallel.schur_spa_3d.SchurSpaProblem3D`) as numpy arrays,
    with its truth.

    Nodes lie on laps of a loop that rises and falls, `dt` apart, their
    orientation the heading with a small roll and pitch. Of the
    `num_slots` reduced slots the last is the trajectory's IMU block
    (gravity 9.81 learned from 9.7 and clamped non-negative, an IMU
    calibration a degree off learned from the identity), the one before it
    a yaw-only fixed-frame origin tied to every 10th node, and the rest
    submaps: node n belongs to submap n * (num_slots - 2) // N and is tied
    to it and to the next (INTRA, the pose graph's weights); submap 0 is
    frozen. The remaining constraint slots are Huber-weighted loop closures
    between random nodes and submaps, `outlier_share` of them a metre wrong.
    The chain carries local-SLAM terms, a gyro term per consecutive pair and
    an acceleration triplet per consecutive triple, both exact for the
    truth, with the reference's weights. The initial poses are the truth
    plus `pose_noise` of Gaussian noise (a tenth of it in radians).
    Returns (arrays, truth node translations (N, 3), truth node rotations
    (N, 4))."""
    from cartographer_tpu_torch.transform import nquat

    rng = np.random.RandomState(seed)
    S, N = num_slots, num_nodes
    n_sub, origin_slot, imu_slot = S - 2, S - 2, S - 1
    s = np.linspace(0.0, 2.0 * np.pi * max(1, N // 1000), N, endpoint=False)
    truth_t = np.stack([11.0 * np.cos(s), 7.0 * np.sin(s), 0.3 * np.sin(3.0 * s)], -1)
    truth_q = np.stack([nquat.multiply(nquat.from_yaw(a + np.pi / 2), nquat.from_axis_angle(
        np.array([0.02 * np.sin(5 * a), 0.03 * np.cos(4 * a), 0.0]))) for a in s])

    def inv(t, q):
        iq = nquat.conjugate(q)
        return nquat.rotate(iq, -t), iq

    def comp(a, b):
        return a[0] + nquat.rotate(a[1], b[0]), nquat.normalize(nquat.multiply(a[1], b[1]))

    first = (np.arange(n_sub) * N) // n_sub
    sub_t = np.zeros((S, 3))
    sub_q = np.tile([1.0, 0.0, 0.0, 0.0], (S, 1))
    sub_t[:n_sub] = truth_t[first] + np.array([0.3, -0.2, 0.05])
    sub_q[:n_sub] = truth_q[first]
    sub_t[origin_slot] = [2.0, -1.0, 0.5]
    sub_q[origin_slot] = nquat.from_yaw(0.3)
    calib = nquat.from_axis_angle(np.radians([0.5, -0.4, 0.8]))
    gravity = 9.81

    owner = np.arange(N) * n_sub // N
    a_idx = list(owner) + list(np.minimum(owner + 1, n_sub - 1))
    b_idx = list(range(N)) * 2
    tw, rw, hub = [5e2] * (2 * N), [1.6e3] * (2 * N), [False] * (2 * N)
    fixes = list(range(0, N, 10))
    a_idx += [origin_slot] * len(fixes)
    b_idx += fixes
    tw += [1e1] * len(fixes)
    rw += [1e2] * len(fixes)
    hub += [False] * len(fixes)
    n_loop = max(constraint_slots - len(a_idx), 0)
    a_idx += list(rng.randint(0, n_sub, n_loop))
    b_idx += list(rng.randint(0, N, n_loop))
    tw += [1.1e4] * n_loop
    rw += [1e5] * n_loop
    hub += [True] * n_loop
    a_idx, b_idx = np.asarray(a_idx[:constraint_slots]), np.asarray(b_idx[:constraint_slots])
    C = a_idx.shape[0]
    rel = [comp(inv(sub_t[a], sub_q[a]), (truth_t[b], truth_q[b])) for a, b in zip(a_idx, b_idx)]
    rel_t = np.asarray([r[0] for r in rel]) + rng.normal(0.0, 0.01, (C, 3))
    rel_q = np.asarray([r[1] for r in rel])
    wrong = np.asarray(hub[:C]) & (rng.rand(C) < outlier_share)
    rel_t[wrong] += np.array([1.0, -0.7, 0.2])
    nn = [comp(inv(truth_t[j], truth_q[j]), (truth_t[j + 1], truth_q[j + 1]))
          for j in range(N - 1)]
    rot_dq = [nquat.multiply(nquat.conjugate(calib), nquat.multiply(
        nquat.multiply(nquat.conjugate(truth_q[i]), truth_q[i + 1]), calib))
        for i in range(N - 1)]
    acc_dv = []
    for i in range(N - 2):
        second = (truth_t[i + 2] - truth_t[i + 1]) / dt - (truth_t[i + 1] - truth_t[i]) / dt
        v = second + np.array([0.0, 0.0, gravity * dt])
        acc_dv.append(nquat.rotate(nquat.conjugate(calib),
                                   nquat.rotate(nquat.conjugate(truth_q[i + 1]), v)))
    sub_free = np.ones((S, 6), bool)
    sub_free[0] = False
    sub_free[origin_slot] = [True, True, True, False, False, True]
    sub_free[imu_slot] = [True, False, False, True, True, True]
    grav_clamp = np.zeros(S, bool)
    grav_clamp[imu_slot] = True
    init_sub_t, init_sub_q = sub_t.copy(), sub_q.copy()
    init_sub_t[1:n_sub] += pose_noise * rng.normal(size=(n_sub - 1, 3))
    init_sub_t[imu_slot] = [9.7, 0.0, 0.0]
    init_q = np.stack([nquat.normalize(nquat.multiply(q, nquat.from_axis_angle(
        0.1 * pose_noise * rng.normal(size=3)))) for q in truth_q])
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    arrays = dict(
        sub_t=f32(init_sub_t), sub_q=f32(init_sub_q),
        node_t=f32(truth_t + pose_noise * rng.normal(size=(N, 3))), node_q=f32(init_q),
        sub_free=sub_free, node_free=np.ones((N, 6), bool), grav_clamp=grav_clamp,
        a_idx=a_idx.astype(np.int32), b_idx=b_idx.astype(np.int32), rel_t=f32(rel_t),
        rel_q=f32(rel_q), trans_weight=f32(tw[:C]), rot_weight=f32(rw[:C]),
        use_huber=np.asarray(hub[:C]), valid=np.ones(C, bool),
        j_idx=np.arange(N - 1, dtype=np.int32), nn_rel_t=f32([r[0] for r in nn]),
        nn_rel_q=f32([r[1] for r in nn]), nn_trans_weight=f32(np.full(N - 1, 1e5)),
        nn_rot_weight=f32(np.full(N - 1, 1e5)), nn_valid=np.ones(N - 1, bool),
        rot_i=np.arange(N - 1, dtype=np.int32), rot_traj=np.full(N - 1, imu_slot, np.int32),
        rot_delta_q=f32(rot_dq), rot_weight_c=f32(np.full(N - 1, 1.6e4 / dt)),
        rot_valid=np.ones(N - 1, bool),
        acc_i=np.arange(N - 2, dtype=np.int32), acc_traj=np.full(N - 2, imu_slot, np.int32),
        acc_delta_v=f32(acc_dv), acc_dt1=f32(np.full(N - 2, dt)),
        acc_dt2=f32(np.full(N - 2, dt)), acc_weight=f32(np.full(N - 2, 1.1e2 / (2 * dt))),
        acc_valid=np.ones(N - 2, bool))
    return arrays, truth_t, truth_q
