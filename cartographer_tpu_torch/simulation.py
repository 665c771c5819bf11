"""A simulated 2D LiDAR robot in a multi-room floor plan (numpy only).

Used to drive the 2D frontend end to end where no recorded data is at
hand: a floor plan of wall segments, a closed smooth path through its
rooms driven with a speed ramp from rest, and a rotating range sensor whose
beams are fired at successive times along the path (so scans carry the
motion distortion the frontend's unwarp removes).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


def floor_plan() -> np.ndarray:
    """Wall segments (W, 4) [x0, y0, x1, y1] of a 36 m x 20 m floor: outer
    walls, a central block of rooms, dividing walls with doorways where the
    path crosses them, and pillars."""
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
    return np.asarray(walls, np.float64)


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
    """Speed ramp from rest to `speed` m/s over `ramp` seconds along `path`."""

    path: Path
    speed: float
    ramp: float

    def arc_at(self, t: np.ndarray) -> np.ndarray:
        t = np.maximum(np.asarray(t, np.float64), 0.0)
        ramping = 0.5 * self.speed / self.ramp * t * t
        cruising = 0.5 * self.speed * self.ramp + self.speed * (t - self.ramp)
        return np.where(t < self.ramp, ramping, cruising)

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
