"""Host-side float64 quaternion helpers (numpy, (w, x, y, z)).

The sequential sensor-rate state machines (ImuTracker, PoseExtrapolator) run
on the host in double precision — per-sample dispatch to the device would be
latency-bound and the reference also runs these in double (Eigen::Quaterniond).
"""

from __future__ import annotations

import numpy as np

IDENTITY = np.array([1.0, 0.0, 0.0, 0.0])


def normalize(q):
    return q / np.linalg.norm(q)


def multiply(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def conjugate(q):
    return np.array([q[0], -q[1], -q[2], -q[3]])


def _cross(a, b):
    """Cross product of two 3-vectors; np.cross spends tens of microseconds
    on axis bookkeeping, which the IMU-rate callers pay per message."""
    return np.array([a[1] * b[2] - a[2] * b[1],
                     a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0]])


def rotate(q, v):
    qv = q[1:4]
    t = 2.0 * _cross(qv, v)
    return v + q[0] * t + _cross(qv, t)


def from_axis_angle(aa):
    angle = np.linalg.norm(aa)
    if angle < 1e-12:
        return np.array([1.0, 0.5 * aa[0], 0.5 * aa[1], 0.5 * aa[2]])
    axis = aa / angle
    s = np.sin(0.5 * angle)
    return np.array([np.cos(0.5 * angle), s * axis[0], s * axis[1], s * axis[2]])


def to_axis_angle(q):
    q = -q if q[0] < 0 else q
    vnorm = np.linalg.norm(q[1:4])
    if vnorm < 1e-12:
        return 2.0 * q[1:4] / max(q[0], 1e-12)
    angle = 2.0 * np.arctan2(vnorm, q[0])
    return q[1:4] / vnorm * angle


def from_two_vectors(a, b):
    """Rotation taking a to b (Eigen FromTwoVectors)."""
    an = np.linalg.norm(a)
    bn = np.linalg.norm(b)
    if an < 1e-12 or bn < 1e-12:
        return IDENTITY.copy()
    a = a / an
    b = b / bn
    c = _cross(a, b)
    w = 1.0 + np.dot(a, b)
    if w < 1e-8:
        ortho = _cross(a, [1.0, 0.0, 0.0] if abs(a[0]) < 0.9 else [0.0, 1.0, 0.0])
        return normalize(np.array([0.0, *ortho]))
    return normalize(np.array([w, *c]))


def get_yaw(q):
    w, x, y, z = q
    return np.arctan2(2 * (x * y + w * z), 1 - 2 * (y * y + z * z))


def from_yaw(yaw):
    return np.array([np.cos(0.5 * yaw), 0.0, 0.0, np.sin(0.5 * yaw)])


def angle(q):
    return 2.0 * np.arctan2(np.linalg.norm(q[1:4]), abs(q[0]))
