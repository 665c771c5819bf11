"""The port's transforms and PointCloud.compact against the JAX package
(atol 1e-6), on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cartographer_tpu.sensor.point_cloud import PointCloud as JPointCloud
from cartographer_tpu.transform import quaternion as jquat
from cartographer_tpu.transform.interpolation import interpolate_rigid3 as j_interpolate
from cartographer_tpu.transform.rigid import Rigid2 as JRigid2, Rigid3 as JRigid3
from cartographer_tpu_torch.sensor.point_cloud import PointCloud
from cartographer_tpu_torch.transform import quaternion as quat
from cartographer_tpu_torch.transform.interpolation import interpolate_rigid3
from cartographer_tpu_torch.transform.rigid import Rigid2, Rigid3

ATOL = 1e-6


def _unit_quats(rng, n):
    q = rng.randn(n, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", ["generic", "opposite_hemisphere", "nearly_parallel"])
def test_slerp(case):
    rng = np.random.RandomState(0)
    a = _unit_quats(rng, 64)
    if case == "generic":
        b = _unit_quats(rng, 64)
    elif case == "opposite_hemisphere":
        b = -a + 0.05 * rng.randn(64, 4).astype(np.float32)
        b /= np.linalg.norm(b, axis=-1, keepdims=True)
    else:
        b = a.copy()
    t = rng.uniform(0, 1, 64).astype(np.float32)
    _close(quat.slerp(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(t)),
           jquat.slerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(t)))


def test_interpolate_rigid3():
    rng = np.random.RandomState(1)
    ts, te = rng.randn(3).astype(np.float32), rng.randn(3).astype(np.float32)
    qs, qe = _unit_quats(rng, 2)
    f = rng.uniform(0, 1, 50).astype(np.float32)
    port = interpolate_rigid3(
        Rigid3(torch.from_numpy(ts)[None], torch.from_numpy(qs)[None]),
        Rigid3(torch.from_numpy(te)[None], torch.from_numpy(qe)[None]), torch.from_numpy(f))
    ref = j_interpolate(JRigid3(jnp.asarray(ts)[None], jnp.asarray(qs)[None]),
                        JRigid3(jnp.asarray(te)[None], jnp.asarray(qe)[None]), jnp.asarray(f))
    _close(port.translation, ref.translation)
    _close(port.rotation, ref.rotation)


@pytest.mark.parametrize("op", ["apply", "compose", "inverse"])
def test_rigid2(op):
    rng = np.random.RandomState(2)
    va, vb = rng.randn(3).astype(np.float32), rng.randn(3).astype(np.float32)
    pts = rng.randn(40, 2).astype(np.float32)
    a, b = Rigid2.from_vector(torch.from_numpy(va)), Rigid2.from_vector(torch.from_numpy(vb))
    ja, jb = JRigid2.from_vector(jnp.asarray(va)), JRigid2.from_vector(jnp.asarray(vb))
    if op == "apply":
        _close(a.apply(torch.from_numpy(pts)), ja.apply(jnp.asarray(pts)))
    elif op == "compose":
        _close(a.compose(b).to_vector(), ja.compose(jb).to_vector())
    else:
        _close(a.inverse().to_vector(), ja.inverse().to_vector())


@pytest.mark.parametrize("op", ["apply", "compose", "inverse"])
def test_rigid3(op):
    rng = np.random.RandomState(3)
    (qa, qb), ta, tb = _unit_quats(rng, 2), rng.randn(3).astype(np.float32), \
        rng.randn(3).astype(np.float32)
    pts = rng.randn(40, 3).astype(np.float32)
    a = Rigid3(torch.from_numpy(ta), torch.from_numpy(qa))
    b = Rigid3(torch.from_numpy(tb), torch.from_numpy(qb))
    ja, jb = JRigid3(jnp.asarray(ta), jnp.asarray(qa)), JRigid3(jnp.asarray(tb), jnp.asarray(qb))
    if op == "apply":
        _close(a.apply(torch.from_numpy(pts)), ja.apply(jnp.asarray(pts)))
    else:
        port = a.compose(b) if op == "compose" else a.inverse()
        ref = ja.compose(jb) if op == "compose" else ja.inverse()
        _close(port.translation, ref.translation)
        _close(port.rotation, ref.rotation)


def test_compact():
    rng = np.random.RandomState(4)
    pts = rng.randn(96, 2).astype(np.float32)
    mask = rng.rand(96) < 0.4
    inten = rng.rand(96).astype(np.float32)
    port = PointCloud(torch.from_numpy(pts), torch.from_numpy(mask),
                      torch.from_numpy(inten)).compact(32)
    ref = JPointCloud(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(inten)).compact(32)
    _close(port.points, ref.points)
    _close(port.intensities, ref.intensities)
    np.testing.assert_array_equal(port.mask.numpy(), np.asarray(ref.mask))


def _axis_angles(case):
    rng = np.random.RandomState(5)
    axes = rng.randn(32, 3).astype(np.float32)
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    angle = {"zero": 0.0, "tiny": 3e-7, "small": 1e-3, "generic": 1.3,
             "near_pi": np.pi - 1e-3}[case]
    return (angle * axes).astype(np.float32)


@pytest.mark.parametrize("case", ["zero", "tiny", "small", "generic", "near_pi"])
def test_axis_angle_maps(case):
    aa = _axis_angles(case)
    q = jquat.from_axis_angle(jnp.asarray(aa))
    port_q = quat.from_axis_angle(torch.from_numpy(aa))
    _close(port_q, q)
    # Near pi the log map divides a small w into atan2: 1e-6 of the angle.
    back = quat.to_axis_angle(port_q)
    np.testing.assert_allclose(back.numpy(), np.asarray(jquat.to_axis_angle(q)), atol=4e-6,
                               rtol=0)
    np.testing.assert_allclose(back.numpy(), aa, atol=2e-5, rtol=0)
    # q and -q are the same rotation: the hemisphere flip.
    _close(quat.to_axis_angle(-port_q), jquat.to_axis_angle(-q))


def test_get_yaw():
    rng = np.random.RandomState(6)
    q = _unit_quats(rng, 64)
    _close(quat.get_yaw(torch.from_numpy(q)), jquat.get_yaw(jnp.asarray(q)))
    yaw = torch.tensor([0.7, -2.9])
    np.testing.assert_allclose(quat.get_yaw(quat.from_yaw(yaw)).numpy(), yaw.numpy(), atol=1e-6)
