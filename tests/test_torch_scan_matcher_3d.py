"""The port's 3D scan matcher (plain twin of kernel K11) against the JAX
package: trilinear interpolation, the analytic Jacobian against jax.jacfwd
of the JAX residual, the LM solve with a retraction, and the match."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cartographer_tpu.ops.gauss_newton import lm_solve as j_lm_solve
from cartographer_tpu.ops.grid_3d import Grid3D as JGrid3D
from cartographer_tpu.ops.interp import interp_trilinear as j_interp_trilinear
from cartographer_tpu.ops.paged_grid_3d import PagedSubmapGrid3D as JPaged
from cartographer_tpu.ops.scan_matcher_3d import (
    GaussNewtonMatcherParams3D as JParams,
    _occupied_residuals as j_occupied_residuals,
    gauss_newton_match_3d as j_match,
    se3_retract as j_retract,
)
from cartographer_tpu.transform import quaternion as jquat
from cartographer_tpu.transform.rigid import Rigid3 as JRigid3
from cartographer_tpu_torch.interop import grid3d_from_numpy
from cartographer_tpu_torch.ops.gauss_newton import lm_solve
from cartographer_tpu_torch.ops.interp import interp_trilinear
from cartographer_tpu_torch.ops.scan_matcher_3d import (
    GaussNewtonMatcherParams3D,
    gauss_newton_match_3d,
    residuals_and_jacobian_3d,
    se3_retract,
)
from cartographer_tpu_torch.transform.rigid import Rigid3

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_interp_trilinear_matches_jax():
    rng = np.random.RandomState(0)
    grid = rng.rand(12, 10, 14).astype(np.float32)
    coords = rng.uniform(-2.0, 16.0, (300, 3)).astype(np.float32)  # some beyond the border
    ref = np.asarray(j_interp_trilinear(jnp.asarray(grid), jnp.asarray(coords)))
    got = interp_trilinear(_t(grid), _t(coords)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def _room_cloud(rng, n):
    """Points on the walls and the floor of a 6 x 5 x 2.5 m room."""
    side = rng.randint(5, size=n)
    u, v = rng.uniform(-1, 1, n), rng.uniform(-1, 1, n)
    pts = np.where((side == 0)[:, None], np.stack([np.full(n, 3.01), 2.5 * u, 1.25 * v], -1),
          np.where((side == 1)[:, None], np.stack([np.full(n, -2.98), 2.5 * u, 1.25 * v], -1),
          np.where((side == 2)[:, None], np.stack([3 * u, np.full(n, 2.52), 1.25 * v], -1),
          np.where((side == 3)[:, None], np.stack([3 * u, np.full(n, -2.49), 1.25 * v], -1),
                   np.stack([3 * u, 2.5 * v, np.full(n, -1.23)], -1)))))
    c, s = np.cos(0.3), np.sin(0.3)  # off the grid axes
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return (pts @ rot.T).astype(np.float32)


def _grids(seed=1):
    """A high- and a low-resolution dense window around the origin, cropped
    from paged grids the JAX package filled with scans of the room."""
    rng = np.random.RandomState(seed)
    world = _room_cloud(rng, 6000)
    center = np.zeros(3, np.float32)
    out = []
    for res, size in ((0.2, 48), (0.5, 32)):
        paged = JPaged(res, center, page_size=8, max_pages=512, num_blocks=16)
        for k in range(3):
            part = world[k::3]
            paged.insert_range_data(np.float32([0.05 * k, 0.02, 0.01]), part,
                                    np.ones(len(part), bool))
        out.append(paged.crop_dense(center, size))
    return out, world


def _port_grid(g: JGrid3D):
    return grid3d_from_numpy(np.asarray(g.log_odds), np.asarray(g.known), np.asarray(g.origin),
                             g.resolution, "cpu")


def _clouds(world, rng, nh=256, nl=384):
    hp = world[rng.choice(len(world), nh, replace=False)]
    lp = world[rng.choice(len(world), nl, replace=False)]
    return hp, rng.rand(nh) < 0.9, lp, rng.rand(nl) < 0.9


def _quat(axis_angle):
    return np.asarray(jquat.from_axis_angle(jnp.asarray(axis_angle, jnp.float32)))


@pytest.mark.parametrize("yaw_only", [False, True])
@pytest.mark.parametrize("offset", [
    [0.0, 0.0, 0.0],        # at the target: the small branch of the log map
    [0.004, -0.003, 0.005],  # near it
    [0.3, -0.2, 0.5],        # far from it
    [1.9, -1.2, 1.6],        # beyond pi / 2 from it: w of the error quaternion small
])
def test_jacobian_matches_jacfwd(yaw_only, offset):
    (jh, jl), world = _grids()
    rng = np.random.RandomState(2)
    hp, hm, lp, lm = _clouds(world, rng)
    q_target = _quat([0.02, -0.01, 0.1])
    q = np.asarray(jquat.normalize(jquat.multiply(jnp.asarray(q_target), jnp.asarray(
        _quat(offset)))))
    t = np.float32([0.07, -0.05, 0.03])
    t_target = np.float32([0.05, -0.02, 0.0])
    jparams = JParams(only_optimize_yaw=yaw_only)
    hprob, lprob = jh.probability(), jl.probability()

    def residual_fn(pose):
        dq = jquat.multiply(jquat.conjugate(jnp.asarray(q_target)), pose.rotation)
        return jnp.concatenate([
            j_occupied_residuals(hprob, jh, jnp.asarray(hp), jnp.asarray(hm), pose,
                                 jparams.occupied_space_weight_0),
            j_occupied_residuals(lprob, jl, jnp.asarray(lp), jnp.asarray(lm), pose,
                                 jparams.occupied_space_weight_1),
            jparams.translation_weight * (pose.translation - jnp.asarray(t_target)),
            jparams.rotation_weight * jquat.to_axis_angle(dq)])

    def local(delta):
        if yaw_only:
            delta = jnp.concatenate([delta[0:3], jnp.zeros(2), delta[3:4]])
        return residual_fn(j_retract(JRigid3(jnp.asarray(t), jnp.asarray(q)), delta))

    dim = 4 if yaw_only else 6
    ref_r = np.asarray(local(jnp.zeros(dim)))
    ref_j = np.asarray(jax.jacfwd(local)(jnp.zeros(dim, jnp.float32)))

    params = GaussNewtonMatcherParams3D(only_optimize_yaw=yaw_only)
    r, jac = residuals_and_jacobian_3d(
        _port_grid(jh), _port_grid(jl), _t(hp), _t(hm), _t(lp), _t(lm),
        _t(np.concatenate([t, q]).astype(np.float32)), _t(t_target), _t(q_target), params)
    np.testing.assert_allclose(r.numpy(), ref_r, atol=2e-4 * max(1.0, np.abs(ref_r).max()),
                               rtol=0)
    # The rotation penalty's rows carry the weight 400: relative to it.
    scale = np.maximum(np.abs(ref_j).max(axis=1, keepdims=True), 1.0)
    np.testing.assert_allclose(jac.numpy() / scale, ref_j / scale, atol=1e-4, rtol=0)
    assert np.abs(ref_j[:-6]).max() > 1e-3  # the occupied-space rows are live


@pytest.mark.parametrize("yaw_only,nonmonotonic", [(False, False), (True, False),
                                                   (False, True)])
def test_match_matches_jax(yaw_only, nonmonotonic):
    (jh, jl), world = _grids()
    rng = np.random.RandomState(3)
    hp, hm, lp, lm = _clouds(world, rng)
    t0 = np.float32([0.12, -0.09, 0.04])
    q0 = _quat([0.0, 0.0, 0.03] if yaw_only else [0.01, -0.015, 0.03])
    kw = dict(num_iterations=6, only_optimize_yaw=yaw_only,
              use_nonmonotonic_steps=nonmonotonic)
    ref_pose, ref_cost = j_match(
        jh, jl, jnp.asarray(hp), jnp.asarray(hm), jnp.asarray(lp), jnp.asarray(lm),
        JRigid3(jnp.asarray(t0), jnp.asarray(q0)), JParams(**kw))
    pose, cost = gauss_newton_match_3d(
        _port_grid(jh), _port_grid(jl), _t(hp), _t(hm), _t(lp), _t(lm),
        Rigid3(_t(t0), _t(q0)), GaussNewtonMatcherParams3D(**kw))
    np.testing.assert_allclose(pose.translation.numpy(), np.asarray(ref_pose.translation),
                               atol=1e-3, rtol=0)
    dq = jquat.multiply(jquat.conjugate(ref_pose.rotation), jnp.asarray(pose.rotation.numpy()))
    assert float(jquat.get_angle(dq)) < 1e-3
    np.testing.assert_allclose(float(cost), float(ref_cost), rtol=1e-3, atol=0)
    # The match moved toward the truth (the identity pose) against the
    # penalties that hold it at the start.
    assert np.linalg.norm(pose.translation.numpy()) < np.linalg.norm(t0)


def test_lm_solve_with_a_retract():
    """A rotation that maps one set of vectors onto another, found on the
    quaternion manifold with the retraction q * exp(delta)."""
    rng = np.random.RandomState(4)
    v = rng.normal(size=(20, 3)).astype(np.float32)
    q_true = _quat([0.2, -0.3, 0.4])
    w = np.asarray(jquat.rotate(jnp.asarray(q_true), jnp.asarray(v)))
    q0 = np.float32([1.0, 0.0, 0.0, 0.0])

    def j_residual(q):
        return (jquat.rotate(q, jnp.asarray(v)) - jnp.asarray(w)).reshape(-1)

    def j_ret(q, d):
        return jquat.normalize(jquat.multiply(q, jquat.from_axis_angle(d)))

    ref, ref_cost, _ = j_lm_solve(j_residual, jnp.asarray(q0), retract_fn=j_ret, tangent_dim=3,
                                  num_iterations=15)

    from cartographer_tpu_torch.transform import quaternion as quat
    tv, tw = _t(v), _t(w)

    def residual_and_jacobian(q):
        rotated = quat.rotate(q, tv)
        # d (R exp(delta) v) / d delta = -R [v]x: column k is R (e_k x v).
        cols = [quat.rotate(q, torch.linalg.cross(torch.eye(3)[k].expand_as(tv), tv))
                for k in range(3)]
        return (rotated - tw).reshape(-1), torch.stack(cols, dim=-1).reshape(-1, 3)

    def retract(q, d):
        return quat.normalize(quat.multiply(q, quat.from_axis_angle(d)))

    got, cost, iterations = lm_solve(residual_and_jacobian, _t(q0), retract_fn=retract,
                                     tangent_dim=3, num_iterations=15)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), q_true, atol=1e-5, rtol=0)
    assert float(cost) < 1e-9 and float(ref_cost) < 1e-9 and 0 < int(iterations) <= 15
    with pytest.raises(ValueError, match="tangent_dim"):
        lm_solve(residual_and_jacobian, _t(q0), retract_fn=retract)


def test_se3_retract_matches_jax():
    rng = np.random.RandomState(5)
    t, q = rng.normal(size=3).astype(np.float32), _quat([0.3, 0.1, -0.5])
    for delta in (np.zeros(6), 1e-7 * rng.normal(size=6), rng.normal(size=6)):
        delta = delta.astype(np.float32)
        ref = j_retract(JRigid3(jnp.asarray(t), jnp.asarray(q)), jnp.asarray(delta))
        got = se3_retract(_t(np.concatenate([t, q])), _t(delta)).numpy()
        np.testing.assert_allclose(got[:3], np.asarray(ref.translation), atol=1e-6, rtol=0)
        np.testing.assert_allclose(got[3:], np.asarray(ref.rotation), atol=1e-6, rtol=0)
