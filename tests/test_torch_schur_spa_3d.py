"""The port's SE(3) residual Jacobians and Schur SPA (plain twin of kernel
K16) against the JAX package."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from cartographer_tpu.parallel import schur_spa_3d as jss
from cartographer_tpu.transform import nquat
from cartographer_tpu_torch.interop import schur_problem_3d_from_numpy
from cartographer_tpu_torch.ops import spa_3d
from cartographer_tpu_torch.parallel import schur_spa_3d as tss
from cartographer_tpu_torch.parallel.schur_spa import cyclic_reduction_solve
from cartographer_tpu_torch.simulation import synthetic_pose_graph_3d

from test_schur_spa_3d import _wavy_problem

torch.set_num_threads(1)


def _quats(rng, n):
    q = rng.randn(n, 4)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _family(name, rng, n=24):
    """(JAX local function, tangent count, data arrays, port Jacobian fn)."""
    f = lambda *s: rng.randn(n, *s).astype(np.float32)  # noqa: E731
    pos = lambda: (0.05 + rng.rand(n) * 0.2).astype(np.float32)  # noqa: E731
    if name == "binary":
        data = (f(3), _quats(rng, n), f(3), _quats(rng, n), f(3), _quats(rng, n), pos(), pos())
        return jss._bin_local, 2, data, spa_3d.constraint_jacobians_3d
    if name == "rotation":
        data = (_quats(rng, n), _quats(rng, n), _quats(rng, n), _quats(rng, n), pos())
        return jss._rot_local, 3, data, spa_3d.rotation_jacobians_3d
    data = (f(3), f(3), f(3), _quats(rng, n), (9.5 + rng.rand(n)).astype(np.float32),
            _quats(rng, n), f(3), pos(), pos(), pos())
    return jss._acc_local, 4, data, spa_3d.acceleration_jacobians_3d


@pytest.mark.parametrize("name", ["binary", "rotation", "acceleration"])
def test_jacobians_match_jacfwd(name):
    rng = np.random.RandomState(len(name))
    fn, k, data, port = _family(name, rng)
    zero = jnp.zeros(6)
    axes = (None,) * k + (0,) * len(data)
    ref_r = np.asarray(jax.jit(jax.vmap(fn, in_axes=axes))(*(zero,) * k, *data))
    ref = [np.asarray(jax.jit(jax.vmap(jax.jacfwd(fn, argnums=a), in_axes=axes))(
        *(zero,) * k, *data)) for a in range(k)]
    r, jac = port(*(torch.from_numpy(d) for d in data))
    np.testing.assert_allclose(r.numpy(), ref_r, atol=1e-5)
    for got, want in zip(jac, ref):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def _imu_problem(seed=0, N=32, S=4):
    """The wavy problem of the JAX tests with a trajectory IMU slot (gravity
    clamped, calibration learned), gyro terms and acceleration triplets
    consistent with the truth, a yaw-only slot, and two loop closures a
    metre wrong (Huber)."""
    prob, gt_t, gt_q, init_t = _wavy_problem(N=N, S=S, seed=seed)
    a = {f.name: np.array(getattr(prob, f.name)) for f in dataclasses.fields(prob)}
    rng = np.random.RandomState(seed + 10)
    dt = 0.3
    calib = nquat.normalize(np.array([1.0, 0.02, -0.01, 0.03]))
    gravity = 9.81
    traj = S
    a["sub_t"] = np.concatenate([a["sub_t"], [[9.7, 0.0, 0.0]]]).astype(np.float32)
    a["sub_q"] = np.concatenate([a["sub_q"], [[1.0, 0.0, 0.0, 0.0]]]).astype(np.float32)
    a["sub_free"] = np.concatenate([a["sub_free"], [[True, False, False, True, True, True]]])
    a["sub_free"][1] = [True, True, True, False, False, True]  # yaw-only
    a["grav_clamp"] = np.concatenate([a["grav_clamp"], [True]])
    loops = np.where(a["use_huber"] & a["valid"])[0]
    a["rel_t"][loops[:2]] += np.array([1.0, -0.6, 0.3], np.float32)
    rot_dq = [nquat.multiply(nquat.conjugate(calib), nquat.multiply(
        nquat.multiply(nquat.conjugate(gt_q[i]), gt_q[i + 1]), calib)) for i in range(N - 1)]
    acc_dv = []
    for i in range(N - 2):
        second = (gt_t[i + 2] - gt_t[i + 1]) / dt - (gt_t[i + 1] - gt_t[i]) / dt
        v = second + np.array([0.0, 0.0, gravity * dt])
        acc_dv.append(nquat.rotate(nquat.conjugate(calib),
                                   nquat.rotate(nquat.conjugate(gt_q[i + 1]), v)))
    noise = rng.randn(N - 2, 3) * 0.002
    a.update(
        rot_i=np.arange(N - 1, dtype=np.int32), rot_traj=np.full(N - 1, traj, np.int32),
        rot_delta_q=np.asarray(rot_dq, np.float32),
        rot_weight_c=np.full(N - 1, 1.6e4 / dt, np.float32), rot_valid=np.ones(N - 1, bool),
        acc_i=np.arange(N - 2, dtype=np.int32), acc_traj=np.full(N - 2, traj, np.int32),
        acc_delta_v=(np.asarray(acc_dv) + noise).astype(np.float32),
        acc_dt1=np.full(N - 2, dt, np.float32), acc_dt2=np.full(N - 2, dt, np.float32),
        acc_weight=np.full(N - 2, 1.1e2 / (2 * dt), np.float32),
        acc_valid=np.ones(N - 2, bool))
    return a, gt_t


def _jax_problem(arrays):
    return jss.SchurSpaProblem3D(**{k: jnp.asarray(v) for k, v in arrays.items()})


def test_assemble_matches_jax():
    arrays, _ = _imu_problem()
    jp = _jax_problem(arrays)
    tp = schur_problem_3d_from_numpy(arrays, "cpu")
    hs = 10.0 / 1e3
    ref = jax.jit(jss._assemble_local, static_argnums=5)(jp.sub_t, jp.sub_q, jp.node_t,
                                                        jp.node_q, jp, hs)
    got = tss.assemble(tp.sub_t, tp.sub_q, tp.node_t, tp.node_q, tp, hs)
    for name, g, r in zip(("A", "d0", "u1", "u2", "g_s", "g_n", "Bc", "ae", "be"), got, ref):
        r = np.asarray(r)
        scale = max(float(np.abs(r).max()), 1e-6)
        np.testing.assert_allclose(g.numpy(), r, atol=1e-4 * scale, rtol=1e-4, err_msg=name)
    c_ref = float(jax.jit(jss._cost_local, static_argnums=5)(jp.sub_t, jp.sub_q, jp.node_t,
                                                             jp.node_q, jp, hs))
    c_got = float(tss.cost(tp.sub_t, tp.sub_q, tp.node_t, tp.node_q, tp, hs))
    assert abs(c_got - c_ref) <= 1e-4 * abs(c_ref)


@pytest.mark.parametrize("n_nodes,iterations", [(32, 50), (31, 10)])
def test_solve_matches_jax(n_nodes, iterations):
    """50 iterations of the twin against the JAX solver on one device; an
    odd node count pads to even."""
    arrays, _ = _imu_problem(N=n_nodes)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("pairs",))
    ref = jss.solve_spa_3d_schur(mesh, _jax_problem(arrays), num_iterations=iterations)
    got = tss.solve_spa_3d_schur(schur_problem_3d_from_numpy(arrays, "cpu"),
                                 num_iterations=iterations)
    s_t, s_q, n_t, n_q = (np.asarray(x) for x in ref)
    np.testing.assert_allclose(got[0].numpy(), s_t, atol=1e-3)
    np.testing.assert_allclose(got[2].numpy(), n_t, atol=1e-3)
    for q_got, q_ref in ((got[1].numpy(), s_q), (got[3].numpy(), n_q)):
        dot = np.abs(np.sum(q_got * q_ref, -1)).clip(max=1.0)
        assert np.max(2 * np.arccos(dot)) < 1e-3
    assert got[0][-1, 0] >= 0.0 and np.isfinite(n_t).all()  # the clamped gravity slot


def test_synthetic_pose_graph_3d_recovers_truth():
    arrays, truth_t, truth_q = synthetic_pose_graph_3d(8, 96, 320, seed=1)
    p = schur_problem_3d_from_numpy(arrays, "cpu")
    init_err = np.abs(arrays["node_t"] - truth_t).mean()
    _, _, n_t, n_q = tss.solve_spa_3d_schur(p, num_iterations=30)
    err = np.abs(n_t.numpy() - truth_t).mean()
    assert err < 0.1 * init_err, (err, init_err)
    # Every family is present, with frozen, yaw-only and gravity slots.
    assert arrays["rot_valid"].sum() == 95 and arrays["acc_valid"].sum() == 94
    assert (~arrays["sub_free"].any(1)).sum() >= 1 and arrays["grav_clamp"].sum() == 1
    assert arrays["use_huber"].sum() > 0


def _band_system(n, width, seed):
    """A damped block-tridiagonal system of n 12x12 super-blocks as the
    solver builds it: each block's own rank-6 term, a 12 x 24 Jacobian's
    J^T J on each consecutive pair, lambda |diag| + damping on the diagonal
    (1e-4, 1e-6); and a right-hand side of `width` columns. -> (T float64,
    Td, To, rhs float32)."""
    rng = np.random.RandomState(seed)
    T = np.zeros((12 * n, 12 * n))
    for i in range(n):
        R = rng.randn(6, 12)
        T[12 * i:12 * i + 12, 12 * i:12 * i + 12] += R.T @ R
    for i in range(n - 1):
        J = rng.randn(12, 24)
        T[12 * i:12 * i + 24, 12 * i:12 * i + 24] += J.T @ J
    T[np.diag_indices_from(T)] += 1e-4 * np.abs(np.diag(T)) + 1e-6
    Td = np.stack([T[12 * i:12 * i + 12, 12 * i:12 * i + 12] for i in range(n)])
    To = np.zeros((n - 1, 12, 12))
    for i in range(n - 1):
        To[i] = T[12 * i:12 * i + 12, 12 * i + 12:12 * i + 24]
    rhs = rng.randn(n, 12, width)
    return T, Td.astype(np.float32), To.astype(np.float32), rhs.astype(np.float32)


@pytest.mark.parametrize("width", [1, 13, 385])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 100])
def test_cyclic_reduction_matches_thomas(n, width):
    """The plain form of K16's band solve (block cyclic reduction, level by
    level as the kernel's launches) against the JAX package's Thomas chain
    (_block_tridiag_factor, _tridiag_solve_multi) in float32 on the same
    system. Two backward-stable solves of one system differ by rounding:
    tolerance eps_float32 x cond(T) relative to the solution's largest
    entry, the first-order bound on either's forward error."""
    T, Td, To, rhs = _band_system(n, width, seed=100 * n + width)
    factors = jss._block_tridiag_factor(jnp.asarray(Td), jnp.asarray(To), 12)
    ref = np.asarray(jss._tridiag_solve_multi(factors, jnp.asarray(rhs), 12))
    got = cyclic_reduction_solve(*(torch.from_numpy(x) for x in (Td, To, rhs))).numpy()
    tol = np.finfo(np.float32).eps * np.linalg.cond(T)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, (err, tol)
