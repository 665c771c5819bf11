"""The port's GICP and NDT (plain twins of kernels K26-K29) against the JAX
package's `ops/icp.py`, on the CPU.

The neighbour search keeps the reference's distance form |a|^2 + |b|^2 -
2 a.b, which XLA takes as a matrix product and the port elementwise, so the
10th and 11th neighbours can swap at near-ties: neighbour sets and normals
are compared on the rows whose 10th and 11th distances differ by more than
1e-5 relative. JAX takes the eigenvectors in float32, the port in float64:
normals agree within |cos| >= 1 - 1e-5. NDT's cell sums are added in input
order in both packages, so the means agree to the bit; the inverse and the
Cholesky factor differ by float32 rounding (JAX) against float64 (port).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartographer_tpu.ops.icp import (
    IcpParams as JIcpParams,
    NdtParams as JNdtParams,
    _pairwise_sq_dist as j_pairwise_sq_dist,
    build_ndt_grid as j_build_ndt_grid,
    estimate_normals as j_estimate_normals,
    gicp_match as j_gicp_match,
    ndt_match as j_ndt_match,
)
from cartographer_tpu.transform import Rigid3 as JRigid3, quaternion as jquat
from cartographer_tpu_torch.interop import ndt_grid_from_numpy
from cartographer_tpu_torch.ops import icp
from cartographer_tpu_torch.transform import quaternion as quat
from cartographer_tpu_torch.transform.rigid import Rigid3
from test_icp_ndt import perturbed_pair
from test_ops_3d import make_environment_3d

torch.set_num_threads(1)
K = 10
IDENTITY = (0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _identity():
    return Rigid3(torch.zeros(3), torch.tensor([1.0, 0.0, 0.0, 0.0]))


def _cloud(kind, n=512, seed=0):
    """(points (n, 3), mask (n,)): a general cloud (a noisy blob of
    surfaces), one tilted plane, or two walls meeting at a corner."""
    rng = np.random.RandomState(seed)
    if kind == "general":
        pts = make_environment_3d(num=n, seed=seed) + rng.normal(0, 0.05, (n, 3))
    elif kind == "planar":
        uv = rng.uniform(-4, 4, (n, 2))
        pts = uv[:, :1] * np.array([0.9, 0.1, 0.2]) + uv[:, 1:] * np.array([-0.1, 0.8, 0.3])
    else:  # corner: the walls x = 0 and y = 0, tilted
        a, h = rng.uniform(0, 5, n), rng.uniform(0, 3, n)
        side = rng.rand(n) < 0.5
        pts = np.stack([np.where(side, 0.0, a), np.where(side, a, 0.0), h], -1)
        c, s = np.cos(0.3), np.sin(0.3)
        pts = pts @ np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]).T
    return pts.astype(np.float32), rng.rand(n) < 0.9


def _jax_neighbours(points, mask):
    d2 = j_pairwise_sq_dist(jnp.asarray(points), jnp.asarray(points))
    d2 = jnp.where(jnp.asarray(mask)[None, :], d2, jnp.inf)
    return np.asarray(jax.lax.top_k(-d2, K)[1]), np.sort(np.asarray(d2, np.float64), 1)


def _separated(sorted_d2):
    """Rows whose 10th and 11th distances differ by more than 1e-5 relative."""
    a, b = sorted_d2[:, K - 1], sorted_d2[:, K]
    return np.abs(b - a) > 1e-5 * np.maximum(np.abs(a), 1e-12)


@pytest.mark.parametrize("kind", ["general", "planar", "corner"])
def test_estimate_normals_matches_jax(kind):
    """K26's twin: neighbour sets and normals against JAX (|cos| >= 1 - 1e-5)
    on separated rows; unit normals, largest component positive; masked
    rows zero."""
    pts, mask = _cloud(kind)
    jn = np.asarray(j_estimate_normals(jnp.asarray(pts), jnp.asarray(mask)))
    j_idx, sorted_d2 = _jax_neighbours(pts, mask)
    normals, idx = icp.normals_with_neighbours(_t(pts), _t(mask))
    normals, idx = normals.numpy(), idx.numpy()
    assert idx.dtype == np.int32 and idx.shape == (512, K)
    rows = _separated(sorted_d2) & mask
    assert rows.sum() > 0.9 * mask.sum()
    for r in np.flatnonzero(rows):
        assert set(idx[r]) == set(j_idx[r]), r
    cos = np.abs((normals * jn).sum(1))
    assert cos[rows].min() >= 1 - 1e-5
    np.testing.assert_allclose(np.linalg.norm(normals[mask], axis=1), 1.0, atol=1e-6)
    big = np.abs(normals[mask]).argmax(1)
    assert (normals[mask][np.arange(mask.sum()), big] > 0).all()
    assert not normals[~mask].any()


def test_estimate_normals_few_valid_and_padded_rows():
    """Fewer than 10 masked-in points: the lists fill with masked columns in
    index order, as lax.top_k; padded rows give zero normals."""
    rng = np.random.RandomState(7)
    pts = np.zeros((40, 3), np.float32)
    pts[:30] = rng.uniform(-2, 2, (30, 3))
    mask = np.zeros(40, bool)
    mask[[1, 4, 8, 9, 15, 22, 27]] = True
    j_idx, _ = _jax_neighbours(pts, mask)
    normals, idx = icp.normals_with_neighbours(_t(pts), _t(mask))
    np.testing.assert_array_equal(idx.numpy(), j_idx)
    jn = np.asarray(j_estimate_normals(jnp.asarray(pts), jnp.asarray(mask)))
    cos = np.abs((normals.numpy() * jn).sum(1))
    assert cos[mask].min() >= 1 - 1e-5
    assert not normals.numpy()[~mask].any()


def _gicp_pair(case):
    if case == "masked":
        src, sm, tgt, tm, true = perturbed_pair(seed=2)
        sm, tm = np.asarray(sm).copy(), np.asarray(tm).copy()
        sm[::4] = False
        tm[1::5] = False
        return np.asarray(src), sm, np.asarray(tgt), tm, true
    src, sm, tgt, tm, true = perturbed_pair(seed=2 if case == "room" else 5,
                                            t=(0.3, -0.2, 0.1) if case == "room"
                                            else (-0.2, 0.15, -0.05),
                                            aa=(0.0, 0.0, 0.1) if case == "room"
                                            else (0.02, -0.01, -0.08))
    return np.asarray(src), np.asarray(sm), np.asarray(tgt), np.asarray(tm), true


def _rotation_gap(q_ref, q):
    dq = quat.multiply(quat.conjugate(_t(np.asarray(q_ref))), q)
    return float(quat.to_axis_angle(dq).norm())


@pytest.mark.parametrize("case,max_iterations", [("room", 30), ("other", 30),
                                                 ("masked", 30), ("room", 5)])
def test_gicp_match_matches_jax(case, max_iterations):
    """gicp_match (6 rounds; 1 round at max_iterations 5): pose within 1e-4
    m and 1e-4 rad of JAX's, fitness and RMSE within 1e-5, and the truth
    within 0.12 m as tests/test_icp_ndt.py holds JAX."""
    src, sm, tgt, tm, true = _gicp_pair(case)
    params = JIcpParams(max_iterations=max_iterations)
    jpose, jfit, jrmse = j_gicp_match(jnp.asarray(src), jnp.asarray(sm), jnp.asarray(tgt),
                                      jnp.asarray(tm), JRigid3.identity(), params)
    pose, fit, rmse = icp.gicp_match(_t(src), _t(sm), _t(tgt), _t(tm), _identity(),
                                     icp.IcpParams(max_iterations=max_iterations))
    np.testing.assert_allclose(pose.translation.numpy(), np.asarray(jpose.translation),
                               atol=1e-4)
    assert _rotation_gap(jpose.rotation, pose.rotation) < 1e-4
    assert abs(float(fit) - float(jfit)) < 1e-5 and abs(float(rmse) - float(jrmse)) < 1e-5
    if max_iterations == 30:
        np.testing.assert_allclose(pose.translation.numpy(), np.asarray(true.translation),
                                   atol=0.12)
        assert float(fit) > 0.85


def test_gicp_round_does_not_depend_on_the_normals_sign():
    """K27's twin: flipping every normal flips every residual and Jacobian
    row, so J^T J, J^T r, the cost and the pose keep their bits."""
    src, sm, tgt, tm, _ = _gicp_pair("room")
    normals, _ = icp.normals_plain(_t(tgt), _t(tm))
    x0 = torch.tensor(IDENTITY)
    nn, _, valid = icp.nearest(_t(src), _t(sm), _t(tgt), _t(tm), x0, 1.0)
    a = icp.gicp_lm(_t(src), _t(tgt), normals, nn, valid, x0, 10)
    b = icp.gicp_lm(_t(src), _t(tgt), -normals, nn, valid, x0, 10)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert int(a[2]) >= 2 and float(a[1]) > 0


def _ndt_clouds(seed=3):
    src, sm, tgt, tm, true = perturbed_pair(seed=seed, t=(0.25, -0.15, 0.05),
                                            aa=(0.0, 0.0, 0.05), n=600)
    return np.asarray(src), np.asarray(sm), np.asarray(tgt), np.asarray(tm), true


def _jax_center(tgt, tm):
    return jnp.sum(jnp.where(jnp.asarray(tm)[:, None], jnp.asarray(tgt), 0.0), 0) / jnp.maximum(
        jnp.sum(jnp.asarray(tm)), 1)


@pytest.mark.parametrize("resolution,extent", [(1.0, 24), (1.0, 8), (0.5, 16), (0.5, 24)])
def test_build_ndt_grid_matches_jax(resolution, extent):
    """K28's twin fed JAX's center: origin and valid exact, means exact (the
    same sums in the same order), L within 1e-5 of its largest entries."""
    _, _, tgt, tm, _ = _ndt_clouds()
    tm = tm.copy()
    tm[::7] = False
    center = _jax_center(tgt, tm)
    jparams = JNdtParams(resolution=resolution, grid_extent=extent)
    jm, jL, jv, jo = [np.asarray(a) for a in j_build_ndt_grid(
        jnp.asarray(tgt), jnp.asarray(tm), jparams, center)]
    means, L, valid, origin = icp.build_ndt_grid(
        _t(tgt), _t(tm), icp.NdtParams(resolution=resolution, grid_extent=extent),
        _t(np.asarray(center)))
    np.testing.assert_array_equal(origin.numpy(), jo)
    np.testing.assert_array_equal(valid.numpy(), jv)
    assert 10 < jv.sum() < extent ** 3
    np.testing.assert_array_equal(means.numpy(), jm)
    scale = np.abs(jL[jv]).max()
    np.testing.assert_allclose(L.numpy()[jv], jL[jv], atol=1e-5 * scale, rtol=0)
    assert not np.triu(L.numpy()[jv], 1).any()


def test_ndt_center_matches_jax():
    _, _, tgt, tm, _ = _ndt_clouds()
    tm = tm.copy()
    tm[::3] = False
    np.testing.assert_allclose(icp.ndt_center(_t(tgt), _t(tm)).numpy(),
                               np.asarray(_jax_center(tgt, tm)), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("resolution,extent,seed", [(1.0, 24, 3), (1.0, 32, 4),
                                                    (0.5, 24, 3)])
def test_ndt_match_matches_jax(resolution, extent, seed):
    """ndt_match: pose within 1e-4 m and 1e-4 rad of JAX's, cost within 1e-4
    relative; K29's twin on JAX's own grid (`ndt_grid_from_numpy`) likewise;
    the truth within 0.15 m as tests/test_icp_ndt.py holds JAX."""
    src, sm, tgt, tm, true = _ndt_clouds(seed)
    jparams = JNdtParams(resolution=resolution, max_iterations=25, grid_extent=extent)
    params = icp.NdtParams(resolution=resolution, max_iterations=25, grid_extent=extent)
    jpose, jcost = j_ndt_match(jnp.asarray(src), jnp.asarray(sm), jnp.asarray(tgt),
                               jnp.asarray(tm), JRigid3.identity(), jparams)
    pose, cost = icp.ndt_match(_t(src), _t(sm), _t(tgt), _t(tm), _identity(), params)
    np.testing.assert_allclose(pose.translation.numpy(), np.asarray(jpose.translation),
                               atol=1e-4)
    assert _rotation_gap(jpose.rotation, pose.rotation) < 1e-4
    assert float(cost) == pytest.approx(float(jcost), rel=1e-4)

    grid = ndt_grid_from_numpy(*j_build_ndt_grid(jnp.asarray(tgt), jnp.asarray(tm), jparams,
                                                 _jax_center(tgt, tm)), "cpu")
    x, c, _ = icp.ndt_lm(grid, _t(src), _t(sm), torch.tensor(IDENTITY), params)
    np.testing.assert_allclose(x[0:3].numpy(), np.asarray(jpose.translation), atol=1e-4)
    assert _rotation_gap(jpose.rotation, x[3:7]) < 1e-4
    assert float(c) == pytest.approx(float(jcost), rel=1e-4)
    if resolution == 1.0:
        assert np.linalg.norm(pose.translation.numpy() - np.asarray(true.translation)) < 0.15


def test_ndt_residuals_gradient():
    """K29's twin's analytic Jacobian against central differences of its
    residuals through se3_retract (cells held: a step small enough that no
    point changes cell)."""
    from cartographer_tpu_torch.ops.scan_matcher_3d import se3_retract

    src, sm, tgt, tm, _ = _ndt_clouds()
    params = icp.NdtParams(resolution=1.0, grid_extent=24)
    grid = icp.build_ndt_grid(_t(tgt), _t(tm), params, icp.ndt_center(_t(tgt), _t(tm)))
    grid = tuple(g.double() if g.dtype == torch.float32 else g for g in grid)
    x = torch.tensor([0.1, -0.05, 0.02, np.cos(0.02), 0.0, 0.0, np.sin(0.02)],
                     dtype=torch.float64)
    source = _t(src).double()
    r, jac = icp.ndt_residuals(grid, source, _t(sm), x, params)
    assert int((r != 0).sum()) > 300
    h = 1e-6
    for a in range(6):
        d = torch.zeros(6, dtype=torch.float64)
        d[a] = h
        rp, _ = icp.ndt_residuals(grid, source, _t(sm), se3_retract(x, d), params)
        rm, _ = icp.ndt_residuals(grid, source, _t(sm), se3_retract(x, -d), params)
        np.testing.assert_allclose(((rp - rm) / (2 * h)).numpy(), jac[:, a].numpy(),
                                   atol=1e-5)
