"""The port's Schur-complement SPA (plain twin of kernel K8) against the JAX
package's `solve_spa_2d_schur` on a one-device mesh: one assembly, then 50
Levenberg-Marquardt iterations with frozen slots, Huber-weighted loop
closures (some of them outliers) and node-node terms."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from cartographer_tpu.ops.spa import constraint_residual as j_residual
from cartographer_tpu.parallel.schur_spa import (
    SchurSpaProblem2D as JProblem,
    _assemble_local,
    _block_tridiag_factor,
    _tridiag_solve_multi,
    solve_spa_2d_schur as j_solve,
)
from cartographer_tpu_torch.interop import schur_problem_from_numpy
from cartographer_tpu_torch.ops.spa import constraint_jacobians, constraint_residual
from cartographer_tpu_torch.parallel.schur_spa import (
    assemble,
    cyclic_reduction_solve,
    max_weight,
    normalized,
    solve_spa_2d_schur,
)


def _compose(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.array([a[0] + c * b[0] - s * b[1], a[1] + s * b[0] + c * b[1], a[2] + b[2]])


def _inverse(a):
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.array([-(c * a[0] + s * a[1]), -(-s * a[0] + c * a[1]), -a[2]])


def _graph(seed=0, S=6, N=60, Sp=8, Np=64, Cc=256, Dc=64, outliers=4):
    """A noisy loop of N nodes and S submaps, padded to (Sp, Np, Cc, Dc)."""
    rng = np.random.RandomState(seed)
    t = np.linspace(0, 2 * np.pi, N, endpoint=False)
    truth_n = np.stack([4 * np.cos(t), 3 * np.sin(t), t + np.pi / 2], -1)
    truth_s = truth_n[:: N // S][:S] + np.array([0.2, -0.1, 0.05])
    node_of = np.arange(N) * S // N
    a, b, rel, tw, rw, hub = [], [], [], [], [], []
    for n in range(N):
        for s in {node_of[n], min(node_of[n] + 1, S - 1)}:
            a.append(s), b.append(n)
            rel.append(_compose(_inverse(truth_s[s]), truth_n[n]) + rng.normal(0, 0.01, 3))
            tw.append(5e2), rw.append(1.6e3), hub.append(False)
    for k in range(40):  # loop closures, some of them outliers
        s, n = rng.randint(S), rng.randint(N)
        r = _compose(_inverse(truth_s[s]), truth_n[n]) + rng.normal(0, 0.02, 3)
        if k < outliers:
            r = r + np.array([1.5, -1.0, 0.3])
        a.append(s), b.append(n), rel.append(r)
        tw.append(1.1e4), rw.append(1e5), hub.append(True)
    j, nn_rel = [], []
    for n in range(N - 1):
        j.append(n)
        nn_rel.append(_compose(_inverse(truth_n[n]), truth_n[n + 1]) + rng.normal(0, 0.005, 3))
    C, D = len(a), len(j)
    assert C <= Cc and D <= Dc

    def pad(x, cap, dtype, width=None):
        out = np.zeros((cap,) if width is None else (cap, width), dtype)
        out[:len(x)] = x
        return out

    sub = pad(truth_s + rng.normal(0, 0.1, (S, 3)), Sp, np.float32, 3)
    nod = pad(truth_n + rng.normal(0, 0.1, (N, 3)), Np, np.float32, 3)
    sub_fixed = np.ones(Sp, bool)
    sub_fixed[1:S] = False  # submap 0 frozen, padding frozen
    node_fixed = np.ones(Np, bool)
    node_fixed[:N] = False
    return dict(
        submap_poses=sub, node_poses=nod, a_idx=pad(a, Cc, np.int32),
        b_idx=pad(b, Cc, np.int32), rel=pad(rel, Cc, np.float32, 3),
        trans_weight=pad(tw, Cc, np.float32), rot_weight=pad(rw, Cc, np.float32),
        use_huber=pad(hub, Cc, bool), valid=np.arange(Cc) < C, j_idx=pad(j, Dc, np.int32),
        nn_rel=pad(nn_rel, Dc, np.float32, 3), nn_trans_weight=pad([1e5] * D, Dc, np.float32),
        nn_rot_weight=pad([1e5] * D, Dc, np.float32), nn_valid=np.arange(Dc) < D,
        submap_fixed=sub_fixed, node_fixed=node_fixed), truth_s, truth_n


def _jax_problem(arrays):
    return JProblem(**{k: jnp.asarray(v) for k, v in arrays.items()})


def test_residual_and_jacobians_match_jax():
    rng = np.random.RandomState(3)
    pa, pb, rel = (rng.uniform(-3, 3, (16, 3)).astype(np.float32) for _ in range(3))
    tw, rw = np.float32(0.7), np.float32(0.3)
    jr = jax.vmap(j_residual, in_axes=(0, 0, 0, None, None))
    ja = jax.vmap(jax.jacfwd(j_residual, argnums=0), in_axes=(0, 0, 0, None, None))
    jb = jax.vmap(jax.jacfwd(j_residual, argnums=1), in_axes=(0, 0, 0, None, None))
    t = [torch.from_numpy(x) for x in (pa, pb, rel)]
    w = torch.full((16,), float(tw)), torch.full((16,), float(rw))
    args = (pa, pb, rel, tw, rw)
    np.testing.assert_allclose(constraint_residual(*t, *w).numpy(), np.asarray(jr(*args)),
                               rtol=0, atol=1e-6)
    got_a, got_b = constraint_jacobians(t[0], t[1], *w)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(ja(*args)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(jb(*args)), rtol=0, atol=1e-6)


def test_one_assembly_matches_jax():
    arrays, _, _ = _graph()
    problem = schur_problem_from_numpy(arrays, "cpu")
    wmax = max_weight(problem)
    p = normalized(problem, wmax)
    jp = _jax_problem(arrays)
    jp = dataclasses.replace(jp, trans_weight=jp.trans_weight / wmax,
                             rot_weight=jp.rot_weight / wmax,
                             nn_trans_weight=jp.nn_trans_weight / wmax,
                             nn_rot_weight=jp.nn_rot_weight / wmax)
    hs = 10.0 / wmax
    A, Td, To, g_s, g_n, Ja, Jb = _assemble_local(jp.submap_poses, jp.node_poses, jp, hs)
    got = assemble(p.submap_poses, p.node_poses, p, hs)
    free_s = ~arrays["submap_fixed"][arrays["a_idx"]]
    free_n = ~arrays["node_fixed"][arrays["b_idx"]]
    bw = (free_s & free_n).astype(np.float32)[:, None, None]
    Bc = np.einsum("cri,crj->cij", np.asarray(Ja) * bw, np.asarray(Jb))
    for name, want, have in (("A", A, got[0]), ("Td", Td, got[1]), ("To", To, got[2][:-1]),
                             ("g_s", g_s, got[3]), ("g_n", g_n, got[4]), ("Bc", Bc, got[5])):
        want = np.asarray(want)
        scale = max(np.abs(want).max(), 1e-6)
        np.testing.assert_allclose(have.numpy(), want, rtol=0, atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize("seed,outliers", [(0, 4), (1, 0)])
def test_fifty_iterations_match_jax(seed, outliers):
    arrays, truth_s, truth_n = _graph(seed=seed, outliers=outliers)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("pairs",))
    jsub, jnod = j_solve(mesh, _jax_problem(arrays), num_iterations=50, huber_scale=10.0)
    sub, nod = solve_spa_2d_schur(schur_problem_from_numpy(arrays, "cpu"), num_iterations=50,
                                  huber_scale=10.0)
    jsub, jnod = np.asarray(jsub), np.asarray(jnod)
    for got, want in ((sub.numpy(), jsub), (nod.numpy(), jnod)):
        assert np.abs(got[:, :2] - want[:, :2]).max() <= 1e-3
        assert np.abs(got[:, 2] - want[:, 2]).max() <= 1e-3
    # Frozen and padded slots keep their pose; consecutive nodes move toward
    # their true relative poses.
    np.testing.assert_array_equal(sub.numpy()[0], arrays["submap_poses"][0])
    np.testing.assert_array_equal(nod.numpy()[60:], arrays["node_poses"][60:])

    def step_error(poses):
        return np.mean([np.abs(_compose(_inverse(poses[n]), poses[n + 1])
                               - _compose(_inverse(truth_n[n]), truth_n[n + 1]))[:2].sum()
                        for n in range(59)])

    assert step_error(nod.numpy().astype(float)) < 0.2 * step_error(arrays["node_poses"])


def test_singular_step_is_rejected():
    arrays, _, _ = _graph(seed=2)
    arrays["rel"][0, 0] = np.nan  # a NaN residual poisons the step, never the poses
    sub, nod = solve_spa_2d_schur(schur_problem_from_numpy(arrays, "cpu"), num_iterations=3)
    np.testing.assert_array_equal(sub.numpy(), arrays["submap_poses"])
    np.testing.assert_array_equal(nod.numpy(), arrays["node_poses"])


def _band_system(n, width, seed):
    """A damped block-tridiagonal system of n 3x3 node blocks as the 2D
    solver builds it: each node's own rank-2 term (its submap constraints),
    a 3 x 6 Jacobian's J^T J on each consecutive pair (the node-node term),
    lambda |diag| + damping on the diagonal (1e-4, 1e-6); and a right-hand
    side of `width` columns. -> (T float64, Td, To, rhs float32)."""
    rng = np.random.RandomState(seed)
    T = np.zeros((3 * n, 3 * n))
    for i in range(n):
        R = rng.randn(2, 3)
        T[3 * i:3 * i + 3, 3 * i:3 * i + 3] += R.T @ R
    for i in range(n - 1):
        J = rng.randn(3, 6)
        T[3 * i:3 * i + 6, 3 * i:3 * i + 6] += J.T @ J
    T[np.diag_indices_from(T)] += 1e-4 * np.abs(np.diag(T)) + 1e-6
    Td = np.stack([T[3 * i:3 * i + 3, 3 * i:3 * i + 3] for i in range(n)])
    To = np.zeros((n - 1, 3, 3))
    for i in range(n - 1):
        To[i] = T[3 * i:3 * i + 3, 3 * i + 3:3 * i + 6]
    rhs = rng.randn(n, 3, width)
    return T, Td.astype(np.float32), To.astype(np.float32), rhs.astype(np.float32)


@pytest.mark.parametrize("width", [1, 13, 193])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 100])
def test_cyclic_reduction_matches_thomas(n, width):
    """The plain form of K8's band solve (block cyclic reduction of 3x3
    blocks, level by level as the kernel's launches) against the JAX
    package's Thomas chain (_block_tridiag_factor, _tridiag_solve_multi) in
    float32 on the same system. Two backward-stable solves of one system
    differ by rounding: tolerance eps_float32 x cond(T) relative to the
    solution's largest entry, the first-order bound on either's forward
    error."""
    T, Td, To, rhs = _band_system(n, width, seed=100 * n + width)
    factors = _block_tridiag_factor(jnp.asarray(Td), jnp.asarray(To))
    ref = np.asarray(_tridiag_solve_multi(factors, jnp.asarray(rhs)))
    got = cyclic_reduction_solve(*(torch.from_numpy(x) for x in (Td, To, rhs))).numpy()
    tol = np.finfo(np.float32).eps * np.linalg.cond(T)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, (err, tol)
