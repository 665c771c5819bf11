"""The port's 3D loop-closure matcher (plain twins of kernels K14 and K15)
against the JAX package: the precomputation stack, the local-window beam
search, MatchFullSubmap and its certified widening, the twin of the
production-capacity battery of tests/test_global_localization_3d.py, and
the group and wave entry points that K15 runs as one launch (each pair
against its own JAX search, rows against one-pair calls, 2,048 points)."""

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartographer_tpu.ops import bnb_3d as jb
from cartographer_tpu.ops.rot_histogram import compute_rotational_histogram as j_histogram
from cartographer_tpu.transform import quaternion as jq
from cartographer_tpu.transform.rigid import Rigid3
from cartographer_tpu_torch.interop import grid3d_from_numpy, stack3d_from_numpy
from cartographer_tpu_torch.mapping import constraint_builder_3d as cb3
from cartographer_tpu_torch.ops import bnb_3d as tb

from test_global_localization_3d import PARAMS
from test_ops_3d import build_grid_3d, make_environment_3d

torch.set_num_threads(1)

IDENTITY = torch.tensor([1.0, 0.0, 0.0, 0.0])


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_params(p):
    return tb.FastCorrelativeMatcherParams3D(**{f: getattr(p, f) for f in p.__dataclass_fields__})


def _scene(seed):
    world = make_environment_3d(num=400, seed=seed)
    grid = build_grid_3d(world, resolution=0.2, size=64)
    low = build_grid_3d(world, resolution=0.6, size=32)
    port = [grid3d_from_numpy(g.log_odds, g.known, g.origin, g.resolution, "cpu")
            for g in (grid, low)]
    return world, grid, low, port[0], port[1]


def _histogram(points, mask):
    return np.asarray(j_histogram(jnp.asarray(points), jnp.asarray(mask), 60))


def _scan(world, t, yaw):
    pose = Rigid3(jnp.asarray(t, jnp.float32), jq.from_yaw(jnp.array(yaw)))
    return np.asarray(pose.inverse().apply(jnp.asarray(world)), np.float32)


def _pad(cloud, cap):
    pts = np.zeros((cap, 3), np.float32)
    n = min(len(cloud), cap)
    pts[:n] = cloud[:n]
    mask = np.zeros(cap, bool)
    mask[:n] = True
    return pts, mask


@pytest.mark.parametrize("depth,frd", [(4, 3), (8, 3)])
def test_stack_bit_equal_to_jax(depth, frd):
    _, grid, _, tgrid, _ = _scene(7)
    ref = jb.build_precomputation_stack_3d(grid.probability(), depth, frd)
    got = tb.build_precomputation_stack_3d(tgrid, depth, frd)
    np.testing.assert_array_equal(got.full.numpy(), np.asarray(ref.full))
    np.testing.assert_array_equal(got.coarse.numpy(), np.asarray(ref.coarse))
    assert got.full.dtype == torch.uint8 and int(got.full[0].max()) > 200
    back = stack3d_from_numpy(np.asarray(ref.full), np.asarray(ref.coarse), depth, frd, "cpu")
    assert torch.equal(back.coarse, got.coarse)


def test_local_search_matches_jax_beam():
    world, grid, low, tgrid, tlow = _scene(0)
    stack = jb.build_precomputation_stack_3d(grid.probability(), 4)
    tstack = tb.build_precomputation_stack_3d(tgrid, 4)
    params = jb.FastCorrelativeMatcherParams3D(
        branch_and_bound_depth=4, min_rotational_score=0.3, min_low_resolution_score=0.3,
        linear_xy_search_window=1.5, linear_z_search_window=0.4,
        angular_search_window=math.radians(15.0), beam_width=512, max_scan_range=6.0)
    scan = _scan(world, [0.6, -0.4, 0.2], 0.12)
    hp, hm = _pad(scan, 256)
    lp, lm = _pad(scan, 512)
    shist = _histogram(hp, hm)
    sub = _histogram(world, np.ones(len(world), bool))
    init = Rigid3(jnp.array([0.3, -0.2, 0.0]), jq.from_yaw(jnp.array(0.05)))
    match = jax.jit(partial(jb.fast_correlative_match_3d, params=params, min_score=0.3,
                            method="beam", with_certificate=True))
    found, score, pose, rot, lows, cert = match(
        stack, grid, low, jnp.asarray(hp), jnp.asarray(hm), jnp.asarray(lp), jnp.asarray(lm),
        jnp.asarray(shist), jnp.asarray(sub), init)
    out = tb.fast_correlative_match_3d(
        tstack, tgrid, tlow, _t(hp), _t(hm), _t(lp), _t(lm), _t(shist), _t(sub),
        _t(init.translation), _t(init.rotation), _port_params(params), 0.3).numpy()
    assert bool(out[0] > 0.5) == bool(found) and bool(found)
    assert abs(out[1] - float(score)) <= 1e-5
    assert bool(out[11] > 0.5) == bool(cert)
    np.testing.assert_allclose(out[9:11], [float(rot), float(lows)], atol=1e-5)
    # Poses agree up to score ties.
    np.testing.assert_allclose(out[2:5], np.asarray(pose.translation), atol=1e-5)
    np.testing.assert_allclose(np.abs(out[5:9]), np.abs(np.asarray(pose.rotation)), atol=1e-5)
    np.testing.assert_allclose(out[2:5], [0.6, -0.4, 0.2], atol=0.3)


def test_match_full_submap_matches_jax():
    """The kidnapped scene of test_global_localization_3d.py: no translation
    prior, the full yaw circle."""
    true_t, yaw = [1.5, -1.0, 0.2], 2.0
    world, grid, low, tgrid, tlow = _scene(7)
    stack = jb.build_precomputation_stack_3d(grid.probability(), 4)
    tstack = tb.build_precomputation_stack_3d(tgrid, 4)
    scan = _scan(world, true_t, yaw)
    mask = np.ones(len(world), bool)
    shist, sub = _histogram(scan, mask), _histogram(world, mask)
    match = jax.jit(partial(jb.match_full_submap_3d, params=PARAMS, min_score=0.3,
                            method="beam"))
    found, score, pose, rot, lows = match(
        stack, grid, low, jnp.asarray(scan), jnp.asarray(mask), jnp.asarray(scan),
        jnp.asarray(mask), jnp.asarray(shist), jnp.asarray(sub), jq.identity(), jq.identity())
    out = tb.match_full_submap_3d(
        tstack, tgrid, tlow, _t(scan), _t(mask), _t(scan), _t(mask), _t(shist), _t(sub),
        IDENTITY, IDENTITY, _port_params(PARAMS), 0.3).numpy()
    assert bool(out[0] > 0.5) and bool(found)
    assert abs(out[1] - float(score)) <= 1e-5
    np.testing.assert_allclose(out[2:5], np.asarray(pose.translation), atol=1e-5)
    np.testing.assert_allclose(out[2:5], true_t, atol=0.3)
    got_yaw = float(tb.quat.get_yaw(torch.from_numpy(out[5:9])))
    err = abs(got_yaw - yaw)
    assert min(err, 2 * math.pi - err) < 0.08


def test_exact_wrapper_matches_jax():
    """The kidnapped scene at a second pose, through the certified widening."""
    true_t = [-0.8, 1.2, -0.1]
    world, grid, low, tgrid, tlow = _scene(7)
    stack = jb.build_precomputation_stack_3d(grid.probability(), 4)
    tstack = tb.build_precomputation_stack_3d(tgrid, 4)
    scan = _scan(world, true_t, -2.6)
    mask = np.ones(len(world), bool)
    shist, sub = _histogram(scan, mask), _histogram(world, mask)
    found, score, pose, rot, lows, cert = jb.match_full_submap_3d_exact(
        stack, grid, low, jnp.asarray(scan), jnp.asarray(mask), jnp.asarray(scan),
        jnp.asarray(mask), jnp.asarray(shist), jnp.asarray(sub), jq.identity(), jq.identity(),
        PARAMS, min_score=0.3)
    got = tb.match_full_submap_3d_exact(
        tstack, tgrid, tlow, _t(scan), _t(mask), _t(scan), _t(mask), _t(shist), _t(sub),
        IDENTITY, IDENTITY, _port_params(PARAMS), 0.3)
    assert got[0] == found and got[6] == cert
    assert abs(got[1] - score) <= 1e-5
    np.testing.assert_allclose(got[2], np.asarray(pose.translation), atol=1e-5)
    np.testing.assert_allclose(got[2], true_t, atol=0.3)


@pytest.mark.parametrize("seed", [0, 3, 8])
def test_truncated_clouds_sampled_ground_truth(seed):
    """The twin of TestProductionCapacity3D: a scan planted at a snapped pose
    within the production window, truncated to the constraint builder's
    capacities, reaches the ground-truth score in the full-window search."""
    assert cb3.HIGH_CAP == 256 and cb3.LOW_CAP == 512
    rng = np.random.RandomState(100 + seed)
    world, grid, _, tgrid, tlow = _scene(seed)
    stack = tb.build_precomputation_stack_3d(tgrid, 4)
    params = tb.FastCorrelativeMatcherParams3D(
        branch_and_bound_depth=4, min_rotational_score=0.3, min_low_resolution_score=0.3,
        linear_xy_search_window=5.0, linear_z_search_window=1.0,
        angular_search_window=math.radians(15.0), beam_width=4096, max_scan_range=6.0)
    tiny = tb.FastCorrelativeMatcherParams3D(
        branch_and_bound_depth=4, min_rotational_score=0.0, min_low_resolution_score=0.0,
        linear_xy_search_window=0.4, linear_z_search_window=0.4, angular_search_window=1e-4,
        beam_width=4096, max_scan_range=6.0)
    res = 0.2
    dx, dy = np.round(rng.uniform(-2.0, 2.0, 2) / res) * res
    dz = round(rng.uniform(-0.6, 0.6) / res) * res
    scan = _scan(world, [dx, dy, dz], 0.0)
    hp, hm = _pad(scan, cb3.HIGH_CAP)
    lp, lm = _pad(scan, cb3.LOW_CAP)
    sub = _histogram(world, np.ones(len(world), bool))
    shist = _histogram(hp, hm)
    args = (stack, tgrid, tlow, _t(hp), _t(hm), _t(lp), _t(lm), _t(shist), _t(sub))
    gt = tb.fast_correlative_match_3d(*args, torch.tensor([dx, dy, dz], dtype=torch.float32),
                                      IDENTITY, tiny, 0.0).numpy()
    out = tb.fast_correlative_match_3d(*args, torch.zeros(3), IDENTITY, params, 0.2).numpy()
    assert out[0] > 0.5
    assert out[1] >= gt[1] - 0.015, (out[1], gt[1])
    np.testing.assert_allclose(out[2:5], [dx, dy, dz], atol=0.3)


# ------------------------------------------------- the group and wave entry points

GROUP_PARAMS = jb.FastCorrelativeMatcherParams3D(
    branch_and_bound_depth=4, min_rotational_score=0.3, min_low_resolution_score=0.3,
    linear_xy_search_window=1.5, linear_z_search_window=0.4,
    angular_search_window=math.radians(15.0), beam_width=512, max_scan_range=6.0)


def _local_pairs():
    """Three local-window pairs on two submaps (the scenes of seeds 0 and 7)
    from differing starts; the third pair's scan histogram is zero, so that
    every yaw falls below the rotational gate. -> (JAX argument tuples,
    port argument lists of `fast_correlative_match_3d_batch`)."""
    scenes = [_scene(0), _scene(7)]
    stacks = [(jb.build_precomputation_stack_3d(s[1].probability(), 4),
               tb.build_precomputation_stack_3d(s[3], 4)) for s in scenes]
    cases = [(0, [0.6, -0.4, 0.2], 0.12, [0.3, -0.2, 0.0], 0.05),
             (1, [-0.5, 0.7, -0.1], -0.08, [-0.2, 0.4, 0.1], -0.02),
             (0, [0.2, 0.3, 0.0], 0.03, [0.1, 0.1, 0.0], 0.0)]
    jax_args, port = [], {k: [] for k in ("stacks", "grids", "lows", "hp", "hm", "lp", "lm",
                                          "hist", "sub", "t", "q")}
    for i, (k, true_t, yaw, init_t, init_yaw) in enumerate(cases):
        world, grid, low, tgrid, tlow = scenes[k]
        scan = _scan(world, true_t, yaw)
        hp, hm = _pad(scan, 256)
        lp, lm = _pad(scan, 512)
        shist = _histogram(hp, hm) * (0.0 if i == 2 else 1.0)
        sub = _histogram(world, np.ones(len(world), bool))
        init = Rigid3(jnp.array(init_t, jnp.float32), jq.from_yaw(jnp.array(init_yaw)))
        jax_args.append((stacks[k][0], grid, low, jnp.asarray(hp), jnp.asarray(hm),
                         jnp.asarray(lp), jnp.asarray(lm), jnp.asarray(shist), jnp.asarray(sub),
                         init))
        for key, v in (("stacks", stacks[k][1]), ("grids", tgrid), ("lows", tlow), ("hp", hp),
                       ("hm", hm), ("lp", lp), ("lm", lm), ("hist", shist), ("sub", _t(sub)),
                       ("t", np.asarray(init.translation)), ("q", np.asarray(init.rotation))):
            port[key].append(v)
    for key in ("hp", "hm", "lp", "lm", "hist", "t", "q"):
        port[key] = _t(np.stack(port[key]))
    return jax_args, port


def _batch_args(p, params):
    return (p["stacks"], p["grids"], p["lows"], p["hp"], p["hm"], p["lp"], p["lm"], p["hist"],
            p["sub"], p["t"], p["q"], _port_params(params), 0.3)


def test_group_matches_jax_per_pair():
    """The group entry point on three pairs (two submaps, one pair with
    every yaw below the rotational gate), each row against its own JAX
    search at the file's tolerances; the dead pair's row equal to its
    one-pair call's."""
    jax_args, p = _local_pairs()
    rows = tb.fast_correlative_match_3d_batch(*_batch_args(p, GROUP_PARAMS)).numpy()
    match = jax.jit(partial(jb.fast_correlative_match_3d, params=GROUP_PARAMS, min_score=0.3,
                            method="beam", with_certificate=True))
    for b, args in enumerate(jax_args):
        found, score, pose, rot, lows, cert = match(*args)
        out = rows[b]
        assert bool(out[0] > 0.5) == bool(found) == (b != 2)
        np.testing.assert_allclose(out[1], float(score), atol=1e-5)
        assert bool(out[11] > 0.5) == bool(cert)
        if b == 2:
            continue
        np.testing.assert_allclose(out[9:11], [float(rot), float(lows)], atol=1e-5)
        np.testing.assert_allclose(out[2:5], np.asarray(pose.translation), atol=1e-5)
        np.testing.assert_allclose(np.abs(out[5:9]), np.abs(np.asarray(pose.rotation)),
                                   atol=1e-5)
    one = tb.fast_correlative_match_3d(
        p["stacks"][2], p["grids"][2], p["lows"][2], p["hp"][2], p["hm"][2], p["lp"][2],
        p["lm"][2], p["hist"][2], p["sub"][2], p["t"][2], p["q"][2],
        _port_params(GROUP_PARAMS), 0.3)
    assert torch.equal(torch.from_numpy(rows[2]), one)
    assert rows[2][1] == -math.inf and not np.any(np.isnan(rows[2]))


@pytest.mark.parametrize("plain", [False, True])
def test_group_rows_equal_one_pair_calls(plain):
    """Each row of a group equals the one-pair call on the same pair, bit
    for bit, through the plain path."""
    _, p = _local_pairs()
    params = _port_params(GROUP_PARAMS)
    rows = tb.fast_correlative_match_3d_batch(*_batch_args(p, GROUP_PARAMS), plain=plain)
    for b in range(3):
        one = tb.fast_correlative_match_3d(
            p["stacks"][b], p["grids"][b], p["lows"][b], p["hp"][b], p["hm"][b], p["lp"][b],
            p["lm"][b], p["hist"][b], p["sub"][b], p["t"][b], p["q"][b], params, 0.3,
            plain=plain)
        assert torch.equal(rows[b], one), (b, rows[b], one)


def test_full_submap_wave_matches_jax():
    """A wave of two kidnapped requests (two submaps, no translation prior,
    the full yaw circle) through the certified widening, each against JAX's
    match_full_submap_3d_exact."""
    requests = [(7, [1.5, -1.0, 0.2], 2.0), (0, [-0.8, 1.2, -0.1], -2.6)]
    jax_out, port = [], {k: [] for k in ("stacks", "grids", "lows", "pts", "mask", "hist",
                                         "sub")}
    for seed, true_t, yaw in requests:
        world, grid, low, tgrid, tlow = _scene(seed)
        scan = _scan(world, true_t, yaw)
        mask = np.ones(len(world), bool)
        shist, sub = _histogram(scan, mask), _histogram(world, mask)
        jax_out.append(jb.match_full_submap_3d_exact(
            jb.build_precomputation_stack_3d(grid.probability(), 4), grid, low,
            jnp.asarray(scan), jnp.asarray(mask), jnp.asarray(scan), jnp.asarray(mask),
            jnp.asarray(shist), jnp.asarray(sub), jq.identity(), jq.identity(), PARAMS,
            min_score=0.3))
        for key, v in (("stacks", tb.build_precomputation_stack_3d(tgrid, 4)), ("grids", tgrid),
                       ("lows", tlow), ("pts", scan), ("mask", mask), ("hist", shist),
                       ("sub", _t(sub))):
            port[key].append(v)
    pts, mask, hist = (_t(np.stack(port[k])) for k in ("pts", "mask", "hist"))
    rots = IDENTITY[None].repeat(2, 1)
    got = tb.match_full_submap_3d_exact_batch(
        port["stacks"], port["grids"], port["lows"], pts, mask, pts, mask, hist, port["sub"],
        rots, rots, _port_params(PARAMS), 0.3)
    for (seed, true_t, _), (found, score, pose, rot, lows, cert), out in zip(requests, jax_out,
                                                                              got):
        assert out[0] == found and out[6] == cert
        assert abs(out[1] - score) <= 1e-5
        np.testing.assert_allclose(out[2], np.asarray(pose.translation), atol=1e-5)
        np.testing.assert_allclose(np.abs(out[3]), np.abs(np.asarray(pose.rotation)), atol=1e-5)
        np.testing.assert_allclose([out[4], out[5]], [rot, lows], atol=1e-5)
        np.testing.assert_allclose(out[2], true_t, atol=0.3)


def test_local_search_2048_points_matches_jax():
    """2,048 points in both clouds (above the scorer's former 1,024-point
    limit), the plain path against JAX's beam search."""
    world = make_environment_3d(num=2048, seed=5)
    grid = build_grid_3d(world, resolution=0.2, size=64)
    low = build_grid_3d(world, resolution=0.6, size=32)
    tgrid, tlow = (grid3d_from_numpy(g.log_odds, g.known, g.origin, g.resolution, "cpu")
                   for g in (grid, low))
    scan = _scan(world, [0.4, 0.3, -0.2], -0.1)
    assert scan.shape == (2048, 3)
    mask = np.ones(2048, bool)
    mask[::7] = False
    shist, sub = _histogram(scan, mask), _histogram(world, np.ones(2048, bool))
    init = Rigid3(jnp.array([0.2, 0.1, 0.0]), jq.from_yaw(jnp.array(0.0)))
    match = jax.jit(partial(jb.fast_correlative_match_3d, params=GROUP_PARAMS, min_score=0.3,
                            method="beam", with_certificate=True))
    found, score, pose, rot, lows, cert = match(
        jb.build_precomputation_stack_3d(grid.probability(), 4), grid, low, jnp.asarray(scan),
        jnp.asarray(mask), jnp.asarray(scan), jnp.asarray(mask), jnp.asarray(shist),
        jnp.asarray(sub), init)
    out = tb.fast_correlative_match_3d(
        tb.build_precomputation_stack_3d(tgrid, 4), tgrid, tlow, _t(scan), _t(mask), _t(scan),
        _t(mask), _t(shist), _t(sub), _t(init.translation), _t(init.rotation),
        _port_params(GROUP_PARAMS), 0.3).numpy()
    assert bool(out[0] > 0.5) == bool(found) and bool(found)
    assert abs(out[1] - float(score)) <= 1e-5
    assert bool(out[11] > 0.5) == bool(cert)
    np.testing.assert_allclose(out[9:11], [float(rot), float(lows)], atol=1e-5)
    np.testing.assert_allclose(out[2:5], np.asarray(pose.translation), atol=1e-5)
    np.testing.assert_allclose(out[2:5], [0.4, 0.3, -0.2], atol=0.3)
