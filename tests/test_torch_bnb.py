"""The port's precomputation pyramid and branch-and-bound matcher (plain
twins of kernels K6 and K7) against the JAX package's beam path, on a grid
built by the JAX package and carried across."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cartographer_tpu.ops.bnb_2d import (
    FastCorrelativeMatcherParams2D as JParams,
    build_precomputation_pyramid as j_pyramid,
    fast_correlative_match_2d as j_match,
    match_full_submap_exact as j_full,
)
from cartographer_tpu.ops.grid_2d import Grid2D as JGrid2D, insert_range_data as j_insert
from cartographer_tpu.sensor.point_cloud import PointCloud as JPointCloud, RangeData as JRangeData
from cartographer_tpu.transform.rigid import Rigid2 as JRigid2
from cartographer_tpu_torch.interop import grid2d_from_numpy, pyramid_from_numpy
from cartographer_tpu_torch.ops.bnb_2d import (
    FastCorrelativeMatcherParams2D,
    build_precomputation_pyramid,
    fast_correlative_match_2d,
    fast_correlative_match_2d_batch,
    match_full_submap_exact,
    match_plain,
    score_candidates_plain,
)

SIZE, RES, DEPTH = 256, 0.05, 5


def _room_scan(rng, n=300):
    side = rng.randint(4, size=n)
    u = rng.uniform(-1, 1, n)
    x = np.select([side == 0, side == 1], [5.013, -4.987], 5.0 * u)
    y = np.select([side == 2, side == 3], [4.013, -3.987], 4.0 * u)
    return np.stack([x, y], -1).astype(np.float32)


@pytest.fixture(scope="module")
def grids():
    rng = np.random.RandomState(0)
    grid = JGrid2D.create(SIZE, RES, jnp.asarray([0.3, -0.2]))
    for _ in range(3):
        rd = JRangeData(jnp.zeros(2), JPointCloud.from_numpy(_room_scan(rng), 512),
                        JPointCloud.empty(512, 2))
        grid = j_insert(grid, rd, ray_samples=128, method="scatter")
    port = grid2d_from_numpy(np.asarray(grid.log_odds), np.asarray(grid.known),
                             np.asarray(grid.origin), grid.resolution, "cpu")
    return grid, port


def _params(**kw):
    base = dict(linear_search_window=1.0, angular_search_window=math.radians(10.0),
                branch_and_bound_depth=DEPTH, beam_width=256, max_scan_range=12.0)
    base.update(kw)
    return JParams(**base), FastCorrelativeMatcherParams2D(**base)


def _node_scan(seed, n=100, capacity=128, pose=(0.2, -0.1, 0.05)):
    """Room points in the frame of a node at `pose` (in the grid's frame)."""
    pts = _room_scan(np.random.RandomState(seed), n)
    c, s = np.cos(-pose[2]), np.sin(-pose[2])
    d = pts - np.float32(pose[:2])
    local = np.stack([c * d[:, 0] - s * d[:, 1], s * d[:, 0] + c * d[:, 1]], -1)
    out = np.zeros((capacity, 2), np.float32)
    out[:n] = local
    return out, np.arange(capacity) < n


def test_pyramid_exact(grids):
    jgrid, grid = grids
    expected = np.asarray(j_pyramid(jgrid.probability(), DEPTH))
    got = build_precomputation_pyramid(grid, DEPTH).numpy()
    assert got.shape == (DEPTH, SIZE, SIZE)
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("seed,init,min_score", [
    (1, (0.25, -0.05, 0.02), 0.0),
    (2, (0.0, 0.1, 0.1), 0.55),
    (3, (0.6, -0.5, -0.12), 0.3),
])
def test_beam_match_and_certificate(grids, seed, init, min_score):
    jgrid, grid = grids
    jparams, params = _params()
    pts, mask = _node_scan(seed)
    jpyr = j_pyramid(jgrid.probability(), DEPTH)
    init = np.float32(init)
    found, score, pose, cert = j_match(
        jpyr, jgrid, jnp.asarray(pts), jnp.asarray(mask),
        JRigid2(jnp.asarray(init[:2]), jnp.asarray(init[2])), jparams, min_score,
        with_certificate=True, method="beam")
    out = fast_correlative_match_2d(pyramid_from_numpy(np.asarray(jpyr), "cpu"), grid,
                                    torch.from_numpy(pts), torch.from_numpy(mask),
                                    torch.from_numpy(init), params, min_score).numpy()
    assert out[0] == float(score) or abs(out[0] - float(score)) <= 1e-5
    assert bool(out[4] > 0.5) == bool(found)
    assert bool(out[5] > 0.5) == bool(cert)
    np.testing.assert_allclose(out[1:4], np.asarray(pose.to_vector()), rtol=0, atol=1e-5)


def test_match_full_submap_exact(grids):
    jgrid, grid = grids
    jparams, params = _params(angular_search_window=math.radians(6.0), beam_width=64)
    pts, mask = _node_scan(5, pose=(0.35, -0.3, 0.04))
    jpyr = j_pyramid(jgrid.probability(), DEPTH)
    jfound, jscore, jpose, jcert = j_full(jpyr, jgrid, jnp.asarray(pts), jnp.asarray(mask),
                                          jparams, 0.3, max_beam=1024)
    found, score, pose, cert = match_full_submap_exact(
        build_precomputation_pyramid(grid, DEPTH), grid, torch.from_numpy(pts),
        torch.from_numpy(mask), params, 0.3, max_beam=1024)
    assert (found, cert) == (jfound, jcert)
    assert abs(score - jscore) <= 1e-5
    np.testing.assert_allclose(pose, np.asarray(jpose.to_vector()), rtol=0, atol=1e-5)
    assert found and cert and np.linalg.norm(pose[:2] - [0.35, -0.3]) < 0.1


def test_score_candidates_out_of_map_is_unknown():
    level = torch.rand(8, 8)
    cells = torch.zeros((1, 4, 2), dtype=torch.int64)
    mask = torch.tensor([True, True, False, False])
    z = torch.zeros(2, dtype=torch.int64)
    s = score_candidates_plain(level, cells, mask, z, torch.tensor([0, 100]), z)
    assert torch.allclose(s, torch.stack([level[0, 0], torch.tensor(0.1)]))


def test_constraint_builder_global_search_matches_jax(grids):
    """ConstraintBuilder2D's full-submap path: certified beam widening, then
    the GN refine, against the JAX package's on the same grid."""
    import dataclasses

    from cartographer_tpu.core.config import (
        ConstraintBuilderOptions as JCBOptions,
        apply_overrides as j_apply_overrides,
    )
    from cartographer_tpu.mapping.constraint_builder_2d import ConstraintBuilder2D as JBuilder
    from cartographer_tpu.mapping.id import NodeId as JNodeId, SubmapId as JSubmapId
    from cartographer_tpu_torch.core.config import ConstraintBuilderOptions, from_dict
    from cartographer_tpu_torch.mapping.constraint_builder_2d import ConstraintBuilder2D
    from cartographer_tpu_torch.mapping.id import NodeId, SubmapId

    jgrid, grid = grids
    overrides = {"global_localization_min_score": 0.3,
                 "fast_correlative_scan_matcher.angular_search_window": math.radians(6.0),
                 "fast_correlative_scan_matcher.branch_and_bound_depth": DEPTH,
                 "fast_correlative_scan_matcher.beam_width": 64,
                 "fast_correlative_scan_matcher.max_scan_range": 12.0}
    jopts = j_apply_overrides(JCBOptions(), overrides)
    d = dataclasses.asdict(jopts)
    for key in ("log_matches", "fast_correlative_scan_matcher_3d", "ceres_scan_matcher_3d"):
        d.pop(key)
    builder = ConstraintBuilder2D(from_dict(ConstraintBuilderOptions, d), device="cpu")
    jbuilder = JBuilder(jopts)
    pts, mask = _node_scan(5, pose=(0.35, -0.3, 0.04))
    pts = pts[mask]
    (jc,) = jbuilder.compute_constraints(
        [jbuilder.begin_global_constraint(JSubmapId(0, 0), jgrid, JNodeId(0, 7), pts)])
    (c,) = builder.compute_constraints(
        [builder.begin_global_constraint(SubmapId(0, 0), grid, NodeId(0, 7), pts)])
    assert builder.last_global_certified == [True]
    assert abs(c.score - jc.score) <= 1e-5
    np.testing.assert_allclose(c.rel, jc.rel, rtol=0, atol=1e-3)
    assert np.linalg.norm(c.rel[:2] - [0.35, -0.3]) < 0.05


def _flat_grid(jgrid):
    """The room grid with a 40 x 40 patch of cells at one known
    probability: coarse levels near it tie."""
    import dataclasses

    log_odds = np.asarray(jgrid.log_odds).copy()
    known = np.asarray(jgrid.known).copy()
    log_odds[60:100, 120:160] = np.float32(2.0)
    known[60:100, 120:160] = True
    flat = dataclasses.replace(jgrid, log_odds=jnp.asarray(log_odds), known=jnp.asarray(known))
    port = grid2d_from_numpy(log_odds, known, np.asarray(jgrid.origin), jgrid.resolution, "cpu")
    return flat, port


@pytest.mark.parametrize("case", ["ties", "narrow_beam", "min_score"])
def test_batch_matches_per_pair_and_jax(grids, case):
    """The batched entry point (here its plain twin, pair by pair) equals the
    per-pair search exactly and JAX's beam path on each pair of a group of
    three: a grid with a flat patch (ties), a beam below the candidate count,
    and min_score pruning."""
    jgrid, grid = grids
    jflat, flat = _flat_grid(jgrid)
    beam = {"ties": 256, "narrow_beam": 8, "min_score": 64}[case]
    min_score = 0.55 if case == "min_score" else 0.0
    jparams, params = _params(beam_width=beam)
    members = [(jgrid, grid, 11, (0.25, -0.05, 0.02)), (jflat, flat, 12, (3.3, 4.2, -0.05)),
               (jflat if case == "ties" else jgrid, flat if case == "ties" else grid, 13,
                (0.6, -0.5, -0.12))]
    pyrs, jpyrs, clouds, masks, inits = [], [], [], [], []
    for jg, g, seed, init in members:
        jpyr = j_pyramid(jg.probability(), DEPTH)
        jpyrs.append(jpyr)
        pyrs.append(pyramid_from_numpy(np.asarray(jpyr), "cpu"))
        pts, mask = _node_scan(seed)
        clouds.append(pts)
        masks.append(mask)
        inits.append(np.float32(init))
    rows = fast_correlative_match_2d_batch(
        pyrs, [m[1] for m in members], torch.from_numpy(np.stack(clouds)),
        torch.from_numpy(np.stack(masks)), torch.from_numpy(np.stack(inits)), params,
        min_score).numpy()
    for b, (jg, g, _, _) in enumerate(members):
        one = fast_correlative_match_2d(pyrs[b], g, torch.from_numpy(clouds[b]),
                                        torch.from_numpy(masks[b]), torch.from_numpy(inits[b]),
                                        params, min_score).numpy()
        np.testing.assert_array_equal(rows[b], one)
        found, score, pose, cert = j_match(
            jpyrs[b], jg, jnp.asarray(clouds[b]), jnp.asarray(masks[b]),
            JRigid2(jnp.asarray(inits[b][:2]), jnp.asarray(inits[b][2])), jparams, min_score,
            with_certificate=True, method="beam")
        assert rows[b][0] == float(score) or abs(rows[b][0] - float(score)) <= 1e-5
        assert bool(rows[b][4] > 0.5) == bool(found)
        assert bool(rows[b][5] > 0.5) == bool(cert)
        np.testing.assert_allclose(rows[b][1:4], np.asarray(pose.to_vector()), rtol=0,
                                   atol=1e-5)
    if case == "min_score":
        assert rows[:, 4].min() == 0.0  # a pair pruned below min_score


def test_plain_twin_is_the_group_of_one(grids):
    """`match_plain` is what the group of one returns on the CPU."""
    _, grid = grids
    _, params = _params()
    pyr = build_precomputation_pyramid(grid, DEPTH)
    pts, mask = _node_scan(4)
    init = torch.tensor([0.1, 0.0, 0.03])
    got = fast_correlative_match_2d(pyr, grid, torch.from_numpy(pts), torch.from_numpy(mask),
                                    init, params, 0.2)
    assert torch.equal(got, match_plain(pyr, grid, torch.from_numpy(pts),
                                        torch.from_numpy(mask), init, params, 0.2))


def test_global_wave_with_doubling_beam_matches_jax(grids):
    """Three full-submap requests in one wave whose beam doubles until each
    is certified: the port's builder (one batched search a wave) against
    JAX's and against the port's own one-request search."""
    import dataclasses

    from cartographer_tpu.core.config import (
        ConstraintBuilderOptions as JCBOptions,
        apply_overrides as j_apply_overrides,
    )
    from cartographer_tpu.mapping.constraint_builder_2d import ConstraintBuilder2D as JBuilder
    from cartographer_tpu.mapping.id import NodeId as JNodeId, SubmapId as JSubmapId
    from cartographer_tpu_torch.core.config import ConstraintBuilderOptions, from_dict
    from cartographer_tpu_torch.mapping.constraint_builder_2d import ConstraintBuilder2D
    from cartographer_tpu_torch.mapping.id import NodeId, SubmapId

    jgrid, grid = grids
    overrides = {"global_localization_min_score": 0.3,
                 "fast_correlative_scan_matcher.angular_search_window": math.radians(6.0),
                 "fast_correlative_scan_matcher.branch_and_bound_depth": DEPTH,
                 "fast_correlative_scan_matcher.beam_width": 4,
                 "fast_correlative_scan_matcher.max_scan_range": 12.0}
    jopts = j_apply_overrides(JCBOptions(), overrides)
    d = dataclasses.asdict(jopts)
    for key in ("log_matches", "fast_correlative_scan_matcher_3d", "ceres_scan_matcher_3d"):
        d.pop(key)
    builder = ConstraintBuilder2D(from_dict(ConstraintBuilderOptions, d), device="cpu")
    jbuilder = JBuilder(jopts)
    scans = [_node_scan(seed, n=n, pose=pose)
             for seed, n, pose in ((5, 100, (0.35, -0.3, 0.04)), (6, 60, (-0.2, 0.4, -0.03)),
                                   (7, 120, (0.1, 0.1, 0.0)))]
    scans = [pts[mask] for pts, mask in scans]
    jraw = jbuilder._raw_results([jbuilder.begin_global_constraint(
        JSubmapId(0, 0), jgrid, JNodeId(0, i), p) for i, p in enumerate(scans)])
    reqs = [builder.begin_global_constraint(SubmapId(0, 0), grid, NodeId(0, i), p)
            for i, p in enumerate(scans)]
    raw = builder.raw_results(reqs)
    assert max(builder.last_global_beams) > 4  # the beam doubled
    np.testing.assert_allclose(raw[:, 0], jraw[:, 0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(raw[:, 1:], jraw[:, 1:], rtol=0, atol=1e-3)
    params = builder._bnb_params
    pyr = build_precomputation_pyramid(grid, DEPTH)
    for i, p in enumerate(scans):
        pts, mask = torch.from_numpy(p), torch.ones(len(p), dtype=torch.bool)
        found, score, pose, cert = match_full_submap_exact(pyr, grid, pts, mask, params, 0.3,
                                                           max_beam=65536)
        assert cert == builder.last_global_certified[i]
        assert score == raw[i, 0]
