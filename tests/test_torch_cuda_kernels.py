"""The port's CUDA kernels against their plain PyTorch twins, on the card.

These tests need an NVIDIA GPU with nvcc (sm_90a) and skip elsewhere; run
them on the card, where JAX (which tests/conftest.py loads) is absent, with
`python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py`.
`chip_smoke.py` holds the same kernels against their twins at full width.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cartographer_tpu_torch.ops import grid_2d, scan_matcher_2d, scan_pipeline_2d
from cartographer_tpu_torch.ops.grid_2d import Grid2D
from cartographer_tpu_torch.ops.probability import probability_to_log_odds
from cartographer_tpu_torch.sensor import voxel_filter
from cartographer_tpu_torch.sensor.point_cloud import PointCloud, RangeData
from cartographer_tpu_torch.transform.rigid import Rigid3

pytestmark = pytest.mark.cuda
N, SIZE, SAMPLES = 512, 256, 128


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda:0")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _room(rng, n):
    a = rng.uniform(-np.pi, np.pi, n)
    r = np.where(rng.rand(n) < 0.8, rng.uniform(0.5, 5.5, n), rng.uniform(13.0, 20.0, n))
    return np.stack([r * np.cos(a), r * np.sin(a), rng.uniform(-0.2, 0.4, n)], -1)


def test_scan_preprocess_2d_kernel(dev):
    rng = np.random.RandomState(0)
    pts = _room(rng, N).astype(np.float32)
    q = np.float32([np.cos(0.1), 0.0, 0.0, np.sin(0.1)])
    args = (_t(pts, dev), _t(np.linspace(0, 1, N, dtype=np.float32), dev),
            _t(rng.rand(N) < 0.9, dev), _t(np.zeros((N, 3), np.float32), dev),
            Rigid3(_t(np.float32([0.1, 0.2, 0.0]), dev), _t(np.float32([1, 0, 0, 0]), dev)),
            Rigid3(_t(np.float32([0.3, 0.1, 0.0]), dev), _t(q, dev)),
            _t(np.float32([1, 0, 0, 0]), dev),
            scan_pipeline_2d.ScanPreprocessParams2D(max_range=12.0))
    got = scan_pipeline_2d.align_scan(*args)
    ref = scan_pipeline_2d.align_scan_plain(*args)
    for k in (0, 1, 4):
        torch.testing.assert_close(got[k], ref[k], atol=1e-5, rtol=0)
    for k in (2, 3):
        assert torch.equal(got[k], ref[k])


@pytest.mark.parametrize("dim,adaptive", [(3, False), (2, True)])
def test_voxel_filter_kernel(dev, dim, adaptive):
    rng = np.random.RandomState(1)
    pts = _t(rng.uniform(-4, 4, (N, dim)).astype(np.float32), dev)
    mask = _t(rng.rand(N) < 0.9, dev)
    perm = _t(rng.permutation(N).astype(np.int32), dev)
    if adaptive:
        cloud = PointCloud(pts, mask, torch.zeros(N, device=dev))
        got = voxel_filter.adaptive_voxel_filter(cloud, 0.5, 100, 5.0, perm).mask
        ref = voxel_filter.adaptive_voxel_filter_mask_plain(pts, mask, 0.5, 100, 5.0, perm)
    else:
        got = voxel_filter.voxel_filter_mask(pts, mask, 0.3, perm)
        ref = voxel_filter.voxel_filter_mask_plain(pts, mask, 0.3, perm)
    assert torch.equal(got, ref)


def _grids_and_scan(dev):
    rng = np.random.RandomState(2)
    pts = _room(rng, N)[:, :2].astype(np.float32)
    r = np.linalg.norm(pts, axis=1)
    miss = (pts * (5.0 / r)[:, None]).astype(np.float32)
    z = torch.zeros(N, device=dev)
    rd = RangeData(_t(np.float32([0.2, -0.1]), dev),
                   PointCloud(_t(pts, dev), _t(r <= 12.0, dev), z),
                   PointCloud(_t(miss, dev), _t(r > 12.0, dev), z))
    grids = Grid2D(torch.zeros((2, SIZE, SIZE), device=dev),
                   torch.zeros((2, SIZE, SIZE), dtype=torch.bool, device=dev),
                   _t(np.float32([[-6.4, -6.4], [-6.0, -6.3]]), dev), 0.05)
    return grids, rd


def test_insert_2d_kernel(dev):
    grids, rd = _grids_and_scan(dev)
    plain = grids.clone()
    active = _t(np.array([True, True]), dev)
    yes = torch.ones((), dtype=torch.bool, device=dev)
    grid_2d.insert_into_slots(grids, rd, active, yes, 0.55, 0.49, True, SAMPLES)
    grid_2d._insert_plain(plain, rd, active, yes, probability_to_log_odds(0.55),
                          probability_to_log_odds(0.49), True, SAMPLES)
    touched = int(plain.known.sum())
    differ = int(((grids.log_odds - plain.log_odds).abs() > 1e-6).sum()
                 + (grids.known != plain.known).sum())
    assert touched > 1000 and differ <= 1e-3 * touched


def test_scan_matcher_2d_kernel(dev):
    grids, rd = _grids_and_scan(dev)
    grid_2d.insert_into_slots(grids, rd, _t(np.array([True, False]), dev),
                              torch.ones((), dtype=torch.bool, device=dev), 0.55, 0.49, True,
                              SAMPLES)
    params = scan_matcher_2d.GaussNewtonMatcherParams2D(translation_weight=1.0,
                                                        rotation_weight=1.0)
    x0 = _t(np.float32([0.23, -0.12, 0.01]), dev)
    args = (grids.slot(0), rd.returns.points, rd.returns.mask, x0, x0[0:2], params)
    xk, ck, _ = scan_matcher_2d.lm_match_2d(*args)
    xp, cp, _ = scan_matcher_2d._match_plain(*args)
    torch.testing.assert_close(xk, xp, atol=1e-4, rtol=0)
    torch.testing.assert_close(ck, cp, atol=0, rtol=1e-4)


def _card_grid(dev):
    grids, rd = _grids_and_scan(dev)
    grid_2d.insert_into_slots(grids, rd, _t(np.array([True, False]), dev),
                              torch.ones((), dtype=torch.bool, device=dev), 0.55, 0.49, True,
                              SAMPLES)
    return grids.slot(0), rd


def test_correlative_2d_kernel(dev):
    from cartographer_tpu_torch.ops import correlative_2d

    grid, rd = _card_grid(dev)
    params = correlative_2d.CorrelativeSearchParams(max_scan_range=12.0)
    x0 = _t(np.float32([0.23, -0.12, 0.02]), dev)
    best, scores = correlative_2d.correlative_match(grid, rd.returns.points, rd.returns.mask, x0,
                                                params)
    best_p, scores_p = correlative_2d.correlative_match_plain(
        grid, rd.returns.points, rd.returns.mask, x0, params)
    assert torch.equal(scores, scores_p)
    assert torch.equal(best, best_p)


def test_bnb_kernels(dev):
    from cartographer_tpu_torch.ops import bnb_2d

    grid, rd = _card_grid(dev)
    pyr = bnb_2d.build_precomputation_pyramid(grid, 7)
    assert torch.equal(pyr, bnb_2d.pyramid_plain(grid, 7))
    rng = np.random.RandomState(4)
    n = 128
    cells = _t(rng.randint(-20, SIZE + 20, (31, n, 2)).astype(np.int32), dev)
    mask = _t(rng.rand(n) < 0.8, dev)
    b = 5000
    a_idx = _t(rng.randint(0, 31, b).astype(np.int32), dev)
    ox = _t(rng.randint(-64, 64, b).astype(np.int32), dev)
    oy = _t(rng.randint(-64, 64, b).astype(np.int32), dev)
    for h in (0, 3, 6):
        got = bnb_2d.score_candidates(pyr[h], cells, mask, a_idx, ox, oy)
        ref = bnb_2d.score_candidates_plain(pyr[h], cells, mask, a_idx, ox, oy)
        assert torch.equal(got, ref)
    params = bnb_2d.FastCorrelativeMatcherParams2D(linear_search_window=2.0, beam_width=512,
                                                   max_scan_range=12.0)
    pts, m = rd.returns.points[:n], rd.returns.mask[:n]
    x0 = _t(np.float32([0.3, -0.2, 0.05]), dev)
    out = bnb_2d.fast_correlative_match_2d(pyr, grid, pts, m, x0, params, 0.3)
    ref = bnb_2d.fast_correlative_match_2d(pyr, grid, pts, m, x0, params, 0.3,
                                           score=bnb_2d.score_candidates_plain)
    assert torch.equal(out, ref)


def _spa_problem(dev):
    from cartographer_tpu_torch.interop import schur_problem_from_numpy
    from cartographer_tpu_torch.simulation import synthetic_pose_graph

    arrays, _, _ = synthetic_pose_graph(8, 120, 512, seed=5)
    return schur_problem_from_numpy(arrays, dev)


@pytest.mark.parametrize("iterations", [1, 2, 50])
def test_schur_spa_2d_kernel(dev, iterations):
    from cartographer_tpu_torch.parallel import schur_spa

    p = _spa_problem(dev)
    wmax = schur_spa.max_weight(p)
    q = schur_spa.normalized(p, wmax)
    sub, nod = schur_spa._solve_kernel(q, iterations, 10.0 / wmax, 1e-6)
    sub_p, nod_p = schur_spa.solve_plain(q, iterations, 10.0 / wmax, 1e-6)
    torch.testing.assert_close(sub, sub_p, atol=1e-3, rtol=0)
    torch.testing.assert_close(nod, nod_p, atol=1e-3, rtol=0)


def _k8_problem(dev, S, N, seed):
    """A synthetic 2D pose graph of S submaps and N nodes, 4N + 16
    constraint slots, with frozen nodes and submaps: every 97th node from
    the 97th, the middle submap where S > 2, and, as the pose graph pads
    its slots, every submap that no constraint reaches; the gauge is
    submap 0 (frozen), or node 0 where S = 1 (the submap free). The poses
    start 5 mm
    from the truth, as a running pose graph's solve starts from the last
    solution, so that the first steps are no near-ties of the accept test
    (test_schur_spa_3d_kernel's reasoning for K16). -> (the weight-normalized
    problem on `dev`, the Huber scale)."""
    from cartographer_tpu_torch.interop import schur_problem_from_numpy
    from cartographer_tpu_torch.parallel import schur_spa
    from cartographer_tpu_torch.simulation import synthetic_pose_graph

    arrays, _, _ = synthetic_pose_graph(S, N, 4 * N + 16, seed=seed, pose_noise=0.005)
    arrays["node_fixed"][97::97] = True
    if S == 1:
        arrays["submap_fixed"][0] = False
        arrays["node_fixed"][0] = True
    if S > 2:
        arrays["submap_fixed"][S // 2] = True
    reached = np.zeros(S, bool)
    reached[arrays["a_idx"][arrays["valid"]]] = True
    arrays["submap_fixed"] |= ~reached
    p = schur_problem_from_numpy(arrays, dev)
    wmax = schur_spa.max_weight(p)
    return schur_spa.normalized(p, wmax), 10.0 / wmax


@pytest.mark.parametrize("S", [1, 8, 64])
@pytest.mark.parametrize("N", [1, 2, 3, 120, 1000, 4096])
def test_schur_spa_2d_kernel_shapes(dev, N, S):
    """K8 against its twin over 2 iterations at N node blocks (the band's
    cyclic reduction at 0, 1, 2, 7, 10 and 12 levels, N not always a power
    of two) and S submaps (X's 4, 25 and 193 columns; the reduced system at
    3, 24 and 192 rows, in clusters of 1, 2 and 8 blocks), with frozen
    nodes and submaps: the accept flags equal, the poses within the twin's
    1e-3, the costs at the start within 1e-4 and at each candidate within
    1e-3. The twin runs in float64 here: on 3 nodes against 8 or 64
    submaps its float32 Thomas chain lands 4.9 and 0.7 mm from its own
    float64 form after 2 iterations (the band's weak submap terms cancel
    against its strong node-node ones), where the cyclic reduction's
    float32 lands 8e-6 and 3.5e-5 m from it (the same solves on the CPU).
    A candidate near the optimum has residuals of some 1e-3 m from poses of
    some 10 m, so float32 fixes its cost to 3-4 digits: on such small
    graphs the first candidate's costs are 2-9e-4 apart."""
    from cartographer_tpu_torch.parallel import schur_spa

    q, hs = _k8_problem(dev, S, N, seed=N + S)
    q64 = dataclasses.replace(q, **{f.name: getattr(q, f.name).double()
                                    for f in dataclasses.fields(q)
                                    if getattr(q, f.name).dtype == torch.float32})
    hk = torch.zeros((2, 4), device=dev)
    hp = torch.zeros((2, 4), dtype=torch.float64, device=dev)
    sub, nod = schur_spa._solve_kernel(q, 2, hs, 1e-6, history=hk)
    sub_p, nod_p = schur_spa.solve_plain(q64, 2, hs, 1e-6, history=hp)
    hk, hp = hk.cpu().numpy(), hp.cpu().numpy()
    print(f"N={N} S={S}: kernel {hk.tolist()}, twin {hp.tolist()}")
    assert (hk[:, 2] == hp[:, 2]).all()
    torch.testing.assert_close(sub, sub_p.float(), atol=1e-3, rtol=0)
    torch.testing.assert_close(nod, nod_p.float(), atol=1e-3, rtol=0)
    np.testing.assert_allclose(hk[0, 0], hp[0, 0], rtol=1e-4, atol=0)
    np.testing.assert_allclose(hk[:, :2], hp[:, :2], rtol=1e-3, atol=0)


def test_schur_spa_2d_kernel_not_positive_definite(dev):
    """A damping of -1e4 makes the reduced system indefinite: its Cholesky
    gives NaN on the card as in the twin, both reject the step (the poses
    unchanged bit for bit) and multiply lambda by 8."""
    from cartographer_tpu_torch.parallel import schur_spa

    q, hs = _k8_problem(dev, 8, 120, seed=7)
    for solve in (schur_spa._solve_kernel, schur_spa.solve_plain):
        history = torch.zeros((1, 4), dtype=torch.float32, device=dev)
        sub, nod = solve(q, 1, hs, -1e4, history=history)
        h = history.cpu().numpy()[0]
        assert np.isfinite(h[0]) and not np.isfinite(h[1]) and h[2] == 0.0, (solve, h)
        assert h[3] == np.float32(1e-4) * 8, (solve, h)
        assert torch.equal(sub, q.submap_poses) and torch.equal(nod, q.node_poses)


def test_voxel_filter_kernel_3d_scan(dev):
    """K2 at the shape the 3D frontend gives it: 4096 points, 3D keys, the
    voxel filter and then both adaptive searches."""
    rng = np.random.RandomState(6)
    n = 4096
    pts = rng.uniform(-1.0, 1.0, (n, 3))
    pts /= np.abs(pts).max(axis=1, keepdims=True)
    pts = _t((pts * np.float32([14.0, 9.0, 1.5])).astype(np.float32), dev)
    mask = _t(rng.rand(n) < 0.95, dev)
    perm = _t(rng.permutation(n).astype(np.int32), dev)
    keep = voxel_filter.voxel_filter_mask(pts, mask, 0.15, perm)
    assert torch.equal(keep, voxel_filter.voxel_filter_mask_plain(pts, mask, 0.15, perm))
    cloud = PointCloud(pts, keep, torch.zeros(n, device=dev))
    for max_length, min_num_points, max_range in ((2.0, 150, 15.0), (4.0, 200, 60.0)):
        got = voxel_filter.adaptive_voxel_filter(cloud, max_length, min_num_points, max_range,
                                                 perm).mask
        ref = voxel_filter.adaptive_voxel_filter_mask_plain(pts, keep, max_length,
                                                            min_num_points, max_range, perm)
        assert torch.equal(got, ref) and int(got.sum()) >= min_num_points


def _hall_scan(rng, origin, n=1024):
    d = rng.normal(size=(n, 3))
    d /= np.abs(d).max(axis=1, keepdims=True)
    pts = (origin + d * np.float32([3.0, 2.5, 1.2]) * rng.uniform(0.7, 1.0, (n, 1)))
    return pts.astype(np.float32), rng.rand(n) < 0.9


def _paged_pair(dev, resolution=0.1):
    from cartographer_tpu_torch.ops.paged_grid_3d import PagedSubmapGrid3D

    center = np.float32([0.3, -0.2, 0.1])
    args = dict(page_size=8, max_pages=1024, num_blocks=32)
    card = PagedSubmapGrid3D(resolution, center, device=dev, **args)
    cpu = PagedSubmapGrid3D(resolution, center, device="cpu", **args)
    rng = np.random.RandomState(7)
    for k in range(4):
        origin = np.float32([0.2 * k + 0.013, -0.1 * k + 0.021, 0.037])
        pts, mask = _hall_scan(rng, origin)
        for paged in (card, cpu):
            paged.insert_range_data(origin, pts, mask)
    return card, cpu


def test_paged_insert_kernel(dev):
    from cartographer_tpu_torch.ops import paged_grid_3d

    card, cpu = _paged_pair(dev)
    assert card._slots == cpu._slots
    assert torch.equal(card.grid.page_table.cpu(), cpu.grid.page_table)
    assert torch.equal(card.grid.known.cpu(), cpu.grid.known)
    assert torch.equal(card.grid.pages.cpu(), cpu.grid.pages)
    assert int(card._scratch.state.sum()) == 0  # the state bytes are zero again
    assert int(card.grid.known.sum()) > 3000
    # And against the twin on the card.
    twin = dataclasses.replace(card.grid, pages=card.grid.pages.clone(),
                               known=card.grid.known.clone())
    rng = np.random.RandomState(8)
    origin = np.float32([0.41, 0.33, -0.05])
    pts, mask = _hall_scan(rng, origin)
    o, p, m = _t(origin, dev), _t(pts, dev), _t(mask, dev)
    paged_grid_3d.insert_paged(card.grid, o, p, m, 0.55, 0.49, 2, card._scratch)
    paged_grid_3d.insert_paged_plain(twin, o, p, m, 0.55, 0.49, 2)
    assert torch.equal(card.grid.pages, twin.pages) and torch.equal(card.grid.known, twin.known)


@pytest.mark.parametrize("center,size", [([0.31, -0.22, 0.13], 64), ([0.97, -1.13, 0.52], 48),
                                         ([-12.0, 12.1, 0.2], 64), ([12.6, 12.6, 12.6], 40)])
def test_paged_crop_kernel(dev, center, size):
    from cartographer_tpu_torch.ops import paged_grid_3d

    card, _ = _paged_pair(dev)
    got = card.crop_dense(np.float32(center), size)
    ref = paged_grid_3d.crop_dense_plain(card.grid, _t(np.float32(center), dev), size)
    assert torch.equal(got.log_odds, ref.log_odds) and torch.equal(got.known, ref.known)
    assert torch.equal(got.origin, ref.origin)
    card.compact()
    again = card.crop_dense(np.float32(center), size)
    assert torch.equal(again.log_odds, got.log_odds) and torch.equal(again.known, got.known)


@pytest.mark.parametrize("yaw_only", [False, True])
def test_scan_matcher_3d_kernel(dev, yaw_only):
    from cartographer_tpu_torch.ops import scan_matcher_3d

    high, _ = _paged_pair(dev, 0.1)
    low, _ = _paged_pair(dev, 0.3)
    center = np.float32([0.3, 0.0, 0.0])
    hg, lg = high.crop_dense(center, 96), low.crop_dense(center, 48)
    rng = np.random.RandomState(9)
    hp, hm = _hall_scan(rng, np.float32([0.313, -0.079, 0.037]), 256)
    lp, lm = _hall_scan(rng, np.float32([0.313, -0.079, 0.037]), 512)
    x0 = _t(np.float32([0.05, -0.04, 0.02, np.cos(0.01), 0.0, 0.0, np.sin(0.01)]), dev)
    params = scan_matcher_3d.GaussNewtonMatcherParams3D(only_optimize_yaw=yaw_only)
    args = (hg, lg, _t(hp - np.float32([0.313, -0.079, 0.037]), dev), _t(hm, dev),
            _t(lp - np.float32([0.313, -0.079, 0.037]), dev), _t(lm, dev), x0, x0[0:3].clone(),
            params)
    xk, ck, itk = scan_matcher_3d.lm_match_3d(*args)
    xp, cp, itp = scan_matcher_3d._match_plain(*args)
    torch.testing.assert_close(xk, xp, atol=1e-4, rtol=0)
    torch.testing.assert_close(ck, cp, atol=0, rtol=1e-4)
    assert int(itk) > 1 and float((xk[0:3] - x0[0:3]).norm()) > 1e-3  # it moved


@pytest.mark.parametrize("n,bins", [(512, 120), (300, 120), (64, 60)])
def test_rot_histogram_kernel(dev, n, bins):
    from cartographer_tpu_torch.ops import rot_histogram

    rng = np.random.RandomState(n)
    pts, _ = _hall_scan(rng, np.zeros(3, np.float32), n)
    mask = _t(rng.rand(n) < 0.9, dev)
    pts = _t(pts, dev)
    got = rot_histogram.compute_rotational_histogram(pts, mask, bins)
    ref = rot_histogram.rotational_histogram_plain(pts, mask, bins)
    assert torch.equal(got, ref) and float(got.sum()) > 1.0
    empty = rot_histogram.compute_rotational_histogram(pts, torch.zeros_like(mask), bins)
    assert torch.equal(empty, torch.zeros(bins, device=dev))
    for angle in (0.0, 0.4, -2.0, 7.0):
        a = torch.tensor(angle, dtype=torch.float32, device=dev)
        assert torch.equal(rot_histogram.rotate_histogram(got, a),
                           rot_histogram.rotate_histogram_plain(got, a))


def test_rot_match_kernel(dev):
    from cartographer_tpu_torch.ops import rot_histogram

    rng = np.random.RandomState(13)
    scan, submap = (_t(rng.rand(120).astype(np.float32), dev) for _ in range(2))
    angles = _t(rng.uniform(-4.0, 4.0, 1259).astype(np.float32), dev)
    got = rot_histogram.match_histograms(submap, scan, angles)
    ref = rot_histogram.match_histograms_plain(submap, scan, angles)
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)


def _occupied_grid_3d(rng, dev, size=64, resolution=0.2):
    """A 3D grid with eight random planes of occupied cells, known
    everywhere, and points on them."""
    from cartographer_tpu_torch.ops.grid_3d import Grid3D

    log_odds = torch.full((size,) * 3, -2.0, device=dev)
    cells = []
    for _ in range(8):
        u = rng.randint(size // 8, size - size // 8, (600, 2))
        cells.append(np.insert(u, rng.randint(3), rng.randint(size // 4, 3 * size // 4), axis=1))
    cells = np.concatenate(cells)
    c = torch.from_numpy(cells).to(dev)
    log_odds[c[:, 0], c[:, 1], c[:, 2]] = 2.0
    origin = -0.5 * size * resolution
    grid = Grid3D(log_odds, torch.ones((size,) * 3, dtype=torch.bool, device=dev),
                  torch.full((3,), origin, device=dev), resolution)
    return grid, (cells + 0.37).astype(np.float32) * resolution + origin


@pytest.mark.parametrize("depth,frd", [(4, 3), (8, 3)])
def test_bnb3d_stack_kernel(dev, depth, frd):
    from cartographer_tpu_torch.ops import bnb_3d

    grid, _ = _occupied_grid_3d(np.random.RandomState(depth), dev, size=128)
    grid = dataclasses.replace(grid, known=_t(np.random.RandomState(1).rand(128, 128, 128) < 0.7,
                                              dev))
    got = bnb_3d.build_precomputation_stack_3d(grid, depth, frd)
    ref = bnb_3d.stack_plain(grid, depth, frd)
    assert torch.equal(got.full, ref.full) and torch.equal(got.coarse, ref.coarse)


def test_bnb3d_search_kernels(dev):
    from cartographer_tpu_torch.ops import bnb_3d, rot_histogram

    rng = np.random.RandomState(5)
    grid, points = _occupied_grid_3d(rng, dev)
    low = dataclasses.replace(grid, log_odds=grid.log_odds[::2, ::2, ::2].contiguous(),
                              known=grid.known[::2, ::2, ::2].contiguous(), resolution=0.4)
    stack = bnb_3d.build_precomputation_stack_3d(grid, 4, 3)
    world = points[rng.choice(len(points), 512, replace=False)]
    c, s = np.cos(0.1), np.sin(0.1)
    local = ((world - np.float32([0.4, -0.2, 0.2]))
             @ np.float32([[c, -s, 0], [s, c, 0], [0, 0, 1]])).astype(np.float32)
    hp, lp = _t(local[:256], dev), _t(local, dev)
    hm, lm = (torch.ones(n, dtype=torch.bool, device=dev) for n in (256, 512))
    hist = rot_histogram.compute_rotational_histogram(hp, hm, 120)
    params = bnb_3d.FastCorrelativeMatcherParams3D(
        branch_and_bound_depth=4, min_rotational_score=0.0, min_low_resolution_score=0.0,
        linear_xy_search_window=1.0, linear_z_search_window=0.4, beam_width=512,
        max_scan_range=8.0)
    init_t, init_q = torch.zeros(3, device=dev), _t(np.float32([1, 0, 0, 0]), dev)
    yaw_q = torch.nn.functional.normalize(torch.randn(33, 4, device=dev), dim=-1)
    assert torch.equal(bnb_3d.discretize(hp, yaw_q, init_q, init_t, grid.origin, 0.2),
                       bnb_3d.discretize_plain(hp, yaw_q, init_q, init_t, grid.origin, 0.2))
    args = (stack, grid, low, hp, hm, lp, lm, hist, hist, init_t, init_q, params, 0.3)
    got = bnb_3d.fast_correlative_match_3d(*args)
    ref = bnb_3d.fast_correlative_match_3d(*args, plain=True)
    assert torch.equal(got, ref) and float(got[0]) == 1.0


@pytest.mark.parametrize("iterations", [1, 2, 30])
def test_schur_spa_3d_kernel(dev, iterations):
    """K16 against its twin, iteration by iteration. Atomics reorder the
    kernel's cost sums (float32, about 1e-7 relative), so once an LM step
    changes the cost by less than that, the accept test is a tie that either
    side may take either way, and from there lambda and the path differ.
    Until the accept flags part the costs agree at 1e-4; every decision they
    take apart is such a near-tie on both sides; both end at the same cost.
    Over the steps that lower the cost by more than 1e-5, which no rounding
    flips, the states agree at 1e-3. After 30 iterations both have
    converged."""
    from cartographer_tpu_torch.simulation import synthetic_pose_graph_3d

    arrays, truth_t, _ = synthetic_pose_graph_3d(8, 200, 640, seed=2)
    _check_schur_spa_3d(dev, arrays, truth_t, iterations)


def _k16_graph(S, N, seed):
    """A synthetic SE(3) pose graph of S reduced slots and N nodes with frozen
    nodes and dims: every 97th node frozen, roll and pitch frozen on every
    13th. S = 1: the graph of 3 slots cut to its first (freed), its binary
    terms to that slot, no IMU terms, node 0 frozen. The poses start 5 mm
    from the truth, as a running pose graph's solve starts from the last
    solution: from 5 cm the first step of a 6-node graph lowers the cost
    3,500-fold, and the float32 candidate cost is then fixed only to about
    2e-4 by either elimination order (on the CPU the twin's own Thomas
    chain lands 1.9e-4 from its float64 form), which a 1e-4 check of the
    costs cannot tell from a fault."""
    from cartographer_tpu_torch.simulation import synthetic_pose_graph_3d

    arrays, truth_t, _ = synthetic_pose_graph_3d(max(S, 3), N, 4 * N + 16, seed=seed,
                                                 pose_noise=0.005)
    arrays["acc_delta_v"] = arrays["acc_delta_v"].reshape(-1, 3)
    if S == 1:
        keep = arrays["a_idx"] == 0
        for k in ("a_idx", "b_idx", "rel_t", "rel_q", "trans_weight", "rot_weight",
                  "use_huber", "valid"):
            arrays[k] = arrays[k][keep]
        for k in ("sub_t", "sub_q", "sub_free", "grav_clamp"):
            arrays[k] = arrays[k][:1]
        arrays["sub_free"][:] = True
        for k in ("rot_i", "rot_traj", "rot_delta_q", "rot_weight_c", "rot_valid", "acc_i",
                  "acc_traj", "acc_delta_v", "acc_dt1", "acc_dt2", "acc_weight", "acc_valid"):
            arrays[k] = arrays[k][:0]
        arrays["node_free"][0] = False
    arrays["node_free"][::97] = False
    arrays["node_free"][5::13, 3:5] = False
    return arrays, truth_t


@pytest.mark.parametrize("S", [1, 8, 64])
@pytest.mark.parametrize("pairs", [1, 3, 100, 350, 2048])
def test_schur_spa_3d_kernel_shapes(dev, pairs, S):
    """K16 against its twin over 2 iterations at N/2 = `pairs` super-blocks
    (the band's cyclic reduction at 0, 2, 7, 9 and 11 levels) and S reduced
    slots (1, 1 or 4 column tiles of X), with frozen nodes and dims: the
    checks and tolerances of test_schur_spa_3d_kernel."""
    arrays, truth_t = _k16_graph(S, 2 * pairs, seed=pairs + S)
    _check_schur_spa_3d(dev, arrays, truth_t, 2)


def test_schur_spa_3d_kernel_not_positive_definite(dev):
    """A damping of -1e4 makes the reduced system indefinite: its Cholesky
    gives NaN on the card as in the twin, both reject the step (the state
    unchanged bit for bit) and multiply lambda by 8."""
    from cartographer_tpu_torch.interop import schur_problem_3d_from_numpy
    from cartographer_tpu_torch.parallel import schur_spa_3d

    arrays, _ = _k16_graph(8, 200, seed=7)
    p = schur_problem_3d_from_numpy(arrays, dev)
    wmax = schur_spa_3d.max_weight(p)
    pp = schur_spa_3d.pad_even(schur_spa_3d.normalized(p, wmax))
    for solve in (schur_spa_3d._solve_kernel, schur_spa_3d.solve_plain):
        history = torch.zeros((1, 4), dtype=torch.float32, device=dev)
        out = solve(pp, 1, 10.0 / wmax, -1e4, history=history)
        h = history.cpu().numpy()[0]
        assert np.isfinite(h[0]) and not np.isfinite(h[1]) and h[2] == 0.0, (solve, h)
        assert h[3] == np.float32(1e-4) * 8, (solve, h)
        for got, start in zip(out, (pp.sub_t, pp.sub_q, pp.node_t, pp.node_q)):
            assert torch.equal(got, start)


@pytest.mark.parametrize("n", [3, 6, 66, 192, 384, 1200, -192, -384])
def test_schur_reduced_cholesky_kernel(dev, n):
    """The reduced-system Cholesky of K8 and K16 alone (csrc/schur_reduced.cuh
    in one cluster: 1 block at 3 and 6 rows, 8 at 192 (K8 at capacity), 16
    at 384 (K16 at capacity); at 1,200 its rows in device memory) against a
    float64 solve: within 1e-4 of the solution's scale on a
    well-conditioned system (cond below 10); an indefinite system (n < 0:
    the same with its diagonal's sign flipped on one row) gives NaN."""
    from cartographer_tpu_torch.parallel import schur_spa

    m = abs(n)
    rng = np.random.RandomState(m)
    R = rng.randn(m, m)
    P = R @ R.T / m + np.eye(m)
    if n < 0:
        P[m // 2, m // 2] = -P[m // 2, m // 2]
    b = rng.randn(m)
    x = schur_spa.reduced_cholesky_solve(_t(P.astype(np.float32), dev),
                                         _t(b.astype(np.float32), dev)).cpu().numpy()
    if n < 0:
        assert np.isnan(x).any()
        return
    ref = np.linalg.solve(P, b)
    assert np.abs(x - ref).max() <= 1e-4 * np.abs(ref).max()


def _check_schur_spa_3d(dev, arrays, truth_t, iterations):
    """test_schur_spa_3d_kernel's checks of K16 against its twin on the
    problem `arrays`."""
    from cartographer_tpu_torch.interop import schur_problem_3d_from_numpy
    from cartographer_tpu_torch.parallel import schur_spa_3d

    p = schur_problem_3d_from_numpy(arrays, dev)
    wmax = schur_spa_3d.max_weight(p)
    pp = schur_spa_3d.pad_even(schur_spa_3d.normalized(p, wmax))

    def run(solve, n):
        history = torch.zeros((n, 4), dtype=torch.float32, device=dev)
        return solve(pp, n, 10.0 / wmax, 1e-6, history=history), history.cpu().numpy()

    got, hk = run(schur_spa_3d._solve_kernel, iterations)
    ref, hp = run(schur_spa_3d.solve_plain, iterations)
    for i, (k, r) in enumerate(zip(hk, hp)):
        print(f"iteration {i}: kernel cost {k[0]:.9g} -> {k[1]:.9g} accept {k[2]:.0f}, "
              f"twin cost {r[0]:.9g} -> {r[1]:.9g} accept {r[2]:.0f}")
    parted = np.flatnonzero(hk[:, 2] != hp[:, 2])
    d = int(parted[0]) if parted.size else iterations
    gap = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    print(f"accept flags part at iteration {d} of {iterations}; states {gap:.3g} apart")
    np.testing.assert_allclose(hk[:d, :2], hp[:d, :2], rtol=1e-4, atol=0)
    for i in parted:
        for h in (hk, hp):
            assert abs(h[i, 1] - h[i, 0]) <= 1e-5 * h[i, 0], (i, h[i])
    np.testing.assert_allclose(hk[-1, 0], hp[-1, 0], rtol=1e-4, atol=0)
    ends = (got[2], ref[2])
    small = np.flatnonzero(hp[:, 0] - hp[:, 1] < 1e-5 * hp[:, 0])
    steps = int(small[0]) if small.size else iterations
    assert steps == iterations or steps >= 3
    if steps < iterations:
        (got, hk), (ref, _) = run(schur_spa_3d._solve_kernel, steps), run(schur_spa_3d.solve_plain,
                                                                          steps)
        assert (hk[:, 2] == hp[:steps, 2]).all()
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-3, rtol=0)
    if iterations > 2:
        for nodes in ends:
            err = np.abs(nodes.cpu().numpy()[:len(truth_t)] - truth_t).mean()
            assert err < 0.1 * np.abs(arrays["node_t"] - truth_t).mean()


def _intensity_pair(dev):
    """The same intensity pools on the card and on the CPU after four scans."""
    from cartographer_tpu_torch.ops.paged_grid_3d import PagedIntensitySubmapGrid3D

    center = np.float32([0.3, -0.2, 0.1])
    args = dict(page_size=8, max_pages=1024, num_blocks=32)
    card = PagedIntensitySubmapGrid3D(0.1, center, device=dev, **args)
    cpu = PagedIntensitySubmapGrid3D(0.1, center, device="cpu", **args)
    rng = np.random.RandomState(17)
    for k in range(4):
        pts, mask = _hall_scan(rng, np.float32([0.2 * k + 0.013, -0.1 * k + 0.021, 0.037]))
        intens = (rng.rand(len(pts)) * 60.0).astype(np.float32)
        for paged in (card, cpu):
            paged.insert(pts, intens, mask, 40.0)
    return card, cpu


def test_paged_intensity_insert_kernel(dev):
    """K18: counts and sums equal to the CPU twin's bit for bit, and the
    same to the bit from run to run (each cell adds its returns in their
    order)."""
    import dataclasses

    from cartographer_tpu_torch.ops import paged_grid_3d

    card, cpu = _intensity_pair(dev)
    assert card._slots == cpu._slots
    assert torch.equal(card.grid.page_table.cpu(), cpu.grid.page_table)
    assert torch.equal(card.grid.counts.cpu(), cpu.grid.counts)
    assert torch.equal(card.grid.sums.cpu(), cpu.grid.sums)
    assert float(card.grid.counts.sum()) > 2000
    rng = np.random.RandomState(18)
    pts, mask = _hall_scan(rng, np.float32([0.41, 0.33, -0.05]), 4096)
    host = (pts, (rng.rand(4096) * 50.0).astype(np.float32), mask)
    args = tuple(_t(a, dev) for a in host)
    runs = []
    for _ in range(2):
        grid = dataclasses.replace(card.grid, sums=card.grid.sums.clone(),
                                   counts=card.grid.counts.clone())
        paged_grid_3d.insert_intensity_paged(grid, *args, 40.0)
        runs.append(grid)
    assert torch.equal(runs[0].sums, runs[1].sums) and torch.equal(runs[0].counts, runs[1].counts)
    assert not torch.equal(runs[0].counts, card.grid.counts)
    paged_grid_3d.insert_intensity_paged_plain(cpu.grid, *(torch.from_numpy(a) for a in host),
                                               40.0)
    assert torch.equal(runs[0].counts.cpu(), cpu.grid.counts)
    assert torch.equal(runs[0].sums.cpu(), cpu.grid.sums)


@pytest.mark.parametrize("center,size", [([0.31, -0.22, 0.13], 64), ([-12.0, 12.1, 0.2], 64),
                                         ([12.6, 12.6, 12.6], 40)])
def test_paged_intensity_crop_kernel(dev, center, size):
    """K19: the window exactly, including windows beyond the page table."""
    from cartographer_tpu_torch.ops import paged_grid_3d

    card, _ = _intensity_pair(dev)
    got = card.crop_dense(np.float32(center), size)
    ref = paged_grid_3d.crop_dense_intensity_plain(card.grid, _t(np.float32(center), dev), size)
    assert torch.equal(got.sums, ref.sums) and torch.equal(got.counts, ref.counts)
    assert torch.equal(got.origin, ref.origin)


def test_scan_matcher_3d_kernel_with_intensities(dev):
    """K11 with its intensity rows against the twin, within 1e-4."""
    from cartographer_tpu_torch.ops import scan_matcher_3d

    high, _ = _paged_pair(dev, 0.1)
    low, _ = _paged_pair(dev, 0.3)
    inten, _ = _intensity_pair(dev)
    center = np.float32([0.3, 0.0, 0.0])
    hg, lg, ig = high.crop_dense(center, 96), low.crop_dense(center, 48), inten.crop_dense(
        center, 96)
    assert torch.equal(hg.origin, ig.origin)
    rng = np.random.RandomState(19)
    shift = np.float32([0.313, -0.079, 0.037])
    hp, hm = _hall_scan(rng, shift, 256)
    lp, lm = _hall_scan(rng, shift, 512)
    hi = _t((rng.rand(256) * 50.0).astype(np.float32), dev)
    x0 = _t(np.float32([0.05, -0.04, 0.02, np.cos(0.01), 0.0, 0.0, np.sin(0.01)]), dev)
    params = scan_matcher_3d.GaussNewtonMatcherParams3D(intensity_weight=0.5)
    args = (hg, lg, _t(hp - shift, dev), _t(hm, dev), _t(lp - shift, dev), _t(lm, dev), x0,
            x0[0:3].clone(), params, ig, hi)
    xk, ck, itk = scan_matcher_3d.lm_match_3d(*args)
    xp, cp, itp = scan_matcher_3d._match_plain(*args)
    torch.testing.assert_close(xk, xp, atol=1e-4, rtol=0)
    torch.testing.assert_close(ck, cp, atol=0, rtol=1e-4)
    without, cost_without, _ = scan_matcher_3d.lm_match_3d(*args[:9])
    assert float(cost_without) < float(ck)  # the intensity rows add to the cost


@pytest.mark.parametrize("window,max_range", [(np.radians(1.0), 60.0), (0.05, 6.0)])
def test_correlative_3d_kernel(dev, window, max_range):
    """K17: the score and the pose bit for bit against the twin, at the
    default window (27 to 125 of the 21^3 rotations valid) and at a window
    where every rotation of the static grid is valid."""
    from cartographer_tpu_torch.ops import scan_matcher_3d

    high, _ = _paged_pair(dev, 0.1)
    grid = high.crop_dense(np.float32([0.3, 0.0, 0.0]), 96)
    rng = np.random.RandomState(23)
    shift = np.float32([0.313, -0.079, 0.037])
    pts, mask = _hall_scan(rng, shift, 512)
    pts = pts - shift
    if max_range == 6.0:
        pts[0] = [5.0, 4.0, 1.0]  # about 6.5 m: every angle of the 7 is valid
        mask[0] = True
    params = scan_matcher_3d.CorrelativeSearchParams3D(
        linear_search_window=0.15, angular_search_window=window, max_scan_range=max_range)
    x0 = _t(np.float32([0.04, -0.03, 0.01, np.cos(0.005), 0.0, 0.0, np.sin(0.005)]), dev)
    args = (grid, _t(pts, dev), _t(mask, dev), x0, params)
    score, x, best = scan_matcher_3d._correlative_kernel(*args)
    ref_score, ref_x, ref_index = scan_matcher_3d.correlative_match_3d_plain(*args)
    flat = ~int(best.cpu()) & 0xFFFFFFFF
    assert flat == ref_index
    assert float(score) == float(ref_score) and torch.equal(x[0:3], ref_x[0:3])
    torch.testing.assert_close(x[3:7], ref_x[3:7], atol=1e-6, rtol=0)


# ---------------------------------------------------------------- scan sizes above one block


@pytest.mark.parametrize("n", [4096, 8192, 16384])
def test_correlative_2d_kernel_large(dev, n):
    """K5 at its former one-block limit (4,096 points) and above it (the
    fold), scores and best candidate bit for bit against the twin."""
    from cartographer_tpu_torch.ops import correlative_2d

    grid, _ = _card_grid(dev)
    rng = np.random.RandomState(n)
    pts = _t(_room(rng, n)[:, :2].astype(np.float32) * np.float32(0.5), dev)
    mask = _t(rng.rand(n) < 0.9, dev)
    params = correlative_2d.CorrelativeSearchParams(max_scan_range=12.0)
    x0 = _t(np.float32([0.23, -0.12, 0.02]), dev)
    best, scores = correlative_2d.correlative_match(grid, pts, mask, x0, params)
    best_p, scores_p = correlative_2d.correlative_match_plain(grid, pts, mask, x0, params)
    assert torch.equal(scores, scores_p)
    assert torch.equal(best, best_p)


@pytest.mark.parametrize("n", [1024, 2048, 4096])
def test_bnb_score_kernel_large(dev, n):
    """K7 at its former one-warp limit (1,024 points) and above it (the
    fold), bit for bit against the twin on three pyramid levels."""
    from cartographer_tpu_torch.ops import bnb_2d

    grid, _ = _card_grid(dev)
    pyr = bnb_2d.build_precomputation_pyramid(grid, 7)
    rng = np.random.RandomState(n)
    cells = _t(rng.randint(-20, SIZE + 20, (31, n, 2)).astype(np.int32), dev)
    mask = _t(rng.rand(n) < 0.8, dev)
    b = 5000
    a_idx = _t(rng.randint(0, 31, b).astype(np.int32), dev)
    ox = _t(rng.randint(-64, 64, b).astype(np.int32), dev)
    oy = _t(rng.randint(-64, 64, b).astype(np.int32), dev)
    for h in (0, 3, 6):
        got = bnb_2d.score_candidates(pyr[h], cells, mask, a_idx, ox, oy)
        assert torch.equal(got, bnb_2d.score_candidates_plain(pyr[h], cells, mask, a_idx, ox, oy))


@pytest.mark.parametrize("n,bins", [(1024, 120), (2048, 120), (8192, 120), (2048, 2048)])
def test_rot_histogram_kernel_large(dev, n, bins):
    """K12 at its former one-block limit (1,024 points) and above it (the
    device-memory scratch and the multi-block key sort), up to 2,048 bins,
    bit for bit against the twin."""
    from cartographer_tpu_torch.ops import rot_histogram

    rng = np.random.RandomState(n + bins)
    pts, mask = _hall_scan(rng, np.zeros(3, np.float32), n)
    pts, mask = _t(pts, dev), _t(mask, dev)
    got = rot_histogram.compute_rotational_histogram(pts, mask, bins)
    ref = rot_histogram.rotational_histogram_plain(pts, mask, bins)
    assert torch.equal(got, ref) and float(got.sum()) > 1.0


@pytest.mark.parametrize("bins", [1024, 2048])
def test_rot_match_kernel_large(dev, bins):
    """K13 at its former one-block limit (1,024 bins) and above it (the
    fold), bit for bit against the twin."""
    from cartographer_tpu_torch.ops import rot_histogram

    rng = np.random.RandomState(bins)
    scan, submap = (_t(rng.rand(bins).astype(np.float32), dev) for _ in range(2))
    angles = _t(rng.uniform(-4.0, 4.0, 1259).astype(np.float32), dev)
    got = rot_histogram.match_histograms(submap, scan, angles)
    assert torch.equal(got, rot_histogram.match_histograms_plain(submap, scan, angles))


@pytest.mark.parametrize("n", [2048, 4096, 8192])
def test_correlative_3d_kernel_large(dev, n):
    """K17 at its former one-block limit (2,048 points) and above it (cells
    in a device scratch, the fold above 4,096): score, pose and flat index
    bit for bit against the twin."""
    from cartographer_tpu_torch.ops import scan_matcher_3d

    high, _ = _paged_pair(dev, 0.1)
    grid = high.crop_dense(np.float32([0.3, 0.0, 0.0]), 96)
    rng = np.random.RandomState(n)
    shift = np.float32([0.313, -0.079, 0.037])
    pts, mask = _hall_scan(rng, shift, n)
    params = scan_matcher_3d.CorrelativeSearchParams3D(
        linear_search_window=0.15, angular_search_window=np.radians(1.0), max_scan_range=60.0)
    x0 = _t(np.float32([0.04, -0.03, 0.01, np.cos(0.005), 0.0, 0.0, np.sin(0.005)]), dev)
    args = (grid, _t(pts - shift, dev), _t(mask, dev), x0, params)
    score, x, best = scan_matcher_3d._correlative_kernel(*args)
    ref_score, ref_x, ref_index = scan_matcher_3d.correlative_match_3d_plain(*args)
    assert ~int(best.cpu()) & 0xFFFFFFFF == ref_index
    assert float(score) == float(ref_score) and torch.equal(x[0:3], ref_x[0:3])
    torch.testing.assert_close(x[3:7], ref_x[3:7], atol=1e-6, rtol=0)


@pytest.mark.parametrize("n", [4097, 16384, 32768])
def test_voxel_filter_kernel_large(dev, n):
    """K2 above one block's shared memory (its table in device memory): the
    voxel filter with 3D keys and both adaptive searches, masks equal to the
    twin's (exact)."""
    rng = np.random.RandomState(n)
    pts = rng.uniform(-1.0, 1.0, (n, 3))
    pts /= np.abs(pts).max(axis=1, keepdims=True)
    pts = _t((pts * np.float32([14.0, 9.0, 1.5])).astype(np.float32), dev)
    mask = _t(rng.rand(n) < 0.95, dev)
    perm = _t(rng.permutation(n).astype(np.int32), dev)
    keep = voxel_filter.voxel_filter_mask(pts, mask, 0.05, perm)
    assert torch.equal(keep, voxel_filter.voxel_filter_mask_plain(pts, mask, 0.05, perm))
    assert int(keep.sum()) < int(mask.sum())
    cloud = PointCloud(pts, keep, torch.zeros(n, device=dev))
    for max_length, min_num_points, max_range in ((2.0, 150, 15.0), (0.5, 3000, 60.0)):
        got = voxel_filter.adaptive_voxel_filter(cloud, max_length, min_num_points, max_range,
                                                 perm).mask
        ref = voxel_filter.adaptive_voxel_filter_mask_plain(pts, keep, max_length,
                                                            min_num_points, max_range, perm)
        assert torch.equal(got, ref) and int(got.sum()) >= min(min_num_points, int(keep.sum()))


@pytest.mark.parametrize("n", [4097, 16384, 32768])
def test_paged_intensity_insert_kernel_large(dev, n):
    """K18 at and above one block's 8,192 keys (the multi-block sort): pools
    equal to the CPU twin's to the bit after two scans."""
    from cartographer_tpu_torch.ops.paged_grid_3d import PagedIntensitySubmapGrid3D

    center = np.float32([0.3, -0.2, 0.1])
    args = dict(page_size=8, max_pages=4096, num_blocks=32)
    card = PagedIntensitySubmapGrid3D(0.1, center, device=dev, **args)
    cpu = PagedIntensitySubmapGrid3D(0.1, center, device="cpu", **args)
    rng = np.random.RandomState(n + 1)
    for k in range(2):
        pts, mask = _hall_scan(rng, np.float32([0.2 * k + 0.013, -0.1 * k + 0.021, 0.037]), n)
        intens = (rng.rand(n) * 60.0).astype(np.float32)
        for paged in (card, cpu):
            paged.insert(pts, intens, mask, 40.0)
    assert float(cpu.grid.counts.sum()) > 0.5 * n
    assert torch.equal(card.grid.counts.cpu(), cpu.grid.counts)
    assert torch.equal(card.grid.sums.cpu(), cpu.grid.sums)


# The in-order scatter of K18 and K30 (csrc/in_order_scatter.cuh): a cluster
# of one block per 512 returns (up to 16 of 8,192 each), a launch per
# 131,072. Returns sit at cell centers, so a pool index or flat cell places
# them.
THRESHOLD = 40.0
SCATTER_SIZES = [511, 512, 513, 8191, 8192, 8193, 16384, 32768, 131073]
SCATTER_CASES = ["one_cell_8192", "one_cell_32768", "none", "last_cell", "digits"]


def _scatter_case(case, n_cells, place, outside, rng):
    """(points, intensities, mask) of a case, cells given by flat index:
    `place` maps cells to points, `outside` gives n points that add
    nothing for want of a cell."""
    if case.startswith("one_cell"):
        n = int(case.split("_")[-1])
        cells = np.full(n, rng.randint(n_cells))
        return place(cells), rng.uniform(0, THRESHOLD, n).astype(np.float32), np.ones(n, bool)
    n = {"none": 4096, "last_cell": 5000, "digits": 6000}[case]
    if case == "none":
        cells = rng.randint(0, n_cells, n)
    elif case == "last_cell":
        cells = np.full(n, n_cells - 1)
    else:
        cells = rng.choice([0, 0xFF, 0x100, 0xFFFF, 0x10000, n_cells - 1], n)
    pts = place(cells)
    intens = rng.uniform(0, THRESHOLD, n).astype(np.float32)
    mask = np.ones(n, bool)
    # Returns that add nothing, interleaved with the rest: masked out,
    # above the threshold, NaN, without a cell.
    drop = rng.randint(0, 5, n) if case == "none" else rng.choice(5, n, p=[.6, .1, .1, .1, .1])
    mask[drop == 1] = False
    intens[drop == 2] = THRESHOLD + 1.0 + rng.uniform(0, 20, int((drop == 2).sum()))
    intens[drop == 3] = np.nan
    pts[drop == 4] = outside(int((drop == 4).sum()))
    if case == "none":
        drop[drop == 0] = 1
        mask[drop == 1] = False
    return pts, intens, mask


def _default_pool(seed):
    """A pool of the default size (2,048 pages of 16^3: 2^23 cells) behind
    a 16^3-block table whose random half of the blocks holds every page,
    with random old sums and counts; -> (grid on the CPU, place, outside)."""
    from cartographer_tpu_torch.ops.paged_grid_3d import PagedIntensityGrid3D

    rng = np.random.RandomState(seed)
    P, B, nb = 2048, 16, 16
    grid = PagedIntensityGrid3D.create(0.1, np.float32([0.3, -0.2, 0.1]), "cpu", page_size=B,
                                       max_pages=P, num_blocks=nb)
    blocks = rng.choice(nb ** 3, P, replace=False)
    table = np.full(nb ** 3, -1, np.int32)
    table[blocks] = np.arange(P, dtype=np.int32)
    grid.page_table.copy_(torch.from_numpy(table.reshape(nb, nb, nb)))
    grid.sums.copy_(torch.from_numpy(rng.uniform(0, 500, grid.sums.shape).astype(np.float32)))
    grid.counts.copy_(torch.from_numpy(rng.randint(0, 20, grid.counts.shape).astype(np.float32)))
    origin = grid.origin.numpy().astype(np.float64)
    unpaged = np.setdiff1d(np.arange(nb ** 3), blocks)

    def place(cells):
        page, off = np.divmod(cells, B ** 3)
        block = np.stack(np.unravel_index(blocks[page], (nb,) * 3), -1)
        offset = np.stack(np.unravel_index(off, (B,) * 3), -1)
        return (origin + (block * B + offset + 0.5) * 0.1).astype(np.float32)

    def outside(n):  # beyond the table or on a block without a page
        block = np.stack(np.unravel_index(rng.choice(unpaged, n), (nb,) * 3), -1)
        pts = origin + (block * B + rng.randint(0, B, (n, 3)) + 0.5) * 0.1
        far = rng.rand(n) < 0.5
        pts[far] += np.float32(100.0)
        return pts.astype(np.float32)

    return grid, place, outside


def _k18_against_cpu(dev, grid, inputs):
    """Each (points, intensities, mask) of `inputs` into `grid` by K18 on
    the card and by the twin on the CPU; True where both pools end equal."""
    import dataclasses

    from cartographer_tpu_torch.ops import paged_grid_3d

    card = dataclasses.replace(grid, sums=grid.sums.to(dev), counts=grid.counts.to(dev),
                               page_table=grid.page_table.to(dev), origin=grid.origin.to(dev))
    for pts, intens, mask in inputs:
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in (pts, intens, mask)]
        paged_grid_3d.insert_intensity_paged(card, *(a.to(dev) for a in host), THRESHOLD)
        paged_grid_3d.insert_intensity_paged_plain(grid, *host, THRESHOLD)
    torch.cuda.synchronize()
    return (torch.equal(card.counts.cpu(), grid.counts)
            and torch.equal(card.sums.cpu(), grid.sums))


@pytest.mark.parametrize("n", SCATTER_SIZES)
def test_paged_intensity_insert_kernel_sizes(dev, n):
    """K18 about the one-block capacity and the cluster's, on the default
    pool: two scans of clustered returns (long runs), with returns that add
    nothing; sums and counts equal to the CPU twin's bit for bit."""
    grid, place, outside = _default_pool(n)
    rng = np.random.RandomState(n + 3)
    inputs = []
    k = 64 if n >= 4096 else 4  # hot cells: runs of over 10 returns at every size
    for _ in range(2):
        hot = rng.randint(0, 2 ** 23, k)
        cells = np.where(rng.rand(n) < 0.5, hot[rng.randint(0, k, n)], rng.randint(0, 2 ** 23, n))
        pts = place(cells)
        far = rng.rand(n) < 0.05
        pts[far] = outside(int(far.sum()))
        intens = rng.uniform(0, 60, n).astype(np.float32)
        intens[rng.rand(n) < 0.01] = np.nan
        inputs.append((pts, intens, rng.rand(n) < 0.9))
    before = grid.counts.clone()
    assert _k18_against_cpu(dev, grid, inputs)
    assert float((grid.counts - before).max()) > 10


@pytest.mark.parametrize("case", SCATTER_CASES)
def test_paged_intensity_insert_kernel_cases(dev, case):
    """K18 on the default pool: one run of every return, no contributing
    return, the pool's last cell among returns that add nothing, and pool
    indices at the radix digits' boundaries and the top of the key's 23
    bits; equal to the CPU twin bit for bit."""
    grid, place, outside = _default_pool(7)
    before = grid.counts.clone()
    inputs = [_scatter_case(case, 2 ** 23, place, outside, np.random.RandomState(11))]
    assert _k18_against_cpu(dev, grid, inputs)
    added = float((grid.counts - before).sum())
    assert (added == 0) == (case == "none")


def _dense_window(dev, seed):
    """A 256^3 window at 0.1 m with random old sums and counts, on the card
    and on a clone; -> (grid, twin, place, outside)."""
    from cartographer_tpu_torch.ops.grid_3d import IntensityGrid3D

    rng = np.random.RandomState(seed)
    grid = IntensityGrid3D.create(256, 0.1, np.float32([0.113, -0.071, 0.037]), dev)
    grid.sums.copy_(_t(rng.uniform(0, 500, grid.sums.shape).astype(np.float32), dev))
    grid.counts.copy_(_t(rng.randint(0, 20, grid.counts.shape).astype(np.float32), dev))
    twin = dataclasses.replace(grid, sums=grid.sums.clone(), counts=grid.counts.clone())
    origin = grid.origin.cpu().numpy().astype(np.float64)

    def place(cells):
        c = np.stack(np.unravel_index(cells, (256,) * 3), -1)
        return (origin + (c + 0.5) * 0.1).astype(np.float32)

    def outside(n):
        c = rng.randint(0, 256, (n, 3))
        c[np.arange(n), rng.randint(0, 3, n)] = rng.choice([-3, -1, 256, 300], n)
        return (origin + (c + 0.5) * 0.1).astype(np.float32)

    return grid, twin, place, outside


@pytest.mark.parametrize("case", SCATTER_CASES)
def test_dense_intensity_insert_kernel_cases(dev, case):
    """K30 on a 256^3 window: the cases of K18's, the top of the key's 24
    bits the window's last cell; equal to the twin bit for bit."""
    from cartographer_tpu_torch.ops.grid_3d import insert_intensities, insert_intensities_plain

    grid, twin, place, outside = _dense_window(dev, 5)
    before = grid.counts.clone()
    pts, intens, mask = _scatter_case(case, 256 ** 3, place, outside, np.random.RandomState(12))
    args = (_t(pts, dev), _t(intens, dev), _t(mask, dev), THRESHOLD)
    insert_intensities(grid, *args)
    insert_intensities_plain(twin, *args)
    assert torch.equal(grid.sums, twin.sums) and torch.equal(grid.counts, twin.counts)
    assert (float((grid.counts - before).sum()) == 0) == (case == "none")


# ---------------------------------------------------------------- TSDF (K20-K22, K3/K5/K6 forms)


def _tsdf_scan(dev, n, valid, seed=21, origin=(0.031, -0.017)):
    """A room scan of `valid` returns padded to `n` with the sensor origin."""
    rng = np.random.RandomState(seed)
    a = np.sort(rng.uniform(-np.pi, np.pi, valid))
    d = np.stack([np.cos(a), np.sin(a)], -1)
    o = np.asarray(origin, np.float64)
    tx = np.where(d[:, 0] > 0, (5.013 - o[0]) / d[:, 0], (-4.987 - o[0]) / d[:, 0])
    ty = np.where(d[:, 1] > 0, (4.013 - o[1]) / d[:, 1], (-3.987 - o[1]) / d[:, 1])
    r = np.minimum(np.abs(tx), np.abs(ty)) + rng.normal(0, 0.003, valid)
    pts = np.tile(np.float32(origin), (n, 1))
    pts[:valid] = o + r[:, None] * d
    none = PointCloud(torch.zeros(n, 2, device=dev), torch.zeros(n, dtype=torch.bool, device=dev),
                      torch.zeros(n, device=dev))
    return RangeData(_t(np.float32(origin), dev),
                     PointCloud(_t(pts, dev), _t(np.arange(n) < valid, dev),
                                torch.zeros(n, device=dev)), none)


@pytest.mark.parametrize("n,valid", [(300, 300), (2048, 1500), (16384, 12000)])
def test_tsdf_normals_kernel(dev, n, valid):
    """K20 against its twin on the card: the sort (one block, or several at
    16,384) and the normals, within 1e-5 where the neighbourhood is not
    isotropic (there any unit vector is an eigenvector)."""
    from cartographer_tpu_torch.ops import tsdf_2d

    rd = _tsdf_scan(dev, n, valid)
    pts, mask = rd.returns.points, rd.returns.mask
    got = tsdf_2d.estimate_normals_2d(pts, mask, rd.origin)
    ref = tsdf_2d._normals_plain(pts, mask, rd.origin)
    close = (got - ref).abs().max(-1).values <= 1e-5
    assert float(close[mask].float().mean()) >= 0.995
    torch.testing.assert_close(got.norm(dim=-1), torch.ones(n, device=dev), atol=1e-5, rtol=0)


def _tsdf_batch(dev):
    from cartographer_tpu_torch.ops.tsdf_2d import TsdfGrid2D

    origins = _t(np.float32([[-6.4, -6.4], [-6.1, -6.3]]), dev)
    return TsdfGrid2D(torch.zeros(2, SIZE, SIZE, device=dev), torch.zeros(2, SIZE, SIZE,
                                                                          device=dev),
                      origins, 0.05)


def test_tsdf_insert_kernel(dev):
    """K21 against its in-order twin on the card over three scans (one with
    slot 1 inactive, one with do_insert False): tsd and weight bit for bit
    (both add each cell's samples in input order), and a second run
    repeats them."""
    from cartographer_tpu_torch.ops import tsdf_2d

    runs = []
    for _ in range(2):
        card, plain = _tsdf_batch(dev), _tsdf_batch(dev)
        params = tsdf_2d.TsdfInserterParams()
        for k, (active, do) in enumerate((([True, False], True), ([True, True], False),
                                          ([True, True], True))):
            rd = _tsdf_scan(dev, 2048, 1500, seed=30 + k, origin=(0.05 * k + 0.031, -0.017))
            a, d = _t(np.array(active), dev), torch.tensor(do, device=dev)
            normals = tsdf_2d._normals_plain(rd.returns.points, rd.returns.mask, rd.origin)
            tsdf_2d.insert_into_slots_tsdf(card, rd, a, d, params, normals=normals)
            tsdf_2d._insert_plain(plain, rd, normals, a, d, params)
        assert int((plain.weight > 0).sum()) > 5000
        assert torch.equal(card.weight, plain.weight)
        assert torch.equal(card.tsd, plain.tsd)
        runs.append(card)
    assert torch.equal(runs[0].tsd, runs[1].tsd) and torch.equal(runs[0].weight, runs[1].weight)


@pytest.mark.parametrize("n", [512, 4096, 6144, 8192])
def test_tsdf_insert_kernel_sizes(dev, n):
    """K21 bit for bit against its twin where the two slots' 2 x 16 x n
    samples take one launch of the in-order routine (16,384 and 131,072)
    and two (196,608, the second slot's cells split between them, and
    262,144), with the range-exponent and no-projection options."""
    from cartographer_tpu_torch.ops import tsdf_2d

    card, plain = _tsdf_batch(dev), _tsdf_batch(dev)
    params = tsdf_2d.TsdfInserterParams(update_weight_range_exponent=1,
                                        project_to_normal=n != 4096)
    rd = _tsdf_scan(dev, n, n * 3 // 4, seed=50, origin=(0.031, -0.017))
    normals = tsdf_2d._normals_plain(rd.returns.points, rd.returns.mask, rd.origin)
    yes = torch.tensor(True, device=dev)
    both = _t(np.array([True, True]), dev)
    tsdf_2d.insert_into_slots_tsdf(card, rd, both, yes, params, normals=normals)
    tsdf_2d._insert_plain(plain, rd, normals, both, yes, params)
    assert int((plain.weight > 0).sum()) > 500
    assert torch.equal(card.weight, plain.weight)
    assert torch.equal(card.tsd, plain.tsd)


def _tsdf_grid(dev):
    from cartographer_tpu_torch.ops import tsdf_2d

    batch = _tsdf_batch(dev)
    for k in range(3):
        rd = _tsdf_scan(dev, 2048, 1500, seed=40 + k, origin=(0.04 * k + 0.031, -0.017))
        normals = tsdf_2d._normals_plain(rd.returns.points, rd.returns.mask, rd.origin)
        tsdf_2d._insert_plain(batch, rd, normals, _t(np.array([True, True]), dev),
                              torch.tensor(True, device=dev), tsdf_2d.TsdfInserterParams())
    return batch.slot(0), rd


def test_tsdf_lm_kernel(dev):
    """K22 against its twin, within 1e-4 (pose) and 1e-4 relative (cost)."""
    from cartographer_tpu_torch.ops import tsdf_2d

    grid, rd = _tsdf_grid(dev)
    params = scan_matcher_2d.GaussNewtonMatcherParams2D()
    pts, mask = rd.returns.points[:512], rd.returns.mask[:512]
    x0 = _t(np.float32([0.11, -0.05, 0.01]), dev)
    args = (grid, pts, mask, x0, x0[0:2] - 0.02, params)
    xk, ck, ik = tsdf_2d.lm_match_tsdf_2d(*args)
    xp, cp, ip = tsdf_2d._match_plain(*args)
    torch.testing.assert_close(xk, xp, atol=1e-4, rtol=0)
    torch.testing.assert_close(ck, cp, atol=0, rtol=1e-4)
    assert int(ik) > 1


def test_tsdf_surface_forms_of_k3_k5_k6(dev):
    """K3, K5 and K6 on the score surface of a TSDF grid against their
    twins: K3 within 1e-4, K5's scores and argmax and K6's levels exact."""
    from cartographer_tpu_torch.ops import bnb_2d, correlative_2d

    grid, rd = _tsdf_grid(dev)
    params = scan_matcher_2d.GaussNewtonMatcherParams2D()
    pts, mask = rd.returns.points[:512], rd.returns.mask[:512]
    x0 = _t(np.float32([0.09, -0.04, 0.02]), dev)
    args = (grid, pts, mask, x0, x0[0:2], params)
    xk, ck, _ = scan_matcher_2d.lm_match_2d(*args)
    xp, cp, _ = scan_matcher_2d._match_plain(*args)
    torch.testing.assert_close(xk, xp, atol=1e-4, rtol=0)
    torch.testing.assert_close(ck, cp, atol=0, rtol=1e-4)
    cparams = correlative_2d.CorrelativeSearchParams(max_scan_range=12.0)
    best, scores = correlative_2d.correlative_match(grid, pts, mask, x0, cparams)
    best_p, scores_p = correlative_2d.correlative_match_plain(grid, pts, mask, x0, cparams)
    assert torch.equal(scores, scores_p) and torch.equal(best, best_p)
    pyr = bnb_2d.build_precomputation_pyramid(grid, 7)
    assert torch.equal(pyr, bnb_2d.pyramid_plain(grid, 7))


def _tsdf_robots(dev, n):
    """Three robots' TSDF scans of n points (RangeData with a leading R) and
    their windows (two slots each, a scan inserted by the twin), each robot
    with its own scan, sensor origin and grid origins."""
    from cartographer_tpu_torch.ops import tsdf_2d

    rds, grids = [], []
    for r in range(3):
        origin = (0.031 + 0.04 * r, -0.017 + 0.01 * r)
        rds.append(_tsdf_scan(dev, n, n * 3 // 4 - 97 * r, seed=60 + r, origin=origin))
        g = _tsdf_batch(dev)
        g = dataclasses.replace(g, origin=g.origin + 0.013 * (r + 1))
        prior = _tsdf_scan(dev, n, n // 2, seed=80 + r, origin=origin)
        tsdf_2d._insert_plain(g, prior, tsdf_2d._normals_plain(
            prior.returns.points, prior.returns.mask, prior.origin),
            _t(np.array([True, True]), dev), torch.tensor(True, device=dev),
            tsdf_2d.TsdfInserterParams())
        grids.append(g)
    stack = lambda ts: torch.stack(ts)  # noqa: E731
    rd = RangeData(stack([x.origin for x in rds]),
                   PointCloud(stack([x.returns.points for x in rds]),
                              stack([x.returns.mask for x in rds]),
                              stack([x.returns.intensities for x in rds])),
                   PointCloud(stack([x.misses.points for x in rds]),
                              stack([x.misses.mask for x in rds]),
                              stack([x.misses.intensities for x in rds])))
    return rd, rds, grids


def _graph_kernels(fn):
    """Kernels one call of fn() launches: the kernel nodes of a CUDA graph
    captured around it."""
    import ctypes

    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    libcuda = ctypes.CDLL("libcuda.so.1")
    raw, count = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    assert libcuda.cuGraphGetNodes(raw, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    libcuda.cuGraphGetNodes(raw, nodes, ctypes.byref(count))
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        libcuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kinds.append(kind.value)
    return kinds.count(0)  # CU_GRAPH_NODE_TYPE_KERNEL


@pytest.mark.parametrize("robots", [1, 3])
@pytest.mark.parametrize("n", [2048, 16384])
def test_robot_batched_tsdf_kernels(dev, robots, n):
    """K20 and K21 with a robot index (the batched step's TSDF insertion):
    one call for R robots of different scans and grids equals each robot's
    own call bit for bit; K21 equals its twin bit for bit robot by robot
    (slot 1 inactive for some robots, do_insert False for one), K20 its twin
    at the single-robot test's tolerance. K20 takes the kernels of one
    robot's call at every R: 3, and 5 at 16,384 points (the sort over
    several tiles, its runs side by side); each robot's K21 items take four
    chunks there."""
    from cartographer_tpu_torch.ops import tsdf_2d

    rd, rds, grids = _tsdf_robots(dev, n)
    rd = rd if robots == 3 else RangeData(rd.origin[:1], PointCloud(
        rd.returns.points[:1], rd.returns.mask[:1], rd.returns.intensities[:1]), PointCloud(
        rd.misses.points[:1], rd.misses.mask[:1], rd.misses.intensities[:1]))
    rds, grids = rds[:robots], grids[:robots]
    pts, mask = rd.returns.points, rd.returns.mask
    normals = tsdf_2d.estimate_normals_2d(pts, mask, rd.origin)
    kernels = _graph_kernels(lambda: tsdf_2d.estimate_normals_2d(pts, mask, rd.origin))
    assert kernels == (3 if n <= 8192 else 5)
    for r in range(robots):
        alone = tsdf_2d.estimate_normals_2d(pts[r], mask[r], rd.origin[r])
        assert torch.equal(normals[r], alone)
        ref = tsdf_2d._normals_plain(pts[r], mask[r], rd.origin[r])
        close = (normals[r] - ref).abs().max(-1).values <= 1e-5
        assert float(close[mask[r]].float().mean()) >= 0.995

    params = tsdf_2d.TsdfInserterParams()
    active = _t(np.array([[True, r != 1] for r in range(robots)]), dev)
    do = _t(np.array([r != 2 for r in range(robots)]), dev)
    twins = [g.clone() for g in grids]
    alone = [g.clone() for g in grids]
    before = tsdf_2d._INSERT.launches
    tsdf_2d.insert_into_slots_tsdf(grids, rd, active, do, params, normals=normals)
    assert tsdf_2d._INSERT.launches == before + 1
    for r in range(robots):
        tsdf_2d._insert_plain(twins[r], rds[r], normals[r], active[r], do[r], params)
        tsdf_2d.insert_into_slots_tsdf(alone[r], rds[r], active[r], do[r], params,
                                       normals=normals[r])
        assert int((twins[r].weight > 0).sum()) > 2000
        for g in (twins[r], alone[r]):
            assert torch.equal(grids[r].tsd, g.tsd) and torch.equal(grids[r].weight, g.weight)


# ---------------------------------------------------------------- the scan-match testbed


def _icp_clouds(dev, n, planar=False):
    """A target on the walls of a room (or one tilted plane) and the source:
    the target moved by a small pose, with 10% of either masked out."""
    from cartographer_tpu_torch.transform import quaternion as quat

    rng = np.random.RandomState(n + planar)
    if planar:
        uv = rng.uniform(-4, 4, (n, 2))
        tgt = uv[:, :1] * np.array([0.9, 0.1, 0.2]) + uv[:, 1:] * np.array([-0.1, 0.8, 0.3])
    else:
        tgt, _ = _hall_scan(rng, np.float32([0.3, -0.2, 0.1]), n)
    tgt = _t(tgt.astype(np.float32), dev)
    q = quat.from_axis_angle(_t(np.float32([0.02, -0.01, 0.08]), dev))
    src = quat.rotate(q, tgt) + _t(np.float32([0.21, -0.13, 0.05]), dev)
    return (src.contiguous(), _t(rng.rand(n) < 0.9, dev), tgt, _t(rng.rand(n) < 0.9, dev))


@pytest.mark.parametrize("n", [1000, 4096])
def test_icp_nearest_kernel(dev, n):
    """K23: indices, moved points and valid flags bit for bit against the
    twin (the same elementwise distance form)."""
    from cartographer_tpu_torch.ops import icp

    src, sm, tgt, tm = _icp_clouds(dev, n)
    pose = _t(np.float32([0.1, -0.05, 0.02, np.cos(0.02), 0.0, 0.0, np.sin(0.02)]), dev)
    for max_dist in (0.2, 1.0):
        got = icp.nearest(src, sm, tgt, tm, pose, max_dist)
        ref = icp.nearest_plain(src, sm, tgt, tm, pose, max_dist)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


@pytest.mark.parametrize("planar", [False, True])
def test_icp_kabsch_kernel(dev, planar):
    """K24: one round's R, t and pose within 1e-5 of the twin on the same
    correspondences (general and rank-2 clouds); its stats form exact."""
    from cartographer_tpu_torch.ops import icp

    src, sm, tgt, tm = _icp_clouds(dev, 4096, planar)
    x0 = _t(np.float32([0, 0, 0, 1, 0, 0, 0]), dev)
    nn, world, valid = icp.nearest(src, sm, tgt, tm, x0, 1.0)
    pose, R, t = icp.kabsch(world, tgt, nn, valid, x0)
    pose_p, R_p, t_p = icp.kabsch_plain(world, tgt, nn, valid, x0)
    torch.testing.assert_close(R, R_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(t, t_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(pose, pose_p, atol=1e-5, rtol=0)
    assert torch.equal(torch.stack(icp.stats(world, sm, tgt, nn, valid)),
                       torch.stack(icp.stats_plain(world, sm, tgt, nn, valid)))


def test_icp_match_kernel(dev):
    """The whole card icp_match (30 rounds of K23 + K24, then the stats)
    within 1e-4 m and 1e-4 rad of the twin's on the card."""
    from cartographer_tpu_torch.ops import icp
    from cartographer_tpu_torch.transform import quaternion as quat

    src, sm, tgt, tm = _icp_clouds(dev, 4096)
    x0 = _t(np.float32([0, 0, 0, 1, 0, 0, 0]), dev)
    pose, fit, rmse = icp.icp_match_vector(src, sm, tgt, tm, x0)
    pose_p, fit_p, rmse_p = icp.icp_match_plain(src, sm, tgt, tm, x0, icp.IcpParams())
    torch.testing.assert_close(pose[0:3], pose_p[0:3], atol=1e-4, rtol=0)
    dq = quat.multiply(quat.conjugate(pose_p[3:7]), pose[3:7])
    assert float(quat.to_axis_angle(dq).norm()) < 1e-4
    torch.testing.assert_close(fit, fit_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(rmse, rmse_p, atol=1e-5, rtol=0)
    assert float(fit) > 0.7


def _same_up_to_sign(a, b):
    """Largest componentwise gap between the rows of a and b or -b."""
    return float(torch.minimum((a - b).abs().amax(1), (a + b).abs().amax(1)).max())


@pytest.mark.parametrize("n,k", [(1000, 10), (4096, 10), (700, 16), (300, 3)])
def test_icp_normals_kernel(dev, n, k):
    """K26: neighbour lists exact against the twin (the same distance form
    and tie-break), normals within 1e-5 up to sign (Jacobi against eigh,
    both in double on the same float32 covariance), zero on masked rows."""
    from cartographer_tpu_torch.ops import icp

    _, _, tgt, tm = _icp_clouds(dev, n)
    normals, idx = icp.normals_with_neighbours(tgt, tm, k)
    ref, ref_idx = icp.normals_plain(tgt, tm, k)
    assert torch.equal(idx, ref_idx)
    assert _same_up_to_sign(normals, ref) < 1e-5
    assert not normals[~tm].any()


def test_icp_normals_kernel_few_valid(dev):
    """K26 with fewer than k masked-in points: masked columns fill the lists
    in index order."""
    from cartographer_tpu_torch.ops import icp

    rng = np.random.RandomState(7)
    pts = _t(rng.uniform(-2, 2, (40, 3)).astype(np.float32), dev)
    mask = torch.zeros(40, dtype=torch.bool, device=dev)
    mask[[1, 4, 8, 9, 15, 22, 27]] = True
    normals, idx = icp.normals_with_neighbours(pts, mask)
    ref, ref_idx = icp.normals_plain(pts, mask)
    assert torch.equal(idx, ref_idx)
    assert _same_up_to_sign(normals, ref) < 1e-5


def test_gicp_lm_kernel(dev):
    """K27: one round's LM within 1e-4 m, 1e-4 rad and 1e-4 of the cost of
    the twin on the same correspondences, and unchanged by flipped normals."""
    from cartographer_tpu_torch.ops import icp
    from cartographer_tpu_torch.transform import quaternion as quat

    src, sm, tgt, tm = _icp_clouds(dev, 4096)
    normals, _ = icp.normals_with_neighbours(tgt, tm)
    x0 = _t(np.float32([0, 0, 0, 1, 0, 0, 0]), dev)
    nn, _, valid = icp.nearest(src, sm, tgt, tm, x0, 1.0)
    x, cost, its = icp.gicp_lm(src, tgt, normals, nn, valid, x0, 10)
    xp, cp, _ = icp.gicp_lm_plain(src, tgt, normals, nn, valid, x0, 10)
    torch.testing.assert_close(x[0:3], xp[0:3], atol=1e-4, rtol=0)
    dq = quat.multiply(quat.conjugate(xp[3:7]), x[3:7])
    assert float(quat.to_axis_angle(dq).norm()) < 1e-4
    torch.testing.assert_close(cost, cp, atol=0, rtol=1e-4)
    flipped = icp.gicp_lm(src, tgt, -normals, nn, valid, x0, 10)
    assert torch.equal(flipped[0], x) and torch.equal(flipped[1], cost)
    assert int(its) >= 2


def test_gicp_match_kernel(dev):
    """The whole card gicp_match (K26, 6 x (K23 + K27), K23, stats) within
    1e-4 m and 1e-4 rad of the twin's on the card."""
    from cartographer_tpu_torch.ops import icp
    from cartographer_tpu_torch.transform import quaternion as quat

    src, sm, tgt, tm = _icp_clouds(dev, 4096)
    x0 = _t(np.float32([0, 0, 0, 1, 0, 0, 0]), dev)
    pose, fit, rmse = icp.gicp_match_vector(src, sm, tgt, tm, x0)
    pose_p, fit_p, rmse_p = icp.gicp_match_plain(src, sm, tgt, tm, x0, icp.IcpParams())
    torch.testing.assert_close(pose[0:3], pose_p[0:3], atol=1e-4, rtol=0)
    dq = quat.multiply(quat.conjugate(pose_p[3:7]), pose[3:7])
    assert float(quat.to_axis_angle(dq).norm()) < 1e-4
    torch.testing.assert_close(fit, fit_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(rmse, rmse_p, atol=1e-5, rtol=0)


@pytest.mark.parametrize("resolution,extent", [(1.0, 32), (0.5, 24), (0.3, 32)])
def test_ndt_grid_kernel(dev, resolution, extent):
    """K28: valid and the means exact against the twin (both add each cell's
    points in input order), L within 1e-5 of its largest entries (both
    double, adjugate against LU)."""
    from cartographer_tpu_torch.ops import icp

    _, _, tgt, tm = _icp_clouds(dev, 4096)
    params = icp.NdtParams(resolution=resolution, grid_extent=extent)
    center = icp.ndt_center(tgt, tm)
    means, L, valid, origin = icp.build_ndt_grid(tgt, tm, params, center)
    rm, rL, rv, ro = icp.build_ndt_grid_plain(tgt, tm, params, center)
    assert torch.equal(origin, ro) and torch.equal(valid, rv) and torch.equal(means, rm)
    assert int(valid.sum()) > 10
    torch.testing.assert_close(L[valid], rL[valid], atol=1e-5 * float(rL[valid].abs().max()),
                               rtol=0)


def _ndt_case(dev, case):
    """-> (target, mask, NdtParams, center) of a K28 size case."""
    from cartographer_tpu_torch.ops import icp

    rng = np.random.RandomState(len(case))
    if case == "two_launches":  # one point above a launch of the in-order routine
        pts, _ = _hall_scan(rng, np.float32([0.3, -0.2, 0.1]), 131073)
        params = icp.NdtParams(resolution=1.0)
    elif case == "one_cell":  # every point in one cell: one run of 20,000
        pts = rng.uniform(0.2, 0.8, (20000, 3)) + np.float32([3.0, -2.0, 1.0])
        params = icp.NdtParams(resolution=1.0)
    elif case == "none_in_bounds":
        pts, _ = _hall_scan(rng, np.float32([0.3, -0.2, 0.1]), 4096)
        params = icp.NdtParams(resolution=0.5)
    else:  # "three_passes": 48^3 cells need 17 bits, three radix passes
        pts, _ = _hall_scan(rng, np.float32([0.3, -0.2, 0.1]), 32768)
        params = icp.NdtParams(resolution=0.5, grid_extent=48)
    tgt = _t(pts.astype(np.float32), dev)
    tm = _t(rng.rand(len(pts)) < 0.95, dev)
    center = (_t(np.float32([1e4, 0.0, 0.0]), dev) if case == "none_in_bounds"
              else _t(np.zeros(3, np.float32), dev) if case == "one_cell"  # cells on integers
              else icp.ndt_center(tgt, tm))
    return tgt, tm, params, center


@pytest.mark.parametrize("case", ["two_launches", "one_cell", "none_in_bounds",
                                  "three_passes"])
def test_ndt_grid_kernel_sizes(dev, case):
    """K28 at the in-order routine's edges, with test_ndt_grid_kernel's
    checks (valid and means exact, L within 1e-5 of its largest entries;
    every cell where none is valid), and its kernels per call in a captured
    CUDA graph: 2 up to 131,072 points (the cells' defaults, one launch of
    the routine), 3 above (two launches on running sums, then the cells)."""
    from cartographer_tpu_torch.ops import icp, in_order_scatter

    tgt, tm, params, center = _ndt_case(dev, case)
    means, L, valid, origin = icp.build_ndt_grid(tgt, tm, params, center)
    rm, rL, rv, ro = icp.build_ndt_grid_plain(tgt, tm, params, center)
    assert torch.equal(origin, ro) and torch.equal(valid, rv) and torch.equal(means, rm)
    cells = valid if bool(valid.any()) else torch.ones_like(valid)
    torch.testing.assert_close(L[cells], rL[cells], atol=1e-5 * float(rL[cells].abs().max()),
                               rtol=0)
    assert (int(valid.sum()) == 1) == (case == "one_cell")
    assert (not bool(valid.any())) == (case == "none_in_bounds")
    n = tgt.shape[0]
    expected = 2 if n <= in_order_scatter.CHUNK else in_order_scatter.launches(n) + 1
    assert _graph_kernels(lambda: icp.build_ndt_grid(tgt, tm, params, center)) == expected


@pytest.mark.parametrize("resolution", [1.0, 0.5])
def test_ndt_match_kernel(dev, resolution):
    """K29 on K28's grid and the whole card ndt_match: pose within 1e-4 m
    and 1e-4 rad, cost within 1e-4 relative, of the twins on the card."""
    from cartographer_tpu_torch.ops import icp
    from cartographer_tpu_torch.transform import quaternion as quat

    src, sm, tgt, tm = _icp_clouds(dev, 4096)
    params = icp.NdtParams(resolution=resolution)
    x0 = _t(np.float32([0, 0, 0, 1, 0, 0, 0]), dev)
    grid = icp.build_ndt_grid(tgt, tm, params, icp.ndt_center(tgt, tm))
    x, cost, its = icp.ndt_lm(grid, src, sm, x0, params)
    xp, cp, _ = icp.ndt_lm_plain(grid, src, sm, x0, params)
    torch.testing.assert_close(x[0:3], xp[0:3], atol=1e-4, rtol=0)
    dq = quat.multiply(quat.conjugate(xp[3:7]), x[3:7])
    assert float(quat.to_axis_angle(dq).norm()) < 1e-4
    torch.testing.assert_close(cost, cp, atol=0, rtol=1e-4)
    assert int(its) >= 2
    pose, c2 = icp.ndt_match_vector(src, sm, tgt, tm, x0, params)
    assert torch.equal(pose, x) and torch.equal(c2, cost)


@pytest.mark.parametrize("free_space", [0, 2])
def test_dense_insert_kernel(dev, free_space):
    """K25: four inserts of rays in every octant, log-odds and known equal
    to the twin's (exact)."""
    from cartographer_tpu_torch.ops.grid_3d import (
        Grid3D,
        insert_range_data_3d,
        insert_range_data_3d_plain,
    )

    rng = np.random.RandomState(free_space)
    center = np.float32([0.113, -0.071, 0.037])
    grid = Grid3D.create(64, 0.2, center, dev)
    ref = grid
    for k in range(4):
        origin = _t(center + np.float32([0.05 * k, -0.03 * k, 0.01]), dev)
        d = rng.normal(size=(4096, 3))
        pts = center + d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(0.5, 8, (4096, 1))
        pts, mask = _t(pts.astype(np.float32), dev), _t(rng.rand(4096) < 0.9, dev)
        grid = insert_range_data_3d(grid, origin, pts, mask, num_free_space_voxels=free_space)
        ref = insert_range_data_3d_plain(ref, origin, pts, mask,
                                         num_free_space_voxels=free_space)
        assert torch.equal(grid.log_odds, ref.log_odds)
        assert torch.equal(grid.known, ref.known)
    assert int(grid.known.sum()) > 1000


@pytest.mark.parametrize("n", [4096] + SCATTER_SIZES)
def test_dense_intensity_insert_kernel(dev, n):
    """K30: two inserts into a 256^3 window with clustered returns (long
    runs per cell), intensities above the threshold and returns outside
    the cube: sums and counts equal to the twin's bit for bit."""
    from cartographer_tpu_torch.ops.grid_3d import (
        IntensityGrid3D,
        insert_intensities,
        insert_intensities_plain,
    )

    rng = np.random.RandomState(n)
    center = np.float32([0.113, -0.071, 0.037])
    grid = IntensityGrid3D.create(256, 0.1, center, dev)
    ref = IntensityGrid3D.create(256, 0.1, center, dev)
    c = 64 if n >= 4096 else 4  # clusters: runs of over 10 returns at every size
    for k in range(2):
        centers = rng.uniform(-10, 10, (c, 3))
        pts = np.concatenate([centers[rng.randint(0, c, n // 2)]
                              + rng.normal(0, 0.05, (n // 2, 3)),
                              rng.uniform(-16, 16, (n - n // 2, 3))]) + center
        args = (_t(pts.astype(np.float32), dev), _t(rng.uniform(0, 60, n).astype(np.float32), dev),
                _t(rng.rand(n) < 0.9, dev), 40.0)
        insert_intensities(grid, *args)
        insert_intensities_plain(ref, *args)
    assert torch.equal(grid.sums, ref.sums) and torch.equal(grid.counts, ref.counts)
    assert float(grid.counts.max()) > 10


@pytest.mark.parametrize("dim,n", [(2, 1081), (3, 4096), (3, 16384), (3, 32768)])
def test_voxel_filter_edge_kernel(dev, dim, n):
    """K31 at the path's shapes: keep-masks equal to the twin's (exact),
    with masked points piled into one voxel."""
    from cartographer_tpu_torch.sensor.voxel_filter import (
        voxel_filter_edge_mask,
        voxel_filter_edge_plain,
    )

    rng = np.random.RandomState(dim * n)
    centers = rng.uniform(-20, 20, (40, dim))
    pts = np.concatenate([centers[rng.randint(0, 40, n // 2)] + rng.normal(0, 0.3, (n // 2, dim)),
                          rng.uniform(-30, 30, (n - n // 2, dim))]).astype(np.float32)
    mask = rng.rand(n) < 0.9
    pile = rng.choice(n, n // 20, replace=False)
    pts[pile], mask[pile] = np.float32(0.01), False
    p, m = _t(pts, dev), _t(mask, dev)
    got = voxel_filter_edge_mask(p, m, 0.3, 0.5)
    want = voxel_filter_edge_plain(p, m, 0.3, 0.5)
    assert torch.equal(got, want)
    assert 0 < int(got.sum()) < int(m.sum())


# ---------------------------------------------------------------- robot batches


def _robot_scans(dev, robots, n=N):
    """R robots' scans (RangeData with a leading R) and their grids, each
    robot's two slots with a scan inserted, and their K4 scratches."""
    rds, grids, scratch = [], [], []
    for r in range(robots):
        rng = np.random.RandomState(100 + r)
        pts = _room(rng, n)[:, :2].astype(np.float32)
        rr = np.linalg.norm(pts, axis=1)
        miss = (pts * (5.0 / rr)[:, None]).astype(np.float32)
        z = torch.zeros(n, device=dev)
        rds.append(RangeData(_t(np.float32([0.2 + 0.01 * r, -0.1]), dev),
                             PointCloud(_t(pts, dev), _t(rr <= 12.0, dev), z),
                             PointCloud(_t(miss, dev), _t(rr > 12.0, dev), z)))
        g = Grid2D(torch.zeros((2, SIZE, SIZE), device=dev),
                   torch.zeros((2, SIZE, SIZE), dtype=torch.bool, device=dev),
                   _t(np.float32([[-6.4 + 0.013 * r, -6.4], [-6.0, -6.3 + 0.007 * r]]), dev),
                   0.05)
        sc = grid_2d.InsertScratch.create(2, SIZE, dev)
        grid_2d.insert_into_slots(g, rds[-1], _t(np.array([True, True]), dev),
                                  torch.ones((), dtype=torch.bool, device=dev), 0.55, 0.49,
                                  True, SAMPLES, sc)
        grids.append(g)
        scratch.append(sc)
    stack = lambda ts: torch.stack(ts)  # noqa: E731
    rd = RangeData(stack([x.origin for x in rds]),
                   PointCloud(stack([x.returns.points for x in rds]),
                              stack([x.returns.mask for x in rds]),
                              stack([x.returns.intensities for x in rds])),
                   PointCloud(stack([x.misses.points for x in rds]),
                              stack([x.misses.mask for x in rds]),
                              stack([x.misses.intensities for x in rds])))
    return rd, rds, grids, scratch


@pytest.mark.parametrize("robots", [1, 3, 16])
def test_robot_batched_kernels(dev, robots):
    """K1-K5 with a robot index in their grids (the cross-robot batched
    step): one launch for R robots equals each robot's own launch bit for
    bit, and the plain twins robot by robot: K2 and K5 bit for bit, K1 (1e-5
    m, masks exact), K3 (cost 1e-4; pose 1e-4 on the twin's LM path, 1e-3
    where a near-tie parts the paths) and K4 (0.1% of touched cells) at
    their twins' tolerances."""
    from cartographer_tpu_torch.ops import correlative_2d
    from cartographer_tpu_torch.ops.scan_pipeline_2d import (
        ScanPreprocessParams2D,
        align_scan,
        align_scan_plain,
    )

    rng = np.random.RandomState(robots)
    rd, rds, grids, scratch = _robot_scans(dev, robots)

    # K1: rows of one (R, L) upload, as the step lays them out.
    row = 8 * N + 33
    upload = torch.zeros((robots, row), device=dev)
    for r in range(robots):
        pts = _room(np.random.RandomState(200 + r), N).astype(np.float32)
        upload[r, :3 * N] = _t(pts.reshape(-1), dev)
        upload[r, 6 * N:7 * N] = _t(np.linspace(0, 1, N, dtype=np.float32), dev)
        upload[r, 7 * N:8 * N] = _t((rng.rand(N) < 0.9).astype(np.float32), dev)
        yaw = 0.1 * r
        small = np.float32([0.1, 0.2, 0, 1, 0, 0, 0, 0.3 + 0.01 * r, 0.1, 0,
                            np.cos(yaw), 0, 0, np.sin(yaw), 1, 0, 0, 0])
        upload[r, 8 * N:8 * N + 18] = _t(small, dev)
    small = upload[:, 8 * N:]
    args = (upload[:, :3 * N].view(robots, N, 3), upload[:, 6 * N:7 * N],
            upload[:, 7 * N:8 * N] > 0.5, upload[:, 3 * N:6 * N].view(robots, N, 3),
            Rigid3(small[:, 0:3], small[:, 3:7]), Rigid3(small[:, 7:10], small[:, 10:14]),
            small[:, 14:18])
    pre = ScanPreprocessParams2D(max_range=12.0)
    got = align_scan(*args, pre)
    for r in range(robots):
        one = [a[r] if isinstance(a, torch.Tensor) else Rigid3(a.translation[r], a.rotation[r])
               for a in args]
        alone = align_scan(*[x.contiguous() if isinstance(x, torch.Tensor) else x
                             for x in one], pre)
        ref = align_scan_plain(*one, pre)
        for k in range(5):
            assert torch.equal(got[k][r], alone[k])
        for k in (0, 1, 4):
            torch.testing.assert_close(got[k][r], ref[k], atol=1e-5, rtol=0)
        for k in (2, 3):
            assert torch.equal(got[k][r], ref[k])

    # K2: the voxel filter and the two adaptive filters in one launch.
    perm = torch.stack([_t(np.random.RandomState(300 + r).permutation(N).astype(np.int32),
                           dev) for r in range(robots)])
    hits, is_return = got[0], got[2]
    keep = voxel_filter.voxel_filter_mask(hits, is_return, 0.05, perm)
    filters = [(0.5, 100, 12.0), (0.9, 50, 12.0)]
    adaptive = voxel_filter.adaptive_voxel_filter_masks(hits[..., 0:2], keep, filters, perm)
    for r in range(robots):
        assert torch.equal(keep[r], voxel_filter.voxel_filter_mask_plain(
            hits[r], is_return[r], 0.05, perm[r]))
        for f, (length, num, max_range) in enumerate(filters):
            assert torch.equal(adaptive[f][r], voxel_filter.adaptive_voxel_filter_mask_plain(
                hits[r, :, 0:2], keep[r], length, num, max_range, perm[r]))

    # K5 and K3 on each robot's slot 0.
    slot0 = [g.slot(0) for g in grids]
    x0 = torch.stack([_t(np.float32([0.23 + 0.01 * r, -0.12, 0.02]), dev)
                      for r in range(robots)])
    cparams = correlative_2d.CorrelativeSearchParams(max_scan_range=12.0)
    best, scores = correlative_2d.correlative_match(slot0, rd.returns.points, rd.returns.mask,
                                                    x0, cparams)
    params = scan_matcher_2d.GaussNewtonMatcherParams2D(translation_weight=1.0,
                                                        rotation_weight=1.0)
    target = x0[:, 0:2]
    xk, ck, ik = scan_matcher_2d.lm_match_2d(slot0, rd.returns.points, rd.returns.mask, x0,
                                             target, params)
    for r in range(robots):
        bp, sp = correlative_2d.correlative_match_plain(
            slot0[r], rds[r].returns.points, rds[r].returns.mask, x0[r], cparams)
        assert torch.equal(scores[r], sp) and torch.equal(best[r], bp)
        alone = scan_matcher_2d.lm_match_2d(slot0[r], rds[r].returns.points,
                                            rds[r].returns.mask, x0[r], x0[r, 0:2], params)
        assert torch.equal(xk[r], alone[0]) and torch.equal(ck[r], alone[1])
        assert torch.equal(ik[r], alone[2])
        xp, cp, ip = scan_matcher_2d._match_plain(slot0[r], rds[r].returns.points,
                                                  rds[r].returns.mask, x0[r], x0[r, 0:2],
                                                  params)
        # The twin sums in another order: both reach the minimum (cost
        # within 1e-4), and where an accept test meets a near-tie their LM
        # paths part (as test_scan_matcher_2d_kernel's 1e-4 holds one path).
        why = f"robot {r}: {int(ik[r])} iterations, the twin {int(ip)}"
        torch.testing.assert_close(ck[r], cp, atol=0, rtol=1e-4, msg=why)
        torch.testing.assert_close(xk[r], xp, atol=1e-4 if int(ik[r]) == int(ip) else 1e-3,
                                   rtol=0, msg=why)

    # K4: R robots' second scans into their own grids, slot 1 of robot 1 off
    # and robot 2's do_insert False, against one launch per robot.
    active = torch.ones((robots, 2), dtype=torch.bool, device=dev)
    do_insert = torch.ones(robots, dtype=torch.bool, device=dev)
    if robots >= 3:
        active[1, 1] = False
        do_insert[2] = False
    moved = RangeData(rd.origin + 0.02, PointCloud(rd.returns.points + 0.03, rd.returns.mask,
                                                   rd.returns.intensities), rd.misses)
    alone = [g.clone() for g in grids]
    plain = [g.clone() for g in grids]
    grid_2d.insert_into_slots(grids, moved, active, do_insert, 0.55, 0.49, True, SAMPLES,
                              scratch)
    for r in range(robots):
        one = RangeData(moved.origin[r], PointCloud(moved.returns.points[r],
                                                    moved.returns.mask[r],
                                                    moved.returns.intensities[r]), rds[r].misses)
        grid_2d.insert_into_slots(alone[r], one, active[r], do_insert[r], 0.55, 0.49, True,
                                  SAMPLES)
        grid_2d._insert_plain(plain[r], one, active[r], do_insert[r],
                              probability_to_log_odds(0.55), probability_to_log_odds(0.49),
                              True, SAMPLES)
        assert torch.equal(grids[r].log_odds, alone[r].log_odds)
        assert torch.equal(grids[r].known, alone[r].known)
        assert int(scratch[r].hit.sum()) == 0 and int(scratch[r].free.sum()) == 0
        touched = int(plain[r].known.sum())
        differ = int(((grids[r].log_odds - plain[r].log_odds).abs() > 1e-6).sum()
                     + (grids[r].known != plain[r].known).sum())
        assert touched > 1000 and differ <= 1e-3 * touched


@pytest.mark.parametrize("robots", [1, 3])
def test_robot_batched_tsdf_matchers(dev, robots):
    """The TSDF forms of K3 and K5 and K22 with a robot index: one launch
    equals each robot's own launch bit for bit, and K5's form its twin."""
    from cartographer_tpu_torch.ops import correlative_2d, tsdf_2d

    grids = []
    for r in range(robots):
        g, rd = _tsdf_grid(dev)
        grids.append(dataclasses.replace(g, origin=g.origin + 0.01 * r))
    pts = torch.stack([rd.returns.points[:N] for _ in range(robots)])
    mask = torch.stack([rd.returns.mask[:N] for _ in range(robots)])
    x0 = torch.stack([_t(np.float32([0.02 * r, -0.01, 0.01]), dev) for r in range(robots)])
    params = scan_matcher_2d.GaussNewtonMatcherParams2D()
    for fn in (scan_matcher_2d.lm_match_2d, tsdf_2d.lm_match_tsdf_2d):
        out = fn(grids, pts, mask, x0, x0[:, 0:2], params)
        for r in range(robots):
            alone = fn(grids[r], pts[r], mask[r], x0[r], x0[r, 0:2], params)
            for a, b in zip(out, alone):
                assert torch.equal(a[r], b)
    cparams = correlative_2d.CorrelativeSearchParams(max_scan_range=12.0)
    best, scores = correlative_2d.correlative_match(grids, pts, mask, x0, cparams)
    for r in range(robots):
        bp, sp = correlative_2d.correlative_match_plain(grids[r], pts[r], mask[r], x0[r],
                                                        cparams)
        assert torch.equal(scores[r], sp) and torch.equal(best[r], bp)


# ---------------------------------------------------------------- K3's LM template

LM_SURFACES = ["K3", "K3 TSDF form", "K22"]


def _lm_surface(dev, surface):
    """(solve, plain twin, grid) of one surface of K3's template, its grid
    holding three scans of _tsdf_scan's room."""
    from cartographer_tpu_torch.ops import tsdf_2d

    if surface == "K22":
        return tsdf_2d.lm_match_tsdf_2d, tsdf_2d._match_plain, _tsdf_grid(dev)[0]
    if surface == "K3 TSDF form":
        grid = _tsdf_grid(dev)[0]
    else:
        grids = Grid2D(torch.zeros((2, SIZE, SIZE), device=dev),
                       torch.zeros((2, SIZE, SIZE), dtype=torch.bool, device=dev),
                       _t(np.float32([[-6.4, -6.4], [-6.1, -6.3]]), dev), 0.05)
        for k in range(3):
            rd = _tsdf_scan(dev, 2048, 1500, seed=40 + k, origin=(0.04 * k + 0.031, -0.017))
            grid_2d._insert_plain(grids, rd, _t(np.array([True, True]), dev),
                                  torch.tensor(True, device=dev), probability_to_log_odds(0.55),
                                  probability_to_log_odds(0.49), True, SAMPLES)
        grid = grids.slot(0)
    return scan_matcher_2d.lm_match_2d, scan_matcher_2d._match_plain, grid


def _lm_points(dev, m, seed=90):
    """m points of a scan of the room (three quarters of them valid, one at
    least)."""
    rd = _tsdf_scan(dev, m, max(1, 3 * m // 4), seed=seed, origin=(0.081, -0.047))
    return rd.returns.points, rd.returns.mask


def _check_lm(solve, plain, args):
    """The kernel against its twin: the pose within 1e-4 and the cost within
    1e-4 relative, over the iterations both ran where a near-tie in the stop
    test (relative improvement under 1e-6) ends one an iteration before the
    other; two calls of the kernel bit-equal. -> the kernel's iterations."""
    xk, ck, ik = solve(*args)
    again = solve(*args)
    for a, b in zip((xk, ck, ik), again):
        assert torch.equal(a, b)
    xp, cp, ip = plain(*args)
    torch.testing.assert_close(ck, cp, atol=0, rtol=1e-4)
    if int(ik) != int(ip):
        cap = (*args[:5], dataclasses.replace(args[5], num_iterations=min(int(ik), int(ip))))
        xk, xp = solve(*cap)[0], plain(*cap)[0]
    torch.testing.assert_close(xk, xp, atol=1e-4, rtol=0)
    return int(ik)


@pytest.mark.parametrize("m", [1, 31, 128, 512, 513, 4096])
@pytest.mark.parametrize("surface", LM_SURFACES)
def test_lm_template_kernel_shapes(dev, surface, m):
    """K3, its TSDF form and K22 (one pass an iteration) against their twins
    at m points: a thread per point up to 512 (1 to 16 warps), a loop above;
    monotonic steps from 6 cm and 0.02 rad off."""
    solve, plain, grid = _lm_surface(dev, surface)
    pts, mask = _lm_points(dev, m)
    x0 = _t(np.float32([0.06, -0.04, 0.02]), dev)
    params = scan_matcher_2d.GaussNewtonMatcherParams2D()
    _check_lm(solve, plain, (grid, pts, mask, x0, x0[0:2] - 0.01, params))


@pytest.mark.parametrize("surface", LM_SURFACES)
def test_lm_template_kernel_steps(dev, surface):
    """The template's LM paths at 512 points against the twins: non-monotonic
    steps (K3 and its TSDF form; K22 takes monotonic steps, as in JAX), an
    iteration cap of 1, and an early exit by function_tolerance (of the
    solve from the start and a second one from its result, one at least
    stops before its cap, in the kernel and the twin alike)."""
    solve, plain, grid = _lm_surface(dev, surface)
    pts, mask = _lm_points(dev, 512, seed=91)
    x0 = _t(np.float32([0.09, 0.05, -0.03]), dev)
    default = scan_matcher_2d.GaussNewtonMatcherParams2D()
    cases = [dataclasses.replace(default, num_iterations=1)]
    if surface != "K22":
        cases.append(dataclasses.replace(default, use_nonmonotonic_steps=True))
    for params in cases:
        _check_lm(solve, plain, (grid, pts, mask, x0, x0[0:2], params))
    first = _check_lm(solve, plain, (grid, pts, mask, x0, x0[0:2], default))
    x1 = solve(grid, pts, mask, x0, x0[0:2], default)[0]
    second = _check_lm(solve, plain, (grid, pts, mask, x1, x0[0:2], default))
    assert min(first, second) < default.num_iterations


@pytest.mark.parametrize("surface", LM_SURFACES)
def test_lm_template_kernel_robots(dev, surface):
    """16 robots in one launch, each with its own grid origin, points and
    start: every robot bit-equal to its own one-robot launch."""
    solve, _, grid = _lm_surface(dev, surface)
    robots = 16
    grids = [dataclasses.replace(grid, origin=grid.origin + 0.007 * r) for r in range(robots)]
    clouds = [_lm_points(dev, 512, seed=100 + r) for r in range(robots)]
    pts = torch.stack([c[0] for c in clouds])
    mask = torch.stack([c[1] for c in clouds])
    x0 = torch.stack([_t(np.float32([0.05 - 0.004 * r, 0.03, 0.01 * (r % 3)]), dev)
                      for r in range(robots)])
    params = scan_matcher_2d.GaussNewtonMatcherParams2D()
    out = solve(grids, pts, mask, x0, x0[:, 0:2], params)
    for r in range(robots):
        alone = solve(grids[r], pts[r], mask[r], x0[r], x0[r, 0:2], params)
        for a, b in zip(out, alone):
            assert torch.equal(a[r], b)
