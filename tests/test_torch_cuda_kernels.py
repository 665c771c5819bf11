"""The port's CUDA kernels against their plain PyTorch twins, on the card.

These tests need an NVIDIA GPU with nvcc (sm_90a) and skip elsewhere; run
them on the card with `python -m pytest -m cuda tests/test_torch_cuda_kernels.py`.
`chip_smoke.py` holds the same kernels against their twins at the 2D
frontend's full width.
"""

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
