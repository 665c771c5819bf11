"""The port's paged 3D grid (plain twins of kernels K9, K10 and K19) against
the JAX package: the same scans inserted into the same pool give the same
allocation, pool and known cells, and the same dense crops, cell for cell,
alone and as the 3D frontend's matching windows."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cartographer_tpu.ops.paged_grid_3d import PagedSubmapGrid3D as JPaged
from cartographer_tpu.ops.paged_grid_3d import _insert_paged as j_insert_paged
from cartographer_tpu.ops.probability import probability_to_log_odds as j_log_odds
from cartographer_tpu_torch.interop import paged_grid_from_numpy, paged_grid_to_numpy
from cartographer_tpu_torch.ops.paged_grid_3d import PagedSubmapGrid3D, insert_paged_grids
from cartographer_tpu_torch.ops.probability import probability_to_log_odds

RES, PAGE, PAGES, BLOCKS = 0.1, 8, 512, 16  # 12.8 m addressable per side
CENTER = np.float32([0.3, -0.2, 0.1])

torch.set_num_threads(1)


def _scan(rng, origin, n=256, reach=2.0, valid=0.9):
    """Returns on a box around `origin`: rays in every direction, so the
    deltas to the origin take both signs and rays cross page borders.

    The tests' sensor origins lie off the cell borders: under jit XLA turns
    the JAX program's division by the resolution into a multiplication by
    its reciprocal, which puts a coordinate that sits on a border (to the
    last bit) into the other cell than a true division does."""
    d = rng.normal(size=(n, 3))
    d /= np.abs(d).max(axis=1, keepdims=True)
    pts = (origin + reach * d * rng.uniform(0.6, 1.0, (n, 1))).astype(np.float32)
    return pts, rng.rand(n) < valid


def _pair(**kw):
    args = dict(page_size=PAGE, max_pages=PAGES, num_blocks=BLOCKS)
    args.update(kw)
    return JPaged(RES, CENTER, **args), PagedSubmapGrid3D(RES, CENTER, device="cpu", **args)


def _same_increment(p):
    return np.float32(j_log_odds(jnp.float32(p))) == np.float32(probability_to_log_odds(p))


# XLA's float32 log puts the default hit increment (p = 0.55) one ulp from
# the port's, so with the defaults the pools agree to 1e-6 and not bit for
# bit; with probabilities whose increments coincide they are equal exactly.
HIT, MISS = next((h, 0.49) for h in (0.56, 0.57, 0.58, 0.59, 0.61, 0.62)
                 if _same_increment(h) and _same_increment(0.49))


def _insert_both(jp, tp, origin, pts, mask, free=2, hit=HIT, miss=MISS):
    kwargs = dict(hit_probability=hit, miss_probability=miss, num_free_space_voxels=free)
    jp.insert_range_data(origin, pts, mask, **kwargs)
    tp.insert_range_data(origin, pts, mask, **kwargs)


def _assert_same_pool(jp, tp, atol=0.0):
    pages, known, table, origin, _, _, slots = paged_grid_to_numpy(tp)
    assert slots == jp._slots
    np.testing.assert_array_equal(table, np.asarray(jp.grid.page_table))
    np.testing.assert_array_equal(origin, np.asarray(jp.grid.origin))
    np.testing.assert_array_equal(known, np.asarray(jp.grid.known))
    np.testing.assert_allclose(pages, np.asarray(jp.grid.pages), atol=atol, rtol=0)


@pytest.mark.parametrize("free", [0, 2, 3])
def test_insert_matches_jax(free):
    rng = np.random.RandomState(free)
    jp, tp = _pair()
    for k in range(4):
        origin = np.float32([0.4 * k - 0.487, 0.1 * k + 0.031, 0.057])
        pts, mask = _scan(rng, origin)
        _insert_both(jp, tp, origin, pts, mask, free)
    _assert_same_pool(jp, tp)
    assert tp.num_allocated > 8 and int(tp.grid.known.sum()) > 500


def test_insert_with_default_probabilities():
    rng = np.random.RandomState(4)
    jp, tp = _pair()
    for k in range(4):
        origin = np.float32([0.3 * k + 0.017, -0.2 * k - 0.023, 0.057])
        pts, mask = _scan(rng, origin, reach=1.0)  # the same cells hit again and again
        _insert_both(jp, tp, origin, pts, mask, hit=0.55, miss=0.49)
    _assert_same_pool(jp, tp, atol=1e-6)
    assert float(tp.grid.pages.max()) > 0.3  # cells hit more than once


def test_returns_outside_the_table_are_dropped():
    rng = np.random.RandomState(5)
    jp, tp = _pair()
    origin = np.float32([5.51, 0.013, 0.027])  # 0.9 m from the table's edge at 6.7 m
    pts, mask = _scan(rng, origin, reach=3.0)
    _insert_both(jp, tp, origin, pts, mask)
    _assert_same_pool(jp, tp)
    assert int((pts[mask][:, 0] > 6.8).sum()) > 10


def _crossing_scan(rng, origin, n=256):
    """A scan whose first 32 returns lie on 16 rays two at a time, the far
    one 2 cells (of the finer grid) beyond the near one: the near return's
    hit cell is a free-space cell of the far one, and the hit wins."""
    pts, mask = _scan(rng, origin, n)
    d = rng.normal(size=(16, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    near = origin + d * rng.uniform(0.8, 1.6, (16, 1))
    pts[:16] = near
    pts[16:32] = near + d * np.float32(2 * RES)
    mask[:32] = True
    return pts.astype(np.float32), mask


# Two submaps x (high, low) as ActiveSubmaps3D keeps them: the high grids at
# RES, the low at 3 RES, the second submap centred elsewhere.
SUBMAP_GRIDS = [(RES, CENTER), (3 * RES, CENTER), (RES, CENTER + np.float32([0.9, -0.4, 0.2])),
                (3 * RES, CENTER + np.float32([0.9, -0.4, 0.2]))]


@pytest.mark.parametrize("free", [0, 2])
def test_scan_insert_matches_jax_grid_by_grid(free):
    """The scan-level entry (`insert_paged_grids`: each grid's allocation
    first, then one call for the 4 grids, the new table entries with it)
    against JAX's `_insert_paged` applied grid by grid, exactly: the high
    grids take the returns within 1.8 m (a subset of the low grids'),
    returns cross each other's rays and leave the finer tables."""
    rng = np.random.RandomState(20 + free)
    args = dict(page_size=PAGE, max_pages=PAGES, num_blocks=BLOCKS)
    jaxes = [JPaged(res, c, **args) for res, c in SUBMAP_GRIDS]
    ports = [PagedSubmapGrid3D(res, c, device="cpu", **args) for res, c in SUBMAP_GRIDS]
    kwargs = dict(hit_probability=HIT, miss_probability=MISS, num_free_space_voxels=free)
    origins = ([0.013, 0.021, 0.037], [0.61, -0.29, 0.11], [5.31, 5.22, 0.07])  # the last
    for origin in origins:  # 1.2 m inside the finer tables' corner: returns leave them
        origin = np.float32(origin)
        pts, mask = _crossing_scan(rng, origin)
        high = mask & (np.linalg.norm(pts - origin, axis=1) <= 1.8)
        assert 0 < high.sum() < mask.sum()
        jobs = []
        for g, (jp, tp) in enumerate(zip(jaxes, ports)):
            m = high if g % 2 == 0 else mask
            jp.insert_range_data(origin, pts, m, **kwargs)
            jobs.append((tp.grid, torch.from_numpy(m), tp.allocate(pts, m, free)))
        insert_paged_grids(jobs, torch.from_numpy(origin), torch.from_numpy(pts), HIT, MISS,
                           free)
    for jp, tp in zip(jaxes, ports):
        _assert_same_pool(jp, tp)
        assert int(tp.grid.known.sum()) > 100
    lo = CENTER - np.float32(0.5 * BLOCKS * PAGE * RES)
    assert int((pts[mask] >= lo + np.float32(BLOCKS * PAGE * RES)).any(axis=1).sum()) > 5


@pytest.mark.parametrize("free", [0, 2])
def test_scan_insert_drops_cells_without_a_page(free):
    """One call for two grids: one gains the scan's pages in the call, the
    other was allocated for the high returns only and takes all of them, so
    the cells of blocks without a page are dropped, as in JAX's
    `_insert_paged` on the same table."""
    rng = np.random.RandomState(30 + free)
    (jp, tp), (jq, tq) = _pair(), _pair()
    kwargs = dict(hit_probability=HIT, miss_probability=MISS, num_free_space_voxels=free)
    origin = np.float32([0.213, -0.121, 0.037])
    pts, mask = _crossing_scan(rng, origin)
    high = mask & (np.linalg.norm(pts - origin, axis=1) <= 1.3)
    jq.insert_range_data(origin, pts, high, **kwargs)
    tq.insert_range_data(origin, pts, high, **kwargs)
    pts2, mask2 = _crossing_scan(rng, origin + np.float32([0.05, 0.03, 0.0]))
    origin2 = origin + np.float32([0.05, 0.03, 0.0])
    jp.insert_range_data(origin2, pts2, mask2, **kwargs)
    jq.grid = j_insert_paged(jq.grid, jnp.asarray(origin2), jnp.asarray(pts2),
                             jnp.asarray(mask2), HIT, MISS, free)
    pages_before = tq.num_allocated
    insert_paged_grids([(tp.grid, torch.from_numpy(mask2), tp.allocate(pts2, mask2, free)),
                        (tq.grid, torch.from_numpy(mask2), None)],
                       torch.from_numpy(origin2), torch.from_numpy(pts2), HIT, MISS, free)
    _assert_same_pool(jp, tp)
    _assert_same_pool(jq, tq)
    assert tq.num_allocated == pages_before < tp.num_allocated


def test_pool_exhaustion_raises():
    rng = np.random.RandomState(6)
    _, tp = _pair(max_pages=4)
    pts, mask = _scan(rng, np.zeros(3, np.float32), reach=3.0)
    with pytest.raises(MemoryError):
        tp.insert_range_data(np.zeros(3, np.float32), pts, mask)


# The table spans [LO, LO + 12.8) m on each axis.
LO = CENTER - np.float32(0.5 * BLOCKS * PAGE * RES)
HI = LO + np.float32(BLOCKS * PAGE * RES)


def _face_origin(axis, high, inset):
    """A point `inset` m inside the table's low or high face on `axis`, off
    the cell borders on the other two."""
    p = np.float64([0.013, -0.021, 0.037])
    p[axis] = HI[axis] - inset if high else LO[axis] + inset
    return p


# 16 centers a cell apart on a diagonal: the window start takes every
# residue mod the page size on each axis (twice), at an odd and an even size.
DIAGONAL = [((np.float64([0.31, -0.22, 0.13]) + k * RES).tolist(), size)
            for size in (37, 40) for k in range(16)]
# A window that crosses each face of the table, 1.72 m beyond it.
FACES = [(_face_origin(axis, high, 0.13).tolist(), 37) for axis in range(3)
         for high in (False, True)]


@functools.lru_cache(maxsize=1)
def _crop_pair():
    """Both packages' pools after the same ten scans: four inside the
    table, one 0.93 m inside each face."""
    rng = np.random.RandomState(7)
    jp, tp = _pair(max_pages=2048)
    origins = [[0.01, 0.02, 0.03], [0.51, -1.02, 0.33], [-5.03, 5.01, 0.02],
               [5.61, 5.62, 5.63]] + [_face_origin(axis, high, 0.93)
                                      for axis in range(3) for high in (False, True)]
    for origin in origins:
        origin = np.float32(origin)
        pts, mask = _scan(rng, origin, reach=1.5)
        _insert_both(jp, tp, origin, pts, mask)
    return jp, tp


@pytest.mark.parametrize("center,size", [
    ([0.31, -0.22, 0.13], 32),   # the table's middle
    ([0.37, -1.13, 0.52], 48),   # an offset that is no multiple of the page
    ([-5.93, 5.84, 0.02], 32),   # partly outside the table, negative window start
    ([6.33, 6.31, 6.32], 40),    # leaves the table at its far corner
] + DIAGONAL + FACES)
def test_crop_matches_jax(center, size):
    jp, tp = _crop_pair()
    ref = jp.crop_dense(np.float32(center), size)
    got = tp.crop_dense(np.float32(center), size)
    np.testing.assert_array_equal(got.known.numpy(), np.asarray(ref.known))
    np.testing.assert_array_equal(got.log_odds.numpy(), np.asarray(ref.log_odds))
    np.testing.assert_allclose(got.origin.numpy(), np.asarray(ref.origin), atol=1e-6, rtol=0)
    assert got.resolution == ref.resolution
    assert int(got.known.sum()) > 0


def test_matching_grids_match_jax():
    """ActiveSubmaps3D.matching_grids_at with intensities, the port's plain
    path (on the card one crop launch) against the JAX package's: the high,
    low and intensity windows exactly, around centers a cell apart."""
    from cartographer_tpu.core import config as jconfig
    from cartographer_tpu.mapping.submap_3d import ActiveSubmaps3D as JActive
    from cartographer_tpu_torch.core import config as tconfig
    from cartographer_tpu_torch.mapping.submap_3d import ActiveSubmaps3D

    def options(cfg):
        tpu = dataclasses.replace(cfg.TpuOptions3D(), page_size=PAGE, max_pages=PAGES,
                                  num_blocks=BLOCKS, high_grid_size=37, low_grid_size=20)
        inserter = dataclasses.replace(cfg.RangeDataInserterOptions3D(), hit_probability=HIT,
                                       miss_probability=MISS)
        subs = dataclasses.replace(cfg.SubmapsOptions3D(), num_range_data=3,
                                   high_resolution_max_range=1.6,
                                   range_data_inserter=inserter)
        return subs, tpu

    jactive = JActive(*options(jconfig), histogram_size=8, use_intensities=True)
    active = ActiveSubmaps3D(*options(tconfig), "cpu", 8, use_intensities=True)
    rng = np.random.RandomState(10)
    for k in range(4):  # a second submap starts at the fourth scan
        origin = np.float32([0.2 * k + 0.013, -0.1 * k + 0.021, 0.037])
        pts, mask = _scan(rng, origin, reach=2.0)
        intens = (rng.rand(len(pts)) * 60.0).astype(np.float32)
        hist = np.ones(8)
        jactive.insert_range_data(origin, pts, mask, hist, 0.0, intensities=intens,
                                  rotated_histogram=hist)
        active.insert_range_data(origin, pts, mask, hist, 0.0, rotated_histogram=hist,
                                 intensities=intens)
    assert len(active.submaps) == len(jactive.submaps) == 2
    for k in range(3):
        center = np.float32(np.float64([0.31, -0.22, 0.13]) + k * RES)
        ref = jactive.matching_grids_at(center)
        got = active.matching_grids_at(center)
        for g, r in zip(got[:2], ref[:2]):
            np.testing.assert_array_equal(g.log_odds.numpy(), np.asarray(r.log_odds))
            np.testing.assert_array_equal(g.known.numpy(), np.asarray(r.known))
            np.testing.assert_array_equal(g.origin.numpy(), np.asarray(r.origin))
        np.testing.assert_array_equal(got[2].sums.numpy(), np.asarray(ref[2].sums))
        np.testing.assert_array_equal(got[2].counts.numpy(), np.asarray(ref[2].counts))
        np.testing.assert_array_equal(got[2].origin.numpy(), np.asarray(ref[2].origin))
        assert torch.equal(got[2].origin, got[0].origin) and float(got[2].counts.sum()) > 0
        assert int(got[0].known.sum()) > 0 and int(got[1].known.sum()) > 0


def test_compacted_pool_crops_the_same():
    rng = np.random.RandomState(8)
    jp, tp = _pair()
    origin = np.float32([0.21, 0.13, 0.02])
    pts, mask = _scan(rng, origin)
    _insert_both(jp, tp, origin, pts, mask)
    before = tp.crop_dense(tp.known_center(), 48)
    jp.compact()
    tp.compact()
    assert tp.grid.max_pages == jp.grid.pages.shape[0] < PAGES
    np.testing.assert_allclose(tp.known_center(), jp.known_center(), atol=0, rtol=0)
    ref = jp.crop_dense(jp.known_center(), 48)
    got = tp.crop_dense(tp.known_center(), 48)
    np.testing.assert_array_equal(got.log_odds.numpy(), np.asarray(ref.log_odds))
    np.testing.assert_array_equal(got.known.numpy(), np.asarray(ref.known))
    assert torch.equal(got.log_odds, before.log_odds) and int(got.known.sum()) > 100


def test_state_carries_across_from_jax():
    """A pool built by the JAX package goes on in the port, and both give
    the same probabilities at the same points."""
    rng = np.random.RandomState(9)
    jp, _ = _pair()
    origin = np.float32([0.01, 0.23, 0.02])
    pts, mask = _scan(rng, origin)
    jp.insert_range_data(origin, pts, mask)
    g = jp.grid
    tp = paged_grid_from_numpy(np.asarray(g.pages), np.asarray(g.known),
                               np.asarray(g.page_table), np.asarray(g.origin), g.resolution,
                               g.page_size, jp._slots, "cpu")
    origin2 = np.float32([0.61, -0.33, 0.12])
    pts2, mask2 = _scan(rng, origin2)
    _insert_both(jp, tp, origin2, pts2, mask2)
    _assert_same_pool(jp, tp)
    query = np.concatenate([pts, pts2, np.float32([[50.0, 0.0, 0.0]])])
    ref = np.asarray(jp.grid.probability_at(jnp.asarray(query)))
    got = tp.probability_at(torch.from_numpy(query)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
