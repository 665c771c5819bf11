"""The port's raycast insertion (plain twin of kernel K4) and its active
submap window against the JAX package's scatter form."""

import numpy as np
import torch

import jax.numpy as jnp

from cartographer_tpu.core.config import SubmapsOptions2D as JSubmaps, TpuOptions2D as JTpu
from cartographer_tpu.mapping.submap_2d import ActiveSubmaps2D as JActive
from cartographer_tpu.ops.grid_2d import Grid2D as JGrid2D, insert_range_data as j_insert
from cartographer_tpu.sensor.point_cloud import PointCloud as JPointCloud, RangeData as JRangeData
from cartographer_tpu_torch.core.config import SubmapsOptions2D, TpuOptions2D
from cartographer_tpu_torch.interop import grid2d_from_numpy, grid2d_to_numpy
from cartographer_tpu_torch.mapping.submap_2d import ActiveSubmaps2D
from cartographer_tpu_torch.ops.grid_2d import insert_range_data
from cartographer_tpu_torch.sensor.point_cloud import PointCloud, RangeData

SIZE, RES, SAMPLES, CAP = 256, 0.05, 128, 256


def _scan(rng, origin):
    """Returns inside the grid, misses clamped 5 m out, both around `origin`."""
    a = rng.uniform(-np.pi, np.pi, CAP)
    r = rng.uniform(0.5, 5.5, CAP)
    returns = (origin + np.stack([r * np.cos(a), r * np.sin(a)], -1)).astype(np.float32)
    b = rng.uniform(-np.pi, np.pi, CAP)
    misses = (origin + 5.0 * np.stack([np.cos(b), np.sin(b)], -1)).astype(np.float32)
    return returns, rng.rand(CAP) < 0.9, misses, rng.rand(CAP) < 0.2


def _jax_rd(origin, returns, rmask, misses, mmask):
    z = jnp.zeros(CAP)
    return JRangeData(jnp.asarray(origin, jnp.float32),
                      JPointCloud(jnp.asarray(returns), jnp.asarray(rmask), z),
                      JPointCloud(jnp.asarray(misses), jnp.asarray(mmask), z))


def _port_rd(origin, returns, rmask, misses, mmask):
    z = torch.zeros(CAP)
    return RangeData(torch.tensor(origin, dtype=torch.float32),
                     PointCloud(torch.from_numpy(returns), torch.from_numpy(rmask), z),
                     PointCloud(torch.from_numpy(misses), torch.from_numpy(mmask), z))


def _assert_grids_agree(port_lo, port_known, ref_lo, ref_known, touched_ref):
    """Equal log-odds (to 1e-6) and known flags except on at most 0.1% of
    the touched cells, where a ray sample lies on a cell boundary."""
    differ = (np.abs(port_lo - ref_lo) > 1e-6) | (port_known != ref_known)
    assert differ.sum() <= max(1, int(1e-3 * touched_ref)), (differ.sum(), touched_ref)


def test_insert_range_data_matches_scatter_form():
    rng = np.random.RandomState(0)
    origin = np.array([0.37, -0.41], np.float32)
    jgrid = JGrid2D.create(SIZE, RES, jnp.asarray([0.1, 0.2]))
    pgrid = grid2d_from_numpy(np.asarray(jgrid.log_odds), np.asarray(jgrid.known),
                              np.asarray(jgrid.origin), RES, "cpu")
    for _ in range(3):
        scan = _scan(rng, origin)
        jgrid = j_insert(jgrid, _jax_rd(origin, *scan), ray_samples=SAMPLES, method="scatter")
        pgrid = insert_range_data(pgrid, _port_rd(origin, *scan), ray_samples=SAMPLES)
    lo, known, _, _ = grid2d_to_numpy(pgrid)
    ref_known = np.asarray(jgrid.known)
    assert ref_known.sum() > 5000
    _assert_grids_agree(lo, known, np.asarray(jgrid.log_odds), ref_known, ref_known.sum())


def test_active_submaps_counters_and_finished_submaps():
    num_range_data = 3
    jactive = JActive(JSubmaps(num_range_data=num_range_data),
                      JTpu(submap_grid_size=SIZE, ray_samples=SAMPLES))
    pactive = ActiveSubmaps2D(SubmapsOptions2D(num_range_data=num_range_data),
                              TpuOptions2D(submap_grid_size=SIZE, ray_samples=SAMPLES), "cpu")
    rng = np.random.RandomState(1)
    jfinished, pfinished = [], []
    for i in range(12):
        origin = np.array([0.2 * i, 0.05 * i], np.float32)
        scan = _scan(rng, origin)
        jfinished += jactive.insert_range_data(_jax_rd(origin, *scan), origin)
        pfinished += pactive.insert_range_data(_port_rd(origin, *scan), origin)
        assert ([s.num_range_data for s in pactive.submaps]
                == [s.num_range_data for s in jactive.submaps])
        for ps, js in zip(pactive.submaps, jactive.submaps):
            np.testing.assert_array_equal(ps.local_pose_translation, js.local_pose_translation)
    assert len(pfinished) == len(jfinished) == 3
    for ps, js in zip(pfinished, jfinished):
        assert ps.num_range_data == js.num_range_data == 2 * num_range_data
        lo, known, origin, _ = grid2d_to_numpy(ps.grid)
        np.testing.assert_array_equal(origin, np.asarray(js.grid.origin))
        ref_known = np.asarray(js.grid.known)
        _assert_grids_agree(lo, known, np.asarray(js.grid.log_odds), ref_known,
                            ref_known.sum())


def test_touched_cells_of_two_slots_match_jax():
    """The cells the port's insertion twin updates in two slots with
    different origins (the two active submaps) are the cells of JAX's
    hit_mask | free_mask in each: the known flags after one scan into fresh
    grids, in the scatter form."""
    from cartographer_tpu_torch.ops.grid_2d import Grid2D, _insert_plain
    from cartographer_tpu_torch.ops.probability import probability_to_log_odds

    rng = np.random.RandomState(3)
    origin = np.array([0.37, -0.41], np.float32)
    centers = np.float32([[0.1, 0.2], [0.63, -0.29]])
    scan = _scan(rng, origin)
    batch = Grid2D(torch.zeros((2, SIZE, SIZE)), torch.zeros((2, SIZE, SIZE), dtype=torch.bool),
                   torch.from_numpy(centers - np.float32(0.5 * SIZE * RES)), RES)
    _insert_plain(batch, _port_rd(origin, *scan), torch.ones(2, dtype=torch.bool),
                  torch.tensor(True), probability_to_log_odds(0.55),
                  probability_to_log_odds(0.49), True, SAMPLES)
    for slot in range(2):
        jgrid = j_insert(JGrid2D.create(SIZE, RES, jnp.asarray(centers[slot])),
                         _jax_rd(origin, *scan), ray_samples=SAMPLES, method="scatter")
        want = np.asarray(jgrid.known)
        assert want.sum() > 3000
        np.testing.assert_array_equal(np.asarray(batch.origin[slot]), np.asarray(jgrid.origin))
        differ = int((batch.known[slot].numpy() != want).sum())
        assert differ == 0, (slot, differ, int(want.sum()))
