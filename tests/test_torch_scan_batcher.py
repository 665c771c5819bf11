"""Cross-robot batched serving in the port (mapping/scan_batcher.py over the
robot-batched step of mapping/local_trajectory_builder_2d.py), plain path:
the twin of tests/test_scan_batcher.py, each robot against its own
unbatched run (exactly) and against the JAX package's ScanBatcher, padded
lanes, and the batched step itself against the JAX package's
`_batched_step_cached` on the same inputs and grids; on probability grids
and on TSDF submaps."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import jax

from cartographer_tpu.mapping.local_trajectory_builder_2d import (
    LocalTrajectoryBuilder2D as JBuilder,
)
from cartographer_tpu.mapping.local_trajectory_builder_2d import _batched_step_cached
from cartographer_tpu.mapping.scan_batcher import ScanBatcher as JScanBatcher
from cartographer_tpu.ops.grid_2d import Grid2D as JGrid2D
from cartographer_tpu.ops.tsdf_2d import TsdfGrid2D as JTsdfGrid2D
from cartographer_tpu.sensor.data import TimedPointCloudData as JScan
from cartographer_tpu_torch.core.time import from_seconds
from cartographer_tpu_torch.interop import (
    grid2d_to_numpy,
    options_from_dict,
    tsdf_grid2d_to_numpy,
)
from cartographer_tpu_torch.mapping.local_trajectory_builder_2d import (
    LocalTrajectoryBuilder2D,
    batched_step,
)
from cartographer_tpu_torch.mapping.scan_batcher import ScanBatcher
from cartographer_tpu_torch.sensor.data import TimedPointCloudData
from cartographer_tpu_torch.simulation import reference_permutation
from cartographer_tpu_torch.transform import nquat
from test_local_slam_2d import make_wall_points, scan_at, small_options

# The suite runs several test processes at once; PyTorch's CPU thread pool in
# each would contend for the cores and slow every process many times over.
torch.set_num_threads(1)
T0 = 1_000_000_000
STARTS = [np.array([0.0, 0.0]), np.array([0.3, -0.2]), np.array([-0.2, 0.25])]
TSDF = {"submaps.grid_type": "TSDF"}


def _jax_permutation(seed, n):
    return np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))


def _jax_options(**overrides):
    return small_options(**{"motion_filter.max_distance_meters": 0.01, **overrides})


def _port(jopts, **kwargs):
    return LocalTrajectoryBuilder2D(options_from_dict(dataclasses.asdict(jopts)), ["laser"],
                                    device="cpu", permutation_fn=_jax_permutation, **kwargs)


def _scan(scan_cls, world, offset, i):
    return scan_cls(time=T0 + from_seconds(i * 0.1), origin=np.zeros(3, np.float32),
                    ranges=scan_at(world, offset + np.array([0.05 * i, 0.0]), 0.0),
                    times=np.zeros(len(world), np.float32))


def _drive(builder, world, offset, n_scans=8, scan_cls=TimedPointCloudData):
    """-> [(translation, rotation)] of every scan the builder placed."""
    poses = []
    for i in range(n_scans):
        r = builder.add_range_data("laser", _scan(scan_cls, world, offset, i))
        if r is not None:
            poses.append((np.asarray(r.local_pose_translation),
                          np.asarray(r.local_pose_rotation)))
    return poses


def _in_threads(builders, world, starts, scan_cls=TimedPointCloudData):
    results = [None] * len(builders)

    def run(k):
        results[k] = _drive(builders[k], world, starts[k], scan_cls=scan_cls)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(len(builders))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


def _batched_against_alone(jopts, world, starts):
    """Robot threads through one batcher: each robot's poses equal its
    unbatched run exactly. -> the batched runs."""
    expected = [_drive(_port(jopts), world, s) for s in starts]
    batcher = ScanBatcher(max_batch=len(starts), max_wait_s=0.5)
    got = _in_threads([_port(jopts, batcher=batcher) for _ in starts], world, starts)
    batcher.close()
    assert batcher.num_scans == sum(len(e) for e in expected) == 8 * len(starts)
    assert batcher.num_batches < batcher.num_scans  # ticks coalesced robots
    for exp, g in zip(expected, got):
        assert len(exp) == len(g)
        for (et, eq), (gt, gq) in zip(exp, g):
            assert np.array_equal(gt, et) and np.array_equal(gq, eq)
    return got


def test_batched_matches_unbatched():
    """Two robot threads through one batcher: each robot's poses equal its
    unbatched run exactly, and the JAX package's batched run within 5 mm
    and 5e-3 rad."""
    world = make_wall_points(num=300, seed=3)
    jopts = _jax_options()
    starts = STARTS[:2]
    got = _batched_against_alone(jopts, world, starts)

    jbatcher = JScanBatcher(max_batch=2, max_wait_s=0.5, fixed_bucket=True)
    jax_runs = _in_threads([JBuilder(jopts, ["laser"], batcher=jbatcher) for _ in starts],
                           world, starts, scan_cls=JScan)
    jbatcher.close()
    for j, g in zip(jax_runs, got):
        assert len(j) == len(g)
        for (jt, jq), (gt, gq) in zip(j, g):
            np.testing.assert_allclose(gt, jt, atol=5e-3, rtol=0)
            assert abs(nquat.get_yaw(gq) - nquat.get_yaw(np.asarray(jq))) < 5e-3


def test_batched_matches_unbatched_tsdf():
    """TSDF submaps (K20 and K21 with a robot index): two robot threads
    through one batcher equal their unbatched runs exactly."""
    _batched_against_alone(_jax_options(**TSDF), make_wall_points(num=300, seed=3),
                           STARTS[:2])


def test_single_robot_through_batcher():
    world = make_wall_points(num=300, seed=5)
    batcher = ScanBatcher(max_batch=4, max_wait_s=0.001)
    b = _port(_jax_options(), batcher=batcher)
    poses = _drive(b, world, np.zeros(2), n_scans=5)
    batcher.close()
    assert len(poses) == 5 and batcher.num_batches == 5
    np.testing.assert_allclose(poses[-1][0][:2], [0.05 * 4, 0.0], atol=0.08)


def test_mismatched_options_rejected():
    world = make_wall_points(num=300, seed=5)
    batcher = ScanBatcher(max_batch=2, max_wait_s=0.001)
    a = _port(_jax_options(), batcher=batcher)
    b = _port(_jax_options(**{"motion_filter.max_distance_meters": 0.5}), batcher=batcher)
    _drive(a, world, np.zeros(2), n_scans=1)
    with pytest.raises(ValueError, match="different"):
        _drive(b, world, np.zeros(2), n_scans=1)
    batcher.close()


def _padded_against_unpadded(jopts, to_numpy):
    """A lone robot through an unpadded batcher and under fixed_bucket:
    poses, and the grids' arrays (`to_numpy`), bit for bit. -> the grids."""
    world = make_wall_points(num=300, seed=7)
    runs = []
    for fixed in (False, True):
        batcher = ScanBatcher(max_batch=3, max_wait_s=0.001, fixed_bucket=fixed)
        b = _port(jopts, batcher=batcher)
        poses = _drive(b, world, np.zeros(2), n_scans=6)
        batcher.close()
        runs.append((poses, to_numpy(b._active_submaps.grids)))
    (poses_a, grids_a), (poses_b, grids_b) = runs
    assert len(poses_a) == len(poses_b) == 6
    for (ta, qa), (tb, qb) in zip(poses_a, poses_b):
        assert np.array_equal(ta, tb) and np.array_equal(qa, qb)
    for a, b in zip(grids_a[:3], grids_b[:3]):
        assert np.array_equal(a, b)
    return grids_a


def test_padded_lanes_leave_grids_unchanged():
    """Under fixed_bucket a lone robot's ticks carry two inert lanes that
    repeat its inputs: its poses and its grids equal those of the same robot
    through an unpadded batcher, bit for bit."""
    grids = _padded_against_unpadded(_jax_options(), grid2d_to_numpy)
    assert int(grids[1].sum()) > 1000  # known cells


def test_padded_lanes_leave_grids_unchanged_tsdf():
    """The same on TSDF submaps: the inert lanes' K21 items add nothing to
    the grids they point at (entry 0's)."""
    grids = _padded_against_unpadded(_jax_options(**TSDF), tsdf_grid2d_to_numpy)
    assert int((grids[1] > 0).sum()) > 1000  # known cells


def _step_against_jax(jopts, tsdf):
    """The port's robot-batched step against the JAX package's
    `_batched_step_cached` for 3 robots on the same padded inputs, seeds and
    grids: poses within 5 mm and 5e-3 rad, the same insertion decisions and
    loop-closure cloud sizes, and 99.9% of the updated grid cells within
    1e-6 (TSDF weights 2e-5)."""
    world = make_wall_points(num=300, seed=9)
    builders = [_port(jopts) for _ in STARTS]
    for b, s in zip(builders, STARTS):
        _drive(b, world, s, n_scans=3)
    scans = [b._prepare(_scan(TimedPointCloudData, world, s, 3))
             for b, s in zip(builders, STARTS)]
    staging = torch.cat([b._staging for b in builders])
    seeds = [s.seed for s in scans]
    to_numpy, jgrid = ((tsdf_grid2d_to_numpy, JTsdfGrid2D) if tsdf else
                       (grid2d_to_numpy, JGrid2D))
    before = [tuple(np.copy(a) if isinstance(a, np.ndarray) else a
                    for a in to_numpy(b._active_submaps.grids)) for b in builders]
    packed, _ = batched_step(builders, staging, seeds)
    packed = packed.numpy()

    rows = staging.numpy()
    n = jopts.tpu.scan_capacity
    step = _batched_step_cached(*JBuilder(jopts, ["laser"])._step_key, len(builders))
    jgrids = tuple(jgrid(*fields) for fields in before)
    jgrids_out, jpacked, _ = step(
        jgrids, rows[:, 8 * n + 31:8 * n + 33] > 0.5, rows[:, :3 * n].reshape(-1, n, 3),
        rows[:, 6 * n:7 * n], rows[:, 7 * n:8 * n] > 0.5, rows[:, 3 * n:6 * n].reshape(-1, n, 3),
        rows[:, 8 * n:8 * n + 31], np.asarray(seeds, np.uint32))
    jpacked = np.asarray(jpacked)
    lc = (jpacked.shape[1] - 10) // 3
    np.testing.assert_allclose(packed[:, :2], jpacked[:, :2], atol=5e-3, rtol=0)
    np.testing.assert_allclose(packed[:, 2], jpacked[:, 2], atol=5e-3, rtol=0)
    assert np.array_equal(packed[:, 8:10], jpacked[:, 8:10])  # do_insert, ok
    assert packed[:, 8].all()
    assert np.array_equal((packed[:, 11:11 + lc] > 0.5).sum(1),
                          (jpacked[:, 10:10 + lc] > 0.5).sum(1))
    for b, jg, fields in zip(builders, jgrids_out, before):
        if tsdf:
            # The cells either package touched: tsd within 1e-6, weights (up
            # to 10, sums of the angle kernel of normals that LAPACK's eigh
            # and the port's closed form give a few ulps apart) within 2e-5.
            tsd, weight = to_numpy(b._active_submaps.grids)[:2]
            changed = (weight != fields[1]) | (np.asarray(jg.weight) != fields[1])
            same = ((np.abs(tsd - np.asarray(jg.tsd)) <= 1e-6)
                    & (np.abs(weight - np.asarray(jg.weight)) <= 2e-5))
        else:  # XLA's and PyTorch's logit(0.55) differ by an ulp
            lo, known = to_numpy(b._active_submaps.grids)[:2]
            changed = (lo != fields[0]) | (np.asarray(jg.log_odds) != fields[0])
            same = ((np.abs(lo - np.asarray(jg.log_odds)) <= 1e-6)
                    & (known == np.asarray(jg.known)))
        assert changed.sum() > 500
        assert same[changed].mean() >= 0.999, same[changed].mean()


@pytest.mark.parametrize("correlative", [False, True])
def test_batched_step_matches_jax(correlative):
    """The robot-batched step on probability grids against JAX's."""
    _step_against_jax(_jax_options(**{"use_online_correlative_scan_matching": correlative}),
                      tsdf=False)


@pytest.mark.parametrize("correlative", [False, True])
def test_batched_step_matches_jax_tsdf(correlative):
    """The robot-batched step on TSDF submaps (K5's TSDF form, K22, K20 and
    K21 with a robot index) against JAX's `_batched_step_cached` with
    use_tsdf."""
    _step_against_jax(_jax_options(**TSDF, **{
        "use_online_correlative_scan_matching": correlative}), tsdf=True)


@pytest.mark.parametrize("n", [1, 256, 1024, 2048, 16384])
def test_reference_permutation_is_jax(n):
    """The port's numpy copy of the JAX package's voxel-filter permutation
    (one sorting round up to 1,629 points, two above) equals
    jax.random.permutation for the seeds a run draws."""
    for seed in (0, 1, 2, 59, 80, 2 ** 31 - 1):
        got = reference_permutation(seed, n)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, _jax_permutation(seed, n))
