"""The port's LocalTrajectoryBuilder2D (the whole 2D frontend slice, plain
path) against the JAX package's, and alone against ground truth.

The default configuration runs no correlative search, so the scan matcher
only refines the extrapolator's constant-velocity prediction: the
trajectories here start from rest and ramp their speed up, as a robot does.
With the online correlative matcher on, the frontend also follows a robot
that starts at speed.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from cartographer_tpu.mapping.local_trajectory_builder_2d import (
    LocalTrajectoryBuilder2D as JBuilder,
)
from cartographer_tpu.sensor.data import TimedPointCloudData as JScan
from cartographer_tpu_torch.core.config import apply_overrides
from cartographer_tpu_torch.interop import (
    grid2d_to_numpy,
    options_from_dict,
    tsdf_grid2d_to_numpy,
)
from cartographer_tpu_torch.mapping.local_trajectory_builder_2d import (
    LocalTrajectoryBuilder2D,
    check_kernel_limits,
)
from cartographer_tpu_torch.ops.tsdf_2d import TsdfGrid2D
from cartographer_tpu_torch.sensor.data import TimedPointCloudData
from cartographer_tpu_torch.transform import nquat
from test_local_slam_2d import make_wall_points, scan_at, small_options

T0 = 1_000_000_000

# The suite runs several test processes at once; PyTorch's CPU thread pool in
# each would contend for the cores and slow every process many times over.
torch.set_num_threads(1)


def _jax_options(**overrides):
    return small_options(**{"use_online_correlative_scan_matching": False, **overrides})


def _jax_permutation(seed, n):
    return np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))


def _ramped(num, top_speed, ramp_scans, yaw_rate=0.0):
    """Poses starting from rest: speed and yaw rate ramp up linearly over
    `ramp_scans` scans, then stay constant."""
    poses, xy, yaw = [], np.zeros(2), 0.0
    for i in range(num):
        k = min(i / ramp_scans, 1.0)
        yaw += k * yaw_rate
        xy = xy + k * top_speed * np.array([np.cos(yaw), np.sin(yaw)])
        poses.append((xy.copy(), yaw))
    return poses


def _scans(world, poses, scan_period=0.0):
    for i, (xy, yaw) in enumerate(poses):
        pts = scan_at(world, xy, yaw)
        times = np.linspace(-scan_period, 0.0, len(pts)).astype(np.float32)
        yield dict(time=T0 + i * 100_000, origin=np.zeros(3, np.float32), ranges=pts,
                   times=times)


def _yaw(q):
    return float(nquat.get_yaw(q))


@pytest.mark.parametrize("correlative", [False, True])
def test_builder_matches_jax(correlative):
    jopts = _jax_options(**{"submaps.num_range_data": 5,
                            "use_online_correlative_scan_matching": correlative})
    jb = JBuilder(jopts, ["laser"])
    tb = LocalTrajectoryBuilder2D(options_from_dict(dataclasses.asdict(jopts)), ["laser"],
                                  device="cpu", permutation_fn=_jax_permutation)
    world = make_wall_points(500)
    poses = _ramped(25, 0.07, 8, yaw_rate=0.01)
    jfinished, tfinished = [], []
    # Scans without per-point times: the unwarp's rounding differences would
    # be amplified by the flat cost of a room of sampled walls, and the
    # unwarp itself is held against the JAX package in test_torch_scan_pipeline.
    for scan in _scans(world, poses):
        rj = jb.add_range_data("laser", JScan(**scan))
        rt = tb.add_range_data("laser", TimedPointCloudData(**scan))
        np.testing.assert_allclose(rt.local_pose_translation, rj.local_pose_translation,
                                   atol=5e-3, rtol=0)
        assert abs(_yaw(rt.local_pose_rotation) - _yaw(rj.local_pose_rotation)) < 5e-3
        assert (rt.insertion_result is None) == (rj.insertion_result is None)
        if rj.insertion_result is not None:
            jfinished += rj.insertion_result.finished_submaps
            tfinished += rt.insertion_result.finished_submaps
    assert len(tfinished) == len(jfinished) >= 2
    assert [s.num_range_data for s in tfinished] == [s.num_range_data for s in jfinished]
    lo, known, _, _ = grid2d_to_numpy(tb._active_submaps.grids)
    jgrids = jb._active_submaps.grids
    same = (np.abs(lo - np.asarray(jgrids.log_odds)) <= 1e-6) & (known == np.asarray(jgrids.known))
    assert same.mean() >= 0.999, same.mean()


def _drive(options, poses, num_points=300):
    builder = LocalTrajectoryBuilder2D(options, ["laser"], device="cpu")
    world = make_wall_points(num_points)
    results = [builder.add_range_data("laser", TimedPointCloudData(**scan))
               for scan in _scans(world, poses)]
    return [r for r in results if r is not None]


def _port_options(**overrides):
    return options_from_dict(dataclasses.asdict(_jax_options(**overrides)))


def test_straight_line_ground_truth():
    poses = _ramped(30, 0.05, 8)
    results = _drive(_port_options(), poses)
    assert len(results) == 30
    err = np.linalg.norm(results[-1].local_pose_translation[:2] - poses[-1][0])
    assert err < 0.1, (results[-1].local_pose_translation, poses[-1][0])


def test_turn_then_move_ground_truth():
    # The yaw rate ramps up to 0.03 rad per scan and back down to 0.
    yaws = np.cumsum([0.03 * min(i, 12 - i) / 6 for i in range(13)])
    turn = [(np.zeros(2), yaw) for yaw in yaws]
    yaw = yaws[-1]
    move = [(d * np.array([np.cos(yaw), np.sin(yaw)]), yaw)
            for d in np.cumsum([0.05 * min(i / 6, 1.0) for i in range(1, 11)])]
    results = _drive(_port_options(), turn + move)
    final = results[-1]
    assert np.linalg.norm(final.local_pose_translation[:2] - move[-1][0]) < 0.1
    assert abs(_yaw(final.local_pose_rotation) - yaw) < 0.05


def test_insertion_results_and_submap_rotation():
    poses = _ramped(45, 0.05, 8)
    results = _drive(_port_options(**{"motion_filter.max_distance_meters": 0.01}), poses)
    inserted = [r for r in results if r.insertion_result is not None]
    assert len(inserted) >= 40  # the motion filter keeps all moving poses
    finished = [s for r in inserted for s in r.insertion_result.finished_submaps]
    assert len(finished) >= 1
    assert finished[0].insertion_finished and finished[0].grid is not None
    assert finished[0].num_range_data == 40


def test_waits_for_imu_when_configured():
    builder = LocalTrajectoryBuilder2D(_port_options(**{"use_imu_data": True}), ["laser"],
                                       device="cpu")
    scan = next(_scans(make_wall_points(), [(np.zeros(2), 0.0)]))
    assert builder.add_range_data("laser", TimedPointCloudData(**scan)) is None


def test_online_correlative_matcher_runs():
    # At speed from the first scan, with a jump the constant-velocity
    # prediction cannot know: the correlative window finds it.
    poses = [(np.array([0.06 * i, 0.0]), 0.0) for i in range(20)]
    poses += [(poses[-1][0] + np.array([0.06 * i + 0.05, 0.04]), 0.03) for i in range(1, 11)]
    options = _port_options(**{"use_online_correlative_scan_matching": True})
    results = _drive(options, poses)
    assert len(results) == len(poses)
    errors = [np.linalg.norm(r.local_pose_translation[:2] - p[0]) for r, p in zip(results, poses)]
    assert max(errors) < 0.05, max(errors)
    assert abs(_yaw(results[-1].local_pose_rotation) - 0.03) < 0.01


@pytest.mark.parametrize("correlative", [True, False])
def test_tsdf_builder_matches_jax(correlative):
    """TSDF submaps (the twin of tests/test_tsdf_local_slam.py, scan by scan
    against the JAX builder): poses within 5 mm and 5e-3 rad, the same
    insertions and finished submaps, 90% of the active grids' known cells
    within 1e-4."""
    jopts = _jax_options(**{"submaps.grid_type": "TSDF", "submaps.num_range_data": 5,
                            "use_online_correlative_scan_matching": correlative})
    jb = JBuilder(jopts, ["laser"])
    tb = LocalTrajectoryBuilder2D(options_from_dict(dataclasses.asdict(jopts)), ["laser"],
                                  device="cpu", permutation_fn=_jax_permutation)
    world = make_wall_points(500)
    poses = _ramped(22, 0.05, 6, yaw_rate=0.01)
    jfinished, tfinished = [], []
    for scan in _scans(world, poses):
        rj = jb.add_range_data("laser", JScan(**scan))
        rt = tb.add_range_data("laser", TimedPointCloudData(**scan))
        np.testing.assert_allclose(rt.local_pose_translation, rj.local_pose_translation,
                                   atol=5e-3, rtol=0)
        assert abs(_yaw(rt.local_pose_rotation) - _yaw(rj.local_pose_rotation)) < 5e-3
        assert (rt.insertion_result is None) == (rj.insertion_result is None)
        if rj.insertion_result is not None:
            jfinished += rj.insertion_result.finished_submaps
            tfinished += rt.insertion_result.finished_submaps
    assert len(tfinished) == len(jfinished) >= 2
    assert [s.num_range_data for s in tfinished] == [s.num_range_data for s in jfinished]
    tsd, weight, _, _, _, _ = tsdf_grid2d_to_numpy(tb._active_submaps.grids)
    jgrids = jb._active_submaps.grids
    known = (weight > 0) | (np.asarray(jgrids.weight) > 0)
    same = ((np.abs(weight - np.asarray(jgrids.weight)) <= 1e-4)
            & (np.abs(tsd - np.asarray(jgrids.tsd)) <= 1e-4))
    # The poses part by up to 0.15 mm over these scans (rounding), which
    # moves samples across cell borders: 90% of the known cells agree.
    assert known.sum() > 1000
    assert same[known].mean() >= 0.9, same[known].mean()
    err = np.linalg.norm(rt.local_pose_translation[:2] - poses[-1][0])
    assert err < 0.12, (rt.local_pose_translation, poses[-1][0])


def test_tsdf_options_are_accepted_and_carried():
    """grid_type TSDF and the TSDF inserter's options, formerly refused,
    reach the builder's submaps."""
    jopts = _jax_options(**{"submaps.grid_type": "TSDF",
                            "submaps.range_data_inserter_type": "TSDF_INSERTER_2D",
                            "submaps.tsdf_range_data_inserter.truncation_distance": 0.25,
                            "submaps.tsdf_range_data_inserter.maximum_weight": 7.0})
    options = options_from_dict(dataclasses.asdict(jopts))
    assert options.submaps.range_data_inserter_type == "TSDF_INSERTER_2D"
    assert dataclasses.asdict(options.submaps.tsdf_range_data_inserter) == dataclasses.asdict(
        jopts.submaps.tsdf_range_data_inserter)
    builder = LocalTrajectoryBuilder2D(options, ["laser"], device="cpu")
    scan = next(_scans(make_wall_points(), [(np.zeros(2), 0.0)]))
    builder.add_range_data("laser", TimedPointCloudData(**scan))
    grid = builder._active_submaps.matching_grid
    assert isinstance(grid, TsdfGrid2D)
    assert (grid.truncation_distance, grid.max_weight) == (0.25, 7.0)
    assert float(grid.weight.max()) > 0


@pytest.mark.parametrize("override,option", [
    ({"tpu.matcher_capacity": 8192, "tpu.scan_capacity": 8192,
      "use_online_correlative_scan_matching": True}, "tpu.matcher_capacity"),
    ({"tpu.loop_closure_capacity": 2048, "tpu.scan_capacity": 2048},
     "tpu.loop_closure_capacity"),
])
def test_kernel_limits_refused_at_construction(override, option):
    """A capacity above a one-block kernel's limit raises on a CUDA device
    before any scan, naming the option; the plain path takes it."""
    options = apply_overrides(_port_options(), override)
    with pytest.raises(ValueError, match=option):
        LocalTrajectoryBuilder2D(options, ["laser"], device="cuda")
    LocalTrajectoryBuilder2D(options, ["laser"], device="cpu")
    # Without the correlative search the matcher capacity meets no K5.
    if option == "tpu.matcher_capacity":
        check_kernel_limits(apply_overrides(
            options, {"use_online_correlative_scan_matching": False}))


def test_batcher_raises():
    with pytest.raises(NotImplementedError):
        LocalTrajectoryBuilder2D(_port_options(), ["laser"], device="cpu", batcher=object())
