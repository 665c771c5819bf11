"""The port's 3D MapBuilder (the 3D global SLAM slice, plain path) against
the JAX package's: the twin of
tests/test_local_slam_3d.py::TestMapBuilder3D, run on both packages with the
searches and solves inline."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from cartographer_tpu.core.config import (
    MapBuilderOptions as JMapBuilderOptions,
    TrajectoryBuilderOptions as JTrajectoryOptions,
    apply_overrides,
)
from cartographer_tpu.mapping.map_builder import MapBuilder as JMapBuilder
from cartographer_tpu.sensor.data import ImuData as JImuData, TimedPointCloudData as JScan
from cartographer_tpu_torch.core.config import MapBuilderOptions, TrajectoryBuilderOptions
from cartographer_tpu_torch.core.time import from_seconds
from cartographer_tpu_torch.interop import (
    map_builder_options_from_dict,
    trajectory_builder_options_from_dict,
)
from cartographer_tpu_torch.mapping.map_builder import MapBuilder
from cartographer_tpu_torch.sensor.data import ImuData, TimedPointCloudData
from test_local_slam_3d import scan_at_3d, small_options_3d
from test_ops_3d import make_environment_3d

torch.set_num_threads(1)

T0 = 1_000_000_000
SMALL_POOL = {"tpu.page_size": 8, "tpu.max_pages": 512, "tpu.num_blocks": 32}
FCSM = "pose_graph.constraint_builder.fast_correlative_scan_matcher_3d."
OVERRIDES = {
    "pose_graph.optimize_every_n_nodes": 10,
    # Fewer solver iterations than the JAX test's defaults keep the plain
    # twin's solves within the file's time.
    "pose_graph.optimization_problem.max_num_iterations": 10,
    "pose_graph.max_num_final_iterations": 30,
    "pose_graph.constraint_builder.sampling_ratio": 1.0,
    "pose_graph.constraint_builder.min_score": 0.35,
    FCSM + "branch_and_bound_depth": 4,
    FCSM + "min_rotational_score": 0.3,
    FCSM + "min_low_resolution_score": 0.3,
    FCSM + "linear_xy_search_window": 1.5,
    FCSM + "linear_z_search_window": 0.4,
}
# Out along x and back over the finished submaps.
POSES = ([(np.array([0.05 * i, 0.0, 0.0]), 0.0) for i in range(10)]
         + [(np.array([0.5 - 0.05 * i, 0.0, 0.0]), 0.0) for i in range(11)])


def _jax_permutation(seed, n):
    return np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))


def _options():
    mb = apply_overrides(JMapBuilderOptions(use_trajectory_builder_3d=True,
                                            async_constraint_search=False), OVERRIDES)
    traj = JTrajectoryOptions(trajectory_builder_3d=small_options_3d(
        **{**SMALL_POOL, "submaps.num_range_data": 6}))
    return mb, traj


def _drive(mb, tid, imu, cloud, world):
    for k in range(5):
        mb.add_sensor_data(tid, "imu", imu(time=T0 - from_seconds(0.05 * (5 - k)),
                                           linear_acceleration=np.array([0.0, 0.0, 9.81]),
                                           angular_velocity=np.zeros(3)))
    for i, (t_xyz, yaw) in enumerate(POSES):
        t = T0 + from_seconds(i * 0.1)
        scan = scan_at_3d(world, t_xyz, yaw)
        mb.add_sensor_data(tid, "points", cloud(time=t, origin=np.zeros(3, np.float32),
                                                ranges=scan,
                                                times=np.zeros(len(scan), np.float32)))
        if i + 1 < len(POSES):
            for k in range(1, 5):
                mb.add_sensor_data(tid, "imu", imu(
                    time=t + from_seconds(0.1 * k / 5),
                    linear_acceleration=np.array([0.0, 0.0, 9.81]),
                    angular_velocity=np.zeros(3)))
    mb.finish_trajectory(tid)
    mb.pose_graph.run_final_optimization()
    return mb.pose_graph


@pytest.fixture(scope="module")
def graphs():
    world = make_environment_3d(num=500, seed=4)
    jmb_opts, jtraj = _options()
    jmb = JMapBuilder(jmb_opts)
    jtid = jmb.add_trajectory_builder(["points", "imu"], jtraj)
    jpg = _drive(jmb, jtid, JImuData, JScan, world)
    mb = MapBuilder(map_builder_options_from_dict(dataclasses.asdict(jmb_opts)), device="cpu")
    tid = mb.add_trajectory_builder(
        ["points", "imu"], trajectory_builder_options_from_dict(dataclasses.asdict(jtraj)),
        permutation_fn=_jax_permutation)
    pg = _drive(mb, tid, ImuData, TimedPointCloudData, world)
    return jpg, pg


def _inter_pairs(pg):
    return {(c.node_id.trajectory_id, c.node_id.node_index, c.submap_id.trajectory_id,
             c.submap_id.submap_index) for c in pg.constraints if c.tag == "INTER_SUBMAP"}


def test_same_loop_closures(graphs):
    jpg, pg = graphs
    assert len(pg.nodes) == len(jpg.nodes) >= 15
    assert len(pg.submap_data) == len(jpg.submap_data) >= 2
    assert pg.num_inter_constraints() > 0
    assert _inter_pairs(pg) == _inter_pairs(jpg)


def test_optimized_poses_match_jax(graphs):
    jpg, pg = graphs
    ref_nodes = {nid: node for nid, node in jpg.nodes.items()}
    for nid, node in pg.nodes.items():
        ref = ref_nodes[nid]
        np.testing.assert_allclose(node.global_t, ref.global_t, atol=0.02)
        dot = abs(float(np.dot(node.global_q, ref.global_q)))
        assert 2 * np.arccos(min(dot, 1.0)) < 0.02
    # Near the out-and-back line, as the JAX test requires.
    errs = [np.linalg.norm(node.global_t - POSES[round((node.time - T0) / 100_000)][0])
            for _, node in pg.nodes.items()]
    assert np.mean(errs) < 0.15, np.mean(errs)
    # The IMU block of the trajectory was learned, gravity kept non-negative.
    td = pg.trajectory_data[0]
    assert td["gravity_constant"] >= 0.0
    np.testing.assert_allclose(td["gravity_constant"],
                               jpg.trajectory_data[0]["gravity_constant"], atol=1e-2)


def test_3d_map_builder_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MapBuilder(MapBuilderOptions(use_trajectory_builder_3d=True))


@pytest.mark.parametrize("path,value", [
    ("pure_localization_trimmer", object()),
])
def test_unported_3d_trajectory_options_raise(path, value):
    mb = MapBuilder(MapBuilderOptions(use_trajectory_builder_3d=True), device="cpu")
    options = apply_overrides(TrajectoryBuilderOptions(), {path: value})
    with pytest.raises(NotImplementedError):
        mb.add_trajectory_builder(["points", "imu"], options)


def test_map_builder_runs_the_full_frontend():
    """The correlative search, intensities and the IMU-based extrapolator
    carried from the JAX package's TrajectoryBuilderOptions into a 3D
    MapBuilder, which places a few scans of the hall with intensities."""
    from cartographer_tpu_torch.mapping.imu_based_pose_extrapolator import (
        ImuBasedPoseExtrapolator,
    )
    from cartographer_tpu_torch.simulation import relative_to_first, simulate_scans_3d

    jtraj = JTrajectoryOptions(trajectory_builder_3d=apply_overrides(
        JTrajectoryOptions().trajectory_builder_3d, {
            "use_online_correlative_scan_matching": True, "use_intensities": True,
            "pose_extrapolator.use_imu_based": True,
            "pose_extrapolator.imu_based.pose_queue_duration": 1.0, "max_range": 20.0,
            "tpu.scan_capacity": 1024, "tpu.page_size": 8, "tpu.max_pages": 1024,
            "tpu.num_blocks": 64, "tpu.high_grid_size": 96, "tpu.low_grid_size": 48}))
    options = trajectory_builder_options_from_dict(dataclasses.asdict(jtraj))
    mb = MapBuilder(MapBuilderOptions(use_trajectory_builder_3d=True,
                                      async_constraint_search=False), device="cpu")
    tid = mb.add_trajectory_builder(["points", "imu"], options)
    scans, imu, truth = simulate_scans_3d(8, rings=8, azimuths=128, seed=1, intensities=True)
    k = 0
    for ts, pts, rel, intens in scans:
        for t, accel, gyro in [m for m in imu[k:] if m[0] <= ts]:
            mb.add_sensor_data(tid, "imu", ImuData(time=T0 + from_seconds(t),
                                                   linear_acceleration=accel,
                                                   angular_velocity=gyro))
            k += 1
        mb.add_sensor_data(tid, "points", TimedPointCloudData(
            time=T0 + from_seconds(ts), origin=np.zeros(3, np.float32), ranges=pts, times=rel,
            intensities=intens))
    mb.finish_trajectory(tid)
    local = mb.get_trajectory_builder(tid)._local
    assert isinstance(local._extrapolator, ImuBasedPoseExtrapolator)
    submap = local._active_submaps.submaps[0]
    assert submap.intensity_paged.num_allocated > 0 and submap.intensity_grid is not None
    nodes = [n for _, n in sorted(mb.pose_graph.nodes.items())]
    assert len(nodes) >= 4  # the robot starts from rest: the motion filter drops some
    gt = relative_to_first(truth)
    last = nodes[-1]
    i = round((last.time - T0) / 100_000) - 1
    assert np.linalg.norm(last.local_pose_translation[:2] - gt[i, :2]) < 0.25


def test_3d_landmarks_and_trimmers_raise():
    mb = MapBuilder(MapBuilderOptions(use_trajectory_builder_3d=True), device="cpu")
    for call in (lambda: mb.pose_graph.add_landmark_data(0, None),
                 lambda: mb.pose_graph.add_trimmer(object()),
                 lambda: mb.add_trajectory_builder(["points"], TrajectoryBuilderOptions(),
                                                   local_slam_results=True)):
        with pytest.raises(NotImplementedError):
            call()


def test_map_builder_import_loads_no_jax():
    code = ("import sys, cartographer_tpu_torch.mapping.map_builder; "
            "sys.exit(1 if any(m == 'jax' or m.startswith('jax.') for m in sys.modules) "
            "else 0)")
    assert subprocess.run([sys.executable, "-c", code]).returncode == 0
