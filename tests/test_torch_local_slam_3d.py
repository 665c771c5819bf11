"""The port's LocalTrajectoryBuilder3D (the whole 3D frontend slice, plain
path) against the JAX package's, scan by scan, and alone: the twin of
tests/test_local_slam_3d.py::TestLocalSlam3D."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from cartographer_tpu.core.config import TrajectoryBuilder3DOptions as JOptions, apply_overrides
from cartographer_tpu.mapping.local_trajectory_builder_3d import (
    LocalTrajectoryBuilder3D as JBuilder,
)
from cartographer_tpu.sensor.data import ImuData as JImuData, TimedPointCloudData as JScan
from cartographer_tpu_torch.core.config import TrajectoryBuilder3DOptions
from cartographer_tpu_torch.core.time import from_seconds
from cartographer_tpu_torch.interop import (
    UNPORTED_3D_SWITCHES,
    UNREAD_3D_OPTIONS,
    options_3d_from_dict,
)
from cartographer_tpu_torch.mapping.local_trajectory_builder_3d import LocalTrajectoryBuilder3D
from cartographer_tpu_torch.sensor.data import ImuData, TimedPointCloudData
from cartographer_tpu_torch.simulation import relative_to_first, simulate_scans_3d
from cartographer_tpu_torch.transform import nquat
from test_local_slam_3d import scan_at_3d, small_options_3d
from test_ops_3d import make_environment_3d

T0 = 1_000_000_000

# The suite runs several test processes at once; PyTorch's CPU thread pool in
# each would contend for the cores and slow every process many times over.
torch.set_num_threads(1)

# Small pools: pages of 8^3 voxels, 512 of them, a table of 32^3 blocks.
SMALL_POOL = {"tpu.page_size": 8, "tpu.max_pages": 512, "tpu.num_blocks": 32}


def _jax_options(**overrides):
    return small_options_3d(**{**SMALL_POOL, **overrides})


def _port_options(**overrides):
    return options_3d_from_dict(dataclasses.asdict(_jax_options(**overrides)))


def _jax_permutation(seed, n):
    return np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))


def _drive(builders, world, poses, dt=0.1):
    """Feed IMU (level, gravity and the yaw rate) and scans along the poses
    to every (builder, ImuData, TimedPointCloudData) triple; returns one
    list of results per builder."""
    results = [[] for _ in builders]
    for k in range(5):  # IMU before the first scan
        for b, imu, _ in builders:
            b.add_imu_data(imu(time=T0 - from_seconds(0.05 * (5 - k)),
                               linear_acceleration=np.array([0.0, 0.0, 9.81]),
                               angular_velocity=np.zeros(3)))
    for i, (t_xyz, yaw) in enumerate(poses):
        t = T0 + from_seconds(i * dt)
        scan = scan_at_3d(world, t_xyz, yaw)
        for out, (b, _, cloud) in zip(results, builders):
            out.append(b.add_range_data("points", cloud(
                time=t, origin=np.zeros(3, np.float32), ranges=scan,
                times=np.zeros(len(scan), np.float32))))
        if i + 1 < len(poses):
            yaw_rate = (poses[i + 1][1] - yaw) / dt
            for k in range(1, 5):
                for b, imu, _ in builders:
                    b.add_imu_data(imu(time=t + from_seconds(dt * k / 5),
                                       linear_acceleration=np.array([0.0, 0.0, 9.81]),
                                       angular_velocity=np.array([0.0, 0.0, yaw_rate])))
    return results


def _port_builder(**overrides):
    return (LocalTrajectoryBuilder3D(_port_options(**overrides), ["points"], device="cpu"),
            ImuData, TimedPointCloudData)


def test_builder_matches_jax():
    jopts = _jax_options()
    jb = JBuilder(jopts, ["points"])
    tb = LocalTrajectoryBuilder3D(options_3d_from_dict(dataclasses.asdict(jopts)), ["points"],
                                  device="cpu", permutation_fn=_jax_permutation)
    world = make_environment_3d(num=500, seed=3)
    poses = [(np.array([0.04 * i, 0.003 * i, 0.0]), 0.004 * i) for i in range(26)]
    jres, tres = _drive([(jb, JImuData, JScan), (tb, ImuData, TimedPointCloudData)], world,
                        poses)
    jfinished, tfinished = [], []
    for rj, rt in zip(jres, tres):
        np.testing.assert_allclose(rt.local_pose_translation, rj.local_pose_translation,
                                   atol=0.02, rtol=0)
        dq = nquat.multiply(nquat.conjugate(rj.local_pose_rotation), rt.local_pose_rotation)
        assert nquat.angle(dq) < 0.01
        assert (rt.insertion_result is None) == (rj.insertion_result is None)
        if rj.insertion_result is not None:
            jfinished += rj.insertion_result.finished_submaps
            tfinished += rt.insertion_result.finished_submaps
            np.testing.assert_allclose(rt.insertion_result.scan_histogram.sum(),
                                       rj.insertion_result.scan_histogram.sum(), rtol=0.05)
    assert len(tfinished) == len(jfinished) >= 1
    assert [s.num_range_data for s in tfinished] == [s.num_range_data for s in jfinished]
    assert ([s.num_range_data for s in tb._active_submaps.submaps]
            == [s.num_range_data for s in jb._active_submaps.submaps])
    jf, tf = jfinished[0], tfinished[0]
    assert tf.high_paged.num_allocated == jf.high_paged.num_allocated
    assert tf.low_paged.num_allocated == jf.low_paged.num_allocated
    assert tf.high_grid.log_odds.shape == jf.high_grid.log_odds.shape
    same = np.asarray(jf.high_grid.known) == tf.high_grid.known.numpy()
    assert same.mean() > 0.999, same.mean()
    np.testing.assert_allclose(tf.histogram, jf.histogram, atol=0.05 * jf.histogram.max())
    assert tb.device_fetches == 26


# The simulated hall at a small width: 8 rings x 128 azimuths, the default
# resolutions (0.10 m / 0.45 m) and matcher, pages of 8^3, windows of 128^3
# and 64^3 cells.
HALL_OPTIONS = {"tpu.scan_capacity": 1024, "tpu.page_size": 8, "tpu.max_pages": 2048,
                "tpu.num_blocks": 64, "tpu.high_grid_size": 128, "tpu.low_grid_size": 64}


@pytest.mark.parametrize("scene,limit", [
    ({}, 0.25),  # the default scene: half scale, heading oblique to the walls
    ({"scale": 1.0, "start": 0.0}, None),  # full size, heading along the walls
], ids=["default_scene", "full_size_axis_aligned"])
def test_simulated_hall_against_jax_and_truth(scene, limit):
    """The first scans of `simulate_scans_3d` through both packages: the port
    follows the JAX builder within 2 cm / 0.01 rad per scan, so whatever
    error against the ground truth the scene brings out (the offset toward
    the low-resolution cell centers, the lag along a corridor when the
    heading lies along the walls) is the reference's own and not the port's."""
    num = 16
    jopts = apply_overrides(JOptions(), HALL_OPTIONS)
    scans, imu, truth = simulate_scans_3d(num, rings=8, azimuths=128, seed=0, **scene)
    gt = relative_to_first(truth)
    builders = [
        (JBuilder(jopts, ["points"]), JImuData, JScan),
        (LocalTrajectoryBuilder3D(options_3d_from_dict(dataclasses.asdict(jopts)), ["points"],
                                  device="cpu", permutation_fn=_jax_permutation),
         ImuData, TimedPointCloudData)]
    errors = []
    for b, imu_data, cloud in builders:
        est, k = [], 0
        for ts, pts, rel in scans:
            while k < len(imu) and imu[k][0] <= ts:
                b.add_imu_data(imu_data(time=T0 + from_seconds(imu[k][0]),
                                        linear_acceleration=imu[k][1],
                                        angular_velocity=imu[k][2]))
                k += 1
            r = b.add_range_data("points", cloud(
                time=T0 + from_seconds(ts), origin=np.zeros(3, np.float32), ranges=pts,
                times=rel))
            est.append([*r.local_pose_translation,
                        nquat.get_yaw(np.asarray(r.local_pose_rotation, np.float64))])
        est = np.asarray(est)
        # (x, y, z, yaw) off the truth, which stays at z = 0.
        errors.append(np.concatenate([est[:, :2] - gt[:, :2], est[:, 2:3],
                                      est[:, 3:4] - gt[:, 2:3]], 1))
    jerr, terr = errors
    np.testing.assert_allclose(terr[:, :3], jerr[:, :3], atol=0.02, rtol=0)
    np.testing.assert_allclose(terr[:, 3], jerr[:, 3], atol=0.01, rtol=0)
    assert np.abs(jerr[:, 3]).mean() < 0.02 and np.abs(terr[:, 3]).mean() < 0.02
    if limit is not None:
        assert np.linalg.norm(jerr[:, :3], axis=1).mean() < limit
        assert np.linalg.norm(terr[:, :3], axis=1).mean() < limit


def test_straight_line():
    world = make_environment_3d(num=500, seed=1)
    poses = [(np.array([0.04 * i, 0.0, 0.0]), 0.0) for i in range(15)]
    (results,) = _drive([_port_builder()], world, poses)
    assert len(results) == 15 and all(r is not None for r in results)
    err = np.linalg.norm(results[-1].local_pose_translation - np.array([0.04 * 14, 0.0, 0.0]))
    assert err < 0.12, results[-1].local_pose_translation


def test_requires_imu():
    world = make_environment_3d(num=200, seed=2)
    builder, _, _ = _port_builder()
    r = builder.add_range_data("points", TimedPointCloudData(
        time=1_000_000, origin=np.zeros(3, np.float32),
        ranges=scan_at_3d(world, np.zeros(3), 0.0), times=np.zeros(len(world), np.float32)))
    assert r is None  # no IMU yet: 3D cannot start


def test_submap_rotation_and_finish():
    world = make_environment_3d(num=500, seed=3)
    poses = [(np.array([0.04 * i, 0.0, 0.0]), 0.0) for i in range(26)]
    (results,) = _drive([_port_builder()], world, poses)
    inserted = [r for r in results if r.insertion_result is not None]
    finished = [s for r in inserted for s in r.insertion_result.finished_submaps]
    assert len(finished) >= 1
    f = finished[0]
    assert f.insertion_finished and f.high_grid is not None and f.low_grid is not None
    assert f.num_range_data == 24
    assert f.histogram is not None and f.histogram.sum() > 0
    assert f.high_paged.grid.max_pages < 512  # compacted
    assert int(f.high_grid.known.sum()) > 500


def test_max_accel_skip_drops_scans():
    world = make_environment_3d(num=200, seed=4)
    builder, _, _ = _port_builder(max_accel_skip=0.5)
    for k in range(3):
        builder.add_imu_data(ImuData(time=T0 - from_seconds(0.05 * (3 - k)),
                                     linear_acceleration=np.array([0.0, 0.0, 9.81]),
                                     angular_velocity=np.zeros(3)))
    scan = dict(origin=np.zeros(3, np.float32), ranges=scan_at_3d(world, np.zeros(3), 0.0),
                times=np.zeros(len(world), np.float32))
    assert builder.add_range_data("points", TimedPointCloudData(time=T0, **scan)) is not None
    builder.add_imu_data(ImuData(time=T0 + from_seconds(0.05),
                                 linear_acceleration=np.array([5.0, 0.0, 9.81]),
                                 angular_velocity=np.zeros(3)))
    assert builder.add_range_data("points", TimedPointCloudData(
        time=T0 + from_seconds(0.1), **scan)) is None


def test_builder_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalTrajectoryBuilder3D(TrajectoryBuilder3DOptions(), ["points"])


def _flat(d, prefix=""):
    out = {}
    for key, value in d.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out


def test_options_carry_across():
    jopts = _jax_options(**{"ceres_scan_matcher.only_optimize_yaw": True})
    port = _flat(dataclasses.asdict(options_3d_from_dict(dataclasses.asdict(jopts))))
    ref = _flat(dataclasses.asdict(jopts))
    assert port == {key: ref[key] for key in port}
    dropped = tuple(UNPORTED_3D_SWITCHES) + UNREAD_3D_OPTIONS
    for key in set(ref) - set(port):
        assert any(key == p or key.startswith(p + ".") for p in dropped), key
    assert options_3d_from_dict(dataclasses.asdict(JOptions())) == TrajectoryBuilder3DOptions()


@pytest.mark.parametrize("path,value", [
    ("use_online_correlative_scan_matching", True),
    ("use_intensities", True),
    ("pose_extrapolator.use_imu_based", True),
    ("num_accumulated_range_data", 2),
])
def test_unported_options_raise(path, value):
    jopts = apply_overrides(JOptions(), {path: value})
    with pytest.raises(NotImplementedError, match=path):
        options_3d_from_dict(dataclasses.asdict(jopts))
