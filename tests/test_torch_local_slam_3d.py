"""The port's LocalTrajectoryBuilder3D (the whole 3D frontend slice, plain
path) against the JAX package's, scan by scan, and alone: the twin of
tests/test_local_slam_3d.py::TestLocalSlam3D."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cartographer_tpu.core.config import TrajectoryBuilder3DOptions as JOptions, apply_overrides
from cartographer_tpu.mapping.local_trajectory_builder_3d import (
    LocalTrajectoryBuilder3D as JBuilder,
)
from cartographer_tpu.ops.rot_histogram import (
    compute_rotational_histogram as j_histogram,
    rotate_histogram as j_rotate,
)
from cartographer_tpu.sensor.data import ImuData as JImuData, TimedPointCloudData as JScan
from cartographer_tpu_torch.core.config import TrajectoryBuilder3DOptions
from cartographer_tpu_torch.core.time import from_seconds
from cartographer_tpu_torch.interop import (
    UNPORTED_3D_SWITCHES,
    UNREAD_3D_OPTIONS,
    options_3d_from_dict,
    paged_grid_from_numpy,
    paged_intensity_grid_from_numpy,
)
from cartographer_tpu_torch.mapping.local_trajectory_builder_3d import (
    LocalTrajectoryBuilder3D,
    check_kernel_limits,
)
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


def _levelled_histogram(ir, jopts):
    """The JAX histogram of a JAX insertion's high-resolution cloud levelled
    by its gravity alignment without the yaw."""
    g = np.asarray(ir.gravity_alignment, np.float64)
    level = nquat.multiply(nquat.from_yaw(-nquat.get_yaw(g)), g)
    cloud = np.stack([nquat.rotate(level, p) for p in ir.high_res_cloud]).astype(np.float32)
    return np.asarray(j_histogram(jnp.asarray(cloud), jnp.ones(len(cloud), bool),
                                  jopts.rotational_histogram_size))


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
                                       _levelled_histogram(rj.insertion_result, jopts).sum(),
                                       rtol=0.05)
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
    # The submap histogram adds each scan's histogram of its cloud levelled
    # without the IMU's yaw, rotated by the scan's yaw (the reference's
    # submap_3d.cc InsertData; the JAX builder rotates the gravity-frame
    # histogram, which counts the IMU yaw twice): rebuilt from the JAX
    # builder's insertions with the JAX functions.
    expected = np.zeros_like(np.asarray(jf.histogram))
    inserted = [r.insertion_result for r in jres if r.insertion_result is not None]
    for ir in inserted[:2 * _jax_options().submaps.num_range_data]:
        expected += np.asarray(j_rotate(jnp.asarray(_levelled_histogram(ir, jopts)), jnp.float32(
            nquat.get_yaw(ir.local_pose_rotation))))
    np.testing.assert_allclose(tf.histogram, expected, atol=0.05 * expected.max())
    assert tb.device_fetches == 26


def test_scan_histogram_departs_from_jax_by_the_imu_yaw():
    """The port's one departure from the JAX builder: its scan histogram is
    of the cloud levelled without the IMU tracker's yaw. At a turning yaw
    rate it is the JAX histogram of the JAX insertion's cloud levelled so,
    and it matches the JAX builder's gravity-frame histogram rotated by
    -yaw(gravity_alignment), up to the rotation's linear interpolation
    (which blurs the few-point histograms of this scene), far better than
    that histogram itself."""
    jopts = _jax_options()
    jb = JBuilder(jopts, ["points"])
    tb = LocalTrajectoryBuilder3D(options_3d_from_dict(dataclasses.asdict(jopts)), ["points"],
                                  device="cpu", permutation_fn=_jax_permutation)
    world = make_environment_3d(num=500, seed=3)
    poses = [(np.array([0.03 * i, 0.0, 0.0]), 0.03 * i) for i in range(20)]
    jres, tres = _drive([(jb, JImuData, JScan), (tb, ImuData, TimedPointCloudData)], world,
                        poses)

    def cosine(a, b):
        return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-9))

    rotated, unrotated = [], []
    for rj, rt in zip(jres, tres):
        if rj.insertion_result is None:
            continue
        jir, tir = rj.insertion_result, rt.insertion_result
        exact = _levelled_histogram(jir, jopts)
        np.testing.assert_allclose(tir.scan_histogram, exact, atol=1e-4 * exact.max(), rtol=0)
        yaw = nquat.get_yaw(np.asarray(jir.gravity_alignment, np.float64))
        if abs(yaw) > 0.05:  # about two bins (1.5 degrees each) or more
            levelled = np.asarray(j_rotate(jnp.asarray(jir.scan_histogram, jnp.float32),
                                           jnp.float32(-yaw)))
            rotated.append(cosine(tir.scan_histogram, levelled))
            unrotated.append(cosine(tir.scan_histogram, jir.scan_histogram))
    assert len(rotated) >= 15
    assert min(rotated) > 0.6 and np.mean(rotated) > 0.75, rotated
    assert all(r > u for r, u in zip(rotated, unrotated)) and np.mean(unrotated) < 0.15


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
    ("num_accumulated_range_data", 2),
])
def test_unported_options_raise(path, value):
    jopts = apply_overrides(JOptions(), {path: value})
    with pytest.raises(NotImplementedError, match=path):
        options_3d_from_dict(dataclasses.asdict(jopts))


# The whole frontend: the correlative search before the LM, the intensity
# rows and pools. A max_range of 20 m (the hall is 18 m long) keeps the
# correlative search's static rotation grid at 7^3 (21^3 at 60 m), which the
# JAX package scores in full.
FULL_FRONTEND = {"use_online_correlative_scan_matching": True, "use_intensities": True,
                 "max_range": 20.0}


def _pool_difference(jax_submap, submap, sync=False) -> float:
    """The largest share of the cells (known, or with an intensity) in which
    the port submap's three page pools differ from the JAX submap's; with
    `sync`, the port's pools are then set to the JAX ones."""
    shares = []
    for name in ("high_paged", "low_paged", "intensity_paged"):
        jp, port = getattr(jax_submap, name), getattr(submap, name)
        g = jp.grid
        if name == "intensity_paged":
            ref, got = np.asarray(g.counts), port.grid.counts.numpy()
            if sync:
                setattr(submap, name, paged_intensity_grid_from_numpy(
                    np.asarray(g.sums), ref, np.asarray(g.page_table), np.asarray(g.origin),
                    g.resolution, g.page_size, jp._slots, "cpu"))
        else:
            ref, got = np.asarray(g.known), port.grid.known.numpy()
            if sync:
                setattr(submap, name, paged_grid_from_numpy(
                    np.asarray(g.pages), ref, np.asarray(g.page_table), np.asarray(g.origin),
                    g.resolution, g.page_size, jp._slots, "cpu"))
        if got.shape == ref.shape:
            shares.append(float((got != ref).sum() / max((ref != 0).sum(), 1)))
        else:
            shares.append(1.0)
    return max(shares)


def _drive_both(jopts, num, sync):
    """The first `num` scans of the half-scale hall with intensities through
    the JAX builder and the port's plain path, one scan to each in turn.
    Returns both packages' poses [x, y, z, yaw], the ground truth, the
    largest pool difference of each scan (before any syncing) and the port
    builder."""
    scans, imu, truth = simulate_scans_3d(num, rings=8, azimuths=128, seed=0, intensities=True)
    jb = JBuilder(jopts, ["points"])
    tb = LocalTrajectoryBuilder3D(options_3d_from_dict(dataclasses.asdict(jopts)), ["points"],
                                  device="cpu", permutation_fn=_jax_permutation)
    est, k, shares = [], 0, []
    for ts, pts, rel, intens in scans:
        for b, imu_data, cloud in ((jb, JImuData, JScan), (tb, ImuData, TimedPointCloudData)):
            for t, accel, gyro in [m for m in imu[k:] if m[0] <= ts]:
                b.add_imu_data(imu_data(time=T0 + from_seconds(t), linear_acceleration=accel,
                                        angular_velocity=gyro))
            r = b.add_range_data("points", cloud(
                time=T0 + from_seconds(ts), origin=np.zeros(3, np.float32), ranges=pts,
                times=rel, intensities=intens))
            est.append([*r.local_pose_translation,
                        nquat.get_yaw(np.asarray(r.local_pose_rotation, np.float64))])
        k += sum(1 for m in imu[k:] if m[0] <= ts)
        shares.append(max(_pool_difference(js, ts_, sync) for js, ts_ in zip(
            jb._active_submaps.submaps, tb._active_submaps.submaps)))
    return (np.asarray(est[0::2]), np.asarray(est[1::2]), relative_to_first(truth), shares,
            tb)


@pytest.mark.parametrize("extrapolator", ["constant_velocity", "imu_based"])
def test_hall_with_the_full_frontend_against_jax(extrapolator):
    """The first 16 scans of the half-scale hall with intensities through
    both packages, with the correlative search and the intensity term on,
    and with the IMU-based extrapolator (a 1 s queue) and the intensity
    term: each scan within 2 cm and 0.01 rad of the JAX builder's.

    After each scan the port's page pools (occupancy and intensity) are
    set to the JAX builder's, once they have been checked to differ in at
    most a few cells while the two poses agree: the JAX inserts may
    multiply by the reciprocal of the resolution where the port divides,
    and a return on a cell border then lands in the neighbouring cell. One
    such cell's running average moves the intensity rows, and the
    correlative search, which picks among candidates a step apart (0.1 m,
    about 0.0074 rad here), makes the difference a jump: without the
    syncing the two builders part by up to 5 cm within these 16 scans.
    Even from the same pools, two candidates that score within float noise
    of each other may go either way; the IMU-based extrapolator's queue
    solve carries the last digits of every pose into the next prediction,
    and with the search on the two builders then part by a candidate step
    within these scans, so that case runs without the search (the test
    below runs the search with that extrapolator, at cells whose size is a
    power of two and without syncing).

    Against the truth only the position is limited: at this width (8
    rings) the search picks rotations from a sparse window and the LM's
    rotation penalty holds the pose there, so the yaw falls behind the
    turning robot in both packages (by up to 0.07 rad over these scans)."""
    extra = ({"pose_extrapolator.use_imu_based": True,
              "pose_extrapolator.imu_based.pose_queue_duration": 1.0,
              "use_online_correlative_scan_matching": False}
             if extrapolator == "imu_based" else {})
    jopts = apply_overrides(JOptions(), {**HALL_OPTIONS, **FULL_FRONTEND, **extra})
    jest, test, gt, shares, tb = _drive_both(jopts, 16, sync=True)
    np.testing.assert_allclose(test[:, :3], jest[:, :3], atol=0.02, rtol=0)
    np.testing.assert_allclose(test[:, 3], jest[:, 3], atol=0.01, rtol=0)
    # The pools are compared where the same scan was inserted at the same pose.
    changed = [s for s, j, t in zip(shares, jest, test) if np.abs(j[:3] - t[:3]).max() < 1e-4]
    assert len(changed) >= 8 and max(changed) < 0.01, changed
    assert tb._active_submaps.submaps[0].intensity_paged.num_allocated > 50
    for e in (jest, test):
        assert np.linalg.norm(e[:, :2] - gt[:16, :2], axis=1).mean() < 0.25


# Cells of 0.125 m and 0.5 m: a division by a power of two is the
# multiplication by its reciprocal, so XLA's rewrite moves no return.
POWER_OF_TWO_CELLS = {"submaps.high_resolution": 0.125, "submaps.low_resolution": 0.5}


@pytest.mark.parametrize("extrapolator", ["constant_velocity", "imu_based"])
def test_hall_with_the_full_frontend_against_jax_unsynced(extrapolator):
    """The slice as a user sets it, correlative search, intensity term and
    (in the second case) the IMU-based extrapolator at once, through both
    packages over the first 16 scans of the half-scale hall, each package
    inserting into its own pools: every scan within 2 cm and 0.01 rad of
    the JAX builder's, and the pools equal cell for cell after every scan
    while the poses agree (the first 8 scans at least). The cells are powers of two in size, so that the
    JAX inserts and voxel keys, which may multiply by the reciprocal of
    the resolution, put every return in the cell the port's division
    gives it (at 0.10 m the test above syncs the pools instead)."""
    extra = ({"pose_extrapolator.use_imu_based": True,
              "pose_extrapolator.imu_based.pose_queue_duration": 1.0}
             if extrapolator == "imu_based" else {})
    jopts = apply_overrides(JOptions(), {**HALL_OPTIONS, **FULL_FRONTEND,
                                         **POWER_OF_TWO_CELLS, **extra})
    jest, test, gt, shares, tb = _drive_both(jopts, 16, sync=False)
    np.testing.assert_allclose(test[:, :3], jest[:, :3], atol=0.02, rtol=0)
    np.testing.assert_allclose(test[:, 3], jest[:, 3], atol=0.01, rtol=0)
    # While the poses agree to the micrometre the pools stay the same cell
    # for cell; after a near-tie of the search or the LM has moved a pose by
    # a millimetre, returns near cell borders go to other cells.
    agree = np.abs(test[:, :3] - jest[:, :3]).max(1) < 1e-5
    same = len(agree) if agree.all() else int(np.argmin(agree))
    assert same >= 8 and max(shares[:same]) == 0.0, (same, shares)
    assert tb._active_submaps.submaps[0].intensity_paged.num_allocated > 20
    for e in (jest, test):
        assert np.linalg.norm(e[:, :2] - gt[:16, :2], axis=1).mean() < 0.25


def test_straight_line_with_the_imu_based_extrapolator():
    """The JAX package's test_local_slam_3d_with_imu_based_extrapolator on
    the port."""
    world = make_environment_3d(num=500, seed=1)
    poses = [(np.array([0.04 * i, 0.0, 0.0]), 0.0) for i in range(12)]
    (results,) = _drive([_port_builder(**{
        "pose_extrapolator.use_imu_based": True,
        "pose_extrapolator.imu_based.pose_queue_duration": 1.0})], world, poses)
    assert len(results) >= 11 and all(r is not None for r in results)
    np.testing.assert_allclose(results[-1].local_pose_translation, [0.04 * 11, 0.0, 0.0],
                               atol=0.15)


def test_full_frontend_options_round_trip():
    """options_3d_from_dict carries the three switches and the options they
    read, at values other than the defaults."""
    jopts = _jax_options(**{
        "use_online_correlative_scan_matching": True, "use_intensities": True,
        "pose_extrapolator.use_imu_based": True,
        "real_time_correlative_scan_matcher.linear_search_window": 0.25,
        "real_time_correlative_scan_matcher.angular_search_window": 0.03,
        "real_time_correlative_scan_matcher.rotation_delta_cost_weight": 0.2,
        "ceres_scan_matcher.intensity_cost_function_options_0.weight": 0.7,
        "ceres_scan_matcher.intensity_cost_function_options_0.huber_scale": 0.4,
        "submaps.range_data_inserter.intensity_threshold": 35.0,
        "pose_extrapolator.imu_based.pose_queue_duration": 2.0,
        "pose_extrapolator.imu_based.imu_rotation_weight": 3.0})
    port = options_3d_from_dict(dataclasses.asdict(jopts))
    flat = _flat(dataclasses.asdict(port))
    ref = _flat(dataclasses.asdict(jopts))
    assert flat == {key: ref[key] for key in flat}
    assert set(ref) - set(flat) == {"num_accumulated_range_data", *UNREAD_3D_OPTIONS}
    assert port.use_intensities and port.pose_extrapolator.use_imu_based
    assert port.real_time_correlative_scan_matcher.linear_search_window == 0.25
    builder = LocalTrajectoryBuilder3D(port, ["points"], device="cpu")
    assert builder._gn_params.intensity_weight == 0.7
    # The JAX builder leaves the matcher's Huber scale and threshold at their
    # defaults; so does the port.
    assert (builder._gn_params.intensity_huber_scale,
            builder._gn_params.intensity_threshold) == (0.3, 40.0)


@pytest.mark.parametrize("override,option", [
    ({"tpu.filtered_capacity_high": 2048}, "tpu.filtered_capacity_high"),
    ({"rotational_histogram_size": 2048}, "rotational_histogram_size"),
])
def test_kernel_limits_refused_at_construction(override, option):
    """A capacity above a one-block kernel's limit (K12's 1,024 points or
    bins) raises on a CUDA device before any scan, naming the option; the
    plain path takes it. A scan capacity above K2's and K18's one-block
    sizes is not refused."""
    from cartographer_tpu_torch.core.config import apply_overrides as port_overrides

    options = port_overrides(TrajectoryBuilder3DOptions(), override)
    with pytest.raises(ValueError, match=option):
        LocalTrajectoryBuilder3D(options, ["points"], device="cuda")
    LocalTrajectoryBuilder3D(options, ["points"], device="cpu")
    check_kernel_limits(port_overrides(TrajectoryBuilder3DOptions(),
                                       {"tpu.scan_capacity": 32768}))
