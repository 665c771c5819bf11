"""The port's MapBuilder (the whole 2D global-SLAM slice, plain path) against
the JAX package's over the loop of tests/test_map_builder.py, with the
background searches off and the JAX package's voxel-filter permutation
injected, and the port's entry points on their own."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from cartographer_tpu.core.config import apply_overrides as j_apply_overrides
from cartographer_tpu.core.time import from_seconds
from cartographer_tpu.mapping.map_builder import MapBuilder as JMapBuilder
from cartographer_tpu.sensor.data import TimedPointCloudData as JScan
from cartographer_tpu_torch.core.config import MapBuilderOptions, apply_overrides
from cartographer_tpu_torch.interop import (
    map_builder_options_from_dict,
    trajectory_builder_options_from_dict,
)
from cartographer_tpu_torch.mapping.id import SubmapId
from cartographer_tpu_torch.mapping.map_builder import MapBuilder
from cartographer_tpu_torch.ops.tsdf_2d import TsdfGrid2D
from cartographer_tpu_torch.sensor.data import LandmarkData, TimedPointCloudData
from test_local_slam_2d import make_wall_points, scan_at
from test_map_builder import build_options, square_loop_poses

REPO = Path(__file__).resolve().parent.parent

# The suite runs several test processes at once; PyTorch's CPU thread pool in
# each would contend for the cores and slow every process many times over.
torch.set_num_threads(1)
T0 = 1_000_000_000


def _jax_permutation(seed, n):
    return np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))


def _record_scores(builder, log):
    """Log (node, submap, score) of every match the constraint builder makes."""
    original = builder._constraints_from_raw

    def wrapped(requests, raw):
        log.extend((r.node_id, r.submap_id, float(row[0]))
                   for r, row in zip(requests, raw) if not r.match_full)
        return original(requests, raw)

    builder._constraints_from_raw = wrapped


def _drive(mb, tid, poses):
    world = make_wall_points(num=400, seed=5)
    for i, (t_xy, yaw) in enumerate(poses):
        scan = scan_at(world, t_xy, yaw)
        mb.add_sensor_data(tid, "laser", (JScan if isinstance(mb, JMapBuilder)
                                          else TimedPointCloudData)(
            time=T0 + from_seconds(i * 0.1), origin=np.zeros(3, np.float32), ranges=scan,
            times=np.zeros(len(scan), np.float32)))
    mb.finish_trajectory(tid)
    mb.pose_graph.run_final_optimization()


def _inter_pairs(pg):
    return {(c.node_id.node_index, c.submap_id.submap_index)
            for c in pg.constraints if c.tag == "INTER_SUBMAP"}


@pytest.fixture(scope="module")
def both():
    jmb_options, jtraj = build_options()
    jmb_options = j_apply_overrides(jmb_options, {"async_constraint_search": False,
                                                  "use_device_mesh": False})
    poses = square_loop_poses()
    jmb = JMapBuilder(jmb_options)
    jlog = []
    _record_scores(jmb.pose_graph._constraint_builder, jlog)
    jtid = jmb.add_trajectory_builder(["laser"], jtraj)
    # The JAX builder draws its voxel-filter permutations from a seed counter;
    # the port gets the same permutations through permutation_fn.
    _drive(jmb, jtid, poses)

    mb = MapBuilder(map_builder_options_from_dict(dataclasses.asdict(jmb_options)), device="cpu")
    log = []
    _record_scores(mb.pose_graph.constraint_builder, log)
    results = []
    tid = mb.add_trajectory_builder(
        ["laser"], trajectory_builder_options_from_dict(dataclasses.asdict(jtraj)),
        local_slam_result_callback=lambda *a: results.append(a),
        permutation_fn=_jax_permutation)
    _drive(mb, tid, poses)
    return jmb, jlog, mb, log, results, poses


def test_graph_matches_jax(both):
    jmb, jlog, mb, log, results, poses = both
    jpg, pg = jmb.pose_graph, mb.pose_graph
    assert len(results) == len(poses)
    assert len(pg.nodes) == len(jpg.nodes) > 30
    assert len(pg.submap_data) == len(jpg.submap_data) >= 3
    assert pg.num_inter_constraints() > 0
    min_score = jmb._options.pose_graph.constraint_builder.min_score
    near = {(n.node_index, s.submap_index) for n, s, score in jlog
            if abs(score - min_score) <= 1e-4}
    assert _inter_pairs(pg) ^ _inter_pairs(jpg) <= near
    scores = {(n, s): score for n, s, score in jlog}
    for n, s, score in log:
        if (n, s) in scores:
            assert abs(score - scores[(n, s)]) <= 1e-3, (n, s)


def test_global_poses_match_jax(both):
    jmb, _, mb, _, _, _ = both
    jposes = jmb.pose_graph.node_global_poses()
    for nid, pose in mb.pose_graph.node_global_poses().items():
        jpose = np.asarray(jposes[(nid.trajectory_id, nid.node_index)]
                           if (nid.trajectory_id, nid.node_index) in jposes
                           else jposes[type(next(iter(jposes)))(*dataclasses.astuple(nid))])
        assert np.abs(pose[:2] - jpose[:2]).max() <= 0.02, nid
        assert abs(pose[2] - jpose[2]) <= 0.01, nid


def test_global_poses_near_truth(both):
    _, _, mb, _, _, poses = both
    errs = [np.linalg.norm(node.global_pose_2d[:2]
                           - poses[round((node.time - T0) / 100_000)][0])
            for _, node in mb.pose_graph.nodes.items()]
    assert np.mean(errs) < 0.12 and np.max(errs) < 0.3


def test_background_searches_build_the_graph():
    jmb_options, jtraj = build_options()
    options = map_builder_options_from_dict(dataclasses.asdict(jmb_options))
    assert options.async_constraint_search
    mb = MapBuilder(options, device="cpu")
    tid = mb.add_trajectory_builder(
        ["laser"], trajectory_builder_options_from_dict(dataclasses.asdict(jtraj)))
    _drive(mb, tid, square_loop_poses()[:40])
    pg = mb.pose_graph
    assert len(pg.nodes) >= 30 and pg.solves >= 2 and pg.num_inter_constraints() > 0


def test_tsdf_map_builder_matches_jax():
    """MapBuilder on TSDF submaps (the pyramid and the loop-closure refine
    read the score surface): the first 48 poses of the loop in both
    packages, searches in the foreground. The same nodes and submaps, the
    same loop closures up to matches within 0.03 of min_score, scores within
    0.03, optimized poses within 2 cm and 0.01 rad. The frontends part by up
    to 3.5 mm over the turns in place (rounding), and a TSDF cell's score
    moves by up to 1 where a sample lands in its neighbour, so the match
    scores part by up to 0.025 where the probability grids' part by 1e-3."""
    jmb_options, jtraj = build_options()
    jmb_options = j_apply_overrides(jmb_options, {"async_constraint_search": False,
                                                  "use_device_mesh": False})
    jtraj = j_apply_overrides(jtraj, {"trajectory_builder_2d.submaps.grid_type": "TSDF"})
    poses = square_loop_poses()[:48]
    jmb = JMapBuilder(jmb_options)
    jlog = []
    _record_scores(jmb.pose_graph._constraint_builder, jlog)
    _drive(jmb, jmb.add_trajectory_builder(["laser"], jtraj), poses)
    mb = MapBuilder(map_builder_options_from_dict(dataclasses.asdict(jmb_options)), device="cpu")
    log = []
    _record_scores(mb.pose_graph.constraint_builder, log)
    tid = mb.add_trajectory_builder(
        ["laser"], trajectory_builder_options_from_dict(dataclasses.asdict(jtraj)),
        permutation_fn=_jax_permutation)
    _drive(mb, tid, poses)
    jpg, pg = jmb.pose_graph, mb.pose_graph
    assert all(isinstance(e.submap.grid, TsdfGrid2D) for _, e in pg.submap_data.items()
               if e.submap.grid is not None)
    assert len(pg.nodes) == len(jpg.nodes) >= 40
    assert len(pg.submap_data) == len(jpg.submap_data) >= 3
    assert pg.num_inter_constraints() > 0
    min_score = jmb._options.pose_graph.constraint_builder.min_score
    near = {(n.node_index, s.submap_index) for n, s, score in jlog
            if abs(score - min_score) <= 0.03}
    assert _inter_pairs(pg) ^ _inter_pairs(jpg) <= near
    scores = {(n.node_index, s.submap_index): score for n, s, score in jlog}
    assert len(log) == len(jlog)
    for n, s, score in log:
        assert abs(score - scores[(n.node_index, s.submap_index)]) <= 0.03, (n, s)
    jposes = jpg.node_global_poses()
    for nid, pose in pg.node_global_poses().items():
        jpose = np.asarray(jposes[type(next(iter(jposes)))(*dataclasses.astuple(nid))])
        assert np.abs(pose[:2] - jpose[:2]).max() <= 0.02, nid
        assert abs(pose[2] - jpose[2]) <= 0.01, nid


def test_second_trajectory_globally_localizes():
    """The twin of tests/test_multi_trajectory.py: robot B starts 1.1 m from
    robot A's start, and full-submap searches against A's map place it."""
    from test_multi_trajectory import build_mb

    jmb, jtraj = build_mb()
    jopts = jmb._options
    mb = MapBuilder(map_builder_options_from_dict(dataclasses.asdict(jopts)), device="cpu")
    traj = trajectory_builder_options_from_dict(dataclasses.asdict(jtraj))
    world = make_wall_points(num=400, seed=11)
    poses_b = [(np.array([1.0, 0.5]) + np.array([0.05 * i, 0.0]), 0.0) for i in range(16)]
    for t0, poses in ((T0, [(np.array([0.05 * i, 0.0]), 0.0) for i in range(16)]),
                      (2 * T0, poses_b)):
        tid = mb.add_trajectory_builder(["laser"], traj)
        for i, (t_xy, yaw) in enumerate(poses):
            scan = scan_at(world, t_xy, yaw)
            mb.add_sensor_data(tid, "laser", TimedPointCloudData(
                time=t0 + from_seconds(i * 0.1), origin=np.zeros(3, np.float32),
                ranges=scan, times=np.zeros(len(scan), np.float32)))
        mb.finish_trajectory(tid)
    pg = mb.pose_graph
    assert pg.num_inter_constraints() > 0 and pg.transitively_connected(0, 1)
    pg.run_final_optimization()
    errs = [np.linalg.norm(node.global_pose_2d[:2]
                           - poses_b[round((node.time - 2 * T0) / 100_000)][0])
            for (tid, _), node in pg.nodes.items() if tid == 1]
    assert errs and float(np.mean(errs)) < 0.15, np.mean(errs)


def test_map_builder_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MapBuilder(MapBuilderOptions(use_trajectory_builder_2d=True))


@pytest.mark.parametrize("override", [
    {"use_trajectory_builder_3d": True, "pose_graph.overlapping_submaps_trimmer_2d": object()},
    {"pose_graph.overlapping_submaps_trimmer_2d": object()},
])
def test_unported_map_builder_options_raise(override):
    options = apply_overrides(MapBuilderOptions(use_trajectory_builder_2d=True), override)
    with pytest.raises(NotImplementedError):
        MapBuilder(options, device="cpu")


def _dispatch_nodes(traj, dispatch, check=None):
    """Two trajectories of `traj` fed 8 scans each through a MapBuilder with
    and without `batch_scan_dispatch`: -> {node id: (local translation,
    rotation)}. `check(mb, tids)` runs after they finish."""
    jmb_options, _ = build_options()
    jmb_options = j_apply_overrides(jmb_options, {"async_constraint_search": False,
                                                  "batch_scan_dispatch": dispatch})
    options = map_builder_options_from_dict(dataclasses.asdict(jmb_options))
    assert options.batch_scan_dispatch == dispatch
    world = make_wall_points(num=400, seed=5)
    mb = MapBuilder(options, device="cpu")
    tids = [mb.add_trajectory_builder(["laser"], traj) for _ in range(2)]
    for i in range(8):
        for tid, start in zip(tids, (np.zeros(2), np.array([0.3, -0.2]))):
            scan = scan_at(world, start + np.array([0.05 * i, 0.0]), 0.0)
            mb.add_sensor_data(tid, "laser", TimedPointCloudData(
                time=T0 + from_seconds(i * 0.1), origin=np.zeros(3, np.float32),
                ranges=scan, times=np.zeros(len(scan), np.float32)))
    for tid in tids:
        mb.finish_trajectory(tid)
    if check is not None:
        check(mb, tids)
    if dispatch:
        assert mb._scan_batcher.num_scans == 16
        mb._scan_batcher.close()
    return {k: (n.local_pose_translation, n.local_pose_rotation)
            for k, n in mb.pose_graph.nodes.items()}


def _same_nodes(nodes):
    assert len(nodes[0]) == 16 and nodes[0].keys() == nodes[1].keys()
    for key, (t, q) in nodes[0].items():
        assert np.array_equal(nodes[1][key][0], t) and np.array_equal(nodes[1][key][1], q)


def test_batch_scan_dispatch_shares_one_batcher():
    """`batch_scan_dispatch` builds one ScanBatcher for the 2D trajectories:
    two trajectories fed through it get the nodes of the same two fed
    through a MapBuilder without it, bit for bit; a trajectory of other 2D
    options (TSDF submaps) raises at its first scan, as in the JAX package
    (one batcher takes one step configuration)."""
    _, jtraj = build_options()
    traj = trajectory_builder_options_from_dict(dataclasses.asdict(jtraj))

    def check(mb, tids):
        locals_ = [mb.get_trajectory_builder(t)._local for t in tids]
        assert locals_[0]._batcher is locals_[1]._batcher is mb._scan_batcher
        other = mb.add_trajectory_builder(["laser"], dataclasses.replace(
            traj, trajectory_builder_2d=apply_overrides(
                traj.trajectory_builder_2d, {"submaps.grid_type": "TSDF"})))
        scan = scan_at(make_wall_points(num=400, seed=5), np.zeros(2), 0.0)
        with pytest.raises(ValueError, match="different step options"):
            for i in range(2):
                mb.add_sensor_data(other, "laser", TimedPointCloudData(
                    time=T0 + from_seconds(1.0 + i * 0.1), origin=np.zeros(3, np.float32),
                    ranges=scan, times=np.zeros(len(scan), np.float32)))
            mb.finish_trajectory(other)

    _same_nodes([_dispatch_nodes(traj, False), _dispatch_nodes(traj, True, check)])


def test_batch_scan_dispatch_tsdf():
    """Two TSDF trajectories under `batch_scan_dispatch` (K20 and K21 with a
    robot index) get the nodes of the same two without it, bit for bit."""
    _, jtraj = build_options()
    traj = trajectory_builder_options_from_dict(dataclasses.asdict(jtraj))
    traj = dataclasses.replace(traj, trajectory_builder_2d=apply_overrides(
        traj.trajectory_builder_2d, {"submaps.grid_type": "TSDF"}))
    _same_nodes([_dispatch_nodes(traj, False), _dispatch_nodes(traj, True)])


def test_unported_entry_points_raise(tmp_path):
    """A mesh and landmark observations still raise; serialize_state and
    load_state, which raised until state interchange was ported, now run
    (an empty map round-trips)."""
    mb = MapBuilder(MapBuilderOptions(use_trajectory_builder_2d=True), device="cpu")
    with pytest.raises(NotImplementedError):
        MapBuilder(MapBuilderOptions(use_trajectory_builder_2d=True), device="cpu",
                   mesh=object())
    path = str(tmp_path / "empty.pbstream")
    mb.serialize_state(path)
    assert MapBuilder(MapBuilderOptions(use_trajectory_builder_2d=True),
                      device="cpu").load_state(path) == {}
    _, jtraj = build_options()
    tid = mb.add_trajectory_builder(
        ["laser", "landmarks"], trajectory_builder_options_from_dict(dataclasses.asdict(jtraj)))
    with pytest.raises(NotImplementedError):
        mb.add_sensor_data(tid, "landmarks", LandmarkData(time=T0, landmark_observations=[]))
        mb.add_sensor_data(tid, "laser", TimedPointCloudData(
            time=T0 + 1, origin=np.zeros(3, np.float32), ranges=np.zeros((1, 3), np.float32),
            times=np.zeros(1, np.float32)))


def test_map_builder_imports_no_jax():
    code = ("import sys, cartographer_tpu_torch.mapping.map_builder\n"
            "print([m for m in sys.modules if m.split('.')[0] in ('jax', 'cartographer_tpu')])\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("fmt", ["native", "carto"])
def test_saved_maps_cross_packages(both, fmt, tmp_path):
    """The loop's map saved by either package loads in the other: JAX's
    stream gives the port the state JAX's own load gives it, and the port's
    stream gives JAX the port's state (poses and constraints exact, grids
    equal to their quantization, clouds within the 1 mm compression)."""
    from test_torch_serialization import _assert_same_graph

    jmb, _, mb, _, _, _ = both
    jpath, ppath = str(tmp_path / "jax.pbstream"), str(tmp_path / "port.pbstream")
    jmb.serialize_state(jpath, format=fmt)
    mb.serialize_state(ppath, format=fmt)
    port_from_jax = MapBuilder(mb._options, device="cpu")
    jax_own = JMapBuilder(jmb._options)
    assert port_from_jax.load_state(jpath) == jax_own.load_state(jpath) == {0: 0}
    _assert_same_graph(jax_own.pose_graph, port_from_jax.pose_graph, 2)
    jax_from_port = JMapBuilder(jmb._options)
    jax_from_port.load_state(ppath, load_frozen_state=False)
    jpg, pg = jax_from_port.pose_graph, mb.pose_graph
    assert len(jpg.nodes) == len(pg.nodes) and len(jpg.constraints) == len(pg.constraints)
    jposes = jpg.node_global_poses()
    for nid, pose in pg.node_global_poses().items():
        jpose = np.asarray(jposes[type(next(iter(jposes)))(*dataclasses.astuple(nid))])
        if fmt == "native":
            np.testing.assert_array_equal(jpose, pose)
        else:  # the reference schema carries the yaw as a quaternion
            np.testing.assert_allclose(jpose, pose, rtol=0, atol=1e-12)
    for (key, e), (_, je) in zip(pg.submap_data.items(), jpg.submap_data.items()):
        if e.submap.grid is None:
            continue
        known = e.submap.grid.known.numpy()
        np.testing.assert_array_equal(np.asarray(je.submap.grid.known), known)
        lo = e.submap.grid.log_odds.numpy()
        tol = 1e-2 if fmt == "native" else 1e-3 * np.abs(lo).max() + 2e-4
        np.testing.assert_allclose(np.asarray(je.submap.grid.log_odds)[known], lo[known],
                                   atol=tol)
    for (key, n), (_, jn) in zip(pg.nodes.items(), jpg.nodes.items()):
        got = np.asarray(jn.filtered_points)
        want = n.filtered_points
        if fmt == "carto":  # the reference's compression reorders by block
            got, want = got[np.lexsort(got.T)], want[np.lexsort(np.round(want * 1000).T)]
        np.testing.assert_allclose(got, want, atol=1e-3)


def test_new_trajectory_against_a_frozen_map(both, tmp_path):
    """A map loaded frozen: the next trajectory takes id 1 in both packages,
    and its scans and solves leave every frozen pose where it was."""
    jmb, _, mb, _, _, poses = both
    path = str(tmp_path / "map.pbstream")
    jmb.serialize_state(path)
    jax_side = JMapBuilder(jmb._options)
    jax_side.load_state(path)
    port = MapBuilder(mb._options, device="cpu")
    port.load_state(path)
    frozen_nodes = {k: v.copy() for k, v in port.pose_graph.node_global_poses().items()}
    frozen_submaps = {k: e.global_pose_2d.copy() for k, e in port.pose_graph.submap_data.items()}
    _, jtraj = build_options()
    traj = trajectory_builder_options_from_dict(dataclasses.asdict(jtraj))
    assert (port.add_trajectory_builder(["laser"], traj)
            == jax_side.add_trajectory_builder(["laser"], jtraj) == 1)
    world = make_wall_points(num=400, seed=5)
    for i, (t_xy, yaw) in enumerate(poses[:24]):
        scan = scan_at(world, t_xy, yaw)
        port.add_sensor_data(1, "laser", TimedPointCloudData(
            time=T0 + from_seconds(100.0 + i * 0.1), origin=np.zeros(3, np.float32),
            ranges=scan, times=np.zeros(len(scan), np.float32)))
    port.finish_trajectory(1)
    port.pose_graph.run_final_optimization()
    pg = port.pose_graph
    assert pg.solves >= 2 and pg.nodes.size_of_trajectory(1) > 10
    assert pg.trajectory_states == {0: "FROZEN", 1: "FINISHED"}
    for nid, pose in frozen_nodes.items():
        np.testing.assert_array_equal(pg.node_global_poses()[nid], pose)
    for key, pose in frozen_submaps.items():
        np.testing.assert_array_equal(pg.submap_data[SubmapId(*key)].global_pose_2d, pose)
