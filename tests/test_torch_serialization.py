"""State interchange between the port and the JAX package, on the CPU.

The same synthetic states (the shapes of tests/test_serialization.py's
`make_pose_graph` and test_serialization_3d.py's `make_pose_graph_3d`, with
random grids, a 3D intensity grid, landmark poses and learned trajectory
data) are built in both packages from one seed. Their native and
reference-schema streams hold the same records byte for byte (the gzip
framing carries a timestamp, so the records are compared, not the files),
and a stream written by either package loads in the other: poses,
constraints and trajectory data exactly, grids equal after the format's
quantization (float16 log-odds natively, the uint16 probability in the
reference schema), clouds within the 1 mm compression. Also: the port's
MessagePack codec against `msgpack`, frozen loads and remapping, the v1
migration and the pbstream CLI."""

import dataclasses
import io as pyio
import struct

import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from cartographer_tpu.core.config import MapBuilderOptions as JMapBuilderOptions
from cartographer_tpu.core.config import PoseGraphOptions as JPoseGraphOptions
from cartographer_tpu.io import carto_pbstream as jcarto
from cartographer_tpu.io import pbstream_main as jcli
from cartographer_tpu.io import serialization as jser
from cartographer_tpu.io.pbstream import ProtoStreamReader as JReader
from cartographer_tpu.io.pbstream import ProtoStreamWriter as JWriter
from cartographer_tpu.mapping import pose_graph_2d as jpg2
from cartographer_tpu.mapping import pose_graph_3d as jpg3
from cartographer_tpu.mapping.constraint_builder_2d import Constraint as JConstraint
from cartographer_tpu.mapping.id import NodeId as JNodeId
from cartographer_tpu.mapping.id import SubmapId as JSubmapId
from cartographer_tpu.mapping.map_builder import MapBuilder as JMapBuilder
from cartographer_tpu.mapping.submap_2d import Submap2D as JSubmap2D
from cartographer_tpu.mapping.submap_3d import Submap3D as JSubmap3D
from cartographer_tpu.ops.grid_2d import Grid2D as JGrid2D
from cartographer_tpu.ops.grid_3d import Grid3D as JGrid3D
from cartographer_tpu.ops.grid_3d import IntensityGrid3D as JIntensityGrid3D
from cartographer_tpu_torch.core.config import MapBuilderOptions, PoseGraphOptions
from cartographer_tpu_torch.io import carto_pbstream, pbstream_main, serialization
from cartographer_tpu_torch.io.msgpack_wire import packb, unpackb
from cartographer_tpu_torch.io.pbstream import ProtoStreamReader, ProtoStreamWriter
from cartographer_tpu_torch.mapping import pose_graph_2d, pose_graph_3d
from cartographer_tpu_torch.mapping.constraint_builder_2d import Constraint
from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
from cartographer_tpu_torch.mapping.map_builder import MapBuilder
from cartographer_tpu_torch.mapping.submap_2d import Submap2D
from cartographer_tpu_torch.mapping.submap_3d import Submap3D
from cartographer_tpu_torch.ops.grid_2d import Grid2D
from cartographer_tpu_torch.ops.grid_3d import Grid3D, IntensityGrid3D
from test_v1_migration import _write_v1_twin

torch.set_num_threads(1)


# ---------------------------------------------------------------- the codec


_leaves = (st.none() | st.booleans() | st.floats(allow_nan=False)
           | st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1)
           | st.text(max_size=300) | st.binary(max_size=300))
_objects = st.recursive(_leaves, lambda inner: st.lists(inner, max_size=20)
                        | st.dictionaries(st.text(max_size=8), inner, max_size=20),
                        max_leaves=60)


@settings(max_examples=300, deadline=None)
@given(_objects)
def test_codec_bytes_equal_msgpack(obj):
    raw = msgpack.packb(obj, use_bin_type=True)
    assert packb(obj) == raw
    assert unpackb(raw) == msgpack.unpackb(raw, raw=False)


@pytest.mark.parametrize("kind", ["int", "str", "bin", "array", "map"])
def test_codec_width_boundaries(kind):
    """Every length and integer format boundary, both sides."""
    if kind == "int":
        edges = [0, 2 ** 7, 2 ** 8, 2 ** 16, 2 ** 32, 2 ** 64]
        values = [v + d for v in edges for d in (-1, 0) if 0 <= v + d < 2 ** 64]
        values += [-v + d for v in (32, 2 ** 7, 2 ** 15, 2 ** 31, 2 ** 63) for d in (0, 1, -1)
                   if -v + d >= -2 ** 63]
    else:
        sizes = [0, 15, 16, 31, 32, 255, 256, 65535, 65536]
        make = {"str": lambda n: "é" * (n // 2) + "a" * (n % 2),
                "bin": lambda n: bytes(n), "array": lambda n: list(range(n)),
                "map": lambda n: {str(i): i for i in range(n)}}[kind]
        values = [make(n) for n in sizes]
    for v in values:
        raw = msgpack.packb(v, use_bin_type=True)
        assert packb(v) == raw, v if kind == "int" else len(v)
        assert unpackb(raw) == v


def test_codec_reads_float32_and_refuses_numpy_scalars():
    assert unpackb(b"\xca" + struct.pack(">f", 1.25)) == 1.25
    raw = msgpack.packb({"a": [np.float64(2.5)]}, use_bin_type=True)
    assert unpackb(raw) == {"a": [2.5]}
    for value in (np.float32(1.0), np.int64(3), np.bool_(True)):
        with pytest.raises(TypeError):
            msgpack.packb(value, use_bin_type=True)
        with pytest.raises(TypeError):
            packb(value)


# ---------------------------------------------------------------- states


def _arrays_2d(seed=0):
    rng = np.random.RandomState(seed)
    return dict(
        log_odds=rng.uniform(-3, 3, (32, 32)).astype(np.float32),
        known=rng.rand(32, 32) < 0.6,
        origin=np.float32([-0.8, -0.8]),
        cloud=rng.uniform(-5, 5, (50, 2)),
        cloud2=rng.uniform(-5, 5, (40, 2)))


def make_states_2d(seed=0):
    """(JAX PoseGraph2D, port PoseGraph2D) holding the same state: two
    submaps with grids (the second unfinished), two nodes, INTRA and INTER
    constraints, a landmark pose and a fixed-frame origin."""
    a = _arrays_2d(seed)
    graphs = []
    for jax_side in (True, False):
        if jax_side:
            pg = jpg2.PoseGraph2D(JPoseGraphOptions())
            G, S2, E, N, C, Sid, Nid = (JGrid2D, JSubmap2D, jpg2.SubmapDataEntry,
                                        jpg2.TrajectoryNode, JConstraint, JSubmapId, JNodeId)
            arr = jnp.asarray
        else:
            pg = pose_graph_2d.PoseGraph2D(PoseGraphOptions(), device="cpu")
            G, S2, E, N, C, Sid, Nid = (Grid2D, Submap2D, pose_graph_2d.SubmapDataEntry,
                                        pose_graph_2d.TrajectoryNode, Constraint, SubmapId,
                                        NodeId)
            arr = torch.from_numpy
        for k, finished in enumerate((True, False)):
            grid = G(log_odds=arr(a["log_odds"] * (1 + k)), known=arr(a["known"]),
                     origin=arr(a["origin"] + k), resolution=0.05)
            submap = S2(local_pose_translation=np.array([1.0 + k, 2.0, 0.0]),
                        local_pose_rotation=np.array([1.0, 0, 0, 0]),
                        num_range_data=20, insertion_finished=finished, grid=grid)
            pg.submap_data.insert(Sid(0, k), E(
                submap=submap, global_pose_2d=np.array([1.0 + k, 2.0, 0.1]), finished=finished))
        for k, cloud in enumerate((a["cloud"], a["cloud2"])):
            pg.nodes.insert(Nid(0, k), N(
                time=123456789 + k, gravity_alignment=np.array([1.0, 0, 0, 0]),
                filtered_points=cloud, local_pose_translation=np.array([1.5, 2.0 + k, 0.0]),
                local_pose_rotation=np.array([np.cos(0.1 * k), 0, 0, np.sin(0.1 * k)]),
                global_pose_2d=np.array([1.5, 2.0 + k, 0.05 + 0.2 * k])))
        for sk, nk, tag in ((0, 0, "INTRA_SUBMAP"), (1, 1, "INTRA_SUBMAP"),
                            (0, 1, "INTER_SUBMAP")):
            pg.constraints.append(C(
                submap_id=Sid(0, sk), node_id=Nid(0, nk), rel=np.array([0.5, 0.1 * nk, -0.05]),
                translation_weight=500.0, rotation_weight=1600.0, tag=tag))
        pg.landmark_poses["lm0"] = np.array([1.0, 2.0, 0.3])
        pg._frozen_landmarks.add("lm0")
        pg.fixed_frame_origin[0] = np.array([0.1, 0.2, 0.03])
        graphs.append(pg)
    return graphs


def _arrays_3d(seed=1):
    rng = np.random.RandomState(seed)
    sums = np.zeros((16, 16, 16), np.float32)
    counts = np.zeros((16, 16, 16), np.float32)
    cells = rng.choice(16 ** 3, 200, replace=False)
    counts.reshape(-1)[cells] = rng.randint(1, 9, 200)
    sums.reshape(-1)[cells] = rng.uniform(0, 40, 200).astype(np.float32)
    return dict(
        high=(rng.uniform(-3, 3, (16, 16, 16)).astype(np.float32), rng.rand(16, 16, 16) < 0.4),
        low=(rng.uniform(-3, 3, (8, 8, 8)).astype(np.float32), rng.rand(8, 8, 8) < 0.7),
        sums=sums, counts=counts, hist=rng.uniform(0, 5, 12).astype(np.float32),
        high_cloud=rng.uniform(-3, 3, (30, 3)), low_cloud=rng.uniform(-3, 3, (50, 3)))


def make_states_3d(seed=1):
    """(JAX PoseGraph3D, port PoseGraph3D) holding the same state: a
    finished submap with dense grids, a histogram and an intensity grid, a
    node, a constraint, landmark poses and learned trajectory data."""
    a = _arrays_3d(seed)
    q_node = np.array([np.cos(0.35), 0, 0, np.sin(0.35)])
    graphs = []
    for jax_side in (True, False):
        if jax_side:
            pg = jpg3.PoseGraph3D(JPoseGraphOptions())
            G, IG, S3, E, N, C, Sid, Nid = (JGrid3D, JIntensityGrid3D, JSubmap3D,
                                            jpg3.SubmapDataEntry3D, jpg3.TrajectoryNode3D,
                                            jpg3.Constraint3D, JSubmapId, JNodeId)
            arr = jnp.asarray
        else:
            pg = pose_graph_3d.PoseGraph3D(PoseGraphOptions(), device="cpu")
            G, IG, S3, E, N, C, Sid, Nid = (Grid3D, IntensityGrid3D, Submap3D,
                                            pose_graph_3d.SubmapDataEntry3D,
                                            pose_graph_3d.TrajectoryNode3D,
                                            pose_graph_3d.Constraint3D, SubmapId, NodeId)
            arr = torch.from_numpy
        high = G(log_odds=arr(a["high"][0]), known=arr(a["high"][1]),
                 origin=arr(np.float32([-1.6, -1.6, -1.6])), resolution=0.2)
        low = G(log_odds=arr(a["low"][0]), known=arr(a["low"][1]),
                origin=arr(np.float32([-2.4, -2.4, -2.4])), resolution=0.6)
        submap = S3(local_pose_translation=np.array([1.0, 2.0, 0.0]),
                    local_pose_rotation=np.array([1.0, 0, 0, 0]), num_range_data=10,
                    insertion_finished=True, high_grid=high, low_grid=low,
                    histogram=a["hist"].copy())
        submap.intensity_grid = IG(sums=arr(a["sums"]), counts=arr(a["counts"]),
                                   origin=arr(np.float32([-1.6, -1.6, -1.6])), resolution=0.2)
        pg.submap_data.insert(Sid(0, 0), E(submap=submap, global_t=np.array([1.0, 2.0, 0.0]),
                                           global_q=np.array([1.0, 0, 0, 0]), finished=True))
        pg.nodes.insert(Nid(0, 0), N(
            time=42, gravity_alignment=np.array([1.0, 0, 0, 0]),
            high_res_cloud=a["high_cloud"], low_res_cloud=a["low_cloud"],
            scan_histogram=a["hist"][::-1].copy(),
            local_pose_translation=np.array([1.2, 2.0, 0.1]), local_pose_rotation=q_node,
            global_t=np.array([1.2, 2.0, 0.1]), global_q=q_node))
        pg.constraints.append(C(
            submap_id=Sid(0, 0), node_id=Nid(0, 0), rel_t=np.array([0.2, 0.0, 0.1]),
            rel_q=q_node, translation_weight=100.0, rotation_weight=200.0, tag="INTRA_SUBMAP"))
        pg.landmark_poses["lm1"] = np.array([1.0, 2.0, 0.5, 1.0, 0, 0, 0])
        pg.trajectory_data[0] = {"gravity_constant": 9.79,
                                 "imu_calibration": np.array([1.0, 0, 0, 0]),
                                 "fixed_frame_origin": (np.array([0.5, -0.25, 0.0]),
                                                        np.array([np.cos(0.2), 0, 0,
                                                                  np.sin(0.2)]))}
        graphs.append(pg)
    return graphs


def _records(write, pg, **kw):
    buf = pyio.BytesIO()
    writer = ProtoStreamWriter(buf) if write.__module__.startswith(
        "cartographer_tpu_torch") else JWriter(buf)
    write(pg, writer, **kw)
    buf.seek(0)
    return list(ProtoStreamReader(buf))


WRITERS = {"native": (jser.serialize_state, serialization.serialize_state),
           "carto": (jcarto.write_carto_state, carto_pbstream.write_carto_state)}
LOADERS = {"native": (jser.load_state, serialization.load_state),
           "carto": (jcarto.load_carto_state, carto_pbstream.load_carto_state)}


def _np(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _key(i):
    """A node or submap id of either package (or a MapById key) as a tuple."""
    return tuple(int(v) for v in (dataclasses.astuple(i) if dataclasses.is_dataclass(i) else i))


def _assert_same_graph(a, b, dim):
    """Two graphs (any package) equal exactly: poses, constraints, submap
    and node fields, grids, clouds, landmarks and trajectory data."""
    assert [_key(k) for k, _ in a.nodes.items()] == [_key(k) for k, _ in b.nodes.items()]
    assert ([_key(k) for k, _ in a.submap_data.items()]
            == [_key(k) for k, _ in b.submap_data.items()])
    for (key, na), (_, nb) in zip(a.nodes.items(), b.nodes.items()):
        assert na.time == nb.time
        for f in ("gravity_alignment", "local_pose_translation", "local_pose_rotation"):
            np.testing.assert_array_equal(getattr(na, f), getattr(nb, f))
        if dim == 2:
            np.testing.assert_array_equal(na.global_pose_2d, nb.global_pose_2d)
            np.testing.assert_array_equal(na.filtered_points, nb.filtered_points)
        else:
            for f in ("global_t", "global_q", "high_res_cloud", "low_res_cloud",
                      "scan_histogram"):
                np.testing.assert_array_equal(getattr(na, f), getattr(nb, f))
    for (key, ea), (_, eb) in zip(a.submap_data.items(), b.submap_data.items()):
        assert ea.finished == eb.finished
        assert {_key(n) for n in ea.node_ids} == {_key(n) for n in eb.node_ids}
        sa, sb = ea.submap, eb.submap
        assert (sa.num_range_data, sa.insertion_finished) == (sb.num_range_data,
                                                              sb.insertion_finished)
        grids = [("grid",)] if dim == 2 else [("high_grid",), ("low_grid",)]
        if dim == 2:
            np.testing.assert_array_equal(ea.global_pose_2d, eb.global_pose_2d)
        else:
            np.testing.assert_array_equal(ea.global_t, eb.global_t)
            np.testing.assert_array_equal(ea.global_q, eb.global_q)
            np.testing.assert_array_equal(sa.histogram, sb.histogram)
            ia, ib = sa.intensity_grid, sb.intensity_grid
            assert (ia is None) == (ib is None)
            if ia is not None:
                for f in ("sums", "counts", "origin"):
                    np.testing.assert_array_equal(_np(getattr(ia, f)), _np(getattr(ib, f)))
        for (name,) in grids:
            ga, gb = getattr(sa, name), getattr(sb, name)
            assert (ga is None) == (gb is None)
            if ga is not None:
                assert ga.resolution == gb.resolution
                for f in ("log_odds", "known", "origin"):
                    np.testing.assert_array_equal(_np(getattr(ga, f)), _np(getattr(gb, f)))
    assert len(a.constraints) == len(b.constraints)
    for ca, cb in zip(a.constraints, b.constraints):
        assert ((_key(ca.submap_id), _key(ca.node_id), ca.tag)
                == (_key(cb.submap_id), _key(cb.node_id), cb.tag))
        assert (ca.translation_weight, ca.rotation_weight) == (cb.translation_weight,
                                                               cb.rotation_weight)
        rels = ("rel",) if dim == 2 else ("rel_t", "rel_q")
        for f in rels:
            np.testing.assert_array_equal(getattr(ca, f), getattr(cb, f))
    assert a.landmark_poses.keys() == b.landmark_poses.keys()
    for k in a.landmark_poses:
        np.testing.assert_array_equal(a.landmark_poses[k], b.landmark_poses[k])
    assert a._frozen_landmarks == b._frozen_landmarks
    if dim == 2:
        assert a.fixed_frame_origin.keys() == b.fixed_frame_origin.keys()
        for k in a.fixed_frame_origin:
            np.testing.assert_array_equal(a.fixed_frame_origin[k], b.fixed_frame_origin[k])
    else:
        assert a.trajectory_data.keys() == b.trajectory_data.keys()
        for k, td in a.trajectory_data.items():
            for f, v in td.items():
                w = b.trajectory_data[k][f]
                for x, y in (zip(v, w) if isinstance(v, tuple) else [(v, w)]):
                    np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _fresh(dim, jax_side):
    if jax_side:
        return (jpg2.PoseGraph2D if dim == 2 else jpg3.PoseGraph3D)(JPoseGraphOptions())
    return (pose_graph_2d.PoseGraph2D if dim == 2 else pose_graph_3d.PoseGraph3D)(
        PoseGraphOptions(), device="cpu")


@pytest.mark.parametrize("fmt", ["native", "carto"])
@pytest.mark.parametrize("dim", [2, 3])
def test_streams_equal_and_cross_load(fmt, dim):
    """Both packages write the same records; each loads the other's stream
    into the same state as its own stream gives it."""
    jpg, pg = make_states_2d() if dim == 2 else make_states_3d()
    j_write, p_write = WRITERS[fmt]
    j_load, p_load = LOADERS[fmt]
    j_records, p_records = _records(j_write, jpg), _records(p_write, pg)
    assert len(j_records) == len(p_records) > 3
    for k, (a, b) in enumerate(zip(j_records, p_records)):
        assert a == b, f"record {k} differs"
    # JAX's stream into both packages: the port's load equals JAX's own.
    j_own, p_from_j = _fresh(dim, True), _fresh(dim, False)
    assert j_load(j_records, j_own) == {0: 0}
    assert p_load(j_records, p_from_j) == {0: 0}
    _assert_same_graph(j_own, p_from_j, dim)
    # The port's stream into JAX.
    j_from_p = _fresh(dim, True)
    j_load(p_records, j_from_p)
    _assert_same_graph(j_own, j_from_p, dim)


@pytest.mark.parametrize("dim", [2, 3])
def test_native_load_keeps_the_state(dim):
    """Against the state written: poses exact, grids equal to their float16
    rounding, clouds within 1 mm, the intensity grid exact."""
    _, pg = make_states_2d() if dim == 2 else make_states_3d()
    loaded = _fresh(dim, False)
    serialization.load_state(_records(serialization.serialize_state, pg), loaded)
    for (key, a), (_, b) in zip(pg.nodes.items(), loaded.nodes.items()):
        if dim == 2:
            np.testing.assert_array_equal(a.global_pose_2d, b.global_pose_2d)
            np.testing.assert_allclose(b.filtered_points, a.filtered_points, atol=1e-3)
        else:
            np.testing.assert_array_equal(a.global_q, b.global_q)
            np.testing.assert_allclose(b.high_res_cloud, a.high_res_cloud, atol=1e-3)
    for (key, a), (_, b) in zip(pg.submap_data.items(), loaded.submap_data.items()):
        names = ("grid",) if dim == 2 else ("high_grid", "low_grid")
        for name in names:
            ga, gb = getattr(a.submap, name), getattr(b.submap, name)
            np.testing.assert_array_equal(
                gb.log_odds.numpy(), ga.log_odds.numpy().astype(np.float16).astype(np.float32))
            np.testing.assert_array_equal(gb.known.numpy(), ga.known.numpy())
            assert gb.log_odds.device == torch.device("cpu")
        if dim == 3:
            np.testing.assert_array_equal(b.submap.intensity_grid.sums.numpy(),
                                          a.submap.intensity_grid.sums.numpy())


@pytest.mark.parametrize("fmt", ["native", "carto"])
def test_frozen_load_and_remapping(fmt):
    """A stream loaded into a graph that holds trajectory 0 becomes
    trajectory 1, frozen: fixed in the solve, no consecutive-node terms."""
    jpg, pg = make_states_2d()
    j_load, p_load = LOADERS[fmt]
    records = _records(WRITERS[fmt][0], jpg)
    _, target = make_states_2d()
    j_target = make_states_2d()[0]
    assert p_load(records, target, frozen=True) == j_load(records, j_target, frozen=True) == {0: 1}
    assert target._frozen_trajectories == j_target._frozen_trajectories == {1}
    assert target.trajectory_states == {1: "FROZEN"}
    assert all(e.frozen == (t == 1) for (t, _), e in target.submap_data.items())
    captured = {}

    def capture(sub_poses, sub_fixed, node_poses, node_fixed, sn_terms, nn_terms, iters):
        captured.update(sub_fixed=list(sub_fixed), node_fixed=list(node_fixed),
                        nn=list(nn_terms[0]))
        return np.asarray(sub_poses, np.float32), np.asarray(node_poses, np.float32)

    target._solve_schur = capture
    target.run_optimization()
    sub_traj = [t for (t, _), _ in target.submap_data.items()]
    node_traj = [t for (t, _), _ in target.nodes.items()]
    assert captured["sub_fixed"][:len(sub_traj)] == [i == 0 or t == 1
                                                     for i, t in enumerate(sub_traj)]
    assert captured["node_fixed"] == [t == 1 for t in node_traj]
    assert captured["nn"] == [0]  # trajectory 0's one consecutive pair, none of 1's


def test_frozen_poses_do_not_move_in_a_solve():
    """A frozen trajectory beside a free one through the plain SPA twin: the
    frozen submap and node poses come back bit for bit."""
    jpg, _ = make_states_2d()
    records = _records(jser.serialize_state, jpg)
    pg = _fresh(2, False)
    serialization.load_state(records, pg)  # trajectory 0, free
    serialization.load_state(records, pg, frozen=True)  # trajectory 1, frozen
    for (t, _), n in pg.nodes.items():  # float32-representable, as a solve leaves them
        n.global_pose_2d = n.global_pose_2d.astype(np.float32).astype(np.float64)
    for (t, _), e in pg.submap_data.items():
        e.global_pose_2d = e.global_pose_2d.astype(np.float32).astype(np.float64)
    before = {k: v.copy() for k, v in pg.node_global_poses().items()}
    sub_before = {k: e.global_pose_2d.copy() for k, e in pg.submap_data.items()}
    pg.run_optimization(5)
    moved = []
    for nid, pose in pg.node_global_poses().items():
        if nid.trajectory_id == 1:
            np.testing.assert_array_equal(pose, before[nid])
        else:
            moved.append(not np.array_equal(pose, before[nid]))
    for (t, i), e in pg.submap_data.items():
        if t == 1:
            np.testing.assert_array_equal(e.global_pose_2d, sub_before[(t, i)])
    assert any(moved)  # the free trajectory's nodes did move
    assert pg.solves == 1


# ---------------------------------------------------------------- builder, CLI


def test_map_builder_round_trip_and_trajectory_ids(tmp_path):
    """The port's MapBuilder writes both formats and loads them; a new
    trajectory after a load takes the next id, as in the JAX package."""
    _, pg = make_states_2d()
    mb = MapBuilder(MapBuilderOptions(use_trajectory_builder_2d=True), device="cpu")
    mb.pose_graph = pg
    for fmt in ("native", "carto"):
        path = str(tmp_path / f"{fmt}.pbstream")
        mb.serialize_state(path, format=fmt)
        fresh = MapBuilder(MapBuilderOptions(use_trajectory_builder_2d=True), device="cpu")
        assert fresh.load_state(path) == {0: 0}
        jmb = JMapBuilder(JMapBuilderOptions(use_trajectory_builder_2d=True,
                                             use_device_mesh=False))
        assert jmb.load_state(path) == {0: 0}
        _assert_same_graph(jmb.pose_graph, fresh.pose_graph, 2)
        assert fresh.pose_graph.trajectory_states == {0: "FROZEN"}
        from cartographer_tpu_torch.core.config import TrajectoryBuilderOptions
        from cartographer_tpu.core.config import TrajectoryBuilderOptions as JTraj
        assert (fresh.add_trajectory_builder(["laser"], TrajectoryBuilderOptions())
                == jmb.add_trajectory_builder(["laser"], JTraj()) == 1)
    with pytest.raises(ValueError):
        mb.serialize_state(str(tmp_path / "x.pbstream"), format="json")


def test_v1_migration_matches_jax(tmp_path):
    """A v1 reference stream (3D submaps without histograms) loads with the
    histograms rebuilt by the rotation of K12's twin, within 1e-5 of the JAX
    package's and of the v2 stream's; the CLI's migrate writes v2."""
    jpg, _ = make_states_3d()
    _write_v1_twin(jpg, tmp_path / "v2.pbstream", tmp_path / "v1.pbstream")
    jmb = JMapBuilder(JMapBuilderOptions(use_trajectory_builder_3d=True, use_device_mesh=False))
    jmb.load_state(str(tmp_path / "v1.pbstream"), load_frozen_state=False)
    mb = MapBuilder(MapBuilderOptions(use_trajectory_builder_3d=True), device="cpu")
    mb.load_state(str(tmp_path / "v1.pbstream"), load_frozen_state=False)
    v2 = MapBuilder(MapBuilderOptions(use_trajectory_builder_3d=True), device="cpu")
    v2.load_state(str(tmp_path / "v2.pbstream"), load_frozen_state=False)
    sid = SubmapId(0, 0)
    rebuilt = mb.pose_graph.submap_data[sid].submap.histogram
    np.testing.assert_allclose(rebuilt, np.asarray(jmb.pose_graph.submap_data[sid].submap.histogram),
                               rtol=1e-5, atol=1e-6)
    # The v2 stream holds the submap's own histogram; the node's histogram
    # rotated into the submap frame is what v1 rebuilds (one node here).
    assert v2.pose_graph.submap_data[sid].submap.histogram is not None
    assert pbstream_main.main(["migrate", str(tmp_path / "v1.pbstream"),
                               str(tmp_path / "migrated.pbstream"), "--device", "cpu"]) == 0
    again = MapBuilder(MapBuilderOptions(use_trajectory_builder_3d=True), device="cpu")
    again.load_state(str(tmp_path / "migrated.pbstream"))
    np.testing.assert_allclose(again.pose_graph.submap_data[sid].submap.histogram, rebuilt,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fmt", ["native", "carto"])
def test_cli_info_prints_what_jax_prints(fmt, tmp_path, capsys):
    jpg, _ = make_states_3d()
    path = str(tmp_path / "s.pbstream")
    w = JWriter(path)
    WRITERS[fmt][0](jpg, w)
    w.close()
    assert jcli.info(path) == 0
    expected = capsys.readouterr().out
    assert pbstream_main.main(["info", path]) == 0
    assert capsys.readouterr().out == expected
    assert "submap" in expected and "node" in expected


def test_cli_migrates_a_native_v1_stream(tmp_path, capsys):
    """A native v1 stream (no submap finished flags) migrates to what the
    JAX CLI writes."""
    jpg, _ = make_states_2d()
    records = [msgpack.unpackb(r, raw=False) for r in _records(jser.serialize_state, jpg)]
    records[0]["format_version"] = 1
    for r in records:
        r.pop("finished", None) if r.get("type") == "submap" else None
    src = str(tmp_path / "v1.pbstream")
    w = JWriter(src)
    for r in records:
        w.write(msgpack.packb(r, use_bin_type=True))
    w.close()
    assert jcli.migrate(src, str(tmp_path / "j.pbstream")) == 0
    assert pbstream_main.migrate(src, str(tmp_path / "p.pbstream")) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace("j.pbstream", "") == out[1].replace("p.pbstream", "")
    assert (list(JReader(str(tmp_path / "j.pbstream")))
            == list(ProtoStreamReader(str(tmp_path / "p.pbstream"))))
