"""The port's PoseGraph2D optimization problem against the JAX package's on
a small hand-built graph: the consecutive local-SLAM terms, odometry terms
and fixed-frame fixes with a learned origin (optimization_problem_2d.cc:
304-394), solved by the plain twin of kernel K8."""

import numpy as np
import pytest

from cartographer_tpu.core.config import PoseGraphOptions as JOptions
from cartographer_tpu.core.config import apply_overrides as j_apply_overrides
from cartographer_tpu.mapping.constraint_builder_2d import Constraint as JConstraint
from cartographer_tpu.mapping.id import NodeId as JNodeId, SubmapId as JSubmapId
from cartographer_tpu.mapping.pose_graph_2d import (
    PoseGraph2D as JPoseGraph2D,
    SubmapDataEntry as JEntry,
    TrajectoryNode as JNode,
)
from cartographer_tpu.mapping.submap_2d import Submap2D as JSubmap2D
from cartographer_tpu.sensor.data import (
    FixedFramePoseData as JFix,
    OdometryData as JOdometry,
)
from cartographer_tpu_torch.core.config import PoseGraphOptions, apply_overrides
from cartographer_tpu_torch.mapping.constraint_builder_2d import Constraint
from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
from cartographer_tpu_torch.mapping.pose_graph_2d import (
    PoseGraph2D,
    SubmapDataEntry,
    TrajectoryNode,
)
from cartographer_tpu_torch.mapping.submap_2d import Submap2D
from cartographer_tpu_torch.sensor.data import FixedFramePoseData, OdometryData
from cartographer_tpu_torch.transform import nquat

PORT = dict(graph=lambda o: PoseGraph2D(o, device="cpu"),
            options=lambda o: apply_overrides(PoseGraphOptions(), o),
            entry=SubmapDataEntry, node=TrajectoryNode, submap=Submap2D, constraint=Constraint,
            node_id=NodeId, submap_id=SubmapId, odometry=OdometryData, fix=FixedFramePoseData)
JAX = dict(graph=JPoseGraph2D, options=lambda o: j_apply_overrides(JOptions(), o),
           entry=JEntry, node=JNode, submap=JSubmap2D, constraint=JConstraint, node_id=JNodeId,
           submap_id=JSubmapId, odometry=JOdometry, fix=JFix)


def _graph(pkg, overrides, num_submaps=2, nodes_per_submap=4):
    """Submaps 1 m apart, nodes at their submap's origin tied to it by weak
    INTRA constraints (the shape of test_aux_components.make_graph_with_submaps)."""
    pg = pkg["graph"](pkg["options"](overrides))
    node_index = 0
    for s in range(num_submaps):
        origin = np.array([s * 1.0, 0.0, 0.0])
        entry = pkg["entry"](submap=pkg["submap"](
            local_pose_translation=origin, local_pose_rotation=np.array([1.0, 0, 0, 0])),
            global_pose_2d=origin.copy(), finished=True)
        sid = pkg["submap_id"](0, pg.submap_data.append(0, entry))
        for _ in range(nodes_per_submap):
            node = pkg["node"](time=node_index * 1000, gravity_alignment=np.array([1.0, 0, 0, 0]),
                               filtered_points=np.zeros((1, 2)), local_pose_translation=origin,
                               local_pose_rotation=np.array([1.0, 0, 0, 0]),
                               global_pose_2d=origin.copy())
            nid = pkg["node_id"](0, pg.nodes.append(0, node))
            entry.node_ids.add(nid)
            pg.constraints.append(pkg["constraint"](
                submap_id=sid, node_id=nid, rel=np.zeros(3), translation_weight=0.01,
                rotation_weight=0.01, tag="INTRA_SUBMAP"))
            node_index += 1
    return pg


ODOMETRY = {"optimization_problem.local_slam_pose_translation_weight": 1.0,
            "optimization_problem.local_slam_pose_rotation_weight": 1.0,
            "optimization_problem.odometry_translation_weight": 1e6,
            "optimization_problem.odometry_rotation_weight": 1e6}
FIXED_FRAME = {"optimization_problem.fixed_frame_pose_translation_weight": 1e6,
               "optimization_problem.fixed_frame_pose_rotation_weight": 1e3,
               "optimization_problem.local_slam_pose_translation_weight": 1.0,
               "optimization_problem.local_slam_pose_rotation_weight": 1.0}


def _feed(pg, pkg, kind):
    for k in range(8):
        t, yaw = k * 1000, 0.05 * k
        if kind == "odometry":
            pg.add_odometry_data(0, pkg["odometry"](
                time=t, pose_translation=np.array([k * 1.0, 0.1 * k, 0.0]),
                pose_rotation=nquat.from_yaw(yaw)))
        else:  # fixes in a frame shifted by +10 y, with or without rotation
            pg.add_fixed_frame_pose_data(0, pkg["fix"](
                time=t, pose_translation=np.array([1.0 * k, 10.0, 0.0]),
                pose_rotation=nquat.from_yaw(yaw) if kind == "fix_rotation" else None))
    pg.add_fixed_frame_pose_data(0, pkg["fix"](time=9000, pose_translation=None,
                                               pose_rotation=None))  # an invalid fix


@pytest.mark.parametrize("kind,overrides", [
    ("odometry", ODOMETRY), ("fix", FIXED_FRAME), ("fix_rotation", FIXED_FRAME)])
def test_optimization_problem_matches_jax(kind, overrides):
    graphs = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        pg = _graph(pkg, overrides)
        _feed(pg, pkg, kind)
        pg.run_optimization(num_iterations=40)
        graphs[name] = pg
    jpg, pg = graphs["jax"], graphs["port"]
    for (tid, index), node in pg.nodes.items():
        want = jpg.nodes[JNodeId(tid, index)].global_pose_2d
        np.testing.assert_allclose(node.global_pose_2d[:2], want[:2], rtol=0, atol=2e-3)
        assert abs(node.global_pose_2d[2] - want[2]) <= 2e-3
    assert pg.fixed_frame_origin.keys() == jpg.fixed_frame_origin.keys()
    for tid, origin in pg.fixed_frame_origin.items():
        np.testing.assert_allclose(origin, jpg.fixed_frame_origin[tid], rtol=0, atol=2e-3)
    n0, n3 = pg.nodes[NodeId(0, 0)].global_pose_2d, pg.nodes[NodeId(0, 3)].global_pose_2d
    assert abs((n3[0] - n0[0]) - 3.0) < 0.05  # the odometry's or the fixes' shape


def test_odometry_yaw_interpolates_across_pi_seam():
    pg = PoseGraph2D(PoseGraphOptions(), device="cpu")
    for t, x, yaw in ((1_000_000, 0.0, 3.10), (1_100_000, 0.1, -3.10)):
        pg.add_odometry_data(0, OdometryData(time=t, pose_translation=np.array([x, 0.0, 0.0]),
                                             pose_rotation=nquat.from_yaw(yaw)))
    (mid,) = pg._odometry_poses_at(0, [1_050_000])
    assert abs(abs(mid[2]) - np.pi) < 0.05, mid
    np.testing.assert_allclose(mid[:2], [0.05, 0.0], atol=1e-6)
