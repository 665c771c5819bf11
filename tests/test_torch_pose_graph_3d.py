"""The port's PoseGraph3D (plain path) against the JAX package's: the
kidnapped-robot test of tests/test_global_localization_3d.py, where a second
trajectory with no pose prior acquires its first cross-trajectory
constraint through the global sampler and the full-submap search."""

import math

import jax.numpy as jnp
import numpy as np
import torch

from cartographer_tpu.core.config import (
    ConstraintBuilderOptions as JConstraintBuilderOptions,
    FastCorrelativeScanMatcherOptions3D as JFcsm3D,
    PoseGraphOptions as JPoseGraphOptions,
)
from cartographer_tpu.mapping import id as jid
from cartographer_tpu.mapping import pose_graph_3d as jpg3
from cartographer_tpu.mapping.submap_3d import Submap3D as JSubmap3D
from cartographer_tpu.ops.rot_histogram import compute_rotational_histogram
from cartographer_tpu.transform import quaternion as jq
from cartographer_tpu.transform.rigid import Rigid3
from cartographer_tpu_torch.core.config import (
    ConstraintBuilderOptions,
    FastCorrelativeScanMatcherOptions3D,
    PoseGraphOptions,
)
from cartographer_tpu_torch.interop import grid3d_from_numpy
from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
from cartographer_tpu_torch.mapping.pose_graph_3d import (
    Constraint3D,
    PoseGraph3D,
    SubmapDataEntry3D,
    TrajectoryNode3D,
)
from cartographer_tpu_torch.mapping.submap_3d import Submap3D
from cartographer_tpu_torch.transform import nquat

from test_ops_3d import build_grid_3d, make_environment_3d

torch.set_num_threads(1)

TRUE_T = np.array([1.5, -1.0, 0.2])
TRUE_YAW = 2.0
IDENTITY = np.array([1.0, 0.0, 0.0, 0.0])


def _options(pg, cb, fcsm):
    return pg(optimize_every_n_nodes=0, global_sampling_ratio=1.0,
              constraint_builder=cb(sampling_ratio=1.0, min_score=0.35,
                                    global_localization_min_score=0.35,
                                    fast_correlative_scan_matcher_3d=fcsm(
                                        branch_and_bound_depth=4, min_rotational_score=0.5,
                                        min_low_resolution_score=0.3,
                                        linear_xy_search_window=1.5,
                                        linear_z_search_window=0.4)))


def _kidnapped(port: bool):
    """Robot 1's map (one finished submap with one node at the origin) and
    robot 2's first node at an unknown pose, through one package's graph.
    Returns (the cross-trajectory constraint, the graph)."""
    world = make_environment_3d(num=400, seed=7)
    grid = build_grid_3d(world, resolution=0.2, size=64)
    low = build_grid_3d(world, resolution=0.6, size=32)
    mask = jnp.ones(len(world), bool)
    submap_hist = np.asarray(compute_rotational_histogram(jnp.asarray(world), mask, 60))
    pose = Rigid3(jnp.asarray(TRUE_T, jnp.float32), jq.from_yaw(jnp.array(TRUE_YAW)))
    scan = np.asarray(pose.inverse().apply(jnp.asarray(world)))
    scan_hist = np.asarray(compute_rotational_histogram(jnp.asarray(scan), mask, 60))
    if port:
        pg = PoseGraph3D(_options(PoseGraphOptions, ConstraintBuilderOptions,
                                  FastCorrelativeScanMatcherOptions3D), device="cpu")
        grids = [grid3d_from_numpy(g.log_odds, g.known, g.origin, g.resolution, "cpu")
                 for g in (grid, low)]
        Sub, Entry, Node, Con, nid, sid = (Submap3D, SubmapDataEntry3D, TrajectoryNode3D,
                                           Constraint3D, NodeId, SubmapId)
    else:
        pg = jpg3.PoseGraph3D(_options(JPoseGraphOptions, JConstraintBuilderOptions, JFcsm3D))
        grids = [grid, low]
        Sub, Entry, Node, Con, nid, sid = (JSubmap3D, jpg3.SubmapDataEntry3D,
                                           jpg3.TrajectoryNode3D, jpg3.Constraint3D,
                                           jid.NodeId, jid.SubmapId)
    submap0 = Sub(local_pose_translation=np.zeros(3), local_pose_rotation=IDENTITY.copy(),
                  num_range_data=10, insertion_finished=True, high_grid=grids[0],
                  low_grid=grids[1], histogram=submap_hist)
    pg.submap_data.insert(sid(0, 0), Entry(submap=submap0, global_t=np.zeros(3),
                                           global_q=IDENTITY.copy(), finished=True))
    pg.nodes.insert(nid(0, 0), Node(
        time=0, gravity_alignment=IDENTITY.copy(), high_res_cloud=np.asarray(world),
        low_res_cloud=np.asarray(world), scan_histogram=submap_hist,
        local_pose_translation=np.zeros(3), local_pose_rotation=IDENTITY.copy(),
        global_t=np.zeros(3), global_q=IDENTITY.copy()))
    pg.constraints.append(Con(submap_id=sid(0, 0), node_id=nid(0, 0), rel_t=np.zeros(3),
                              rel_q=IDENTITY.copy(), translation_weight=1e4,
                              rotation_weight=1e4, tag="INTRA_SUBMAP"))
    own = Sub(local_pose_translation=np.zeros(3), local_pose_rotation=IDENTITY.copy(),
              num_range_data=1, insertion_finished=False)
    node = Node(time=100_000_000, gravity_alignment=IDENTITY.copy(), high_res_cloud=scan,
                low_res_cloud=scan, scan_histogram=scan_hist,
                local_pose_translation=np.zeros(3), local_pose_rotation=IDENTITY.copy())
    pg.add_node(1, node, [own], [])
    pg.wait_for_all_computations()
    inter = [c for c in pg.constraints if c.tag == "INTER_SUBMAP"
             and c.node_id.trajectory_id != c.submap_id.trajectory_id]
    assert inter, "no cross-trajectory constraint acquired"
    pg.run_optimization()
    return inter[0], pg, nid


def test_kidnapped_robot_relocalizes_like_jax():
    c, pg, nid = _kidnapped(port=True)
    ref, jpg, jnid = _kidnapped(port=False)
    np.testing.assert_allclose(c.rel_t, TRUE_T, atol=0.3)
    yaw_err = abs(nquat.get_yaw(c.rel_q) - TRUE_YAW)
    assert min(yaw_err, 2 * math.pi - yaw_err) < 0.1
    np.testing.assert_allclose(c.rel_t, ref.rel_t, atol=0.05)
    assert 2 * np.arccos(min(abs(float(np.dot(c.rel_q, ref.rel_q))), 1.0)) < 0.02
    node = pg.nodes.get(nid(1, 0))
    np.testing.assert_allclose(node.global_t, TRUE_T, atol=0.35)
    np.testing.assert_allclose(node.global_t, jpg.nodes.get(jnid(1, 0)).global_t, atol=0.05)
    assert pg.transitively_connected(0, 1)
