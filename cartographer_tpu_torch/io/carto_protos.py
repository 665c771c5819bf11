"""Wire schemas for the reference's pbstream payload messages.

Hand-written from the reference's .proto definitions (field numbers and
types; the authoritative sources are cited per schema). Used with
io.proto_wire to read/write real Cartographer `.pbstream` state files.
"""

from __future__ import annotations

# --- cartographer/transform/proto/transform.proto ---------------------------

VECTOR2D = {1: ("x", "double"), 2: ("y", "double")}
VECTOR3D = {1: ("x", "double"), 2: ("y", "double"), 3: ("z", "double")}
VECTOR3F = {1: ("x", "float"), 2: ("y", "float"), 3: ("z", "float")}
QUATERNIOND = {1: ("x", "double"), 2: ("y", "double"), 3: ("z", "double"),
               4: ("w", "double")}
RIGID3D = {1: ("translation", VECTOR3D), 2: ("rotation", QUATERNIOND)}

# --- cartographer/sensor/proto/sensor.proto ----------------------------------

COMPRESSED_POINT_CLOUD = {
    1: ("num_points", "int32"),
    3: ("point_data", "int32", "repeated"),
}
SENSOR_IMU_DATA = {
    1: ("timestamp", "int64"),
    2: ("linear_acceleration", VECTOR3D),
    3: ("angular_velocity", VECTOR3D),
}
SENSOR_ODOMETRY_DATA = {1: ("timestamp", "int64"), 2: ("pose", RIGID3D)}
SENSOR_FIXED_FRAME_POSE_DATA = {1: ("timestamp", "int64"), 2: ("pose", RIGID3D)}
LANDMARK_OBSERVATION = {
    1: ("id", "bytes"),
    2: ("landmark_to_tracking_transform", RIGID3D),
    3: ("translation_weight", "double"),
    4: ("rotation_weight", "double"),
}
SENSOR_LANDMARK_DATA = {
    1: ("timestamp", "int64"),
    2: ("landmark_observations", LANDMARK_OBSERVATION, "repeated"),
}

# --- cartographer/mapping/proto/pose_graph.proto -----------------------------

SUBMAP_ID = {1: ("trajectory_id", "int32"), 2: ("submap_index", "int32")}
NODE_ID = {1: ("trajectory_id", "int32"), 2: ("node_index", "int32")}
CONSTRAINT = {
    1: ("submap_id", SUBMAP_ID),
    2: ("node_id", NODE_ID),
    3: ("relative_pose", RIGID3D),
    5: ("tag", "enum"),  # 0 = INTRA_SUBMAP, 1 = INTER_SUBMAP
    6: ("translation_weight", "double"),
    7: ("rotation_weight", "double"),
}
LANDMARK_POSE = {1: ("landmark_id", "string"), 2: ("global_pose", RIGID3D)}

# --- cartographer/mapping/proto/trajectory.proto -----------------------------

TRAJECTORY_NODE = {7: ("node_index", "int32"), 1: ("timestamp", "int64"),
                   5: ("pose", RIGID3D)}
TRAJECTORY_SUBMAP = {2: ("submap_index", "int32"), 1: ("pose", RIGID3D)}
TRAJECTORY = {
    3: ("trajectory_id", "int32"),
    1: ("node", TRAJECTORY_NODE, "repeated"),
    2: ("submap", TRAJECTORY_SUBMAP, "repeated"),
}

POSE_GRAPH = {
    2: ("constraint", CONSTRAINT, "repeated"),
    4: ("trajectory", TRAJECTORY, "repeated"),
    5: ("landmark_poses", LANDMARK_POSE, "repeated"),
}

# --- cartographer/mapping/proto/{map_limits,cell_limits_2d,grid_2d}.proto ----

CELL_LIMITS = {1: ("num_x_cells", "int32"), 2: ("num_y_cells", "int32")}
MAP_LIMITS = {1: ("resolution", "double"), 2: ("max", VECTOR2D),
              3: ("cell_limits", CELL_LIMITS)}
CELL_BOX = {1: ("max_x", "int32"), 2: ("max_y", "int32"),
            3: ("min_x", "int32"), 4: ("min_y", "int32")}
PROBABILITY_GRID = {}
TSDF_2D = {}  # presence marker only; TSDF payload not modeled
GRID_2D = {
    1: ("limits", MAP_LIMITS),
    2: ("cells", "int32", "repeated"),
    3: ("known_cells_box", CELL_BOX),
    4: ("probability_grid_2d", PROBABILITY_GRID),
    5: ("tsdf_2d", TSDF_2D),
    6: ("min_correspondence_cost", "float"),
    7: ("max_correspondence_cost", "float"),
}

# --- cartographer/mapping/proto/{submap,hybrid_grid}.proto -------------------

HYBRID_GRID = {
    1: ("resolution", "float"),
    3: ("x_indices", "sint32", "repeated"),
    4: ("y_indices", "sint32", "repeated"),
    5: ("z_indices", "sint32", "repeated"),
    6: ("values", "int32", "repeated"),
}
SUBMAP_2D = {
    1: ("local_pose", RIGID3D),
    2: ("num_range_data", "int32"),
    3: ("finished", "bool"),
    4: ("grid", GRID_2D),
}
SUBMAP_3D = {
    1: ("local_pose", RIGID3D),
    2: ("num_range_data", "int32"),
    3: ("finished", "bool"),
    4: ("high_resolution_hybrid_grid", HYBRID_GRID),
    5: ("low_resolution_hybrid_grid", HYBRID_GRID),
    6: ("rotational_scan_matcher_histogram", "float", "repeated"),
}

# --- cartographer/mapping/proto/trajectory_node_data.proto -------------------

TRAJECTORY_NODE_DATA = {
    1: ("timestamp", "int64"),
    2: ("gravity_alignment", QUATERNIOND),
    3: ("filtered_gravity_aligned_point_cloud", COMPRESSED_POINT_CLOUD),
    4: ("high_resolution_point_cloud", COMPRESSED_POINT_CLOUD),
    5: ("low_resolution_point_cloud", COMPRESSED_POINT_CLOUD),
    6: ("rotational_scan_matcher_histogram", "float", "repeated"),
    7: ("local_pose", RIGID3D),
}

# --- cartographer/mapping/proto/trajectory_builder_options.proto -------------

SENSOR_ID = {1: ("type", "enum"), 2: ("id", "string")}
TRAJECTORY_BUILDER_OPTIONS = {}  # resolved options not modeled; empty message
TRAJECTORY_BUILDER_OPTIONS_WITH_SENSOR_IDS = {
    1: ("sensor_id", SENSOR_ID, "repeated"),
    2: ("trajectory_builder_options", TRAJECTORY_BUILDER_OPTIONS),
}
ALL_TRAJECTORY_BUILDER_OPTIONS = {
    1: ("options_with_sensor_ids", TRAJECTORY_BUILDER_OPTIONS_WITH_SENSOR_IDS,
        "repeated"),
}

# --- cartographer/mapping/proto/serialization.proto --------------------------

SERIALIZATION_HEADER = {1: ("format_version", "uint32")}
SERIALIZED_SUBMAP = {1: ("submap_id", SUBMAP_ID), 2: ("submap_2d", SUBMAP_2D),
                     3: ("submap_3d", SUBMAP_3D)}
SERIALIZED_NODE = {1: ("node_id", NODE_ID), 5: ("node_data", TRAJECTORY_NODE_DATA)}
SERIALIZED_IMU_DATA = {1: ("trajectory_id", "int32"),
                       2: ("imu_data", SENSOR_IMU_DATA)}
SERIALIZED_ODOMETRY_DATA = {1: ("trajectory_id", "int32"),
                            2: ("odometry_data", SENSOR_ODOMETRY_DATA)}
SERIALIZED_FIXED_FRAME_POSE_DATA = {
    1: ("trajectory_id", "int32"),
    2: ("fixed_frame_pose_data", SENSOR_FIXED_FRAME_POSE_DATA)}
SERIALIZED_LANDMARK_DATA = {1: ("trajectory_id", "int32"),
                            2: ("landmark_data", SENSOR_LANDMARK_DATA)}
TRAJECTORY_DATA = {
    1: ("trajectory_id", "int32"),
    2: ("gravity_constant", "double"),
    3: ("imu_calibration", QUATERNIOND),
    4: ("fixed_frame_origin_in_map", RIGID3D),
}
SERIALIZED_DATA = {
    1: ("pose_graph", POSE_GRAPH),
    2: ("all_trajectory_builder_options", ALL_TRAJECTORY_BUILDER_OPTIONS),
    3: ("submap", SERIALIZED_SUBMAP),
    4: ("node", SERIALIZED_NODE),
    5: ("trajectory_data", TRAJECTORY_DATA),
    6: ("imu_data", SERIALIZED_IMU_DATA),
    7: ("odometry_data", SERIALIZED_ODOMETRY_DATA),
    8: ("fixed_frame_pose_data", SERIALIZED_FIXED_FRAME_POSE_DATA),
    9: ("landmark_data", SERIALIZED_LANDMARK_DATA),
}
