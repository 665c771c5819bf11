"""Localization against a frozen 2D map: the JAX package's MapBuilder beside
the port's plain path on the CPU, at the full widths of `chip_smoke.py`'s
phase 22.

It is the witness for that phase's limits: how many constraints to the
frozen map and how small a mean error the reference reaches there.

- `map`: the JAX package's `MapBuilder` at the default options (the 2D
  frontend with the online correlative search, no IMU) over phase 4's 900
  scans of `simulation.simulate_scans` (seed 2, three laps), written as a
  native pbstream to PATH.
- `localize`: each package loads PATH frozen into a fresh `MapBuilder` and
  runs a new trajectory over LOCALIZE_SCANS scans of the same floor plan
  (seed 3), starting from rest LOCALIZE_START metres of arc into the path
  (3 m before the map's first pose and 25 degrees off its heading), at a
  pose the builder is not told. Both packages' full-submap search keeps the
  fast matcher's 30-degree angular window (the reference's searches +-pi):
  from `start=20` (mid-lap, 102 degrees off) neither package localizes at
  the default global sampling ratio, nor the JAX package at 0.05 or 0.3. Reports the global searches, the loop
  closures between the new trajectory and the frozen map, the mean error of
  the new trajectory's optimized poses against the truth in the map frame
  (overall and over its last 100 scans), and how far any frozen pose moved.

Run from the repository root:

    JAX_PLATFORMS=cpu python tests/localization_witness_2d.py map PATH
    JAX_PLATFORMS=cpu python tests/localization_witness_2d.py localize PATH [jax|port|both] \
        [scans] [option=value ...]

The `localize` options override the map builder's (for example
`pose_graph.global_sampling_ratio=0.05`; `start=M` moves the new
trajectory's start); the map is built at the defaults.

It prints one JSON line per package and one JSON object at the end.
"""

import dataclasses
import json
import os
import resource
import sys
import time

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import torch  # noqa: E402

from cartographer_tpu.core.config import MapBuilderOptions as JMapBuilderOptions  # noqa: E402
from cartographer_tpu.core.config import TrajectoryBuilder2DOptions as JOptions  # noqa: E402
from cartographer_tpu.core.config import TrajectoryBuilderOptions as JTrajOptions  # noqa: E402
from cartographer_tpu.core.config import apply_overrides  # noqa: E402
from cartographer_tpu.mapping.map_builder import MapBuilder as JMapBuilder  # noqa: E402
from cartographer_tpu.sensor.data import TimedPointCloudData as JScan  # noqa: E402
from cartographer_tpu_torch.interop import (  # noqa: E402
    map_builder_options_from_dict,
    trajectory_builder_options_from_dict,
)
from cartographer_tpu_torch.mapping.map_builder import MapBuilder  # noqa: E402
from cartographer_tpu_torch.sensor.data import TimedPointCloudData  # noqa: E402
from cartographer_tpu_torch.simulation import relative_to_first, simulate_scans  # noqa: E402

MAP_SCANS = 900  # chip_smoke.py's GLOBAL_SCANS
LOCALIZE_SCANS = 250  # chip_smoke.py's LOCALIZE_SCANS
LOCALIZE_START = 56.5  # m of arc, chip_smoke.py's LOCALIZE_START
LOCALIZE_SEED = 3
LOCALIZE_TIME_OFFSET = 1000.0  # s: the new run comes after the map's
OPTIONS = {"use_imu_data": False, "use_online_correlative_scan_matching": True}


def _scan(cls, ts, pts, rel, offset=0.0):
    return cls(time=int(round((ts + offset) * 1e6)), origin=np.zeros(3, np.float32),
               ranges=pts, times=rel)


def _options(overrides=None):
    traj = JTrajOptions(trajectory_builder_2d=apply_overrides(JOptions(), OPTIONS))
    mb = JMapBuilderOptions(use_trajectory_builder_2d=True)
    return (apply_overrides(mb, overrides) if overrides else mb), traj


def build_map(path: str) -> dict:
    scans, _ = simulate_scans(MAP_SCANS, seed=2)
    mb_options, traj = _options()
    mb = JMapBuilder(mb_options)
    tid = mb.add_trajectory_builder(["laser"], traj)
    t0 = time.monotonic()
    for ts, pts, rel in scans:
        mb.add_sensor_data(tid, "laser", _scan(JScan, ts, pts, rel))
    mb.finish_trajectory(tid)
    mb.pose_graph.run_final_optimization()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    mb.serialize_state(path)
    pg = mb.pose_graph
    return dict(path=path, nodes=len(pg.nodes), submaps=len(pg.submap_data),
                loop_closures=pg.num_inter_constraints(), seconds=time.monotonic() - t0)


def localize(name: str, path: str, num: int, overrides=None) -> dict:
    overrides = dict(overrides or {})
    start = overrides.pop("start", LOCALIZE_START)
    _, map_truth = simulate_scans(1, seed=2)
    scans, truth = simulate_scans(num, seed=LOCALIZE_SEED, start=start)
    gt = relative_to_first(truth, first=map_truth[0])
    mb_options, traj = _options(overrides)
    if name == "jax":
        mb = JMapBuilder(mb_options)
        cls, cb = JScan, mb.pose_graph._constraint_builder
    else:
        mb = MapBuilder(map_builder_options_from_dict(dataclasses.asdict(mb_options)),
                        device="cpu")
        traj = trajectory_builder_options_from_dict(dataclasses.asdict(traj))
        cls, cb = TimedPointCloudData, mb.pose_graph.constraint_builder
    pg = mb.pose_graph
    mb.load_state(path, load_frozen_state=True)
    frozen_nodes = {(t, i): np.array(n.global_pose_2d) for (t, i), n in pg.nodes.items()}
    frozen_submaps = {(t, i): np.array(e.global_pose_2d) for (t, i), e in pg.submap_data.items()}
    searches = [0]
    begin = cb.begin_global_constraint

    def counting(*args, **kwargs):
        searches[0] += 1
        return begin(*args, **kwargs)

    cb.begin_global_constraint = counting
    tid = mb.add_trajectory_builder(["laser"], traj)
    t0 = time.monotonic()
    for ts, pts, rel in scans:
        mb.add_sensor_data(tid, "laser", _scan(cls, ts, pts, rel, LOCALIZE_TIME_OFFSET))
    mb.finish_trajectory(tid)
    pg.run_final_optimization()
    seconds = time.monotonic() - t0
    nodes = [(i, n) for (t, i), n in pg.nodes.items() if t == tid]
    index = [int(round(n.time / 1e5 - LOCALIZE_TIME_OFFSET * 10)) - 1 for _, n in nodes]
    errors = np.array([np.linalg.norm(np.asarray(n.global_pose_2d)[:2] - gt[k, :2])
                       for (_, n), k in zip(nodes, index)])
    late = np.array(index) >= num - 100
    links = sum(1 for c in pg.constraints if c.tag == "INTER_SUBMAP"
                and {c.node_id.trajectory_id, c.submap_id.trajectory_id} == {0, tid})
    moved = max([float(np.abs(np.asarray(n.global_pose_2d) - frozen_nodes[(t, i)]).max())
                 for (t, i), n in pg.nodes.items() if t != tid]
                + [float(np.abs(np.asarray(e.global_pose_2d) - frozen_submaps[(t, i)]).max())
                   for (t, i), e in pg.submap_data.items() if t != tid])
    return dict(trajectory_id=tid, scans=num, nodes=len(nodes), global_searches=searches[0],
                constraints_to_frozen_map=links, mean_error_m=float(errors.mean()),
                mean_error_last_100_scans_m=float(errors[late].mean()),
                max_error_m=float(errors.max()), frozen_poses_moved=moved, seconds=seconds)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    if len(sys.argv) < 3:
        sys.exit(__doc__)
    mode, path = sys.argv[1], sys.argv[2]
    if mode == "map":
        result = build_map(path)
    else:
        which = sys.argv[3] if len(sys.argv) > 3 else "both"
        num = int(sys.argv[4]) if len(sys.argv) > 4 else LOCALIZE_SCANS
        overrides = {k: float(v) for k, v in (a.split("=") for a in sys.argv[5:])}
        result = {"overrides": overrides}
        for name in (("jax", "port_plain") if which == "both" else (which,)):
            result[name] = localize("jax" if name == "jax" else "port", path, num, overrides)
            print(name, json.dumps(result[name]), flush=True)
    result["max_rss_gb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    print(json.dumps(result))
