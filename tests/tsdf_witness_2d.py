"""The JAX package's 2D frontend and MapBuilder on TSDF submaps beside the
port's plain path on the CPU, at the full widths of `chip_smoke.py`'s two
TSDF phases: each package's mean error against the ground truth.

It is the witness for those phases' limits. TSDF submaps had never run on
the smoke's floor plan: the limits are set from what the reference does
there, not guessed.

- `frontend`: the default 2D options with `submaps.grid_type = "TSDF"`, the
  TSDF inserter at its defaults and the online correlative search on,
  `use_imu_data = false`: the phase's 420 scans of `simulation.simulate_scans`
  (seed 0). Reports the mean and largest position error of each package.
- `global`: `MapBuilder` at the default pose-graph options over the
  phase's 900 scans (three laps, seed 2): loop closures, solves and the
  mean error of the optimized and of the frontend poses.

Run from the repository root (the frontend about 15 minutes, the global
run of one package about an hour, on a CPU):

    JAX_PLATFORMS=cpu python tests/tsdf_witness_2d.py frontend [num_scans]
    JAX_PLATFORMS=cpu python tests/tsdf_witness_2d.py global [num_scans] [jax|port|both]

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
from cartographer_tpu.mapping.local_trajectory_builder_2d import (  # noqa: E402
    LocalTrajectoryBuilder2D as JBuilder,
)
from cartographer_tpu.mapping.map_builder import MapBuilder as JMapBuilder  # noqa: E402
from cartographer_tpu.sensor.data import TimedPointCloudData as JScan  # noqa: E402
from cartographer_tpu_torch.interop import (  # noqa: E402
    map_builder_options_from_dict,
    options_from_dict,
    trajectory_builder_options_from_dict,
)
from cartographer_tpu_torch.mapping.local_trajectory_builder_2d import (  # noqa: E402
    LocalTrajectoryBuilder2D,
)
from cartographer_tpu_torch.mapping.map_builder import MapBuilder  # noqa: E402
from cartographer_tpu_torch.sensor.data import TimedPointCloudData  # noqa: E402
from cartographer_tpu_torch.simulation import relative_to_first, simulate_scans  # noqa: E402
from cartographer_tpu_torch.transform import nquat  # noqa: E402

FRONTEND_SCANS = 450  # what chip_smoke.py simulates for the frontend phase (420 + 30 profiled)
GLOBAL_SCANS = 900
OPTIONS = {"use_imu_data": False, "use_online_correlative_scan_matching": True,
           "submaps.grid_type": "TSDF"}


def _jax_permutation(seed, n):
    return np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))


def _scan(cls, ts, pts, rel):
    return cls(time=int(round(ts * 1e6)), origin=np.zeros(3, np.float32), ranges=pts, times=rel)


def frontend(num: int) -> dict:
    jopts = apply_overrides(JOptions(), OPTIONS)
    scans, truth = simulate_scans(FRONTEND_SCANS, seed=0)
    scans, gt = scans[:num], relative_to_first(truth)[:num]
    builders = {
        "jax": (JBuilder(jopts, ["laser"]), JScan),
        "port_plain": (LocalTrajectoryBuilder2D(options_from_dict(dataclasses.asdict(jopts)),
                                                ["laser"], device="cpu",
                                                permutation_fn=_jax_permutation),
                       TimedPointCloudData)}
    out, poses = {"scans": num}, {}
    for name, (b, cls) in builders.items():
        t0, est = time.monotonic(), []
        for ts, pts, rel in scans:
            r = b.add_range_data("laser", _scan(cls, ts, pts, rel))
            est.append([*r.local_pose_translation[:2],
                        nquat.get_yaw(np.asarray(r.local_pose_rotation, np.float64))])
        est = np.asarray(est)
        poses[name] = est
        errors = np.linalg.norm(est[:, :2] - gt[:, :2], axis=1)
        yaw = np.abs((est[:, 2] - gt[:, 2] + np.pi) % (2 * np.pi) - np.pi)
        out[name] = dict(mean_error_m=float(errors.mean()), max_error_m=float(errors.max()),
                         mean_yaw_error_rad=float(yaw.mean()),
                         error_by_100_scans_m=[float(errors[i:i + 100].mean())
                                               for i in range(0, num, 100)],
                         seconds=time.monotonic() - t0)
        print(name, json.dumps(out[name]), flush=True)
    d = poses["jax"] - poses["port_plain"]
    out["largest_difference"] = [float(np.abs(d[:, :2]).max()),
                                 float(np.abs((d[:, 2] + np.pi) % (2 * np.pi) - np.pi).max())]
    return out


def _global_run(name: str, num: int) -> dict:
    scans, truth = simulate_scans(GLOBAL_SCANS, seed=2)
    scans, gt = scans[:num], relative_to_first(truth)
    traj = JTrajOptions(trajectory_builder_2d=apply_overrides(JOptions(), OPTIONS))
    mb_options = JMapBuilderOptions(use_trajectory_builder_2d=True)
    if name == "jax":
        mb = JMapBuilder(mb_options)
        tid = mb.add_trajectory_builder(["laser"], traj)
        cls = JScan
        pg = mb.pose_graph
        solves = [0]
        solve = pg._solve_schur

        def counting(*args, **kwargs):
            solves[0] += 1
            return solve(*args, **kwargs)

        pg._solve_schur = counting
    else:
        mb = MapBuilder(map_builder_options_from_dict(dataclasses.asdict(mb_options)),
                        device="cpu")
        tid = mb.add_trajectory_builder(
            ["laser"], trajectory_builder_options_from_dict(dataclasses.asdict(traj)),
            permutation_fn=_jax_permutation)
        cls = TimedPointCloudData
        pg = mb.pose_graph
    t0 = time.monotonic()
    for ts, pts, rel in scans:
        mb.add_sensor_data(tid, "laser", _scan(cls, ts, pts, rel))
    mb.finish_trajectory(tid)
    pg.run_final_optimization()
    # Node -> scan index: scan i is stamped (i + 1) * 0.1 s.
    nodes = list(pg.nodes.items())
    index = [int(round(node.time / 1e5)) - 1 for _, node in nodes]
    local = np.mean([np.linalg.norm(node.local_pose_translation[:2] - gt[i, :2])
                     for (_, node), i in zip(nodes, index)])
    optimized = np.mean([np.linalg.norm(np.asarray(node.global_pose_2d)[:2] - gt[i, :2])
                         for (_, node), i in zip(nodes, index)])
    return dict(scans=num, nodes=len(nodes), loop_closures=pg.num_inter_constraints(),
                solves=solves[0] if name == "jax" else pg.solves,
                mean_error_optimized_m=float(optimized), mean_error_frontend_m=float(local),
                seconds=time.monotonic() - t0)


def global_slam(num: int, which: str) -> dict:
    out = {}
    for name in (("jax", "port_plain") if which == "both" else
                 ("jax",) if which == "jax" else ("port_plain",)):
        out[name] = _global_run(name, num)
        print(name, json.dumps(out[name]), flush=True)
    return out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    mode = sys.argv[1] if len(sys.argv) > 1 else "frontend"
    if mode == "frontend":
        result = frontend(int(sys.argv[2]) if len(sys.argv) > 2 else 420)
    else:
        result = global_slam(int(sys.argv[2]) if len(sys.argv) > 2 else GLOBAL_SCANS,
                             sys.argv[3] if len(sys.argv) > 3 else "both")
    result["max_rss_gb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    print(json.dumps(result))
