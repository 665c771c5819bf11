"""The JAX package's 2D frontend beside the port's plain path on the CPU, on
the scans of `chip_smoke.py`'s batched-serving phase (not collected by
pytest): each robot's mean position error against the ground truth.

The phase drives 16 robots at `bench.py`'s shape (1,024-beam scans of
`simulation.simulate_scans(beams=1024, seed=r, start=4.0 * r)`, 512^2 grids
at 5 cm, matcher cloud 512, loop-closure cloud 256, no IMU), with the
default options (the LM refine alone), with the online correlative search
on, and on TSDF submaps with the search on (`tsdf`). This witness says
what each robot's error is when no batching and no card are involved, in
both packages, so the phase's limits rest on the reference. The port runs
with the JAX package's voxel-filter permutations, and so does the phase's
accuracy run on the card (`simulation.reference_permutation`);
`chip_smoke.BATCH_WITNESS` holds this script's means, and the phase holds
every robot that the witness keeps within 0.25 m here to that limit.

`noise=SIGMA` runs the JAX package alone, once per seed of `seeds=K`
(default 4), with N(0, SIGMA) metres added to every range: a scene whose
result moves by more than the limit under noise at a float32 ulp of the
ranges is decided by rounding, and no port can be held to it.

    JAX_PLATFORMS=cpu python tests/batched_serving_witness_2d.py [scans] [default|correlative|tsdf] [robot ...] [noise=SIGMA] [seeds=K]

It prints one JSON line per robot and one JSON object at the end.
"""

import dataclasses
import json
import os
import sys

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import torch  # noqa: E402

from cartographer_tpu.core.config import TrajectoryBuilder2DOptions, apply_overrides  # noqa: E402
from cartographer_tpu.mapping.local_trajectory_builder_2d import (  # noqa: E402
    LocalTrajectoryBuilder2D as JBuilder,
)
from cartographer_tpu.sensor.data import TimedPointCloudData as JScan  # noqa: E402
from cartographer_tpu_torch.interop import options_from_dict  # noqa: E402
from cartographer_tpu_torch.mapping.local_trajectory_builder_2d import (  # noqa: E402
    LocalTrajectoryBuilder2D,
)
from cartographer_tpu_torch.sensor.data import TimedPointCloudData  # noqa: E402
from cartographer_tpu_torch.simulation import relative_to_first, simulate_scans  # noqa: E402

OPTIONS = {"use_imu_data": False, "tpu.scan_capacity": 1024, "tpu.submap_grid_size": 512,
           "submaps.resolution": 0.05, "tpu.matcher_capacity": 512,
           "tpu.loop_closure_capacity": 256}


def _jax_permutation(seed, n):
    return np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))


MODES = {"default": {}, "correlative": {"use_online_correlative_scan_matching": True},
         "tsdf": {"use_online_correlative_scan_matching": True, "submaps.grid_type": "TSDF"}}


def _noisy(pts, sigma, rng):
    """The scan with N(0, sigma) added to each return's range."""
    out = pts.astype(np.float64)
    r = np.linalg.norm(out[:, :2], axis=1)
    out[:, :2] *= ((r + sigma * rng.randn(len(r))) / r)[:, None]
    return out.astype(np.float32)


def main():
    args = [a for a in sys.argv[1:] if "=" not in a]
    keys = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
    scans_per_robot = int(args[0]) if args else 60
    mode = args[1] if len(args) > 1 else "default"
    robots = [int(r) for r in args[2:]] or list(range(16))
    sigma = float(keys.get("noise", 0.0))
    seeds = int(keys.get("seeds", 4))
    torch.set_num_threads(1)
    jopts = apply_overrides(TrajectoryBuilder2DOptions(), {**OPTIONS, **MODES[mode]})
    # Without noise both packages run; with it, the JAX package once per seed.
    runs = ["jax", "port"] if sigma == 0.0 else [f"jax_noise_{k}" for k in range(seeds)]
    out = {}
    for r in robots:
        scans, truth = simulate_scans(scans_per_robot, beams=1024, seed=r, start=4.0 * r)
        gt = relative_to_first(truth)
        errors = {}
        for name in runs:
            if name == "port":
                b, cls = LocalTrajectoryBuilder2D(
                    options_from_dict(dataclasses.asdict(jopts)), ["laser"], device="cpu",
                    permutation_fn=_jax_permutation), TimedPointCloudData
            else:
                b, cls = JBuilder(jopts, ["laser"]), JScan
            rng = np.random.RandomState(1000 + int(name.rsplit("_", 1)[-1])) if sigma else None
            errors[name] = []
            for (ts, pts, rel), g in zip(scans, gt):
                res = b.add_range_data("laser", cls(
                    time=int(round(ts * 1e6)), origin=np.zeros(3, np.float32),
                    ranges=_noisy(pts, sigma, rng) if sigma else pts, times=rel))
                errors[name].append(float(np.linalg.norm(
                    np.asarray(res.local_pose_translation)[:2] - g[:2])))
        out[r] = {k: [float(np.mean(v)), float(np.max(v))] for k, v in errors.items()}
        print(json.dumps({"robot": r, "mean_max_error_m": out[r]}), flush=True)
    print(json.dumps({"mode": mode, "scans_per_robot": scans_per_robot, "noise": sigma,
                      "robots": out}))


if __name__ == "__main__":
    main()
