"""The JAX package's 3D frontend beside the port's plain path on the CPU,
at the full widths of `chip_smoke.py`'s full-frontend phase (16 rings x 256
azimuths of the half-scale hall with intensities, the default pools and
crops, the correlative search and the intensity term on), over its scans:
each package's position and yaw error against the ground truth.

It is the second witness for that phase's yaw limit: the search picks
rotations a step apart and the LM's rotation penalty holds its choice, so
the yaw lags the turning robot, in the reference as in the port.

One change from the smoke's options, which leaves both packages' results
as they are: `max_range` is 20 m, not 60 m. The hall's returns reach
14.75 m, so the same returns are kept; the JAX search scores a static grid
of rotations sized from `max_range` and masks those outside the window,
and at a 20 m range that grid (7^3) still holds every rotation inside the
window (at most 5^3 at these ranges), where 60 m gives 21^3: the same
candidates, in the same order, at a 27th of the work on the CPU.

Run from the repository root (the phase's 400 scans by default: about 12
minutes and 3 GB of memory on a CPU):

    JAX_PLATFORMS=cpu python tests/hall_yaw_witness_3d.py [num_scans] [seed] [PERMS.npy]

`seed` (default 0, the smoke's first run) draws the scans' noise and
intensities; the path is the same for every seed. It prints one JSON object. The two packages part at the search's near-ties
within the first scans, so each is a different path through the same
scans.

With `PERMS.npy` (the voxel-filter permutations of seeds 1..450 for 4,096
points, as `tests/hall_yaw_card_witness_3d.py card-permutations` writes the
card's own) only the port's plain path runs, with those permutations: the
card's inputs on the CPU. Its poses [x, y, z, yaw] go to
`cpu_est_seed<seed>.npy` beside PERMS.npy; where the card's of the same
seed lie there (`card_est_seed<seed>.npy`, from that script's `card` mode),
it also reports the first scan at which the two part.
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

from cartographer_tpu.core.config import TrajectoryBuilder3DOptions as JOptions  # noqa: E402
from cartographer_tpu.core.config import apply_overrides  # noqa: E402
from cartographer_tpu.mapping.local_trajectory_builder_3d import (  # noqa: E402
    LocalTrajectoryBuilder3D as JBuilder,
)
from cartographer_tpu.sensor.data import ImuData as JImuData  # noqa: E402
from cartographer_tpu.sensor.data import TimedPointCloudData as JScan  # noqa: E402
from cartographer_tpu_torch.core.time import from_seconds  # noqa: E402
from cartographer_tpu_torch.interop import options_3d_from_dict  # noqa: E402
from cartographer_tpu_torch.mapping.local_trajectory_builder_3d import (  # noqa: E402
    LocalTrajectoryBuilder3D,
)
from cartographer_tpu_torch.sensor.data import ImuData, TimedPointCloudData  # noqa: E402
from cartographer_tpu_torch.simulation import relative_to_first, simulate_scans_3d  # noqa: E402
from cartographer_tpu_torch.transform import nquat  # noqa: E402

T0 = 1_000_000_000
SMOKE_SCANS = 431  # what chip_smoke.py simulates for the phase (400 + 30 profiled + 1)
OPTIONS = {"use_online_correlative_scan_matching": True, "use_intensities": True,
           "max_range": 20.0}


def _jax_permutation(seed, n):
    return np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))


def _parting(card: np.ndarray, cpu: np.ndarray) -> dict:
    """Where the card's poses part from the plain path's: the first scan
    beyond 1 mm or 1e-4 rad, and each one's yaw steps there."""
    pos = np.linalg.norm(card[:, :3] - cpu[:, :3], axis=1)
    yaw = np.abs((card[:, 3] - cpu[:, 3] + np.pi) % (2 * np.pi) - np.pi)
    apart = np.nonzero((pos > 1e-3) | (yaw > 1e-4))[0]
    out = dict(largest_difference=[float(pos.max()), float(yaw.max())],
               first_parting_scan=int(apart[0]) if len(apart) else None)
    if len(apart) and apart[0] > 0:
        i = int(apart[0])
        out.update(difference_there=[float(pos[i]), float(yaw[i])],
                   yaw_step_there_card=float(card[i, 3] - card[i - 1, 3]),
                   yaw_step_there_cpu=float(cpu[i, 3] - cpu[i - 1, 3]),
                   largest_difference_before=[float(pos[:i].max()), float(yaw[:i].max())])
    return out


def main(num: int, seed: int = 0, perms_path: str = "") -> dict:
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    jopts = apply_overrides(JOptions(), OPTIONS)
    scans, imu, truth = simulate_scans_3d(SMOKE_SCANS, seed=seed, intensities=True)
    scans, gt = scans[:num], relative_to_first(truth)[:num]
    largest = max(float(np.linalg.norm(s[1], axis=1).max()) for s in scans)
    assert largest <= OPTIONS["max_range"], largest
    permutation_fn = _jax_permutation
    if perms_path:
        perms = np.load(perms_path)
        permutation_fn = lambda s, n: perms[s - 1][:n]  # noqa: E731
    builders = {} if perms_path else {"jax": (JBuilder(jopts, ["points"]), JImuData, JScan)}
    builders["port_plain"] = (LocalTrajectoryBuilder3D(
        options_3d_from_dict(dataclasses.asdict(jopts)), ["points"], device="cpu",
        permutation_fn=permutation_fn), ImuData, TimedPointCloudData)
    out = {"scans": num, "seed": seed, "largest_range_m": largest, "permutations": perms_path}
    poses = {}
    for name, (b, imu_data, cloud) in builders.items():
        t0, k, est = time.monotonic(), 0, []
        for ts, pts, rel, intens in scans:
            while k < len(imu) and imu[k][0] <= ts:
                b.add_imu_data(imu_data(time=T0 + from_seconds(imu[k][0]),
                                        linear_acceleration=imu[k][1],
                                        angular_velocity=imu[k][2]))
                k += 1
            r = b.add_range_data("points", cloud(
                time=T0 + from_seconds(ts), origin=np.zeros(3, np.float32), ranges=pts,
                times=rel, intensities=intens))
            est.append([*r.local_pose_translation,
                        nquat.get_yaw(np.asarray(r.local_pose_rotation, np.float64))])
        est = np.asarray(est)
        poses[name] = est
        offset = np.concatenate([est[:, :2] - gt[:, :2], est[:, 2:3]], 1)
        yaw = np.abs((est[:, 3] - gt[:, 2] + np.pi) % (2 * np.pi) - np.pi)
        errors = np.linalg.norm(offset, axis=1)
        out[name] = dict(
            mean_error_m=float(errors.mean()), max_error_m=float(errors.max()),
            mean_yaw_error_rad=float(yaw.mean()), max_yaw_error_rad=float(yaw.max()),
            yaw_error_by_20_scans_rad=[float(yaw[i:i + 20].mean())
                                       for i in range(0, num, 20)],
            seconds=time.monotonic() - t0)
        print(name, json.dumps(out[name]), flush=True)
    if not perms_path:
        d = poses["jax"] - poses["port_plain"]
        out["largest_difference"] = [float(np.abs(d[:, :3]).max()),
                                     float(np.abs(d[:, 3]).max())]
    else:
        folder = os.path.dirname(perms_path) or "."
        np.save(os.path.join(folder, f"cpu_est_seed{seed}.npy"), poses["port_plain"])
        card_path = os.path.join(folder, f"card_est_seed{seed}.npy")
        if os.path.exists(card_path):
            out["card"] = _parting(np.load(card_path)[:num], poses["port_plain"])
    out["max_rss_gb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    return out


if __name__ == "__main__":
    print(json.dumps(main(int(sys.argv[1]) if len(sys.argv) > 1 else 400,
                          int(sys.argv[2]) if len(sys.argv) > 2 else 0,
                          sys.argv[3] if len(sys.argv) > 3 else "")))
