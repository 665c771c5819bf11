"""CPU witness for the scan-match phase of chip_smoke.py (not collected by
pytest).

    JAX_PLATFORMS=cpu python tests/scan_match_witness_3d.py [azimuths] [modes...]

Writes the smoke's two full-width scans of the simulated hall
(`simulation.simulate_scan_pair_3d`, 16 rings x `azimuths` returns, default
1,800: 28,800 returns, padded to 32,768 by the CLI) as binary PCD files, runs
the JAX package's `io/scan_match_main.run` and the port's on its plain path
(`device="cpu"`) for each mode (default `icp ceres gicp ndt:1.0 ndt:0.3`; a
mode written `mode:resolution` runs at that `resolution`, else at the CLI's
0.3 m), and prints one JSON object: each package's pose, its error against the simulator's truth
(translation in metres, rotation angle in radians), the two packages'
difference and the wall seconds. chip_smoke.py holds the card to the JAX
results recorded from this script (`SCAN_MATCH_WITNESS`).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def write_binary_pcd(path, points):
    points = np.ascontiguousarray(points, np.float32)
    n = len(points)
    header = ("VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
              f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA binary\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii") + points.tobytes())


def rotation_matrix(aa):
    aa = np.asarray(aa, np.float64)
    angle = np.linalg.norm(aa)
    if angle < 1e-12:
        return np.eye(3)
    k = aa / angle
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def pose_error(result, translation, yaw):
    """(translation error [m], rotation error [rad]) of a CLI result."""
    c, s = np.cos(yaw), np.sin(yaw)
    R_true = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    R = rotation_matrix(result["rotation_axis_angle"])
    cos_angle = np.clip((np.trace(R_true.T @ R) - 1.0) / 2.0, -1.0, 1.0)
    return (float(np.linalg.norm(np.asarray(result["translation"]) - translation)),
            float(np.arccos(cos_angle)))


def difference(a, b):
    """(translation [m], rotation [rad]) between two CLI results."""
    Ra, Rb = rotation_matrix(a["rotation_axis_angle"]), rotation_matrix(b["rotation_axis_angle"])
    cos_angle = np.clip((np.trace(Ra.T @ Rb) - 1.0) / 2.0, -1.0, 1.0)
    return (float(np.linalg.norm(np.subtract(a["translation"], b["translation"]))),
            float(np.arccos(cos_angle)))


def main(argv):
    azimuths = int(argv[1]) if len(argv) > 1 else 1800
    modes = argv[2:] or ["icp", "ceres", "gicp", "ndt:1.0", "ndt:0.3"]
    import torch

    from cartographer_tpu.io.scan_match_main import run as jax_run
    from cartographer_tpu_torch.io.scan_match_main import run as port_run
    from cartographer_tpu_torch.simulation import simulate_scan_pair_3d

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    source, target, translation, yaw = simulate_scan_pair_3d(azimuths=azimuths)
    out = {"returns": len(source), "true_translation": translation.tolist(), "true_yaw": yaw,
           "modes": {}}
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, name) for name in ("source.pcd", "target.pcd")]
        write_binary_pcd(paths[0], source)
        write_binary_pcd(paths[1], target)
        args = dict(init=[0, 0, 0, 0, 0, 0], max_iterations=30, resolution=0.3,
                    max_correspondence_distance=1.0)
        for spec in modes:
            mode, _, resolution = spec.partition(":")
            row = {}
            for name, run in (("jax", jax_run), ("port_plain", lambda *a, **k: port_run(
                    *a, **k, device="cpu"))):
                t0 = time.monotonic()
                result = run(*paths, mode=mode,
                             **dict(args, resolution=float(resolution or args["resolution"])))
                row[name] = {**result, "wall_seconds": time.monotonic() - t0,
                             "error_against_truth": pose_error(result, translation, yaw)}
                print(f"{spec} {name}: {json.dumps(row[name])}", flush=True)
            row["difference"] = difference(row["jax"], row["port_plain"])
            out["modes"][spec] = row
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
