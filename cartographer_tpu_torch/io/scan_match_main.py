"""Offline scan-matching testbed CLI of the PyTorch port.

Counterpart of the JAX package's `io/scan_match_main.py` (the fork's
io/wangtest_main.cc and its scanmatch_mode dispatch): match two point
clouds read from PCD files with a selectable matcher, configured from the
flags or a yaml file (testcfg.yaml style), and print the result as one JSON
object, the JAX CLI's.

- `icp`: point-to-point ICP (`ops/icp.py`, kernels K23 and K24);
- `gicp`: point-to-plane ICP against the target's normals (`ops/icp.py`,
  kernels K26 for the normals, K23 and K27 for each of the
  `max_iterations // 5` rounds, K24's stats);
- `ndt`: the target's per-voxel Gaussians on a 32^3 grid of cells of
  `resolution` around its masked mean (K28), then one LM solve of the
  source on them (K29). The CLI's default `resolution` of 0.3 m is the
  `ceres` grid's: its 9.6 m cube leaves NDT at the start pose on a scan of a
  hall, in the JAX package as here; 1.0 m is `NdtParams`' own default;
- `ceres`: the target inserted four times into a 128^3 grid at
  `resolution` and a 64^3 grid at 3 x `resolution` around its centroid
  (`ops/grid_3d.py`, K25), then the source refined on them by the 3D
  Gauss-Newton matcher (`ops/scan_matcher_3d.py`, K11).

Both clouds are padded with masked zeros to the next power of two. The work
runs on the card unless `--device cpu` asks for the plain PyTorch path.

Usage:
  python -m cartographer_tpu_torch.io.scan_match_main --source a.pcd --target b.pcd --mode icp
  python -m cartographer_tpu_torch.io.scan_match_main --config testcfg.yaml --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

MODES = ("ceres", "icp", "gicp", "ndt")


def run(source_path: str, target_path: str, mode: str, init: list, max_iterations: int,
        resolution: float, max_correspondence_distance: float, device="cuda") -> dict:
    from cartographer_tpu_torch.io.pcd import read_pcd
    from cartographer_tpu_torch.ops.grid_3d import Grid3D, insert_range_data_3d
    from cartographer_tpu_torch.ops.icp import (
        IcpParams,
        NdtParams,
        gicp_match,
        icp_match,
        ndt_match,
    )
    from cartographer_tpu_torch.ops.scan_matcher_3d import (
        GaussNewtonMatcherParams3D,
        gauss_newton_match_3d,
    )
    from cartographer_tpu_torch.transform import quaternion as quat
    from cartographer_tpu_torch.transform.rigid import Rigid3

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("scan_match: no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run the plain PyTorch path")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")

    source = read_pcd(source_path)
    target = read_pcd(target_path)
    cap = 1 << int(np.ceil(np.log2(max(len(source), len(target), 16))))

    def pad(pts):
        out = np.zeros((cap, 3), np.float32)
        out[: len(pts)] = pts[:cap]
        m = np.zeros(cap, bool)
        m[: len(pts)] = True
        return torch.from_numpy(out).to(dev), torch.from_numpy(m).to(dev)

    src, sm = pad(source)
    tgt, tm = pad(target)
    initial = Rigid3(torch.tensor(init[:3], dtype=torch.float32, device=dev),
                     quat.from_axis_angle(torch.tensor(init[3:6], dtype=torch.float32,
                                                       device=dev)))

    if mode in ("icp", "gicp"):
        match = icp_match if mode == "icp" else gicp_match
        pose, fitness, rmse = match(
            src, sm, tgt, tm, initial,
            IcpParams(max_iterations=max_iterations,
                      max_correspondence_distance=max_correspondence_distance))
        extras = {"fitness": float(fitness), "rmse": float(rmse)}
    elif mode == "ndt":
        pose, cost = ndt_match(src, sm, tgt, tm, initial,
                               NdtParams(resolution=resolution, max_iterations=max_iterations))
        extras = {"cost": float(cost)}
    else:
        # Grid-based Gauss-Newton: the target rasterized into an occupancy
        # grid pair, the source refined on it (the fork's scanmatch_mode 1).
        center = target.mean(0)
        high = Grid3D.create(128, resolution, center, dev)
        low = Grid3D.create(64, resolution * 3, center, dev)
        origin = torch.from_numpy(np.asarray(center, np.float32)).to(dev)
        for _ in range(4):
            high = insert_range_data_3d(high, origin, tgt, tm)
            low = insert_range_data_3d(low, origin, tgt, tm)
        pose, cost = gauss_newton_match_3d(
            high, low, src, sm, src, sm, initial,
            GaussNewtonMatcherParams3D(num_iterations=max_iterations, translation_weight=0.1,
                                       rotation_weight=1.0))
        extras = {"cost": float(cost)}

    aa = quat.to_axis_angle(pose.rotation).cpu().numpy()
    return {
        "mode": mode,
        "translation": [float(x) for x in pose.translation.cpu().numpy()],
        "rotation_axis_angle": [float(x) for x in aa],
        **extras,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="scan_match")
    parser.add_argument("--config", help="yaml config (testcfg.yaml style)")
    parser.add_argument("--source")
    parser.add_argument("--target")
    parser.add_argument("--mode", default="icp", choices=list(MODES))
    parser.add_argument("--max_iterations", type=int, default=30)
    parser.add_argument("--resolution", type=float, default=0.3)
    parser.add_argument("--max_correspondence_distance", type=float, default=1.0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default: the hand-written kernels) or cpu (the plain "
                             "PyTorch path)")
    args = parser.parse_args(argv)

    cfg = {}
    if args.config:
        import yaml

        with open(args.config) as f:
            cfg = yaml.safe_load(f) or {}
    source = cfg.get("source", args.source)
    target = cfg.get("target", args.target)
    if not source or not target:
        parser.error("--source/--target (or config entries) required")
    result = run(
        source, target,
        mode=cfg.get("mode", args.mode),
        init=cfg.get("init", [0, 0, 0, 0, 0, 0]),
        max_iterations=cfg.get("max_iterations", args.max_iterations),
        resolution=cfg.get("resolution", args.resolution),
        max_correspondence_distance=cfg.get(
            "max_correspondence_distance", args.max_correspondence_distance),
        device=args.device)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
