"""Device times of the 2D step's kernels for one robot, K1-K5, K20 and K21,
at the main path's shapes (the default 2D options: 2,048-point scans,
1,024^2 grids), through the wrappers both the robot-batched port and its
parent have (not collected by pytest).

    python tests/robot_batch_timing.py LABEL [TREE]
    python tests/robot_batch_timing.py tsdf-robots

Times each kernel's wrapper over 200 calls with `chip_smoke._cuda_ms` (the
profiler) and `chip_smoke._event_ms` (CUDA events) on the card and prints
LABEL and one JSON object of [profiler ms, event ms] per kernel. TREE
(default: the current directory) is the root of the checkout whose package
and `chip_smoke.py` are used, so one script times two commits: unpack the
parent with `git archive` and run, in one call on the card, parent,
change, change, parent.

`tsdf-robots` times the robot-batched K20 and K21 at `bench.py`'s shape
(1,024-beam scans of R robots, 512^2 grids at 5 cm, two slots) at R = 1, 4
and 16, and prints one JSON object.
"""

import json
import os
import sys

TREE = os.path.abspath(sys.argv[2] if len(sys.argv) > 2 else ".")
sys.path[:0] = [TREE]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from cartographer_tpu_torch.core.config import TrajectoryBuilder2DOptions  # noqa: E402
from cartographer_tpu_torch.ops import (  # noqa: E402
    correlative_2d,
    cuda,
    grid_2d,
    scan_matcher_2d,
    scan_pipeline_2d,
    tsdf_2d,
)
from cartographer_tpu_torch.ops.grid_2d import Grid2D  # noqa: E402
from cartographer_tpu_torch.sensor import voxel_filter  # noqa: E402
from cartographer_tpu_torch.sensor.point_cloud import PointCloud, RangeData  # noqa: E402
from cartographer_tpu_torch.simulation import simulate_scans  # noqa: E402
from cartographer_tpu_torch.transform.rigid import Rigid3  # noqa: E402


def main(label):
    cuda.build()
    dev = torch.device("cuda:0")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    opts = TrajectoryBuilder2DOptions()
    n, size, samples = opts.tpu.scan_capacity, opts.tpu.submap_grid_size, opts.tpu.ray_samples
    scans, _ = simulate_scans(12, seed=1)
    _, pts, rel = scans[-1]
    points = np.zeros((n, 3), np.float32)
    points[:len(pts)] = pts
    times01 = np.zeros(n, np.float32)
    times01[:len(pts)] = (rel - rel.min()) / (rel.max() - rel.min())
    mask = np.zeros(n, bool)
    mask[:len(pts)] = True
    q = np.float32([np.cos(0.1), 0.0, 0.0, np.sin(0.1)])
    pre = scan_pipeline_2d.ScanPreprocessParams2D()
    a1 = (t(points), t(times01), t(mask), t(np.zeros((n, 3), np.float32)),
          Rigid3(t(np.float32([0.3, -0.2, 0.0])), t(np.float32([1, 0, 0, 0]))),
          Rigid3(t(np.float32([0.5, -0.1, 0.0])), t(q)), t(np.float32([1, 0, 0, 0])), pre)
    hits, _, is_return, _, origin = scan_pipeline_2d.align_scan(*a1)
    perm = torch.randperm(n, generator=torch.Generator(device=dev).manual_seed(3), device=dev,
                          dtype=torch.int32)
    keep = voxel_filter.voxel_filter_mask(hits, is_return, pre.voxel_filter_size, perm)
    returns = PointCloud(hits[:, 0:2].contiguous(), keep, torch.zeros(n, device=dev))
    filters = [(f.max_length, f.min_num_points, f.max_range)
               for f in (opts.adaptive_voxel_filter, opts.loop_closure_adaptive_voxel_filter)]

    def k2():  # a scan's filters, as the tree's step launches them
        m = voxel_filter.voxel_filter_mask(hits, is_return, pre.voxel_filter_size, perm)
        if hasattr(voxel_filter, "adaptive_voxel_filter_masks"):
            voxel_filter.adaptive_voxel_filter_masks(hits[:, 0:2], m, filters, perm)
        else:
            c = PointCloud(hits[:, 0:2], m, returns.intensities)
            for length, num, max_range in filters:
                voxel_filter.adaptive_voxel_filter(c, length, num, max_range, perm)

    rd = RangeData(origin[0:2], returns,
                   PointCloud(t(np.zeros((n, 2), np.float32)), t(np.zeros(n, bool)),
                              returns.intensities))
    grids = Grid2D(torch.zeros((2, size, size), device=dev),
                   torch.zeros((2, size, size), dtype=torch.bool, device=dev),
                   t(np.float32([[-25.6, -25.6], [-24.0, -25.0]])), 0.05)
    active = t(np.array([True, True]))
    yes = torch.ones((), dtype=torch.bool, device=dev)
    scratch = grid_2d.InsertScratch.create(2, size, dev)
    a4 = (grids, rd, active, yes, 0.55, 0.49, True, samples, scratch)
    grid_2d.insert_into_slots(*a4)
    cloud = voxel_filter.adaptive_voxel_filter(returns, *filters[0], perm).compact(
        opts.tpu.matcher_capacity)
    x0 = t(np.float32([0.33, 0.02, 0.01]))
    gn = opts.ceres_scan_matcher
    a3 = (grids.slot(0), cloud.points, cloud.mask, x0, x0[0:2],
          scan_matcher_2d.GaussNewtonMatcherParams2D(
              gn.occupied_space_weight, gn.translation_weight, gn.rotation_weight,
              gn.max_num_iterations, gn.use_nonmonotonic_steps))
    corr = opts.real_time_correlative_scan_matcher
    a5 = (grids.slot(0), cloud.points, cloud.mask, x0, correlative_2d.CorrelativeSearchParams(
        corr.linear_search_window, corr.angular_search_window,
        corr.translation_delta_cost_weight, corr.rotation_delta_cost_weight, opts.max_range))
    tsdf = tsdf_2d.TsdfGrid2D(torch.zeros((2, size, size), device=dev),
                              torch.zeros((2, size, size), device=dev), grids.origin, 0.05)
    normals = tsdf_2d.estimate_normals_2d(returns.points, returns.mask, rd.origin)
    tparams = tsdf_2d.TsdfInserterParams()
    extra = {}
    if hasattr(tsdf_2d, "TsdfInsertScratch"):  # the parent's sums and lists
        extra["scratch"] = tsdf_2d.TsdfInsertScratch.create(2, size, n, dev)
    calls = {
        "K1 scan_preprocess_2d": lambda: scan_pipeline_2d.align_scan(*a1),
        "K2 voxel_filter (a scan's filters)": k2,
        "K3 scan_matcher_2d": lambda: scan_matcher_2d.lm_match_2d(*a3),
        "K4 insert_2d": lambda: grid_2d.insert_into_slots(*a4),
        "K5 correlative_2d": lambda: correlative_2d.real_time_correlative_match(*a5),
        "K20 tsdf_normals_2d": lambda: tsdf_2d.estimate_normals_2d(
            returns.points, returns.mask, rd.origin),
        "K21 tsdf_insert_2d": lambda: tsdf_2d.insert_into_slots_tsdf(
            tsdf, rd, active, yes, tparams, normals=normals, **extra),
    }
    out = {name: [cs._cuda_ms(fn, reps=200), cs._event_ms(fn, reps=200)]
           for name, fn in calls.items()}
    print(label, json.dumps(out), flush=True)


def tsdf_robots():
    """K20 and K21 for R robots at bench.py's shape."""
    from cartographer_tpu_torch.simulation import simulate_scans as scans_of

    cuda.build()
    dev = torch.device("cuda:0")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    n, size = 1024, 512
    pts, masks, grids = [], [], []
    for r in range(16):
        scans, _ = scans_of(12, beams=n, seed=r, start=4.0 * r)
        p = scans[-1][1][:, 0:2]
        pts.append(p)
        masks.append(np.linalg.norm(p, axis=1) <= 30.0)
        grids.append(tsdf_2d.TsdfGrid2D(
            torch.zeros((2, size, size), device=dev), torch.zeros((2, size, size), device=dev),
            t(np.float32([[-12.8, -12.8], [-12.0, -12.5]])), 0.05))
    params = tsdf_2d.TsdfInserterParams()
    out = {"card": cs._smi()}
    for robots in (1, 4, 16):
        points = t(np.stack(pts[:robots]).astype(np.float32))
        mask = t(np.stack(masks[:robots]))
        origin = torch.zeros((robots, 2), device=dev)
        none = PointCloud(torch.zeros_like(points), torch.zeros_like(mask),
                          torch.zeros(mask.shape, device=dev))
        rd = RangeData(origin, PointCloud(points, mask, torch.zeros(mask.shape, device=dev)),
                       none)
        active = torch.ones((robots, 2), dtype=torch.bool, device=dev)
        yes = torch.ones(robots, dtype=torch.bool, device=dev)
        normals = tsdf_2d.estimate_normals_2d(points, mask, origin)
        calls = {"K20": lambda: tsdf_2d.estimate_normals_2d(points, mask, origin),
                 "K21": lambda: tsdf_2d.insert_into_slots_tsdf(
                     grids[:robots], rd, active, yes, params, normals=normals)}
        out[robots] = {k: [cs._cuda_ms(fn, reps=200), cs._event_ms(fn, reps=200)]
                       for k, fn in calls.items()}
    print("tsdf-robots", json.dumps(out), flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "tsdf-robots":
        tsdf_robots()
    else:
        main(sys.argv[1])
