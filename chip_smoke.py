#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `cartographer_tpu_torch/csrc/` and runs,
on the card, at full width (the reference's default 2D and 3D options):

1. the frontend kernels K1-K4, each against its plain PyTorch twin;
2. `LocalTrajectoryBuilder2D` with the online correlative matcher on over
   420 simulated scans of a multi-room floor plan: K1-K5 launched, one
   blocking device-to-host copy per scan, agreement with the plain path on
   the CPU, accuracy against ground truth, finished submaps;
3. the backend kernels K5-K8 against their twins, on that run's finished
   submap and node clouds and on a full-width synthetic pose graph;
4. global SLAM through `MapBuilder` over three laps of the floor plan
   (default pose-graph options, background searches): K1-K8 launched, at
   least 100 loop closures and 3 solves, optimized poses within 0.25 m of
   the truth and no worse than the frontend's; the first loop-closure pairs
   again on the CPU's plain path; one certified global localization;
5. the 3D frontend, `LocalTrajectoryBuilder3D`, over 400 simulated scans of
   a 16-ring sensor with an IMU in the same floor plan extruded to a hall
   (paged submaps, dense crops of 256^3 and 192^3 per scan): K2 and K9-K12
   launched, one blocking copy per scan, accuracy against ground truth, one
   finished submap with its dense crops, the first scans again on the
   CPU's plain path;
6. the 3D kernels K9-K12, each against its plain twin, on that run's pools,
   windows and clouds;
7. 3D global SLAM through `MapBuilder(use_trajectory_builder_3d=True)` at
   the default options over 700 scans of that hall (three laps; background
   searches and solves): K2 and K9-K16 launched, at least 50 loop closures
   and 3 solves, optimized poses no worse than the frontend's plus 0.02 m,
   and one certified global localization of a third-lap node against the
   first submap with its yaw unknown;
8. the 3D backend kernels K13-K16, each against its plain twin, on that
   run's state (its node, finished submap and a local pair) and on a
   synthetic SE(3) pose graph with IMU terms at the solver's capacity;
9. the 3D frontend once more over the hall at full size with the robot's
   heading along the walls, where the LM-only matcher tracks worst: its
   error and its page count are reported, not limited;
10. the 3D frontend at its full options (the online correlative search,
    intensities) over 400 scans of the half-scale hall with intensities:
    K2 and K9-K12 and K17-K19 launched (K17 and K11 once per scan, K19
    once per scan after the first, K18 once per active submap and inserted
    scan), one blocking copy per scan, accuracy against ground truth (0.25
    m; a mean yaw error of 0.03 rad, above the JAX builder's and the plain
    path's on the CPU), the first scans again on the CPU's plain path;
11. K17, K18, K19 and K11 with its intensity rows, each against its plain
    twin, on that run's pools, windows and clouds;
12. the full-size hall of phase 9 with the correlative search on (error and
    pages reported, not limited);
13. 200 scans of the half-scale hall with the IMU-based extrapolator (a
    1 s pose queue) and intensities: error reported, the first scans again
    on the CPU's plain path; then 70 scans with the default 5 s queue, its
    host cost read once the queue is full;
14. the 2D frontend of phase 2 on TSDF submaps (`submaps.grid_type =
    "TSDF"`, the TSDF inserter at its defaults): K1, K2, K20, K21, K22 and
    K5's TSDF form launched, one blocking copy per scan, accuracy against
    ground truth, the first scans again on the CPU's plain path;
15. K20, K21, K22 and the TSDF forms of K3, K5 and K6, each against its
    plain twin, on that run's state;
16. global SLAM through `MapBuilder` on TSDF submaps over the three laps of
    phase 4: loop closures, solves, optimized poses no worse than the
    frontend's; the first pairs again on the CPU's plain path;
17. the 3D frontend at the default options plus intensities with a
    16-ring x 1024-azimuth sensor (`tpu.scan_capacity` 16,384, above K2's
    and K18's one-block sizes) over 100 scans, the first 20 again on the
    CPU's plain path, K2 and K18 at that size against their twins.
Phase 10 also runs the scans of two more seeds and reports their yaw error.

Prints a `kernels` JSON line, a timing JSON line, the card's name and power
limit, and as its last line `{"ok": true, "device": {...}}`. Any failed
check raises, so the exit code is non-zero. Without a CUDA device, or
outside the repository, it exits non-zero before printing a result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
NUM_SCANS = 420
CPU_SCANS = 50
PROFILED_SCANS = 30
GLOBAL_SCANS = 900  # three laps of the floor plan's path
CPU_PAIRS = 3
REFINE_EVERY = 150  # the TSDF global run's loop-closure refines held against the twin
NUM_SCANS_3D = 400  # one submap finishes at 320 insertions
CPU_SCANS_3D = 20
TIME_OFFSET_US = 10_000_000  # the simulated IMU starts before t = 0
KERNELS_2D = ("scan_preprocess_2d", "voxel_filter", "scan_matcher_2d", "insert_2d",
              "correlative_2d", "bnb_pyramid", "bnb_score", "schur_spa_2d")
KERNELS_3D = ("voxel_filter", "paged_insert_3d", "paged_crop_3d", "scan_matcher_3d",
              "rot_histogram", "rot_histogram_rotate")
GLOBAL_SCANS_3D = 700  # three laps of the half-scale hall
NUM_SCANS_IMU = 200
IMU_DEFAULT_QUEUE_SCANS = 70  # the 5 s queue fills at scan 50
FULL_FRONTEND_YAW_LIMIT = 0.03  # rad, mean over the 400 scans (see _slice_phase_3d_full)
FULL_FRONTEND_KERNELS = KERNELS_3D + ("correlative_3d", "paged_intensity_insert_3d",
                                      "paged_intensity_crop_3d")
KERNELS_3D_GLOBAL = KERNELS_3D + ("rot_match", "bnb3d_stack", "bnb3d_discretize",
                                  "bnb3d_score", "schur_spa_3d")
YAW_SEEDS = (1, 2)  # the full frontend's phase again over these seeds' scans
TSDF_FRONTEND_KERNELS = ("scan_preprocess_2d", "voxel_filter", "correlative_2d_tsdf",
                         "lm_match_tsdf_2d", "tsdf_normals_2d", "tsdf_insert_2d")
TSDF_KERNELS = TSDF_FRONTEND_KERNELS + ("bnb_pyramid_tsdf", "bnb_score",
                                        "scan_matcher_2d_tsdf", "schur_spa_2d")
TSDF_ERROR_LIMIT = 0.25  # m, the TSDF frontend's mean error (see PERF.md, PR 6)
TSDF_GLOBAL_LIMITS = (100, 3, 0.25)  # loop closures, solves, optimized mean error [m]
LARGE_SCAN_CAPACITY = 16384  # 16 rings x 1024 azimuths
LARGE_SCANS_3D = 100


def _fail(msg):
    raise AssertionError(msg)


def _cuda_ms(fn, reps=30, warmup=3):
    """Device milliseconds per call of fn(): the GPU activity (kernels and
    copies) the profiler records, or, where it records none, the median
    time between two CUDA events around the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device_ms = sum(_device_us(e) for e in prof.key_averages()) / 1e3 / reps
    if device_ms > 0:
        return device_ms
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_us(event):
    """Self device time of a profiler event; 0 for host-side events."""
    if not str(getattr(event, "device_type", "")).endswith("CUDA"):
        return 0.0
    us = getattr(event, "self_device_time_total", None)
    return getattr(event, "self_cuda_time_total", 0.0) if us is None else us


def _bound(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not measured"


def _kernel_phase(torch, dev):
    """Each kernel against its plain twin on the card, at main-path shapes."""
    from cartographer_tpu_torch.core.config import TrajectoryBuilder2DOptions
    from cartographer_tpu_torch.ops import grid_2d, scan_matcher_2d, scan_pipeline_2d
    from cartographer_tpu_torch.ops.grid_2d import Grid2D
    from cartographer_tpu_torch.ops.probability import probability_to_log_odds
    from cartographer_tpu_torch.sensor import voxel_filter
    from cartographer_tpu_torch.sensor.point_cloud import PointCloud, RangeData
    from cartographer_tpu_torch.simulation import simulate_scans
    from cartographer_tpu_torch.transform.rigid import Rigid3

    opts = TrajectoryBuilder2DOptions()
    n, size, samples = opts.tpu.scan_capacity, opts.tpu.submap_grid_size, opts.tpu.ray_samples
    scans, _ = simulate_scans(12, seed=1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    rows = {}

    # K1: one simulated scan (1081 beams padded to 2048), random poses.
    _, pts, rel = scans[-1]
    points = np.zeros((n, 3), np.float32)
    points[:len(pts)] = pts
    times01 = np.zeros(n, np.float32)
    times01[:len(pts)] = (rel - rel.min()) / (rel.max() - rel.min())
    mask = np.zeros(n, bool)
    mask[:len(pts)] = True
    origins = np.zeros((n, 3), np.float32)

    def quat(yaw, tilt):
        q = np.array([np.cos(yaw / 2), tilt, -tilt, np.sin(yaw / 2)])
        return (q / np.linalg.norm(q)).astype(np.float32)

    ps = Rigid3(t(np.float32([0.3, -0.2, 0.0])), t(quat(0.2, 0.0)))
    pe = Rigid3(t(np.float32([0.5, -0.1, 0.0])), t(quat(0.25, 0.0)))
    gravity = t(quat(0.0, 0.002))
    pre = scan_pipeline_2d.ScanPreprocessParams2D()
    args = (t(points), t(times01), t(mask), t(origins), ps, pe, gravity, pre)
    got = scan_pipeline_2d.align_scan(*args)
    ref = scan_pipeline_2d.align_scan_plain(*args)
    err = max(float((got[k] - ref[k]).abs().max()) for k in (0, 1, 4))
    if err > 1e-5:
        _fail(f"K1 points differ by {err} m (tolerance 1e-5)")
    for k in (2, 3):
        if not torch.equal(got[k], ref[k]):
            _fail("K1 masks differ from the plain twin")
    print(f"K1 scan_preprocess_2d: max |err| {err:.3g} m (tolerance 1e-5), masks equal")
    rows["scan_preprocess_2d"] = dict(
        replaces="cartographer_tpu/ops/scan_pipeline_2d.py:40", max_abs_err=err,
        ms=_cuda_ms(lambda: scan_pipeline_2d.align_scan(*args)),
        plain_ms=_cuda_ms(lambda: scan_pipeline_2d.align_scan_plain(*args)),
        bound=_bound(n * 51 + 18 * 4, n * 250), library_ms=None)

    # K2: the preprocess filter (3D keys) and both adaptive filters (2D).
    hits, is_return = got[0], got[2]
    perm = torch.randperm(n, generator=torch.Generator(device=dev).manual_seed(3),
                          device=dev, dtype=torch.int32)
    keep = voxel_filter.voxel_filter_mask(hits, is_return, pre.voxel_filter_size, perm)
    returns = PointCloud(hits[:, 0:2], keep, torch.zeros(n, device=dev))
    mism = int((keep != voxel_filter.voxel_filter_mask_plain(
        hits, is_return, pre.voxel_filter_size, perm)).sum())
    filters = (opts.adaptive_voxel_filter, opts.loop_closure_adaptive_voxel_filter)
    for f in filters:
        a = voxel_filter.adaptive_voxel_filter(returns, f.max_length, f.min_num_points,
                                               f.max_range, perm).mask
        b = voxel_filter.adaptive_voxel_filter_mask_plain(
            returns.points, returns.mask, f.max_length, f.min_num_points, f.max_range, perm)
        mism += int((a != (b & returns.mask)).sum())
    if mism:
        _fail(f"K2 masks differ from the plain twin in {mism} points (tolerance 0)")
    print("K2 voxel_filter: masks equal to the plain twin (tolerance: exact)")
    avf = filters[0]

    def k2_scan():  # the three launches of one scan
        m = voxel_filter.voxel_filter_mask(hits, is_return, pre.voxel_filter_size, perm)
        c = PointCloud(hits[:, 0:2], m, returns.intensities)
        for f in filters:
            voxel_filter.adaptive_voxel_filter(c, f.max_length, f.min_num_points, f.max_range,
                                               perm)

    def k2_plain():
        m = voxel_filter.voxel_filter_mask_plain(hits, is_return, pre.voxel_filter_size, perm)
        for f in filters:
            voxel_filter.adaptive_voxel_filter_mask_plain(hits[:, 0:2], m, f.max_length,
                                                          f.min_num_points, f.max_range, perm)

    # The hashing passes this scan's filters make (the adaptive search ends
    # early), for the operation count of the bound.
    passes = 1
    for f in filters:
        base = keep & (hits[:, 0:2].norm(dim=-1) <= f.max_range)
        if int(base.sum()) <= f.min_num_points:
            continue
        coarse = [int(voxel_filter.voxel_filter_mask_plain(
            hits[:, 0:2], base, f.max_length / 2 ** k, perm).sum()) >= f.min_num_points
            for k in range(7)]
        first = coarse.index(True) if any(coarse) else 7
        passes += min(first + 1, 7) + (5 if 0 < first < 7 else 0) + 1
    valid = int(keep.sum())
    key_sets = [voxel_filter._packed_voxel_keys(hits, is_return, pre.voxel_filter_size)] + [
        voxel_filter._packed_voxel_keys(hits[:, 0:2], keep, f.max_length) for f in filters]
    rows["voxel_filter"] = dict(
        replaces="cartographer_tpu/sensor/voxel_filter.py:67", max_abs_err=float(mism),
        ms=_cuda_ms(k2_scan), plain_ms=_cuda_ms(k2_plain, reps=5),
        bound=_bound(n * (12 + 1 + 4 + 1) + 2 * n * (8 + 1 + 4 + 1), passes * valid * 20),
        library_ms=_cuda_ms(lambda: [torch.unique(k) for k in key_sets]))

    # K4: a few scans into both slots of two full-size grids.
    grids = Grid2D(torch.zeros((2, size, size), device=dev),
                   torch.zeros((2, size, size), dtype=torch.bool, device=dev),
                   t(np.float32([[-25.6, -25.6], [-24.0, -25.0]])), 0.05)
    plain_grids = grids.clone()
    rd_list = []
    for k, (_, pts_k, _) in enumerate(scans[:4]):
        r = np.linalg.norm(pts_k[:, :2], axis=1)
        ret = np.zeros((n, 2), np.float32)
        ret[:len(pts_k)] = pts_k[:, :2] + np.float32([0.1 * k, 0.0])
        rmask = np.zeros(n, bool)
        rmask[:len(pts_k)] = r <= 30.0
        miss = np.zeros((n, 2), np.float32)
        miss[:len(pts_k)] = ret[:len(pts_k)] * (5.0 / np.maximum(r, 1e-6))[:, None]
        mmask = np.zeros(n, bool)
        mmask[:len(pts_k)] = r > 30.0
        rd_list.append(RangeData(t(np.float32([0.1 * k, 0.0])),
                                 PointCloud(t(ret), t(rmask), torch.zeros(n, device=dev)),
                                 PointCloud(t(miss), t(mmask), torch.zeros(n, device=dev))))
    active = t(np.array([True, True]))
    yes = torch.ones((), dtype=torch.bool, device=dev)
    ins = opts.submaps.probability_grid_range_data_inserter
    scratch = grid_2d.InsertScratch.create(2, size, dev)
    for rd in rd_list:
        grid_2d.insert_into_slots(grids, rd, active, yes, ins.hit_probability,
                                  ins.miss_probability, True, samples, scratch)
        grid_2d._insert_plain(plain_grids, rd, active, yes,
                              probability_to_log_odds(ins.hit_probability),
                              probability_to_log_odds(ins.miss_probability), True, samples)
    touched = int(plain_grids.known.sum())
    differ = int(((grids.log_odds - plain_grids.log_odds).abs() > 1e-6).sum()
                 + (grids.known != plain_grids.known).sum())
    err = float((grids.log_odds - plain_grids.log_odds).abs().max())
    if differ > 1e-3 * touched:
        _fail(f"K4 grids differ in {differ} of {touched} touched cells (tolerance 0.1%)")
    print(f"K4 insert_2d: {differ} of {touched} touched cells differ (tolerance 0.1%), "
          f"max |log-odds err| {err:.3g}")
    rd = rd_list[-1]
    # The cells this scan touches: in place, the function reads and writes
    # the log-odds and known of these cells only.
    fresh = Grid2D(torch.zeros_like(grids.log_odds), torch.zeros_like(grids.known),
                   grids.origin, grids.resolution)
    grid_2d._insert_plain(fresh, rd, active, yes, 0.0, 0.0, True, samples)
    scan_cells = int(fresh.known.sum())
    lin = []
    for slot in range(2):
        for pts_k, m, end in ((rd.returns.points, rd.returns.mask, False),
                              (rd.misses.points, rd.misses.mask, True)):
            kk = torch.arange(samples, device=dev, dtype=torch.float32)
            tt = (kk + 1.0 if end else kk) / samples
            s = rd.origin + tt[:, None, None] * (pts_k[m] - rd.origin)[None]
            if not end:  # and the hit cells
                s = torch.cat([s, pts_k[m][None]])
            c = torch.floor((s - grids.origin[slot]) / 0.05).long().reshape(-1, 2)
            c = c[((c >= 0) & (c < size)).all(-1)]
            lin.append(slot * size * size + c[:, 0] * size + c[:, 1])
    lin = torch.cat(lin)
    marks = torch.zeros(2 * size * size, dtype=torch.bool, device=dev)
    ones = torch.ones(lin.shape[0], dtype=torch.bool, device=dev)
    num_samples = 2 * samples * int(rd.returns.mask.sum() + rd.misses.mask.sum())
    rows["insert_2d"] = dict(
        replaces="cartographer_tpu/ops/grid_2d.py:105", max_abs_err=err,
        ms=_cuda_ms(lambda: grid_2d.insert_into_slots(
            grids, rd, active, yes, ins.hit_probability, ins.miss_probability, True,
            samples, scratch)),
        plain_ms=_cuda_ms(lambda: grid_2d._insert_plain(
            plain_grids, rd, active, yes, probability_to_log_odds(ins.hit_probability),
            probability_to_log_odds(ins.miss_probability), True, samples), reps=5),
        bound=_bound(scan_cells * 2 * (4 + 1) + n * 18, num_samples * 10 + scan_cells * 4),
        library_ms=_cuda_ms(lambda: marks.index_put_((lin,), ones)))

    # K3: the LM refine on slot 0 of those grids, 512 points of a scan.
    gn = opts.ceres_scan_matcher
    params = scan_matcher_2d.GaussNewtonMatcherParams2D(
        gn.occupied_space_weight, gn.translation_weight, gn.rotation_weight,
        gn.max_num_iterations, gn.use_nonmonotonic_steps)
    cloud = voxel_filter.adaptive_voxel_filter(rd.returns, avf.max_length, avf.min_num_points,
                                               avf.max_range, perm).compact(
        opts.tpu.matcher_capacity)
    grid0 = grids.slot(0)
    x0 = t(np.float32([0.33, 0.02, 0.01]))
    margs = (grid0, cloud.points, cloud.mask, x0, x0[0:2], params)
    xk, ck, itk = scan_matcher_2d.lm_match_2d(*margs)
    xp, cp, itp = scan_matcher_2d._match_plain(*margs)
    err = float((xk - xp).abs().max())
    rel_cost = abs(float(ck) - float(cp)) / max(abs(float(cp)), 1e-30)
    if err > 1e-4 or rel_cost > 1e-4:
        _fail(f"K3 pose differs by {err} (tolerance 1e-4), cost by {rel_cost} (rtol 1e-4)")
    iters, valid = int(itk), int(cloud.mask.sum())
    print(f"K3 scan_matcher_2d: max |pose err| {err:.3g} (tolerance 1e-4), cost rel err "
          f"{rel_cost:.3g} (rtol 1e-4), {iters} iterations (plain {int(itp)})")
    passes = 1 + 2 * iters
    rows["scan_matcher_2d"] = dict(
        replaces="cartographer_tpu/ops/scan_matcher_2d.py:70", max_abs_err=err,
        ms=_cuda_ms(lambda: scan_matcher_2d.lm_match_2d(*margs)),
        plain_ms=_cuda_ms(lambda: scan_matcher_2d._match_plain(*margs), reps=5),
        bound=_bound(valid * (8 + 1 + 16 * 5), passes * valid * 16 * 12), library_ms=None)
    return rows, dict(grid=grid0, cloud=cloud)


FRONTEND_KERNELS = ("scan_preprocess_2d", "voxel_filter", "scan_matcher_2d", "insert_2d",
                    "correlative_2d")


def _check_launched(launches, names, phase):
    for name in names:
        if launches.get(name, 0) == 0:
            _fail(f"kernel {name} was not launched in the {phase} phase")


def _frontend_options(grid_type="PROBABILITY_GRID"):
    """The default 2D options with the online correlative search on, no IMU,
    and the submaps' grid type (the TSDF inserter at its defaults)."""
    from cartographer_tpu_torch.core.config import TrajectoryBuilder2DOptions, apply_overrides

    return apply_overrides(TrajectoryBuilder2DOptions(), {
        "use_imu_data": False, "use_online_correlative_scan_matching": True,
        "submaps.grid_type": grid_type})


def _grid_on(grid, device):
    """A copy of a Grid2D or TsdfGrid2D on `device`."""
    import dataclasses

    import torch

    return dataclasses.replace(grid, **{f.name: getattr(grid, f.name).to(device)
                                        for f in dataclasses.fields(grid)
                                        if isinstance(getattr(grid, f.name), torch.Tensor)})


def _slice_phase(torch, dev, grid_type="PROBABILITY_GRID", kernels=FRONTEND_KERNELS,
                 error_limit=0.25, label="frontend"):
    """The 2D frontend, online correlative matcher on, on the card over
    simulated scans of a floor plan, on submaps of `grid_type`."""
    from cartographer_tpu_torch.core.config import apply_overrides
    from cartographer_tpu_torch.mapping import local_trajectory_builder_2d as ltb
    from cartographer_tpu_torch.mapping.local_trajectory_builder_2d import (
        LocalTrajectoryBuilder2D,
    )
    from cartographer_tpu_torch.ops import cuda
    from cartographer_tpu_torch.sensor.data import TimedPointCloudData
    from cartographer_tpu_torch.simulation import relative_to_first, simulate_scans
    from cartographer_tpu_torch.transform import nquat

    opts = _frontend_options(grid_type)
    scans, truth = simulate_scans(NUM_SCANS + PROFILED_SCANS + 1, seed=0)
    gt = relative_to_first(truth)[:NUM_SCANS]
    data = [TimedPointCloudData(time=int(round(ts * 1e6)), origin=np.zeros(3, np.float32),
                                ranges=pts, times=rel) for ts, pts, rel in scans]
    data, profiled = data[:NUM_SCANS], data[NUM_SCANS:]

    builder = LocalTrajectoryBuilder2D(opts, ["laser"], device=dev)
    cuda.reset_launch_counts()
    est, finished, walls, nodes = [], [], [], []
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for d in data:
            t0 = time.monotonic()
            r = builder.add_range_data("laser", d)
            walls.append(time.monotonic() - t0)
            est.append([*r.local_pose_translation[:2], nquat.get_yaw(r.local_pose_rotation)])
            if r.insertion_result is not None:
                finished += r.insertion_result.finished_submaps
                nodes.append(r.insertion_result)
    torch.cuda.set_sync_debug_mode("default")
    launches = cuda.launch_counts()
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    print(f"{label}: {len(data)} scans, {builder.device_fetches} fetches, {syncs} "
          f"synchronizing operations, {len(finished)} finished submaps, launches {launches}")
    _check_launched(launches, kernels, label)
    if builder.device_fetches != len(data) or syncs != len(data):
        _fail(f"{label}: expected one blocking copy per scan, got {syncs} synchronizing "
              f"operations for {len(data)} scans")
    if len(finished) < 2:
        _fail(f"{label}: only {len(finished)} submaps finished (need >= 2)")
    est = np.asarray(est)
    errors = np.linalg.norm(est[:, :2] - gt[:, :2], axis=1)
    print(f"{label}: mean error {errors.mean():.4f} m, max {errors.max():.4f} m against "
          f"ground truth (limit {error_limit} m)")
    if errors.mean() > error_limit:
        _fail(f"{label}: mean error {errors.mean()} m against ground truth "
              f"(limit {error_limit} m)")

    # The first scans again on the CPU's plain path, with the same permutations.
    def card_permutation(seed, n):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randperm(n, generator=g, device=dev, dtype=torch.int32).cpu().numpy()

    # The correlative search is off here: between the card's and the CPU's
    # rounding its argmax can flip at a near-tie, which moves the scan by a
    # window cell; K5 is held to the CPU on its own in the kernel phase.
    opts_off = apply_overrides(opts, {"use_online_correlative_scan_matching": False})
    card = LocalTrajectoryBuilder2D(opts_off, ["laser"], device=dev)
    cpu = LocalTrajectoryBuilder2D(opts_off, ["laser"], device="cpu",
                                   permutation_fn=card_permutation)
    worst = np.zeros(2)
    for d in data[:CPU_SCANS]:
        a, b = (x.add_range_data("laser", d) for x in (card, cpu))
        c = [np.array([*r.local_pose_translation[:2], nquat.get_yaw(r.local_pose_rotation)])
             for r in (a, b)]
        worst = np.maximum(worst, [np.linalg.norm(c[0][:2] - c[1][:2]), abs(c[0][2] - c[1][2])])
    print(f"{label}: first {CPU_SCANS} scans, correlative search off, against the CPU plain "
          f"path: max {worst[0]:.3g} m, {worst[1]:.3g} rad (tolerance 0.02 m, 0.01 rad)")
    if worst[0] > 0.02 or worst[1] > 0.01:
        _fail(f"{label}: card and CPU plain path disagree")

    profile = _profile(torch, lambda d: builder.add_range_data("laser", d), profiled[:-1],
                       f"{label} profile")
    # One more scan, keeping the arguments of its search and its refine and
    # its range data in the local frame, for the kernel phases.
    kept = {"correlative": [], "lm": []}
    restore = [_recording(ltb, "real_time_correlative_match", kept["correlative"]),
               _recording(ltb, "lm_match_tsdf_2d" if grid_type == "TSDF" else "lm_match_2d",
                          kept["lm"])]
    try:
        kept["range_data"] = builder.add_range_data("laser", profiled[-1]).range_data_in_local
    finally:
        for r in restore:
            r()
    steady = walls[10:]
    return dict(
        profile=profile,
        scans=len(data), finished_submaps=len(finished), mean_error_m=float(errors.mean()),
        frontend_2d_builder_scans_per_sec=len(steady) / sum(steady),
        host_seconds=builder.host_seconds, device_seconds=builder.device_seconds,
        launches=launches, submap=finished[0], nodes=nodes, builder=builder, kept=kept,
        lm_iterations_per_scan=float(np.mean(builder.lm_iterations)),
        cpu_agreement=[float(worst[0]), float(worst[1])])


def _distinct_cells(torch, lin_list):
    return int(torch.unique(torch.cat([x.reshape(-1) for x in lin_list])).numel())


def _backend_kernel_phase(torch, dev, ctx, run):
    """K5-K8 against their twins on the card: K5 at the frontend's shapes,
    K6 and K7 on the frontend run's first finished submap and a node cloud,
    K8 on a full-width synthetic pose graph."""
    import torch.nn.functional as F

    from cartographer_tpu_torch.core.config import ConstraintBuilderOptions
    from cartographer_tpu_torch.interop import schur_problem_from_numpy
    from cartographer_tpu_torch.mapping.pose_graph_2d import TrajectoryNode, _pose2d_of_node
    from cartographer_tpu_torch.ops import bnb_2d, correlative_2d
    from cartographer_tpu_torch.ops.grid_2d import Grid2D
    from cartographer_tpu_torch.ops.probability import UNKNOWN_PROBABILITY
    from cartographer_tpu_torch.parallel import schur_spa
    from cartographer_tpu_torch.simulation import synthetic_pose_graph

    rows, extra = {}, {}
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731

    # K5: the frontend's correlative search, 512 points on a 1024^2 grid.
    opts = _frontend_options()
    corr = opts.real_time_correlative_scan_matcher
    cparams = correlative_2d.CorrelativeSearchParams(
        corr.linear_search_window, corr.angular_search_window,
        corr.translation_delta_cost_weight, corr.rotation_delta_cost_weight, opts.max_range)
    grid, cloud = ctx["grid"], ctx["cloud"]
    x0 = t(np.float32([0.31, 0.03, 0.02]))
    args = (grid, cloud.points, cloud.mask, x0, cparams)
    best_k, scores_k = correlative_2d._match_kernel(*args)
    best_p, scores_p = correlative_2d.correlative_match_plain(*args)
    err = float((best_k[0] - best_p[0]).abs())
    if not torch.equal(best_k[1:], best_p[1:]) or err > 1e-6:
        _fail(f"K5 argmax or score differs from the plain twin ({best_k} vs {best_p})")
    score_err = float((scores_k - scores_p).nan_to_num(0.0, 0.0, 0.0).abs().max())
    print(f"K5 correlative_2d: argmax equal, best score err {err:.3g} (tolerance 1e-6), "
          f"max score err {score_err:.3g}")
    # The CPU's plain path on the same inputs: the same argmax unless the
    # CPU scores the card's argmax within 1e-5 of its own best (a near-tie).
    cpu_grid = Grid2D(grid.log_odds.cpu(), grid.known.cpu(), grid.origin.cpu(),
                      grid.resolution)
    best_c, scores_c = correlative_2d.correlative_match_plain(
        cpu_grid, cloud.points.cpu(), cloud.mask.cpu(), x0.cpu(), cparams)
    at_card = float(scores_c.reshape(-1)[int(torch.argmax(scores_k.reshape(-1)))])
    cpu_err = abs(float(best_k[0]) - float(best_c[0]))
    same = torch.equal(best_k[1:].cpu(), best_c[1:])
    below = float(best_c[0]) - at_card
    print(f"K5 against the CPU plain path: argmax {'equal' if same else 'differs'}, best "
          f"score err {cpu_err:.3g}, CPU score of the card's argmax {below:.3g} below its best "
          f"(tolerance 1e-5 each)")
    if cpu_err > 1e-5 or below > 1e-5:
        _fail("K5 and the CPU's plain path disagree")
    valid = int(cloud.mask.sum())
    w = 2 * cparams.num_linear(grid.resolution) + 1
    angles = int(torch.isfinite(scores_k[:, 0, 0]).sum())
    _, _, cells = correlative_2d.candidate_cells(
        grid, cloud.points, cloud.mask, x0, scores_k.shape[0], cparams.angular_search_window)
    cells = cells[torch.isfinite(scores_k[:, 0, 0])][:, cloud.mask]
    shifts = torch.arange(w, device=dev) - w // 2
    lin = ((cells[:, None, None, :, 0] + shifts[None, :, None, None]) * grid.size
           + cells[:, None, None, :, 1] + shifts[None, None, :, None])
    rows["correlative_2d"] = dict(
        replaces="cartographer_tpu/ops/correlative_2d.py:138", max_abs_err=max(err, score_err),
        ms=_cuda_ms(lambda: correlative_2d._match_kernel(*args)),
        plain_ms=_cuda_ms(lambda: correlative_2d.correlative_match_plain(*args), reps=5),
        bound=_bound(_distinct_cells(torch, [lin]) * 5 + cloud.points.shape[0] * 9
                     + scores_k.numel() * 4, angles * w * w * valid * 14),
        library_ms=None)

    # K6: the pyramid of the frontend run's first finished submap.
    submap_grid = run["submap"].grid
    size = submap_grid.size
    depth = ConstraintBuilderOptions().fast_correlative_scan_matcher.branch_and_bound_depth
    pyr = bnb_2d.build_precomputation_pyramid(submap_grid, depth)
    ref = bnb_2d.pyramid_plain(submap_grid, depth)
    if not torch.equal(pyr, ref):
        _fail("K6 pyramid differs from the plain twin (tolerance: exact)")
    print(f"K6 bnb_pyramid: {depth} levels of {size}^2 equal to the plain twin (exact)")
    padded = [F.pad(ref[h - 1][None, None], (0, 1 << (h - 1), 0, 1 << (h - 1)),
                    value=UNKNOWN_PROBABILITY) for h in range(1, depth)]
    pooled = [F.max_pool2d(x, 2, stride=1, dilation=1 << h) for h, x in enumerate(padded)]
    if not all(torch.equal(p_[0, 0], ref[h + 1]) for h, p_ in enumerate(pooled)):
        _fail("max_pool2d does not give the pyramid's levels")
    rows["bnb_pyramid"] = dict(
        replaces="cartographer_tpu/ops/bnb_2d.py:60", max_abs_err=0.0,
        ms=_cuda_ms(lambda: bnb_2d.build_precomputation_pyramid(submap_grid, depth)),
        plain_ms=_cuda_ms(lambda: bnb_2d.pyramid_plain(submap_grid, depth), reps=10),
        bound=_bound(size * size * 5 + depth * size * size * 4, size * size * (3 * depth + 4)),
        library_ms=_cuda_ms(lambda: [F.max_pool2d(x, 2, stride=1, dilation=1 << h)
                                     for h, x in enumerate(padded)]))

    # K7: one loop-closure pair at the default options, a node of the
    # frontend run whose cloud lies in the finished submap.
    cb = ConstraintBuilderOptions()
    fc = cb.fast_correlative_scan_matcher
    bparams = bnb_2d.FastCorrelativeMatcherParams2D(
        fc.linear_search_window, fc.angular_search_window, fc.branch_and_bound_depth,
        fc.beam_width, fc.max_scan_range)
    node = run["nodes"][len(run["nodes"]) // 2]
    lc = node.filtered_gravity_aligned_point_cloud
    pts, mask = correlative_2d.pad_points(lc.points.to(dev), lc.mask.to(dev))
    pose2d = _pose2d_of_node(TrajectoryNode(
        node.time, node.gravity_alignment, None, node.local_pose_translation,
        node.local_pose_rotation))
    init = t(pose2d.astype(np.float32) + np.float32([0.4, -0.3, 0.05]))
    calls = []

    def recorded(*a):
        calls.append(a)
        return bnb_2d.score_candidates(*a)

    out_k = bnb_2d.fast_correlative_match_2d(pyr, submap_grid, pts, mask, init, bparams, 0.0,
                                             score=recorded)
    out_p = bnb_2d.fast_correlative_match_2d(pyr, submap_grid, pts, mask, init, bparams, 0.0,
                                             score=bnb_2d.score_candidates_plain)
    err = float((out_k[0] - out_p[0]).abs())
    if err > 1e-5 or not torch.equal(out_k[4:], out_p[4:]):
        _fail(f"K7 match differs from the plain twin: {out_k} vs {out_p}")
    print(f"K7 bnb_score: score {float(out_k[0]):.4f} err {err:.3g} (tolerance 1e-5), found "
          f"and certificate equal ({bool(out_k[4])}, {bool(out_k[5])}), {len(calls)} launches, "
          f"{sum(c[3].shape[0] for c in calls)} candidates")
    lins, gathers = [], 0
    valid = int(mask.sum())
    for h, (level, cells_, mask_, a, ox, oy) in enumerate(calls):
        cx = cells_[a.long()][:, mask_, 0] + ox[:, None]
        cy = cells_[a.long()][:, mask_, 1] + oy[:, None]
        inside = (cx >= 0) & (cx < size) & (cy >= 0) & (cy < size)
        lins.append((cx * size + cy + h * size * size)[inside])
        gathers += a.shape[0] * valid
    cand = sum(c[3].shape[0] for c in calls)
    sorts = [bnb_2d.score_candidates(*c) for c in calls]  # the beam's selection sorts these
    rows["bnb_score"] = dict(
        replaces="cartographer_tpu/ops/bnb_2d.py:81", max_abs_err=err,
        ms=_cuda_ms(lambda: [bnb_2d.score_candidates(*c) for c in calls]),
        plain_ms=_cuda_ms(lambda: [bnb_2d.score_candidates_plain(*c) for c in calls], reps=5),
        bound=_bound(_distinct_cells(torch, lins) * 4 + calls[0][1].numel() * 4 + cand * 16,
                     gathers * 10),
        library_ms=_cuda_ms(lambda: [torch.sort(x, descending=True, stable=True)
                                     for x in sorts]))
    extra["bnb_match_ms"] = _cuda_ms(lambda: bnb_2d.fast_correlative_match_2d(
        pyr, submap_grid, pts, mask, init, bparams, 0.0), reps=10)

    # K8: a synthetic pose graph at the configured capacities.
    arrays, _, _ = synthetic_pose_graph(64, 4096, 16384, seed=3)
    problem = schur_problem_from_numpy(arrays, dev)
    wmax = schur_spa.max_weight(problem)
    q = schur_spa.normalized(problem, wmax)
    hs = 10.0 / wmax
    sub_k, nod_k = schur_spa._solve_kernel(q, 2, hs, 1e-6)
    sub_p, nod_p = schur_spa.solve_plain(q, 2, hs, 1e-6)
    err = float(max((sub_k - sub_p).abs().max(), (nod_k - nod_p).abs().max()))
    if not err <= 1e-3:
        _fail(f"K8 two iterations differ from the plain twin by {err} (tolerance 1e-3)")
    sub50, nod50 = schur_spa._solve_kernel(q, 50, hs, 1e-6)
    cost0 = float(schur_spa._cost(q.submap_poses, q.node_poses, q, hs))
    cost50 = float(schur_spa._cost(sub50, nod50, q, hs))
    if not cost50 < 0.01 * cost0:
        _fail(f"K8 50 iterations: cost {cost50} from {cost0} (must fall 100x)")
    print(f"K8 schur_spa_2d: 2 iterations at N=4096 S=64 C=16384 within {err:.3g} of the plain "
          f"twin (tolerance 1e-3); 50 iterations: cost {cost0:.4g} -> {cost50:.4g}")
    S, N, C, D = 64, 4096, 16384, 4095
    K = 3 * S + 1
    spd = torch.randn(3 * S, 3 * S, device=dev)
    spd = spd @ spd.T + 3 * S * torch.eye(3 * S, device=dev)
    rhs = torch.randn(3 * S, 1, device=dev)
    per_iteration_ops = C * 200 + D * 300 + N * 150 + 2 * N * K * 21 + C * K * 18 \
        + (3 * S) ** 3 // 3 + N * 3 * 3 * S * 2
    rows["schur_spa_2d"] = dict(
        replaces="cartographer_tpu/parallel/schur_spa.py:396", max_abs_err=err,
        ms=_cuda_ms(lambda: schur_spa._solve_kernel(q, 2, hs, 1e-6), reps=5),
        plain_ms=_cuda_ms(lambda: schur_spa.solve_plain(q, 2, hs, 1e-6), reps=1, warmup=0),
        bound=_bound(C * 30 + D * 24 + (S + N) * 13 + (S + N) * 12, 2 * per_iteration_ops),
        library_ms=_cuda_ms(lambda: [torch.cholesky_solve(rhs, torch.linalg.cholesky(spd))
                                     for _ in range(2)]))
    extra["schur_50_iterations_ms"] = _cuda_ms(lambda: schur_spa._solve_kernel(q, 50, hs, 1e-6),
                                               reps=3, warmup=1)
    return rows, extra


def _global_phase(torch, dev, grid_type="PROBABILITY_GRID", kernels=KERNELS_2D,
                  limits=(100, 3, 0.25), localize=True, label="global", refines=None):
    """Global SLAM through MapBuilder on the card over three laps, on
    submaps of `grid_type`; `limits` are the least loop closures and solves
    and the largest mean error of the optimized poses. The arguments of
    every REFINE_EVERY-th loop-closure refine go into `refines` if given."""
    from cartographer_tpu_torch.core.config import MapBuilderOptions, TrajectoryBuilderOptions
    from cartographer_tpu_torch.mapping import constraint_builder_2d
    from cartographer_tpu_torch.mapping.constraint_builder_2d import _pow2_points
    from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
    from cartographer_tpu_torch.mapping.map_builder import MapBuilder
    from cartographer_tpu_torch.ops import bnb_2d, cuda
    from cartographer_tpu_torch.sensor.data import TimedPointCloudData
    from cartographer_tpu_torch.simulation import Path, Robot, relative_to_first, simulate_scans

    scans, truth = simulate_scans(GLOBAL_SCANS, seed=2)
    gt = relative_to_first(truth)
    mb = MapBuilder(MapBuilderOptions(use_trajectory_builder_2d=True), device=dev)
    pg = mb.pose_graph
    cb = pg.constraint_builder
    recorded = []
    compute = cb.compute_constraints

    def recording(requests):
        recorded.extend(r for r in requests if not r.match_full and len(recorded) < CPU_PAIRS)
        return compute(requests)

    cb.compute_constraints = recording
    restore = (_recording(constraint_builder_2d, "lm_match_2d", refines, REFINE_EVERY)
               if refines is not None else lambda: None)
    tid = mb.add_trajectory_builder(["laser"],
                                    TrajectoryBuilderOptions(_frontend_options(grid_type)))
    cuda.reset_launch_counts()
    t0 = time.monotonic()
    for ts, pts, rel in scans:
        mb.add_sensor_data(tid, "laser", TimedPointCloudData(
            time=int(round(ts * 1e6)), origin=np.zeros(3, np.float32), ranges=pts, times=rel))
    mb.finish_trajectory(tid)
    pg.run_final_optimization()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = cuda.launch_counts()
    cb.compute_constraints = compute
    restore()
    inter, solves = pg.num_inter_constraints(), pg.solves
    print(f"{label}: {len(scans)} scans, {len(pg.nodes)} nodes, {len(pg.submap_data)} "
          f"submaps, {inter} loop closures from {cb.pairs_matched} matched pairs, {solves} "
          f"solves, {wall:.1f} s wall; constraint search {cb.match_seconds:.2f} s, solves "
          f"{pg.solve_seconds:.2f} s; launches {launches}")
    _check_launched(launches, kernels, label)
    min_inter, min_solves, max_error = limits
    if inter < min_inter or solves < min_solves:
        _fail(f"{label} ran {inter} loop closures and {solves} solves (need >= {min_inter}, "
              f">= {min_solves})")
    # Node (trajectory, index) -> scan index: scan i is stamped (i + 1) * 0.1 s.
    index = {nid: int(round(node.time / 1e5)) - 1 for nid, node in pg.nodes.items()}
    local_err = np.mean([np.linalg.norm(node.local_pose_translation[:2] - gt[index[nid], :2])
                         for nid, node in pg.nodes.items()])
    global_err = np.mean([np.linalg.norm(node.global_pose_2d[:2] - gt[index[nid], :2])
                          for nid, node in pg.nodes.items()])
    print(f"{label}: mean error of the optimized poses {global_err:.4f} m, of the frontend's "
          f"{local_err:.4f} m (limits {max_error} m and the frontend's)")
    if not (global_err <= max_error and global_err <= local_err):
        _fail(f"{label}: optimized poses are not within {max_error} m of the truth and the "
              f"frontend's error")

    # The first loop-closure pairs again, on the CPU's plain path.
    params = cb._bnb_params
    depth = params.branch_and_bound_depth
    for r in recorded:
        pts, mask = _pow2_points([r.points])
        g_cpu = _grid_on(r.grid, "cpu")
        init = np.asarray(r.init, np.float32)
        card = bnb_2d.fast_correlative_match_2d(
            cb._pyramid_for(r.submap_id, r.grid), r.grid, torch.from_numpy(pts[0]).to(dev),
            torch.from_numpy(mask[0]).to(dev), torch.from_numpy(init).to(dev), params,
            0.0).cpu()
        cpu = bnb_2d.fast_correlative_match_2d(
            bnb_2d.pyramid_plain(g_cpu, depth), g_cpu, torch.from_numpy(pts[0]),
            torch.from_numpy(mask[0]), torch.from_numpy(init), params, 0.0)
        err = float((card[0] - cpu[0]).abs())
        print(f"{label}: pair {r.node_id}/{r.submap_id} card {float(card[0]):.5f} CPU "
              f"{float(cpu[0]):.5f} (tolerance 1e-5), certificates {bool(card[5])}, "
              f"{bool(cpu[5])}")
        if err > 1e-5 or bool(card[5]) != bool(cpu[5]):
            _fail("a loop-closure pair differs between the card and the CPU's plain path")

    summary = dict(scans=len(scans), nodes=len(pg.nodes), submaps=len(pg.submap_data),
                   loop_closures=inter, matched_pairs=cb.pairs_matched, solves=solves,
                   wall_seconds=wall, constraint_search_seconds=cb.match_seconds,
                   solve_seconds=pg.solve_seconds, launches=launches,
                   mean_error_optimized_m=float(global_err),
                   mean_error_frontend_m=float(local_err))
    if not localize:
        return summary
    # Global localization: a lap-3 node against a finished lap-1 submap.
    robot = Robot(Path.superellipse(), 2.1, 6.0)  # simulate_scans' path and speeds
    lap_of_scan = (robot.arc_at((np.arange(len(scans)) + 1) * 0.1)
                   // robot.path.arc[-1]).astype(int)
    sid, entry = next(((s, e) for s, e in pg.submap_data.items()
                       if e.finished and all(lap_of_scan[index[(n.trajectory_id, n.node_index)]]
                                             == 0 for n in e.node_ids)), (None, None))
    if sid is None:
        _fail("no finished lap-1 submap")
    origin = entry.submap.local_pose_translation[:2]
    late = [(nid, node) for nid, node in pg.nodes.items() if lap_of_scan[index[nid]] >= 2]
    nid, node = min(late, key=lambda kv: np.linalg.norm(
        kv[1].local_pose_translation[:2] - origin))
    t0 = time.monotonic()
    row = cb.raw_results([cb.begin_global_constraint(SubmapId(*sid), entry.submap.grid,
                                                     NodeId(*nid), node.filtered_points)])[0]
    loc_s = time.monotonic() - t0
    certified, beam = cb.last_global_certified[0], cb.last_global_beams[0]
    loc_err = float(np.linalg.norm(row[1:3] - gt[index[nid], :2]))
    print(f"global localization: node {nid} (scan {index[nid]}) in submap {sid}: score "
          f"{row[0]:.4f}, certified {certified} at beam {beam}, {loc_err:.4f} m from the truth "
          f"(limit 0.1 m), {loc_s:.2f} s")
    if not certified or not loc_err <= 0.1:
        _fail("global localization did not come back certified within 0.1 m")
    return dict(summary, global_localization_error_m=loc_err,
                global_localization_seconds=loc_s, global_localization_beam=beam)


def _defined_normals(pts, mask, origin):
    """The valid returns whose 5 angle-sorted neighbours have clearly
    separate covariance eigenvalues: there a normal is defined up to the
    sign the flip fixes (numpy, float64)."""
    rel = pts - origin
    order = np.argsort(np.where(mask, np.arctan2(rel[:, 1], rel[:, 0]), np.inf), kind="stable")
    sp = pts[order].astype(np.float64)
    n = len(pts)
    nb = sp[np.clip(np.arange(n)[:, None] + np.arange(-2, 3), 0, n - 1)]
    c = nb - nb.mean(1, keepdims=True)
    ev = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", c, c))
    ok = np.zeros(n, bool)
    ok[order] = (ev[:, 1] - ev[:, 0]) > 1e-3 * np.maximum(ev[:, 1], 1e-12)
    return ok & mask


def _kernel_phase_tsdf(torch, dev, run):
    """K20, K21, K22 and the TSDF forms of K5 and K6 against their twins on
    the card, on the TSDF frontend run's state: its last scan's range data,
    search and refine arguments, active grids and first finished submap
    (default widths)."""
    import torch.nn.functional as F

    from cartographer_tpu_torch.core.tensor import true_div
    from cartographer_tpu_torch.ops import bnb_2d, correlative_2d, tsdf_2d
    from cartographer_tpu_torch.ops.probability import UNKNOWN_PROBABILITY

    rows = {}
    builder, kept = run["builder"], run["kept"]
    rd = kept["range_data"]
    pts, mask, origin = rd.returns.points, rd.returns.mask, rd.origin
    n, valid = pts.shape[0], int(mask.sum())

    # K20: the scan's normals.
    got = tsdf_2d.estimate_normals_2d(pts, mask, origin)
    ref = tsdf_2d._normals_plain(pts, mask, origin)
    defined = _defined_normals(pts.cpu().numpy(), mask.cpu().numpy(), origin.cpu().numpy())
    err = (got - ref).abs().max(-1).values.cpu().numpy()
    max_err = float(err[defined].max())
    print(f"K20 tsdf_normals_2d: {valid} of {n} returns, {int(defined.sum())} with a defined "
          f"normal: max |err| {max_err:.3g} there (tolerance 1e-5), "
          f"{int((err[~defined & mask.cpu().numpy()] > 1e-5).sum())} of the others differ")
    if max_err > 1e-5:
        _fail("K20 differs from the plain twin")
    rel = pts - origin
    keys = torch.where(mask, torch.atan2(rel[:, 1], rel[:, 0]),
                       torch.full_like(rel[:, 0], float("inf")))
    rows["tsdf_normals_2d"] = dict(
        replaces="cartographer_tpu/ops/tsdf_2d.py:86", max_abs_err=max_err,
        ms=_cuda_ms(lambda: tsdf_2d.estimate_normals_2d(pts, mask, origin)),
        plain_ms=_cuda_ms(lambda: tsdf_2d._normals_plain(pts, mask, origin), reps=10),
        # atan2 and the key (20), a sort's n log2 n comparisons, the window's
        # mean, covariance and eigenvector (60) per point.
        bound=_bound(n * 17 + 8, n * (80 + int(np.log2(n)))),
        library_ms=_cuda_ms(lambda: torch.argsort(keys, stable=True)))

    # K21: the scan into both active grids, on clones for the twin.
    grids = builder._active_submaps.grids
    scratch = builder._active_submaps._scratch
    params = builder._active_submaps._tsdf_params
    card = grids.clone()
    twin = grids.clone()
    active = torch.ones(2, dtype=torch.bool, device=dev)
    yes = torch.ones((), dtype=torch.bool, device=dev)
    tsdf_2d.insert_into_slots_tsdf(card, rd, active, yes, params, scratch, normals=got)
    tsdf_2d._insert_plain(twin, rd, got, active, yes, params)
    known_diff = int(((card.weight > 0) != (twin.weight > 0)).sum())
    err = float(max((card.tsd - twin.tsd).abs().max(), (card.weight - twin.weight).abs().max()))
    sample_pts, sdf, w = tsdf_2d._samples(rd, got, grids.truncation_distance, params)
    lins, touched = [], 0
    size = grids.size
    for slot in range(2):
        c = torch.floor(true_div(sample_pts - grids.origin[slot], grids.resolution)).long()
        inside = ((c >= 0) & (c < size)).all(-1) & (w > 0)
        lin = (c[..., 0] * size + c[..., 1])[inside]
        lins.append((lin, w[inside], (w * sdf)[inside]))
        touched += int(torch.unique(lin).numel())
    print(f"K21 tsdf_insert_2d: {touched} cells touched in 2 slots, known sets "
          f"{'equal' if not known_diff else f'differ in {known_diff} cells'}, max |err| "
          f"{err:.3g} (tolerance 1e-5: float atomics order the sums)")
    if known_diff or err > 1e-5:
        _fail("K21 differs from the plain twin")
    sums = [torch.zeros(size * size, device=dev) for _ in range(4)]
    rows["tsdf_insert_2d"] = dict(
        replaces="cartographer_tpu/ops/tsdf_2d.py:115", max_abs_err=err,
        ms=_cuda_ms(lambda: tsdf_2d.insert_into_slots_tsdf(card, rd, active, yes, params,
                                                           scratch, normals=got)),
        plain_ms=_cuda_ms(lambda: tsdf_2d._insert_plain(twin, rd, got, active, yes, params),
                          reps=5),
        # Reads the returns, mask, normals and origin, reads and writes the
        # tsd and weight of the touched cells; 16 samples per return and slot
        # at some 60 operations each, 10 per touched cell.
        bound=_bound(n * 17 + 8 + touched * 16, 2 * 16 * valid * 60 + touched * 10),
        # index_add_ of the two sums of both slots: the scatter only.
        library_ms=_cuda_ms(lambda: [(sums[2 * k].index_add_(0, lin, ww),
                                      sums[2 * k + 1].index_add_(0, lin, ws))
                                     for k, (lin, ww, ws) in enumerate(lins)]))
    del card, twin

    # K22: the scan's TSDF refine (K3's TSDF form is held on the loop
    # closures' refines, where the main path runs it: _refine_phase_tsdf).
    margs = kept["lm"][0]
    lvalid = int(margs[2].sum())
    xk, ck, itk = tsdf_2d.lm_match_tsdf_2d(*margs)
    xp, cp, itp = tsdf_2d._match_plain(*margs)
    err = float((xk - xp).abs().max())
    rel_cost = abs(float(ck) - float(cp)) / max(abs(float(cp)), 1e-30)
    print(f"lm_match_tsdf_2d: max |pose err| {err:.3g} (tolerance 1e-4), cost rel err "
          f"{rel_cost:.3g} (rtol 1e-4), {int(itk)} iterations (plain {int(itp)})")
    if err > 1e-4 or rel_cost > 1e-4:
        _fail("lm_match_tsdf_2d differs from the plain twin")
    rows["lm_match_tsdf_2d"] = dict(
        replaces="cartographer_tpu/ops/tsdf_2d.py:183", max_abs_err=err,
        ms=_cuda_ms(lambda: tsdf_2d.lm_match_tsdf_2d(*margs)),
        plain_ms=_cuda_ms(lambda: tsdf_2d._match_plain(*margs), reps=5),
        # Per valid point: the point and flag, 16 tsd cells per bicubic
        # sample; some 12 operations per cell and pass, 1 + 2 passes per
        # iteration.
        bound=_bound(lvalid * (8 + 1 + 16 * 4), (1 + 2 * int(itk)) * lvalid * 16 * 12),
        library_ms=None)

    # K5's TSDF form: the scan's search.
    cgrid, cpts, cmask, cpose, cparams = kept["correlative"][0]
    cargs = (cgrid, cpts, cmask, cpose, cparams)
    best_k, scores_k = correlative_2d._match_kernel(*cargs)
    best_p, scores_p = correlative_2d.correlative_match_plain(*cargs)
    if not torch.equal(best_k, best_p) or not torch.equal(scores_k, scores_p):
        _fail(f"K5's TSDF form differs from the plain twin ({best_k} vs {best_p})")
    cvalid = int(cmask.sum())
    w_ = scores_k.shape[-1]
    angles = int(torch.isfinite(scores_k[:, 0, 0]).sum())
    _, _, cells = correlative_2d.candidate_cells(cgrid, cpts, cmask, cpose, scores_k.shape[0],
                                                 cparams.angular_search_window)
    cells = cells[torch.isfinite(scores_k[:, 0, 0])][:, cmask]
    shifts = torch.arange(w_, device=dev) - w_ // 2
    lin = ((cells[:, None, None, :, 0] + shifts[None, :, None, None]) * cgrid.size
           + cells[:, None, None, :, 1] + shifts[None, None, :, None])
    print(f"correlative_2d_tsdf: scores and argmax equal to the twin (exact), {angles} valid "
          f"angles, best score {float(best_k[0]):.5f}")
    rows["correlative_2d_tsdf"] = dict(
        symbol="correlative_2d_tsdf", replaces="cartographer_tpu/ops/correlative_2d.py:138",
        max_abs_err=0.0, ms=_cuda_ms(lambda: correlative_2d._match_kernel(*cargs)),
        plain_ms=_cuda_ms(lambda: correlative_2d.correlative_match_plain(*cargs), reps=5),
        bound=_bound(_distinct_cells(torch, [lin]) * 8 + cpts.shape[0] * 9
                     + scores_k.numel() * 4, angles * w_ * w_ * cvalid * 14),
        library_ms=None)

    # K6's TSDF form: the pyramid of the run's first finished submap.
    submap_grid = run["submap"].grid
    depth = 7
    pyr = bnb_2d.build_precomputation_pyramid(submap_grid, depth)
    ref = bnb_2d.pyramid_plain(submap_grid, depth)
    if not torch.equal(pyr, ref):
        _fail("K6's TSDF form differs from the plain twin (tolerance: exact)")
    size = submap_grid.size
    padded = [F.pad(ref[h - 1][None, None], (0, 1 << (h - 1), 0, 1 << (h - 1)),
                    value=UNKNOWN_PROBABILITY) for h in range(1, depth)]
    print(f"bnb_pyramid_tsdf: {depth} levels of {size}^2 equal to the twin (exact)")
    rows["bnb_pyramid_tsdf"] = dict(
        symbol="bnb_pyramid_tsdf", replaces="cartographer_tpu/ops/bnb_2d.py:60",
        max_abs_err=0.0,
        ms=_cuda_ms(lambda: bnb_2d.build_precomputation_pyramid(submap_grid, depth)),
        plain_ms=_cuda_ms(lambda: bnb_2d.pyramid_plain(submap_grid, depth), reps=10),
        bound=_bound(size * size * 8 + depth * size * size * 4, size * size * (3 * depth + 4)),
        library_ms=_cuda_ms(lambda: [F.max_pool2d(x, 2, stride=1, dilation=1 << h)
                                     for h, x in enumerate(padded)]))
    return rows


def _refine_phase_tsdf(torch, calls):
    """K3's TSDF form against its twin on the TSDF global run's loop-closure
    refines (every REFINE_EVERY-th call of ConstraintBuilder2D's refine: a
    power-of-two cloud against a finished submap from the BnB pose), where
    the main path runs it; its time and bound are the means over them."""
    from cartographer_tpu_torch.ops import scan_matcher_2d

    if not calls:
        _fail("the TSDF global run made no loop-closure refine")
    errs, ms, plain_ms, nbytes, ops = [], [], [], 0, 0
    for args in calls:
        xk, ck, itk = scan_matcher_2d.lm_match_2d(*args)
        xp, cp, itp = scan_matcher_2d._match_plain(*args)
        err = float((xk - xp).abs().max())
        rel_cost = abs(float(ck) - float(cp)) / max(abs(float(cp)), 1e-30)
        valid = int(args[2].sum())
        print(f"scan_matcher_2d_tsdf: loop-closure refine of {valid} of {args[1].shape[0]} "
              f"points: max |pose err| {err:.3g} (tolerance 1e-4), cost rel err "
              f"{rel_cost:.3g} (rtol 1e-4), {int(itk)} iterations (plain {int(itp)})")
        if err > 1e-4 or rel_cost > 1e-4:
            _fail("scan_matcher_2d_tsdf differs from the plain twin")
        errs.append(err)
        # Per valid point: the point and flag, 16 cells of tsd and weight per
        # bicubic sample; some 12 operations per cell and pass.
        nbytes += valid * (8 + 1 + 16 * 8)
        ops += (1 + 2 * int(itk)) * valid * 16 * 12
        ms.append(_cuda_ms(lambda: scan_matcher_2d.lm_match_2d(*args), reps=10))
        plain_ms.append(_cuda_ms(lambda: scan_matcher_2d._match_plain(*args), reps=3))
    k = len(calls)
    return {"scan_matcher_2d_tsdf": dict(
        replaces="cartographer_tpu/ops/scan_matcher_2d.py:70", max_abs_err=max(errs),
        ms=sum(ms) / k, plain_ms=sum(plain_ms) / k, bound=_bound(nbytes / k, ops / k),
        library_ms=None)}


def _events_3d(num_scans, seed=0, **scene):
    """Simulated 3D scans as (IMU messages up to the scan's time that no
    earlier scan took, the scan), and the ground truth in the first pose's
    frame; `seed` and `scene` go to `simulate_scans_3d`."""
    from cartographer_tpu_torch.sensor.data import ImuData, TimedPointCloudData
    from cartographer_tpu_torch.simulation import relative_to_first, simulate_scans_3d

    scans, imu, truth = simulate_scans_3d(num_scans, seed=seed, **scene)
    stamp = lambda t: TIME_OFFSET_US + int(round(t * 1e6))  # noqa: E731
    events, k = [], 0
    for ts, pts, rel, *intensities in scans:
        batch = []
        while k < len(imu) and imu[k][0] <= ts:
            batch.append(ImuData(time=stamp(imu[k][0]), linear_acceleration=imu[k][1],
                                 angular_velocity=imu[k][2]))
            k += 1
        events.append((batch, TimedPointCloudData(
            time=stamp(ts), origin=np.zeros(3, np.float32), ranges=pts, times=rel,
            intensities=intensities[0] if intensities else None)))
    return events, relative_to_first(truth)


def _feed_3d(builder, event):
    for message in event[0]:
        builder.add_imu_data(message)
    return builder.add_range_data("points", event[1])


def _drive_3d(torch, builder, events, gt, label):
    """Feeds the events to the builder, counting the synchronizing
    operations; checks that no scan is dropped and that each makes one
    blocking copy. Returns the poses [x, y, z, yaw], their position and yaw
    errors against the truth, the finished submaps, the wall seconds of each
    `add_range_data` and the number of inserted scans."""
    from cartographer_tpu_torch.transform import nquat

    n = len(events)
    est, finished, walls, inserted = [], [], [], 0
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for event in events:
            for message in event[0]:
                builder.add_imu_data(message)
            t0 = time.monotonic()
            r = builder.add_range_data("points", event[1])
            walls.append(time.monotonic() - t0)
            if r is None:
                _fail(f"{label}: the 3D frontend dropped scan {len(est)}")
            est.append([*r.local_pose_translation, nquat.get_yaw(r.local_pose_rotation)])
            if r.insertion_result is not None:
                inserted += 1
                for f in r.insertion_result.finished_submaps:
                    _ = (f.high_grid, f.low_grid)  # the dense crops of the compacted pools
                    finished.append(f)
    torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    print(f"{label}: {n} scans, {inserted} inserted, {builder.device_fetches} fetches, "
          f"{syncs} synchronizing operations, {len(finished)} finished submaps")
    if builder.device_fetches != n or syncs != n:
        _fail(f"{label}: expected one blocking copy per scan, got {syncs} synchronizing "
              f"operations for {n} scans")
    est = np.asarray(est)
    if not np.isfinite(est).all():
        _fail(f"{label}: non-finite poses")
    offset = np.concatenate([est[:, :2] - gt[:n, :2], est[:, 2:3]], 1)
    yaw_err = np.abs((est[:, 3] - gt[:n, 2] + np.pi) % (2 * np.pi) - np.pi)
    return est, offset, yaw_err, finished, walls, inserted


def _cpu_agreement_3d(torch, dev, opts, events, est, label):
    """The first CPU_SCANS_3D scans again on the CPU's plain path, with the
    card's voxel-filter permutations; fails beyond 2 cm / 0.01 rad. Returns
    the largest position and yaw differences."""
    from cartographer_tpu_torch.mapping.local_trajectory_builder_3d import (
        LocalTrajectoryBuilder3D,
    )
    from cartographer_tpu_torch.transform import nquat

    def card_permutation(seed, size):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randperm(size, generator=g, device=dev, dtype=torch.int32).cpu().numpy()

    t_cpu = time.monotonic()
    cpu = LocalTrajectoryBuilder3D(opts, ["points"], device="cpu",
                                   permutation_fn=card_permutation)
    worst = np.zeros(2)
    for i, event in enumerate(events[:CPU_SCANS_3D]):
        r = _feed_3d(cpu, event)
        c = np.array([*r.local_pose_translation, nquat.get_yaw(r.local_pose_rotation)])
        worst = np.maximum(worst, [np.linalg.norm(c[:3] - est[i, :3]), abs(c[3] - est[i, 3])])
    print(f"{label}: first {CPU_SCANS_3D} scans against the CPU plain path: max "
          f"{worst[0]:.3g} m, {worst[1]:.3g} rad (tolerance 0.02 m, 0.01 rad), "
          f"{time.monotonic() - t_cpu:.1f} s")
    if worst[0] > 0.02 or worst[1] > 0.01:
        _fail(f"{label}: card and CPU plain path disagree in 3D")
    return worst


def _slice_phase_3d(torch, dev):
    """The 3D frontend on the card at the default options, over simulated
    scans of a 16-ring sensor with an IMU in the floor plan's hall."""
    from cartographer_tpu_torch.core.config import TrajectoryBuilder3DOptions
    from cartographer_tpu_torch.mapping.local_trajectory_builder_3d import (
        LocalTrajectoryBuilder3D,
    )
    from cartographer_tpu_torch.ops import cuda

    opts, n = TrajectoryBuilder3DOptions(), NUM_SCANS_3D
    t_sim = time.monotonic()
    events, gt = _events_3d(n + PROFILED_SCANS + 1)
    print(f"3D frontend: {time.monotonic() - t_sim:.1f} s to simulate {len(events)} scans")

    builder = LocalTrajectoryBuilder3D(opts, ["points"], device=dev)
    cuda.reset_launch_counts()
    est, offset, yaw_err, finished, walls, inserted = _drive_3d(
        torch, builder, events[:n], gt, "3D frontend")
    launches = cuda.launch_counts()
    print(f"3D frontend: launches {launches}")
    _check_launched(launches, KERNELS_3D, "3D frontend")
    active = builder._active_submaps.submaps
    if len(finished) < 1 or len(active) != 2 or active[1].num_range_data == 0:
        _fail(f"{len(finished)} submaps finished, {len(active)} active: the window did not "
              f"rotate")
    f = finished[0]
    crops = (tuple(f.high_grid.log_odds.shape), tuple(f.low_grid.log_odds.shape))
    known = (int(f.high_grid.known.sum()), int(f.low_grid.known.sum()))
    want = ((opts.tpu.high_grid_size,) * 3, (opts.tpu.low_grid_size,) * 3)
    print(f"3D frontend: finished submap of {f.num_range_data} scans: "
          f"{f.high_paged.num_allocated} high and {f.low_paged.num_allocated} low pages of "
          f"{opts.tpu.max_pages}, pools compacted to {f.high_paged.grid.max_pages} and "
          f"{f.low_paged.grid.max_pages} pages, crops {crops} with {known} known cells, "
          f"histogram sum {f.histogram.sum():.1f}")
    if crops != want or min(known) == 0 or not f.histogram.sum() > 0:
        _fail("the finished submap's dense crops or histogram are empty")
    errors = np.linalg.norm(offset, axis=1)
    print(f"3D frontend: mean error {errors.mean():.4f} m (max {errors.max():.4f}), mean yaw "
          f"error {yaw_err.mean():.5f} rad (max {yaw_err.max():.5f}) against ground truth "
          f"(limits 0.25 m, 0.02 rad)")
    if not (errors.mean() <= 0.25 and yaw_err.mean() <= 0.02):
        _fail("the 3D frontend lost the ground truth")
    # Where the error sits: the mean (x, y, z) offset from the truth while the first
    # submap is matched against, and after matching has moved to the second.
    switch = 2 * opts.submaps.num_range_data
    offsets = [offset[min(20, switch // 2):switch].mean(0).tolist(),
               offset[switch + 20:].mean(0).tolist()]
    print(f"3D frontend: mean offset from the truth {np.round(offsets[0], 4).tolist()} m over "
          f"scans 20-{switch}, {np.round(offsets[1], 4).tolist()} m from scan {switch + 20} on")

    worst = _cpu_agreement_3d(torch, dev, opts, events, est, "3D frontend")

    profile = _profile(torch, lambda e: _feed_3d(builder, e), events[n:n + PROFILED_SCANS],
                       "3D profile")
    # One more scan, keeping what its step read and left on the card (the dense
    # windows, the packed result, the insertion's tensors) for the kernel phase.
    step, kept = builder._fused_step, []

    def keeping_step(high_grid, low_grid, intensity_grid, upload, perm):
        out = step(high_grid, low_grid, intensity_grid, upload, perm)
        kept.append(((high_grid, low_grid), *out))
        return out

    builder._fused_step = keeping_step
    _feed_3d(builder, events[n + PROFILED_SCANS])
    del builder._fused_step
    steady = walls[10:]
    return dict(
        builder=builder, last_step=kept[0], profile=profile, scans=n, inserted=inserted,
        finished_submaps=len(finished), mean_error_m=float(errors.mean()),
        mean_yaw_error_rad=float(yaw_err.mean()),
        mean_offset_m=offsets,
        frontend_3d_builder_scans_per_sec=len(steady) / sum(steady),
        host_seconds=builder.host_seconds, device_seconds=builder.device_seconds,
        allocator_ms_per_inserted_scan=builder.allocator_seconds * 1e3 / max(inserted, 1),
        new_pages_per_inserted_scan=builder.pages_allocated / max(inserted, 1),
        finished_submap_pages=[f.high_paged.num_allocated, f.low_paged.num_allocated],
        launches=launches, lm_iterations_per_scan=float(np.mean(builder.lm_iterations[1:n])),
        cpu_agreement=[float(worst[0]), float(worst[1])])


def _full_hall_phase_3d(torch, dev, correlative=False):
    """The 3D frontend again, over the hall at the floor plan's full size
    (36 m x 20 m) from the start of the path, where the robot's heading,
    and with it the local frame and the voxel grids, lie along the walls.
    The default LM-only matcher has nothing but the constant-velocity
    prediction along a corridor's axis there; with `correlative` the online
    correlative search runs before it. This run's error against the truth
    is reported and not limited; what is checked is that every scan is
    placed with one blocking copy and that the page pools hold a submap of
    this hall."""
    from cartographer_tpu_torch.core.config import TrajectoryBuilder3DOptions, apply_overrides
    from cartographer_tpu_torch.mapping.local_trajectory_builder_3d import (
        LocalTrajectoryBuilder3D,
    )

    opts = apply_overrides(TrajectoryBuilder3DOptions(),
                           {"use_online_correlative_scan_matching": correlative})
    n = NUM_SCANS_3D
    label = "3D full-size hall" + (" (correlative search)" if correlative else "")
    events, gt = _events_3d(n, scale=1.0, start=0.0)
    builder = LocalTrajectoryBuilder3D(opts, ["points"], device=dev)
    est, offset, yaw_err, finished, walls, inserted = _drive_3d(
        torch, builder, events, gt, label)
    errors = np.linalg.norm(offset, axis=1)
    if len(finished) < 1:
        _fail(f"{label}: no submap finished")
    pages = [finished[0].high_paged.num_allocated, finished[0].low_paged.num_allocated]
    result = dict(
        scans=n, inserted=inserted, mean_error_m=float(errors.mean()),
        max_error_m=float(errors.max()), mean_yaw_error_rad=float(yaw_err.mean()),
        error_by_100_scans_m=[float(errors[i:i + 100].mean()) for i in range(0, n, 100)],
        final_offset_m=offset[-20:].mean(0).tolist(), finished_submap_pages=pages,
        pool_pages=opts.tpu.max_pages, scans_per_sec=len(walls[10:]) / sum(walls[10:]))
    print(f"{label} (reported, no limit on the error): " + json.dumps(result))
    return result


def _kernel_phase_3d(torch, dev, builder, last_step):
    """K9-K12 against their twins on the card, on the pools, windows and
    clouds of the 3D run's last scan (default widths): `last_step` is that
    scan's (dense windows, packed result, insertion tensors)."""
    import dataclasses

    from cartographer_tpu_torch.mapping.local_trajectory_builder_3d import unpack_step_result
    from cartographer_tpu_torch.ops import paged_grid_3d, rot_histogram, scan_matcher_3d
    from cartographer_tpu_torch.sensor import voxel_filter
    from cartographer_tpu_torch.sensor.point_cloud import PointCloud
    from cartographer_tpu_torch.transform import quaternion as quat

    opts = builder._options
    rows = {}
    (high_grid, low_grid), packed, (est_t, local_points, keep, in_high, _) = last_step
    bins = opts.rotational_histogram_size
    u = unpack_step_result(packed, bins, builder._caps)
    host = unpack_step_result(packed.cpu().numpy(), bins, builder._caps)
    n = builder._caps[0]
    B = opts.tpu.page_size
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731

    # K2 at the shapes of the 3D step: 4096 points, 3D keys, both searches.
    perm = torch.randperm(n, generator=torch.Generator(device=dev).manual_seed(5), device=dev,
                          dtype=torch.int32)
    m = voxel_filter.voxel_filter_mask(local_points, keep, opts.voxel_filter_size, perm)
    mism = int((m != voxel_filter.voxel_filter_mask_plain(local_points, keep,
                                                          opts.voxel_filter_size, perm)).sum())
    centered = (local_points - est_t).contiguous()
    for f in (opts.high_resolution_adaptive_voxel_filter,
              opts.low_resolution_adaptive_voxel_filter):
        a = voxel_filter.adaptive_voxel_filter(
            PointCloud(centered, keep, torch.zeros(n, device=dev)), f.max_length,
            f.min_num_points, f.max_range, perm).mask
        b = voxel_filter.adaptive_voxel_filter_mask_plain(centered, keep, f.max_length,
                                                          f.min_num_points, f.max_range, perm)
        mism += int((a != (b & keep)).sum())
    if mism:
        _fail(f"K2 (3D keys, {n} points) differs from the plain twin in {mism} points")
    print(f"K2 voxel_filter at 3D shapes ({n} points): masks equal to the plain twin")

    # K10: the two windows of a scan, around the last pose.
    center = host["translation"].astype(np.float32)
    submaps = builder._active_submaps.submaps
    windows = ((submaps[0].high_paged, opts.tpu.high_grid_size),
               (submaps[0].low_paged, opts.tpu.low_grid_size))
    differ, read_bytes, gathers = 0, 0, []
    for paged, size in windows:
        got = paged.crop_dense(center, size)
        ref = paged_grid_3d.crop_dense_plain(paged.grid, t(center), size)
        differ += int((got.log_odds != ref.log_odds).sum() + (got.known != ref.known).sum()
                      + (got.origin != ref.origin).sum())
        start = (paged.grid.world_to_cell(t(center)).cpu().numpy() - size // 2)
        lo, hi = start // B, (start + size - 1) // B + 1
        nb = paged.grid.num_blocks
        lo, hi = np.clip(lo, 0, nb), np.clip(hi, 0, nb)
        table = paged.grid.page_table[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
        pages = table[table >= 0].long()
        gathers.append((paged.grid, pages))
        read_bytes += int(pages.numel()) * B ** 3 * 5 + int(table.numel()) * 4
        del got, ref
    if differ:
        _fail(f"K10 crops differ from the plain twin in {differ} cells (tolerance 0)")
    print(f"K10 paged_crop_3d: {windows[0][1]}^3 and {windows[1][1]}^3 windows, 0 differing "
          f"cells, {[int(p.numel()) for _, p in gathers]} pages under them")
    written = sum(size ** 3 * 5 + 12 for _, size in windows)
    cells = sum(size ** 3 for _, size in windows)
    rows["paged_crop_3d"] = dict(
        replaces="cartographer_tpu/ops/paged_grid_3d.py:287", max_abs_err=float(differ),
        ms=_cuda_ms(lambda: [p.crop_dense(center, s) for p, s in windows]),
        plain_ms=_cuda_ms(lambda: [paged_grid_3d.crop_dense_plain(p.grid, t(center), s)
                                   for p, s in windows], reps=3, warmup=1),
        bound=_bound(written + read_bytes, cells * 20),
        # Advanced indexing gathers the windows' pages; it does not assemble them.
        library_ms=_cuda_ms(lambda: [(g.pages[p], g.known[p]) for g, p in gathers]))

    # K9: the four insertions of a scan, on clones for the twin.
    ins = opts.submaps.range_data_inserter
    args = (ins.hit_probability, ins.miss_probability, ins.num_free_space_voxels)
    jobs = []
    for submap in submaps:
        for paged, mask_t, mask_h in ((submap.high_paged, in_high, host["high_range_mask"]),
                                      (submap.low_paged, keep, host["local_mask"])):
            twin = dataclasses.replace(paged.grid, pages=paged.grid.pages.clone(),
                                       known=paged.grid.known.clone())
            paged.insert_range_data(center, host["local_points"], mask_h, *args,
                                    device_tensors=(est_t, local_points, mask_t))
            paged_grid_3d.insert_paged_plain(twin, est_t, local_points, mask_t, *args)
            jobs.append((paged, mask_t, twin))
    differ = sum(int((p.grid.pages != w.pages).sum() + (p.grid.known != w.known).sum())
                 for p, _, w in jobs)
    if differ:
        _fail(f"K9 pools differ from the plain twin in {differ} cells (tolerance 0)")
    lins = [p._scratch.cells[p._scratch.cells >= 0] for p, _, _ in jobs]
    touched = [int(torch.unique(x).numel()) for x in lins]
    print(f"K9 paged_insert_3d: 4 pools of {opts.tpu.max_pages} x {B}^3, 0 differing cells, "
          f"{touched} cells touched")
    marks = [torch.zeros(p.grid.pages.numel(), dtype=torch.bool, device=dev)
             for p, _, _ in jobs]
    ones = [torch.ones(x.shape[0], dtype=torch.bool, device=dev) for x in lins]
    per = ins.num_free_space_voxels + 1
    rows["paged_insert_3d"] = dict(
        replaces="cartographer_tpu/ops/paged_grid_3d.py:235", max_abs_err=float(differ),
        ms=_cuda_ms(lambda: [paged_grid_3d.insert_paged(p.grid, est_t, local_points, mk, *args,
                                                        p._scratch) for p, mk, _ in jobs]),
        plain_ms=_cuda_ms(lambda: [paged_grid_3d.insert_paged_plain(
            w, est_t, local_points, mk, *args) for _, mk, w in jobs], reps=3, warmup=1),
        bound=_bound(sum(c * 10 for c in touched) + 4 * (n * 13 + 12 + n * per * 4),
                     4 * n * per * 40),
        # index_put_ sets the marks of the candidate cells; it applies nothing.
        library_ms=_cuda_ms(lambda: [mk.index_put_((x,), o)
                                     for mk, x, o in zip(marks, lins, ones)]))
    del marks, jobs

    # K11: the match from a pose 5 cm and 0.6 degrees off the scan's own.
    gn = builder._gn_params
    q0 = quat.normalize(quat.multiply(u["rotation"], quat.from_axis_angle(
        t(np.float32([0.004, -0.003, 0.01])))))
    x0 = torch.cat([u["translation"] + t(np.float32([0.04, -0.03, 0.02])), q0])
    margs = (high_grid, low_grid, u["high_points"].contiguous(), u["high_mask"],
             u["low_points"].contiguous(), u["low_mask"], x0, x0[0:3].clone(), gn)
    xk, ck, itk = scan_matcher_3d.lm_match_3d(*margs)
    xp, cp, itp = scan_matcher_3d._match_plain(*margs)
    err_t = float((xk[0:3] - xp[0:3]).abs().max())
    dq = quat.multiply(quat.conjugate(xp[3:7]), xk[3:7])
    err_r = float(2.0 * torch.asin(dq[1:4].norm().clamp(max=1.0)))
    rel_cost = abs(float(ck) - float(cp)) / max(abs(float(cp)), 1e-30)
    moved = float((xk[0:3] - x0[0:3]).norm())
    iters = int(itk)
    valid = (int(u["high_mask"].sum()), int(u["low_mask"].sum()))
    print(f"K11 scan_matcher_3d: {valid} points, pose err {err_t:.3g} m, {err_r:.3g} rad "
          f"(tolerance 1e-4 each), cost rel err {rel_cost:.3g} (rtol 1e-4), {iters} iterations "
          f"(plain {int(itp)}), moved {moved:.4f} m")
    if err_t > 1e-4 or err_r > 1e-4 or rel_cost > 1e-4 or not moved > 1e-3:
        _fail("K11 differs from the plain twin")
    passes = 1 + 2 * iters
    rows["scan_matcher_3d"] = dict(
        replaces="cartographer_tpu/ops/scan_matcher_3d.py:61", max_abs_err=max(err_t, err_r),
        ms=_cuda_ms(lambda: scan_matcher_3d.lm_match_3d(*margs)),
        plain_ms=_cuda_ms(lambda: scan_matcher_3d._match_plain(*margs), reps=3, warmup=1),
        bound=_bound(sum(valid) * (13 + 8 * 5) + 44, passes * sum(valid) * 8 * 40),
        library_ms=None)

    # K12: the histogram of the high-resolution cloud, and its rotation.
    pts, mask = u["high_points"].contiguous(), u["high_mask"]
    got = rot_histogram.compute_rotational_histogram(pts, mask, bins)
    ref = rot_histogram.rotational_histogram_plain(pts, mask, bins)
    bin_err = float((got - ref).abs().max())
    sum_err = abs(float(got.sum()) - float(ref.sum()))
    empty = rot_histogram.compute_rotational_histogram(pts, torch.zeros_like(mask), bins)
    print(f"K12 rot_histogram: {valid[0]} points, {bins} bins, sum {float(ref.sum()):.3f}: "
          f"largest bin difference {bin_err:.3g}, sum difference {sum_err:.3g} (tolerance "
          f"1e-4 each); empty cloud sum {float(empty.sum())}")
    if bin_err > 1e-4 or sum_err > 1e-4 or not float(ref.sum()) > 0 or float(empty.abs().sum()):
        _fail("K12 differs from the plain twin")
    nv, npad = valid[0], rot_histogram._padded_size(pts.shape[0])
    rows["rot_histogram"] = dict(
        replaces="cartographer_tpu/ops/rot_histogram.py:27", max_abs_err=bin_err,
        ms=_cuda_ms(lambda: rot_histogram.compute_rotational_histogram(pts, mask, bins)),
        plain_ms=_cuda_ms(lambda: rot_histogram.rotational_histogram_plain(pts, mask, bins),
                          reps=2, warmup=1),
        bound=_bound(pts.shape[0] * 13 + bins * 4,
                     npad * 45 + (2 * 129 + bins) * npad + nv * 60),
        library_ms=None)
    yaw = quat.get_yaw(u["rotation"]).contiguous()
    rot_err = float((rot_histogram.rotate_histogram(got, yaw)
                     - rot_histogram.rotate_histogram_plain(got, yaw)).abs().max())
    if rot_err > 1e-6:
        _fail(f"K12's rotation differs from the plain twin by {rot_err} (tolerance 1e-6)")
    print(f"K12 rot_histogram_rotate: max |err| {rot_err:.3g} (tolerance 1e-6)")
    rows["rot_histogram_rotate"] = dict(
        replaces="cartographer_tpu/ops/rot_histogram.py:94", max_abs_err=rot_err,
        ms=_cuda_ms(lambda: rot_histogram.rotate_histogram(got, yaw)),
        plain_ms=_cuda_ms(lambda: rot_histogram.rotate_histogram_plain(got, yaw)),
        bound=_bound(bins * 8 + 4, bins * 10), library_ms=None)
    return rows


def _full_frontend_options(**extra):
    """The default 3D options with the online correlative search and
    intensities on (trajectory_builder_3d.lua: a 0.15 m and 1 degree window,
    both weights 0.1; intensity weight 0.5, threshold 40)."""
    from cartographer_tpu_torch.core.config import TrajectoryBuilder3DOptions, apply_overrides

    return apply_overrides(TrajectoryBuilder3DOptions(), {
        "use_online_correlative_scan_matching": True, "use_intensities": True, **extra})


def _recording(module, name, calls, every=1):
    """Wrap module.name so the arguments of every `every`-th call are
    appended to `calls`; returns a function that restores it."""
    original = getattr(module, name)
    seen = [0]

    def recorded(*args):
        if seen[0] % every == 0:
            calls.append(args)
        seen[0] += 1
        return original(*args)

    setattr(module, name, recorded)
    return lambda: setattr(module, name, original)


def _slice_phase_3d_full(torch, dev):
    """The 3D frontend at its full options on the card, over simulated scans
    of the half-scale hall with per-return intensities."""
    from cartographer_tpu_torch.mapping import local_trajectory_builder_3d as ltb
    from cartographer_tpu_torch.ops import cuda

    opts, n = _full_frontend_options(), NUM_SCANS_3D
    label = "3D full frontend"
    events, gt = _events_3d(n + PROFILED_SCANS + 1, intensities=True)
    builder = ltb.LocalTrajectoryBuilder3D(opts, ["points"], device=dev)
    cuda.reset_launch_counts()
    est, offset, yaw_err, finished, walls, inserted = _drive_3d(
        torch, builder, events[:n], gt, label)
    launches = cuda.launch_counts()
    print(f"{label}: launches {launches}")
    _check_launched(launches, FULL_FRONTEND_KERNELS, label)
    expected = {"correlative_3d": n, "scan_matcher_3d": n, "paged_intensity_crop_3d": n - 1,
                "paged_intensity_insert_3d": launches["paged_insert_3d"] // 2}
    wrong = {k: (launches[k], v) for k, v in expected.items() if launches[k] != v}
    if wrong:
        _fail(f"{label}: launches (got, expected) {wrong}")
    if len(finished) < 1:
        _fail(f"{label}: no submap finished")
    f = finished[0]
    ig = f.intensity_grid
    counted = int(ig.counts.sum())
    print(f"{label}: finished submap of {f.num_range_data} scans: "
          f"{f.intensity_paged.num_allocated} intensity pages (high {f.high_paged.num_allocated}"
          f", low {f.low_paged.num_allocated}), intensity crop {tuple(ig.sums.shape)} with "
          f"{counted} returns counted")
    if tuple(ig.sums.shape) != tuple(f.high_grid.log_odds.shape) or counted == 0:
        _fail(f"{label}: the finished submap's intensity crop is empty or misshapen")
    # The search picks rotations a step of some 0.007 rad apart and the LM's
    # rotation penalty holds the pose at its choice, so the yaw lags the
    # hall's turns, and near-ties of the search make each run a different
    # path: over these 400 scans the JAX builder's mean yaw error is 0.0180
    # rad and the port's plain path's 0.0100 on the CPU
    # (tests/hall_yaw_witness_3d.py), the card's 0.018-0.026 (PERF.md).
    # The limit stands above the largest of those readings.
    errors = np.linalg.norm(offset, axis=1)
    print(f"{label}: mean error {errors.mean():.4f} m (max {errors.max():.4f}), mean yaw error "
          f"{yaw_err.mean():.5f} rad (max {yaw_err.max():.5f}) against ground truth (limits "
          f"0.25 m, {FULL_FRONTEND_YAW_LIMIT} rad)")
    if not (errors.mean() <= 0.25 and yaw_err.mean() <= FULL_FRONTEND_YAW_LIMIT):
        _fail(f"{label} lost the ground truth")
    worst = _cpu_agreement_3d(torch, dev, opts, events, est, label)
    profile = _profile(torch, lambda e: _feed_3d(builder, e), events[n:n + PROFILED_SCANS],
                       f"{label} profile")
    # One more scan, keeping the arguments of its correlative search and LM
    # match and what its insertion reads, for the kernel phase.
    kept = {"correlative": [], "lm": []}
    restore = [_recording(ltb, "correlative_match_3d", kept["correlative"]),
               _recording(ltb, "lm_match_3d", kept["lm"])]
    step = builder._fused_step

    def keeping_step(*args):
        out = step(*args)
        kept["step"] = (args[:3], *out)
        return out

    builder._fused_step = keeping_step
    try:
        _feed_3d(builder, events[n + PROFILED_SCANS])
    finally:
        del builder._fused_step
        for r in restore:
            r()
    # The same phase over the scans of other seeds (the sensor noise and the
    # intensities): the spread of the yaw error, reported beside the CPU
    # witnesses' (tests/hall_yaw_witness_3d.py), not limited.
    yaw_by_seed = {0: float(yaw_err.mean())}
    for seed in YAW_SEEDS:
        events_s, gt_s = _events_3d(n, seed=seed, intensities=True)
        b = ltb.LocalTrajectoryBuilder3D(opts, ["points"], device=dev)
        _, offset_s, yaw_s, _, _, _ = _drive_3d(torch, b, events_s, gt_s, f"{label} seed {seed}")
        yaw_by_seed[seed] = float(yaw_s.mean())
        print(f"{label} seed {seed}: mean error {np.linalg.norm(offset_s, axis=1).mean():.4f} "
              f"m, mean yaw error {yaw_s.mean():.5f} rad (reported)")
        del b
    steady = walls[10:]
    return dict(
        builder=builder, kept=kept, profile=profile, scans=n, inserted=inserted,
        finished_submaps=len(finished), mean_error_m=float(errors.mean()),
        max_error_m=float(errors.max()), mean_yaw_error_rad=float(yaw_err.mean()),
        mean_yaw_error_rad_by_seed=yaw_by_seed,
        yaw_error_by_100_scans_rad=[float(yaw_err[i:i + 100].mean()) for i in range(0, n, 100)],
        final_offset_m=offset[-20:].mean(0).tolist(),
        frontend_3d_builder_scans_per_sec=len(steady) / sum(steady),
        host_seconds=builder.host_seconds, device_seconds=builder.device_seconds,
        allocator_ms_per_inserted_scan=builder.allocator_seconds * 1e3 / max(inserted, 1),
        new_pages_per_inserted_scan=builder.pages_allocated / max(inserted, 1),
        finished_submap_pages=[f.high_paged.num_allocated, f.low_paged.num_allocated,
                               f.intensity_paged.num_allocated],
        launches=launches, lm_iterations_per_scan=float(np.mean(builder.lm_iterations[1:n])),
        cpu_agreement=[float(worst[0]), float(worst[1])])


def _correlative_cells(torch, grid, points, mask, x0, params):
    """The distinct window cells K17's candidates read for this scan, and
    the number of valid rotations: the data-dependent part of its bound."""
    from cartographer_tpu_torch.ops import scan_matcher_3d as sm
    from cartographer_tpu_torch.transform import quaternion as quat

    nl, na = sm.search_sizes(grid.resolution, params)
    step = sm._angular_step(points, mask, grid.resolution)
    ang = torch.arange(-na, na + 1, device=points.device).to(torch.float32) * step
    valid = ang[ang.abs() <= float(np.float32(params.angular_search_window + 1e-6))]
    aa = torch.stack(torch.meshgrid(valid, valid, valid, indexing="ij"), -1).reshape(-1, 3)
    qs, _ = sm._axis_angle_quaternion(aa)
    pts = points[mask]
    world = quat.rotate_expanded(x0[None, None, 3:7], quat.rotate_expanded(qs[:, None], pts[None]))
    cells = torch.floor(grid.world_to_cell_continuous(world + x0[0:3])).long().reshape(-1, 3)
    r = torch.arange(-nl, nl + 1, device=points.device)
    shifts = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    size = grid.size
    c = (cells[None] + shifts[:, None]).clamp(-1, size)  # outside the window: one cell
    lin = (c[..., 0] * (size + 2) + c[..., 1]) * (size + 2) + c[..., 2]
    return int(torch.unique(lin).numel()), aa.shape[0]


def _kernel_phase_3d_full(torch, dev, builder, kept):
    """K17, K18, K19 and K11 with its intensity rows against their twins on
    the card, on the pools, windows and clouds of the full frontend's last
    scan (default widths)."""
    import dataclasses

    from cartographer_tpu_torch.mapping.local_trajectory_builder_3d import unpack_step_result
    from cartographer_tpu_torch.ops import paged_grid_3d, scan_matcher_3d
    from cartographer_tpu_torch.transform import quaternion as quat

    opts = builder._options
    rows = {}
    (high_grid, _, intensity_grid), packed, device_tensors = kept["step"]
    est_t, local_points, keep, in_high, intensities = device_tensors
    bins = opts.rotational_histogram_size
    host = unpack_step_result(packed.cpu().numpy(), bins, builder._caps, True)
    B = opts.tpu.page_size
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731

    # K17: the step's own search, from its prediction.
    cgrid, cpoints, cmask, x0, cparams = kept["correlative"][0]
    cargs = (cgrid, cpoints, cmask, x0, cparams)
    score, x, best = scan_matcher_3d._correlative_kernel(*cargs)
    ref_score, ref_x, ref_index = scan_matcher_3d.correlative_match_3d_plain(*cargs)
    index = ~int(best.cpu()) & 0xFFFFFFFF
    q_err = float((x[3:7] - ref_x[3:7]).abs().max())
    cells, rotations = _correlative_cells(torch, *cargs)
    valid = int(cmask.sum())
    nl, na = scan_matcher_3d.search_sizes(cgrid.resolution, cparams)
    translations, a3, n_high = (2 * nl + 1) ** 3, (2 * na + 1) ** 3, cpoints.shape[0]
    print(f"K17 correlative_3d: {valid} points, {rotations} valid rotations of {a3}, "
          f"best {index} (twin {ref_index}), score {float(score):.7g} (twin "
          f"{float(ref_score):.7g}), quaternion err {q_err:.3g} (tolerance: index and score "
          f"bit for bit, offsets equal, quaternion 1e-6), {cells} window cells read")
    if (index != ref_index or float(score) != float(ref_score)
            or not torch.equal(x[0:3], ref_x[0:3]) or q_err > 1e-6):
        _fail("K17 differs from the plain twin")
    rows["correlative_3d"] = dict(
        replaces="cartographer_tpu/ops/scan_matcher_3d.py:144", max_abs_err=q_err,
        ms=_cuda_ms(lambda: scan_matcher_3d._correlative_kernel(*cargs)),
        plain_ms=_cuda_ms(lambda: scan_matcher_3d.correlative_match_3d_plain(*cargs), reps=3,
                          warmup=1),
        # The range maximum over the valid points, once (7 per point), the
        # valid rotations' transforms of the valid points (36 per point)
        # and their candidates' lookups (a sigmoid, the compare and the
        # sum: 12 per point and translation).
        bound=_bound(n_high * 13 + 28 + cells * 5,
                     valid * 7 + rotations * valid * 36
                     + rotations * translations * valid * 12),
        library_ms=None)

    # K19: the scan's intensity window around its prediction.
    # A center in the middle of the window's middle cell: the same window.
    size = opts.tpu.high_grid_size
    center = np.asarray(cgrid.origin.cpu().numpy() + (size // 2 + 0.5) * cgrid.resolution,
                        np.float32)
    paged = builder._active_submaps.submaps[0].intensity_paged
    got = paged.crop_dense(center, size)
    ref = paged_grid_3d.crop_dense_intensity_plain(paged.grid, t(center), size)
    differ = int((got.sums != ref.sums).sum() + (got.counts != ref.counts).sum()
                 + (got.origin != ref.origin).sum())
    if differ:
        _fail(f"K19 differs from the plain twin in {differ} cells (tolerance 0)")
    if not torch.equal(got.origin, cgrid.origin):
        _fail("K19's window is not the high occupancy window")
    start = paged.grid.world_to_cell(t(center)).cpu().numpy() - size // 2
    nb = paged.grid.num_blocks
    lo = np.clip(start // B, 0, nb)
    hi = np.clip((start + size - 1) // B + 1, 0, nb)
    table = paged.grid.page_table[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
    pages = table[table >= 0].long()
    print(f"K19 paged_intensity_crop_3d: {size}^3 window, 0 differing cells, "
          f"{int(pages.numel())} pages under it")
    g = paged.grid
    rows["paged_intensity_crop_3d"] = dict(
        replaces="cartographer_tpu/ops/paged_grid_3d.py:410", max_abs_err=float(differ),
        ms=_cuda_ms(lambda: paged.crop_dense(center, size)),
        plain_ms=_cuda_ms(lambda: paged_grid_3d.crop_dense_intensity_plain(g, t(center), size),
                          reps=3, warmup=1),
        bound=_bound(size ** 3 * 8 + 12 + int(pages.numel()) * B ** 3 * 8
                     + int(table.numel()) * 4, size ** 3 * 20),
        # Advanced indexing gathers the window's pages; it does not assemble them.
        library_ms=_cuda_ms(lambda: (g.sums[pages], g.counts[pages])))

    # K18: the scan's insertions into both submaps' intensity pools, on clones
    # for the twin.
    threshold = opts.submaps.range_data_inserter.intensity_threshold
    jobs = []
    for submap in builder._active_submaps.submaps:
        p = submap.intensity_paged
        twin = dataclasses.replace(p.grid, sums=p.grid.sums.clone(), counts=p.grid.counts.clone())
        p.insert(host["local_points"], host["local_intensities"], host["high_range_mask"],
                 threshold, device_tensors=(local_points, intensities, in_high))
        paged_grid_3d.insert_intensity_paged_plain(twin, local_points, intensities, in_high,
                                                   threshold)
        jobs.append((p, twin))
    count_diff = sum(int((p.grid.counts != w.counts).sum()) for p, w in jobs)
    sum_err = max(float(((p.grid.sums - w.sums).abs()
                         / w.sums.abs().clamp(min=1e-30)).max()) for p, w in jobs)
    if count_diff or sum_err > 1e-5:
        _fail(f"K18 differs from the plain twin: {count_diff} counts, sums {sum_err:.3g} "
              f"relative (tolerance: counts exact, sums 1e-5)")
    n = local_points.shape[0]
    ok = in_high & (intensities <= threshold)
    lins = []
    for p, _ in jobs:
        lin, found = paged_grid_3d._pool_index(p.grid, p.grid.world_to_cell(local_points), ok)
        lins.append(lin[found])
    touched = [int(torch.unique(x).numel()) for x in lins]
    values = [torch.ones(x.numel(), device=dev) for x in lins]
    print(f"K18 paged_intensity_insert_3d: {len(jobs)} pools, counts equal, sums within "
          f"{sum_err:.3g} relative (tolerance 1e-5), {touched} cells touched")
    rows["paged_intensity_insert_3d"] = dict(
        replaces="cartographer_tpu/ops/paged_grid_3d.py:385", max_abs_err=sum_err,
        ms=_cuda_ms(lambda: [paged_grid_3d.insert_intensity_paged(
            p.grid, local_points, intensities, in_high, threshold) for p, _ in jobs]),
        plain_ms=_cuda_ms(lambda: [paged_grid_3d.insert_intensity_paged_plain(
            w, local_points, intensities, in_high, threshold) for _, w in jobs], reps=3,
            warmup=1),
        bound=_bound(len(jobs) * (n * 17 + 12) + sum(c * 16 for c in touched),
                     len(jobs) * n * 12),
        # index_add_ of the counts: the scatter of one of the two pools, with
        # the pool indices computed beforehand.
        library_ms=_cuda_ms(lambda: [p.grid.counts.view(-1).index_add_(0, x, v)
                                     for (p, _), x, v in zip(jobs, lins, values)]))
    del jobs

    # K11 with its intensity rows: the step's match from a pose 5 cm and 0.6
    # degrees off.
    hg, lg, hp, hm, lp, lm, _, tt, gn, ig, hi = kept["lm"][0]
    u = unpack_step_result(packed, bins, builder._caps, True)
    q0 = quat.normalize(quat.multiply(u["rotation"], quat.from_axis_angle(
        t(np.float32([0.004, -0.003, 0.01])))))
    x1 = torch.cat([u["translation"] + t(np.float32([0.04, -0.03, 0.02])), q0])
    margs = (hg, lg, hp, hm, lp, lm, x1, x1[0:3].clone(), gn, ig, hi)
    xk, ck, itk = scan_matcher_3d.lm_match_3d(*margs)
    xp, cp, itp = scan_matcher_3d._match_plain(*margs)
    err_t = float((xk[0:3] - xp[0:3]).abs().max())
    dq = quat.multiply(quat.conjugate(xp[3:7]), xk[3:7])
    err_r = float(2.0 * torch.asin(dq[1:4].norm().clamp(max=1.0)))
    rel_cost = abs(float(ck) - float(cp)) / max(abs(float(cp)), 1e-30)
    iters = int(itk)
    counts = (int(hm.sum()), int(lm.sum()), int((hm & (hi <= gn.intensity_threshold)).sum()))
    print(f"K11 scan_matcher_3d with intensity rows: {counts} occupancy, occupancy and "
          f"intensity rows, pose err {err_t:.3g} m, {err_r:.3g} rad (tolerance 1e-4 each), cost "
          f"rel err {rel_cost:.3g} (rtol 1e-4), {iters} iterations (plain {int(itp)})")
    if err_t > 1e-4 or err_r > 1e-4 or rel_cost > 1e-4:
        _fail("K11 with intensity rows differs from the plain twin")
    passes = 1 + 2 * iters
    rows["scan_matcher_3d_intensity"] = dict(
        symbol="scan_matcher_3d", replaces="cartographer_tpu/ops/scan_matcher_3d.py:93",
        max_abs_err=max(err_t, err_r),
        ms=_cuda_ms(lambda: scan_matcher_3d.lm_match_3d(*margs)),
        plain_ms=_cuda_ms(lambda: scan_matcher_3d._match_plain(*margs), reps=3, warmup=1),
        bound=_bound(sum(counts[:2]) * (13 + 8 * 5) + counts[2] * (4 + 8 * 8) + 44,
                     passes * (sum(counts[:2]) * 8 * 40 + counts[2] * 8 * 50)),
        library_ms=None)
    return rows


def _large_scan_phase_3d(torch, dev):
    """The 3D frontend at the default options plus intensities with a
    16-ring x 1024-azimuth sensor, `tpu.scan_capacity` 16,384: K2's table
    above one block's shared memory, K18's sort above one block's 8,192 keys.
    The first scans again on the CPU's plain path; K2 and K18 against their
    twins on the last scan."""
    import dataclasses

    from cartographer_tpu_torch.core.config import TrajectoryBuilder3DOptions, apply_overrides
    from cartographer_tpu_torch.mapping import local_trajectory_builder_3d as ltb
    from cartographer_tpu_torch.ops import cuda, paged_grid_3d
    from cartographer_tpu_torch.sensor import voxel_filter
    from cartographer_tpu_torch.sensor.point_cloud import PointCloud

    label = f"3D frontend at {LARGE_SCAN_CAPACITY} returns"
    opts = apply_overrides(TrajectoryBuilder3DOptions(), {
        "use_intensities": True, "tpu.scan_capacity": LARGE_SCAN_CAPACITY})
    n = LARGE_SCANS_3D
    events, gt = _events_3d(n + 1, azimuths=LARGE_SCAN_CAPACITY // 16, intensities=True)
    builder = ltb.LocalTrajectoryBuilder3D(opts, ["points"], device=dev)
    cuda.reset_launch_counts()
    est, offset, yaw_err, _, walls, inserted = _drive_3d(torch, builder, events[:n], gt, label)
    launches = cuda.launch_counts()
    _check_launched(launches, ("voxel_filter", "paged_insert_3d", "paged_crop_3d",
                               "scan_matcher_3d", "paged_intensity_insert_3d",
                               "paged_intensity_crop_3d"), label)
    errors = np.linalg.norm(offset, axis=1)
    print(f"{label}: mean error {errors.mean():.4f} m, mean yaw error {yaw_err.mean():.5f} rad "
          f"(reported), launches {launches}")
    worst = _cpu_agreement_3d(torch, dev, opts, events, est, label)

    # One more scan, keeping its step's tensors.
    kept, step = {}, builder._fused_step

    def keeping_step(*args):
        out = step(*args)
        kept["step"] = out
        return out

    builder._fused_step = keeping_step
    try:
        _feed_3d(builder, events[n])
    finally:
        del builder._fused_step
    packed, device_tensors = kept["step"]
    _, local_points, _, in_high, intensities = device_tensors
    host = ltb.unpack_step_result(packed.cpu().numpy(), opts.rotational_histogram_size,
                                  builder._caps, True)
    rows = {}

    # K2: the scan's 16,384 raw returns, 3D keys, then both adaptive filters.
    pts = torch.from_numpy(np.ascontiguousarray(events[n][1].ranges[:, :3])).to(dev)
    size = pts.shape[0]
    mask = torch.ones(size, dtype=torch.bool, device=dev)
    perm = torch.randperm(size, generator=torch.Generator(device=dev).manual_seed(5),
                          device=dev, dtype=torch.int32)
    keep = voxel_filter.voxel_filter_mask(pts, mask, opts.voxel_filter_size, perm)
    mism = int((keep != voxel_filter.voxel_filter_mask_plain(
        pts, mask, opts.voxel_filter_size, perm)).sum())
    cloud = PointCloud(pts, keep, torch.zeros(size, device=dev))
    filters = (opts.high_resolution_adaptive_voxel_filter,
               opts.low_resolution_adaptive_voxel_filter)
    for f in filters:
        a = voxel_filter.adaptive_voxel_filter(cloud, f.max_length, f.min_num_points,
                                               f.max_range, perm).mask
        b = voxel_filter.adaptive_voxel_filter_mask_plain(pts, keep, f.max_length,
                                                          f.min_num_points, f.max_range, perm)
        mism += int((a != b).sum())
    print(f"K2 voxel_filter at {size} points (table in device memory): {mism} points differ "
          f"from the twin (tolerance: exact)")
    if mism:
        _fail(f"K2 at {size} points differs from the plain twin")

    def k2_scan():
        m = voxel_filter.voxel_filter_mask(pts, mask, opts.voxel_filter_size, perm)
        c = PointCloud(pts, m, cloud.intensities)
        for f in filters:
            voxel_filter.adaptive_voxel_filter(c, f.max_length, f.min_num_points, f.max_range,
                                               perm)

    def k2_plain():
        m = voxel_filter.voxel_filter_mask_plain(pts, mask, opts.voxel_filter_size, perm)
        for f in filters:
            voxel_filter.adaptive_voxel_filter_mask_plain(pts, m, f.max_length,
                                                          f.min_num_points, f.max_range, perm)

    valid = int(keep.sum())
    key_sets = [voxel_filter._packed_voxel_keys(pts, mask, opts.voxel_filter_size)] + [
        voxel_filter._packed_voxel_keys(pts, keep, f.max_length) for f in filters]
    rows["voxel_filter"] = dict(
        max_abs_err=float(mism), ms=_cuda_ms(k2_scan), plain_ms=_cuda_ms(k2_plain, reps=3),
        # Up to 13 hashing passes per adaptive filter, 20 operations per
        # point and pass; the bytes as K2's row.
        bound=_bound(size * 18 + 2 * size * 14, (1 + 2 * 13) * valid * 20),
        library_ms=_cuda_ms(lambda: [torch.unique(k) for k in key_sets]))

    # K18: the scan's insertion into both submaps' intensity pools, against
    # the CPU twin to the bit.
    threshold = opts.submaps.range_data_inserter.intensity_threshold
    jobs = []
    for submap in builder._active_submaps.submaps:
        p = submap.intensity_paged
        p.insert(host["local_points"], host["local_intensities"], host["high_range_mask"],
                 threshold, device_tensors=(local_points, intensities, in_high))
        jobs.append(p)
    before = [dataclasses.replace(p.grid, sums=p.grid.sums.clone(), counts=p.grid.counts.clone())
              for p in jobs]
    cpu_args = (local_points.cpu(), intensities.cpu(), in_high.cpu())
    differ = 0
    for p, b in zip(jobs, before):
        twin = dataclasses.replace(b, sums=b.sums.cpu(), counts=b.counts.cpu(),
                                   page_table=b.page_table.cpu(), origin=b.origin.cpu())
        paged_grid_3d.insert_intensity_paged_plain(twin, *cpu_args, threshold)
        paged_grid_3d.insert_intensity_paged(p.grid, local_points, intensities, in_high,
                                             threshold)
        differ += int((p.grid.sums.cpu() != twin.sums).sum()
                      + (p.grid.counts.cpu() != twin.counts).sum())
    touched = [int(torch.unique(paged_grid_3d._pool_index(
        b, b.world_to_cell(local_points), in_high & (intensities <= threshold))[0]).numel())
        for b in before]
    print(f"K18 paged_intensity_insert_3d at {local_points.shape[0]} returns (multi-block "
          f"sort): {differ} pool cells differ from the CPU twin (tolerance: exact), "
          f"{touched} cells touched")
    if differ:
        _fail(f"K18 at {local_points.shape[0]} returns differs from the CPU twin")
    nret = local_points.shape[0]
    rows["paged_intensity_insert_3d"] = dict(
        max_abs_err=float(differ),
        ms=_cuda_ms(lambda: [paged_grid_3d.insert_intensity_paged(
            b, local_points, intensities, in_high, threshold) for b in before]),
        plain_ms=_cuda_ms(lambda: [paged_grid_3d.insert_intensity_paged_plain(
            b, local_points, intensities, in_high, threshold) for b in before], reps=3,
            warmup=1),
        bound=_bound(len(jobs) * (nret * 17 + 12) + sum(c * 16 for c in touched),
                     len(jobs) * nret * 12),
        library_ms=None)
    steady = walls[10:]
    return dict(scans=n, returns_per_scan=nret, inserted=inserted,
                mean_error_m=float(errors.mean()), mean_yaw_error_rad=float(yaw_err.mean()),
                frontend_3d_builder_scans_per_sec=len(steady) / sum(steady),
                host_seconds=builder.host_seconds, device_seconds=builder.device_seconds,
                cpu_agreement=[float(worst[0]), float(worst[1])], launches=launches,
                kernels=rows)


def _imu_based_phase_3d(torch, dev):
    """The 3D frontend with the IMU-based extrapolator and intensities over
    200 scans of the half-scale hall with a 1 s pose queue (error reported,
    not limited; the first scans again on the CPU's plain path), then over
    IMU_DEFAULT_QUEUE_SCANS with the default 5 s queue, whose host cost is
    read once the queue is full (scans are 0.1 s apart)."""
    from cartographer_tpu_torch.mapping.local_trajectory_builder_3d import (
        LocalTrajectoryBuilder3D,
    )

    def drive(queue_s, n, label):
        opts = _full_frontend_options(**{
            "use_online_correlative_scan_matching": False,
            "pose_extrapolator.use_imu_based": True,
            "pose_extrapolator.imu_based.pose_queue_duration": queue_s})
        events, gt = _events_3d(n, intensities=True)
        builder = LocalTrajectoryBuilder3D(opts, ["points"], device=dev)
        est, offset, yaw_err, _, walls, inserted = _drive_3d(torch, builder, events, gt, label)
        full = walls[int(round(queue_s / 0.1)):]  # scans once the queue holds queue_s
        errors = np.linalg.norm(offset, axis=1)
        result = dict(
            scans=n, pose_queue_duration_s=queue_s, inserted=inserted,
            mean_error_m=float(errors.mean()), max_error_m=float(errors.max()),
            mean_yaw_error_rad=float(yaw_err.mean()),
            host_ms_per_scan=builder.host_seconds * 1e3 / n,
            device_ms_per_scan=builder.device_seconds * 1e3 / n,
            wall_ms_per_scan_full_queue=float(np.mean(full)) * 1e3,
            scans_per_sec_full_queue=len(full) / sum(full))
        return opts, events, est, errors, result

    label = "3D IMU-based extrapolator"
    opts, events, est, errors, result = drive(1.0, NUM_SCANS_IMU, label)
    worst = _cpu_agreement_3d(torch, dev, opts, events, est, label)
    result.update(
        error_by_50_scans_m=[float(errors[i:i + 50].mean()) for i in range(0, len(errors), 50)],
        cpu_agreement=[float(worst[0]), float(worst[1])])
    print(f"{label} (reported, no limit on the error): " + json.dumps(result))
    label = "3D IMU-based extrapolator, default 5 s queue"
    *_, default = drive(5.0, IMU_DEFAULT_QUEUE_SCANS, label)
    print(f"{label} (reported, no limit on the error): " + json.dumps(default))
    result["default_queue"] = default
    return result


def _pair_args(cb, r):
    """The arguments of `fast_correlative_match_3d` for a local request of
    the 3D constraint builder, as its search passes them."""
    hp, hm, lp, lm, hist, init = (x[0].contiguous() for x in cb._clouds([r]))
    m = r.matcher
    return (m.stack, m.high_grid, m.low_grid, hp, hm, lp, lm, hist, m.histogram,
            init[0:3].contiguous(), init[3:7].contiguous(), cb.bnb_params,
            cb._options.min_score, m.low_probability)


def _global_phase_3d(torch, dev):
    """3D global SLAM through MapBuilder on the card over three laps of the
    half-scale hall, then one global localization."""
    from cartographer_tpu_torch.core.config import MapBuilderOptions, TrajectoryBuilderOptions
    from cartographer_tpu_torch.mapping.constraint_builder_3d import MatchRequest3D
    from cartographer_tpu_torch.mapping.id import SubmapId
    from cartographer_tpu_torch.mapping.map_builder import MapBuilder
    from cartographer_tpu_torch.ops import bnb_3d, cuda
    from cartographer_tpu_torch.simulation import Path, Robot
    from cartographer_tpu_torch.transform import nquat

    t_sim = time.monotonic()
    events, gt = _events_3d(GLOBAL_SCANS_3D)
    print(f"3D global: {time.monotonic() - t_sim:.1f} s to simulate {len(events)} scans")
    mb = MapBuilder(MapBuilderOptions(use_trajectory_builder_3d=True), device=dev)
    pg = mb.pose_graph
    cb = pg.constraint_builder
    recorded = []
    compute = cb.compute_constraints

    def recording(requests):
        recorded.extend(r for r in requests[:64 - len(recorded)] if not r.match_full)
        return compute(requests)

    cb.compute_constraints = recording
    tid = mb.add_trajectory_builder(["points", "imu"], TrajectoryBuilderOptions())
    cuda.reset_launch_counts()
    t0 = time.monotonic()
    for imus, scan in events:
        for message in imus:
            mb.add_sensor_data(tid, "imu", message)
        mb.add_sensor_data(tid, "points", scan)
    mb.finish_trajectory(tid)
    pg.run_final_optimization()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = cuda.launch_counts()
    cb.compute_constraints = compute
    inter, solves = pg.num_inter_constraints(), pg.solves
    print(f"3D global: {len(events)} scans, {len(pg.nodes)} nodes, {len(pg.submap_data)} "
          f"submaps, {inter} loop closures from {cb.pairs_matched} pairs tried, {solves} solves, "
          f"{wall:.1f} s wall; constraint search {cb.match_seconds:.2f} s on its threads "
          f"({cb.match_seconds * 1e3 / max(cb.pairs_matched, 1):.2f} ms per pair), solves "
          f"{pg.solve_seconds:.2f} s ({pg.snapshot_seconds:.3f} s of host snapshots); launches "
          f"{launches}")
    _check_launched(launches, KERNELS_3D_GLOBAL, "3D global SLAM")
    if inter < 50 or solves < 3 or not recorded:
        _fail(f"3D global SLAM ran {inter} loop closures and {solves} solves (need >= 50, >= 3)")
    # Node -> scan index: scan i is stamped TIME_OFFSET_US + (i + 1) * 0.1 s.
    index = {nid: int(round((node.time - TIME_OFFSET_US) / 1e5)) - 1
             for nid, node in pg.nodes.items()}

    def mean_error(position):
        return float(np.mean([np.linalg.norm(np.concatenate([
            position(node)[:2] - gt[index[nid], :2], position(node)[2:3]]))
            for nid, node in pg.nodes.items()]))

    local_err = mean_error(lambda n: n.local_pose_translation)
    global_err = mean_error(lambda n: n.global_t)
    print(f"3D global: mean error of the optimized poses {global_err:.4f} m, of the frontend's "
          f"{local_err:.4f} m (limit: the frontend's + 0.02 m); learned gravity "
          f"{pg.trajectory_data[0]['gravity_constant']:.4f} m/s^2")
    if not global_err <= local_err + 0.02:
        _fail("3D optimized poses are worse than the frontend's by more than 0.02 m")

    # Global localization: a third-lap node against submap 0, yaw unknown.
    robot = Robot(Path.superellipse(11.0 * 0.5, 7.0 * 0.5), 1.4, 6.0, 3.0)
    lap = ((robot.arc_at((np.arange(len(events)) + 1) * 0.1) - 3.0)
           // robot.path.arc[-1]).astype(int)
    entry = pg.submap_data[SubmapId(0, 0)]
    late = [(nid, node) for nid, node in pg.nodes.items() if lap[index[nid]] >= 2]
    nid, node = min(late, key=lambda kv: np.linalg.norm(
        kv[1].global_t - entry.submap.local_pose_translation))
    matcher = cb.matcher_for(SubmapId(0, 0), entry.submap)
    unknown_yaw = nquat.multiply(nquat.from_yaw(1.0), node.gravity_alignment)
    req = MatchRequest3D(SubmapId(0, 0), nid, matcher, node.high_res_cloud, node.low_res_cloud,
                         np.asarray(node.scan_histogram, np.float32), np.zeros(3), unknown_yaw,
                         match_full=True)
    hp, hm, lp, lm, hist, _ = (x[0].contiguous() for x in cb._clouds([req]))
    node_q = torch.tensor(unknown_yaw, dtype=torch.float32, device=dev)
    identity = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    t0 = time.monotonic()
    found, score, loc_t, loc_q, rot, low, certified = bnb_3d.match_full_submap_3d_exact(
        matcher.stack, matcher.high_grid, matcher.low_grid, hp, hm, lp, lm, hist,
        matcher.histogram, node_q, identity, cb.bnb_params,
        pg._options.constraint_builder.global_localization_min_score,
        low_probability=matcher.low_probability)
    loc_s = time.monotonic() - t0
    loc_err = float(np.linalg.norm(loc_t - node.global_t))
    rot_err = float(nquat.angle(nquat.multiply(nquat.conjugate(node.global_q), loc_q)))
    print(f"3D global localization: node {nid} (scan {index[nid]}, lap {lap[index[nid]] + 1}) "
          f"in submap (0, 0): score {score:.4f}, found {found}, certified {certified}, "
          f"{loc_err:.4f} m and {rot_err:.4f} rad from its optimized pose (limits 0.2 m, "
          f"0.05 rad), {loc_s:.2f} s")
    if not (found and certified and loc_err <= 0.2 and rot_err <= 0.05):
        _fail("3D global localization did not come back certified within 0.2 m and 0.05 rad")
    # The first recorded pair whose search found a match, for K15's check.
    request = next((r for r in recorded
                    if float(bnb_3d.fast_correlative_match_3d(*_pair_args(cb, r))[0]) > 0.5),
                   recorded[0])
    return dict(
        pose_graph=pg, request=request, node=node, node_rotation=unknown_yaw,
        summary=dict(
            scans=len(events), nodes=len(pg.nodes), submaps=len(pg.submap_data),
            loop_closures=inter, pairs_tried=cb.pairs_matched, solves=solves,
            wall_seconds=wall, constraint_search_seconds=cb.match_seconds,
            solve_seconds=pg.solve_seconds, snapshot_seconds=pg.snapshot_seconds,
            wall_ms_per_pair=cb.match_seconds * 1e3 / max(cb.pairs_matched, 1),
            launches=launches, mean_error_optimized_m=global_err,
            mean_error_frontend_m=local_err, global_localization_score=score,
            global_localization_certified=certified, global_localization_error_m=loc_err,
            global_localization_error_rad=rot_err, global_localization_seconds=loc_s))


def _backend_kernel_phase_3d(torch, dev, ctx):
    """K13-K16 against their twins on the card, on the 3D global run's node,
    finished submap and first local pair, and on a synthetic SE(3) pose
    graph with IMU terms at the solver's capacity."""
    import torch.nn.functional as F

    from cartographer_tpu_torch.interop import schur_problem_3d_from_numpy
    from cartographer_tpu_torch.ops import bnb_3d, rot_histogram
    from cartographer_tpu_torch.parallel import schur_spa_3d
    from cartographer_tpu_torch.simulation import synthetic_pose_graph_3d
    from cartographer_tpu_torch.transform import quaternion as quat

    rows, extra = {}, {}
    pg, req = ctx["pose_graph"], ctx["request"]
    cb = pg.constraint_builder
    m = req.matcher
    params = cb.bnb_params

    # K13: the node's full-circle yaws (1259 at 0.1 m and 20 m).
    n_yaws = bnb_3d.full_circle_yaws(m.high_grid.resolution, params.max_scan_range)
    hist = torch.tensor(np.asarray(ctx["node"].scan_histogram, np.float32), device=dev)
    yaw0 = float(quat.get_yaw(torch.tensor(ctx["node_rotation"])))
    angles = (yaw0 + (torch.arange(n_yaws, dtype=torch.float32, device=dev) - n_yaws // 2)
              * np.float32(2.0 * np.pi / n_yaws)).contiguous()
    got = rot_histogram.match_histograms(m.histogram, hist, angles)
    ref = rot_histogram.match_histograms_plain(m.histogram, hist, angles)
    err = float((got - ref).abs().max())
    print(f"K13 rot_match: {n_yaws} yaws x {hist.shape[0]} bins, max |err| {err:.3g} "
          f"(tolerance 1e-6), best score {float(got.max()):.4f}")
    if not err <= 1e-6:
        _fail("K13 differs from the plain twin")
    bins = hist.shape[0]
    rows["rot_match"] = dict(
        replaces="cartographer_tpu/ops/rot_histogram.py:107", max_abs_err=err,
        ms=_cuda_ms(lambda: rot_histogram.match_histograms(m.histogram, hist, angles)),
        plain_ms=_cuda_ms(lambda: rot_histogram.match_histograms_plain(m.histogram, hist,
                                                                       angles)),
        bound=_bound(2 * bins * 4 + 2 * n_yaws * 4, n_yaws * bins * 14), library_ms=None)

    # K14: the stack of a finished submap's 256^3 crop.
    grid = m.high_grid
    depth, frd = params.branch_and_bound_depth, params.full_resolution_depth
    got = bnb_3d.build_precomputation_stack_3d(grid, depth, frd)
    ref = bnb_3d.stack_plain(grid, depth, frd)
    differ = int((got.full != ref.full).sum() + (got.coarse != ref.coarse).sum())
    S = grid.size
    print(f"K14 bnb3d_stack: {S}^3 crop, {frd} full and {depth - frd} coarse levels, "
          f"{differ} differing cells (tolerance 0), {int(got.full[0].gt(0).sum())} cells above "
          f"the floor")
    if differ or not torch.equal(got.full, m.stack.full):
        _fail("K14 differs from the plain twin")
    q = got.full[0].float()[None, None]
    rows["bnb3d_stack"] = dict(
        replaces="cartographer_tpu/ops/bnb_3d.py:113", max_abs_err=float(differ),
        ms=_cuda_ms(lambda: bnb_3d.build_precomputation_stack_3d(grid, depth, frd), reps=10),
        plain_ms=_cuda_ms(lambda: bnb_3d.stack_plain(grid, depth, frd), reps=3, warmup=1),
        bound=_bound(S ** 3 * 5 + frd * S ** 3 + (depth - frd) * (S // 2) ** 3,
                     S ** 3 * (12 + 8 * (frd - 1)) + (depth - frd) * S ** 3 * 2),
        # One halving of the quantized level; the stack takes 18 such passes.
        library_ms=_cuda_ms(lambda: F.max_pool3d(q, 2, 2)))
    del got, ref

    # K15: one local pair of the run at the default widths, kernel against twin.
    args = _pair_args(cb, req)
    calls = []
    score, discretize = bnb_3d.score, bnb_3d.discretize

    def recorded_score(*a):
        calls.append(("score", a))
        return score(*a)

    def recorded_discretize(*a):
        calls.append(("discretize", a))
        return discretize(*a)

    bnb_3d.score, bnb_3d.discretize = recorded_score, recorded_discretize
    out_k = bnb_3d.fast_correlative_match_3d(*args)
    bnb_3d.score, bnb_3d.discretize = score, discretize
    out_p = bnb_3d.fast_correlative_match_3d(*args, plain=True)
    same = torch.equal(out_k, out_p)
    cand = sum(a[6].shape[0] for kind, a in calls if kind == "score")
    gathers = sum(a[6].shape[0] * int(a[5].sum()) for kind, a in calls if kind == "score")
    print(f"K15 bnb3d_discretize, bnb3d_score: pair {req.node_id}/{req.submap_id}: score "
          f"{float(out_k[1]):.6f} (twin {float(out_p[1]):.6f}), found {bool(out_k[0])}, certified "
          f"{bool(out_k[11])}, result vectors bit-equal {same}; {len(calls)} launches, {cand} "
          f"candidates")
    if not same:
        _fail(f"K15 match differs from the plain twin: {out_k} vs {out_p}")
    scores = [a for kind, a in calls if kind == "score"]

    def score_bytes(a):
        # The level cells the candidates can touch (at most one per point and
        # candidate, at most the whole level), the cells of the yaws in use,
        # the mask, and the candidates in and their scores out.
        level, cells, mask, a_idx = a[0], a[4], a[5], a[6]
        b, item = a_idx.shape[0], level.element_size()
        yaws = int(a_idx.unique().numel())
        return (min(level.numel() * item, b * int(mask.sum()) * item)
                + yaws * cells.shape[1] * 12 + mask.numel() + b * 20)

    cloud_bytes = sum(a[0].numel() * 4 + a[1].numel() * 4 + a[0].shape[0] * a[1].shape[0] * 12
                      for kind, a in calls if kind == "discretize")
    rows["bnb3d_score"] = dict(
        replaces="cartographer_tpu/ops/bnb_3d.py:152", max_abs_err=0.0 if same else 1.0,
        ms=_cuda_ms(lambda: [score(*a) for a in scores], reps=10),
        plain_ms=_cuda_ms(lambda: [bnb_3d.score_plain(*a) for a in scores], reps=3, warmup=1),
        bound=_bound(sum(score_bytes(a) for a in scores), gathers * 25), library_ms=None)
    rows["bnb3d_discretize"] = dict(
        replaces="cartographer_tpu/ops/bnb_3d.py:503", max_abs_err=0.0 if same else 1.0,
        ms=_cuda_ms(lambda: [discretize(*a) for k, a in calls if k == "discretize"]),
        plain_ms=_cuda_ms(lambda: [bnb_3d.discretize_plain(*a) for k, a in calls
                                   if k == "discretize"]),
        bound=_bound(cloud_bytes, sum(a[1].shape[0] * a[0].shape[0] * 60
                                      for k, a in calls if k == "discretize")),
        library_ms=None)
    extra["bnb3d_match_ms"] = _cuda_ms(lambda: bnb_3d.fast_correlative_match_3d(*args), reps=10)

    # K16: a synthetic pose graph with IMU terms at capacity.
    S, N, C = 64, 4096, 16384
    arrays, truth_t, _ = synthetic_pose_graph_3d(S, N, C, seed=3)
    problem = schur_problem_3d_from_numpy(arrays, dev)
    wmax = schur_spa_3d.max_weight(problem)
    p = schur_spa_3d.pad_even(schur_spa_3d.normalized(problem, wmax))
    hs = 10.0 / wmax
    kern = schur_spa_3d._solve_kernel(p, 2, hs, 1e-6)
    twin = schur_spa_3d.solve_plain(p, 2, hs, 1e-6)
    err = max(float((a - b).abs().max()) for a, b in zip(kern, twin))
    if not err <= 1e-3:
        _fail(f"K16 two iterations differ from the plain twin by {err} (tolerance 1e-3)")
    k50 = schur_spa_3d._solve_kernel(p, 50, hs, 1e-6)
    cost0 = float(schur_spa_3d.cost(p.sub_t, p.sub_q, p.node_t, p.node_q, p, hs))
    cost50 = float(schur_spa_3d.cost(*k50, p, hs))
    err0 = float(np.abs(arrays["node_t"] - truth_t).mean())
    err50 = float(np.abs(k50[2].cpu().numpy() - truth_t).mean())
    print(f"K16 schur_spa_3d: 2 iterations at N={N} S={S} C={C} R={N - 1} A={N - 2} within "
          f"{err:.3g} of the plain twin (tolerance 1e-3); 50 iterations: cost {cost0:.4g} -> "
          f"{cost50:.4g}, node error {err0:.4f} -> {err50:.4f} m")
    if not (cost50 < 0.01 * cost0 and err50 < 0.5 * err0):
        _fail("K16 50 iterations did not converge")
    K, E, N2 = 6 * S + 1, C + 2 * (N - 1) + 3 * (N - 2), N // 2
    per_iteration_ops = (C * 2 * 6000 + (N - 1) * 6000 * 4 + (N - 1) * 3 * 5000
                         + (N - 2) * 4 * 5000 + N2 * 12 ** 3 * 6 + 2 * N * 12 * K * 24
                         + E * K * 72 + (6 * S) ** 3 // 3 + N * 6 * 6 * S * 2)
    spd = torch.randn(6 * S, 6 * S, device=dev)
    spd = spd @ spd.T + 6 * S * torch.eye(6 * S, device=dev)
    rows["schur_spa_3d"] = dict(
        replaces="cartographer_tpu/parallel/schur_spa_3d.py:529", max_abs_err=err,
        ms=_cuda_ms(lambda: schur_spa_3d._solve_kernel(p, 2, hs, 1e-6), reps=3),
        plain_ms=_cuda_ms(lambda: schur_spa_3d.solve_plain(p, 2, hs, 1e-6), reps=1, warmup=0),
        bound=_bound(C * 50 + (N - 1) * 44 + (N - 1) * 28 + (N - 2) * 36 + (S + N) * 41,
                     2 * per_iteration_ops),
        # The reduced system's Cholesky factor, twice (one per iteration).
        library_ms=_cuda_ms(lambda: [torch.linalg.cholesky(spd) for _ in range(2)]))
    extra["schur_3d_50_iterations_ms"] = _cuda_ms(
        lambda: schur_spa_3d._solve_kernel(p, 50, hs, 1e-6), reps=2, warmup=1)
    return rows, extra


def _profile(torch, feed, data, label="profile"):
    """Device busy share and kernel time by name over a window of scans
    that continues the main run (its launches are not counted there);
    `feed(d)` hands one scan to the builder."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for d in data:
            feed(d)
        wall = time.monotonic() - t0
    by_name, activities = {}, 0
    for e in prof.key_averages():
        us = _device_us(e)
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3 / len(data)
            activities += e.count
    busy_ms = sum(by_name.values())
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12])
    result = {"scans": len(data), "wall_ms_per_scan": wall * 1e3 / len(data),
              "gpu_activities_per_scan": activities / len(data),
              "device_busy_ms_per_scan": busy_ms if by_name else "not measured",
              "device_busy_share": busy_ms / (wall * 1e3 / len(data)) if by_name
              else "not measured",
              "device_ms_per_scan_by_kernel": top}
    print(f"{label}: " + json.dumps(result))
    return result


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from cartographer_tpu_torch.ops import cuda
    except ImportError:
        print("chip_smoke: run from the root of the repository (cartographer_tpu_torch "
              "not found)", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build_s = cuda.build()
    print(f"build: {build_s:.1f} s for {len(list(cuda.CSRC_DIR.glob('*.cu')))} sources")
    rows, ctx = _kernel_phase(torch, dev)
    run = _slice_phase(torch, dev)
    backend_rows, backend = _backend_kernel_phase(torch, dev, ctx, run)
    rows.update(backend_rows)
    slam = _global_phase(torch, dev)
    for key in ("submap", "nodes", "builder", "kept"):
        del run[key]
    run_tsdf = _slice_phase(torch, dev, "TSDF", TSDF_FRONTEND_KERNELS, TSDF_ERROR_LIMIT,
                            "TSDF frontend")
    rows_tsdf = _kernel_phase_tsdf(torch, dev, run_tsdf)
    for key in ("submap", "nodes", "builder", "kept"):
        del run_tsdf[key]
    refines = []
    slam_tsdf = _global_phase(torch, dev, "TSDF", TSDF_KERNELS, TSDF_GLOBAL_LIMITS,
                              localize=False, label="TSDF global", refines=refines)
    rows_tsdf.update(_refine_phase_tsdf(torch, refines))
    del refines
    run3d = _slice_phase_3d(torch, dev)
    rows3d = _kernel_phase_3d(torch, dev, run3d.pop("builder"), run3d.pop("last_step"))
    slam3d = _global_phase_3d(torch, dev)
    rows3g, backend3d = _backend_kernel_phase_3d(torch, dev, slam3d)
    del slam3d["pose_graph"], slam3d["request"]
    full_hall = _full_hall_phase_3d(torch, dev)
    run3f = _slice_phase_3d_full(torch, dev)
    rows3f = _kernel_phase_3d_full(torch, dev, run3f.pop("builder"), run3f.pop("kept"))
    full_hall_corr = _full_hall_phase_3d(torch, dev, correlative=True)
    imu_based = _imu_based_phase_3d(torch, dev)
    large = _large_scan_phase_3d(torch, dev)

    sources = {k.symbol: k.source for k in cuda.KERNELS.values()}
    kernels = []
    for name, row in {**rows, **rows_tsdf, **rows3d, **rows3g, **rows3f}.items():
        bound_ms, bound_by = row["bound"]
        launches = (run3f["launches"] if name in rows3f
                    else slam_tsdf["launches"] if name in rows_tsdf
                    else slam3d["summary"]["launches"] if name in rows3g
                    else run3d["launches"] if name in rows3d else slam["launches"])
        symbol = row.get("symbol", name)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"cartographer_tpu_torch/csrc/{sources[symbol]}",
            "replaces": row["replaces"], "launches": launches[symbol],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": row["library_ms"]})
    smi = _smi()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "card": smi, "build_seconds": build_s,
        "frontend": {
            "scans": run["scans"],
            "frontend_2d_builder_scans_per_sec": run["frontend_2d_builder_scans_per_sec"],
            "host_seconds": run["host_seconds"], "device_seconds": run["device_seconds"],
            "finished_submaps": run["finished_submaps"], "mean_error_m": run["mean_error_m"],
            "lm_iterations_per_scan": run["lm_iterations_per_scan"],
            "launches_per_scan": {k: v / run["scans"] for k, v in run["launches"].items()},
            "profile": {k: v for k, v in run["profile"].items()
                        if k != "device_ms_per_scan_by_kernel"}},
        "global_slam": {k: v for k, v in slam.items()},
        "frontend_tsdf": {
            **{k: v for k, v in run_tsdf.items() if k not in ("profile", "launches")},
            "launches_per_scan": {k: v / run_tsdf["scans"] for k, v in
                                  run_tsdf["launches"].items() if v},
            "profile": {k: v for k, v in run_tsdf["profile"].items()
                        if k != "device_ms_per_scan_by_kernel"}},
        "global_slam_tsdf": slam_tsdf,
        "frontend_3d": {
            **{k: v for k, v in run3d.items() if k not in ("profile", "launches")},
            "launches_per_scan": {k: v / run3d["scans"] for k, v in run3d["launches"].items()
                                  if k in KERNELS_3D},
            "profile": run3d["profile"]},
        "global_slam_3d": slam3d["summary"],
        "frontend_3d_full_size_hall": full_hall,
        "frontend_3d_full_options": {
            **{k: v for k, v in run3f.items() if k not in ("profile", "launches")},
            "launches_per_scan": {k: v / run3f["scans"] for k, v in run3f["launches"].items()
                                  if k in FULL_FRONTEND_KERNELS},
            "profile": run3f["profile"]},
        "frontend_3d_full_size_hall_correlative": full_hall_corr,
        "frontend_3d_imu_based": imu_based,
        "frontend_3d_16384_returns": {
            **{k: v for k, v in large.items() if k != "kernels"},
            "kernels": {name: {"ms": r["ms"], "plain_ms": r["plain_ms"],
                               "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                               "library_ms": r["library_ms"], "max_abs_err": r["max_abs_err"]}
                        for name, r in large["kernels"].items()}},
        "bnb_match_ms": backend["bnb_match_ms"],
        "schur_50_iterations_ms": backend["schur_50_iterations_ms"],
        "bnb3d_match_ms": backend3d["bnb3d_match_ms"],
        "schur_3d_50_iterations_ms": backend3d["schur_3d_50_iterations_ms"],
        "kernel_device_ms": {k["name"]: k["ms"] for k in kernels},
        "bound_ms": {k["name"]: k["bound_ms"] for k in kernels},
        "library_ms": {k["name"]: k["library_ms"] for k in kernels}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
