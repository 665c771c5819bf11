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
7. the 3D frontend once more over the hall at full size with the robot's
   heading along the walls, where the LM-only matcher tracks worst: its
   error and its page count are reported, not limited.

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
NUM_SCANS_3D = 400  # one submap finishes at 320 insertions
CPU_SCANS_3D = 20
TIME_OFFSET_US = 10_000_000  # the simulated IMU starts before t = 0
KERNELS_2D = ("scan_preprocess_2d", "voxel_filter", "scan_matcher_2d", "insert_2d",
              "correlative_2d", "bnb_pyramid", "bnb_score", "schur_spa_2d")
KERNELS_3D = ("voxel_filter", "paged_insert_3d", "paged_crop_3d", "scan_matcher_3d",
              "rot_histogram", "rot_histogram_rotate")


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


def _frontend_options():
    from cartographer_tpu_torch.core.config import TrajectoryBuilder2DOptions, apply_overrides

    return apply_overrides(TrajectoryBuilder2DOptions(), {
        "use_imu_data": False, "use_online_correlative_scan_matching": True})


def _slice_phase(torch, dev):
    """The 2D frontend, online correlative matcher on, on the card over
    simulated scans of a floor plan."""
    from cartographer_tpu_torch.core.config import apply_overrides
    from cartographer_tpu_torch.mapping.local_trajectory_builder_2d import (
        LocalTrajectoryBuilder2D,
    )
    from cartographer_tpu_torch.ops import cuda
    from cartographer_tpu_torch.sensor.data import TimedPointCloudData
    from cartographer_tpu_torch.simulation import relative_to_first, simulate_scans
    from cartographer_tpu_torch.transform import nquat

    opts = _frontend_options()
    scans, truth = simulate_scans(NUM_SCANS + PROFILED_SCANS, seed=0)
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
    print(f"frontend: {len(data)} scans, {builder.device_fetches} fetches, {syncs} "
          f"synchronizing operations, {len(finished)} finished submaps, launches {launches}")
    _check_launched(launches, FRONTEND_KERNELS, "frontend")
    if builder.device_fetches != len(data) or syncs != len(data):
        _fail(f"expected one blocking copy per scan, got {syncs} synchronizing operations "
              f"for {len(data)} scans")
    if len(finished) < 2:
        _fail(f"only {len(finished)} submaps finished (need >= 2)")
    est = np.asarray(est)
    errors = np.linalg.norm(est[:, :2] - gt[:, :2], axis=1)
    print(f"frontend: mean error {errors.mean():.4f} m, max {errors.max():.4f} m against "
          f"ground truth")
    if errors.mean() > 0.25:
        _fail(f"mean error {errors.mean()} m against ground truth (limit 0.25 m)")

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
    print(f"frontend: first {CPU_SCANS} scans, correlative search off, against the CPU plain "
          f"path: max {worst[0]:.3g} m, {worst[1]:.3g} rad (tolerance 0.02 m, 0.01 rad)")
    if worst[0] > 0.02 or worst[1] > 0.01:
        _fail("card and CPU plain path disagree")

    profile = _profile(torch, lambda d: builder.add_range_data("laser", d), profiled)
    steady = walls[10:]
    return dict(
        profile=profile,
        scans=len(data), finished_submaps=len(finished), mean_error_m=float(errors.mean()),
        frontend_2d_builder_scans_per_sec=len(steady) / sum(steady),
        host_seconds=builder.host_seconds, device_seconds=builder.device_seconds,
        launches=launches, submap=finished[0], nodes=nodes,
        lm_iterations_per_scan=float(np.mean(builder.lm_iterations)))


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


def _global_phase(torch, dev):
    """Global SLAM through MapBuilder on the card over three laps."""
    from cartographer_tpu_torch.core.config import MapBuilderOptions, TrajectoryBuilderOptions
    from cartographer_tpu_torch.mapping.constraint_builder_2d import _pow2_points
    from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
    from cartographer_tpu_torch.mapping.map_builder import MapBuilder
    from cartographer_tpu_torch.ops import bnb_2d, cuda
    from cartographer_tpu_torch.ops.grid_2d import Grid2D
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
    tid = mb.add_trajectory_builder(["laser"], TrajectoryBuilderOptions(_frontend_options()))
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
    inter, solves = pg.num_inter_constraints(), pg.solves
    print(f"global: {len(scans)} scans, {len(pg.nodes)} nodes, {len(pg.submap_data)} submaps, "
          f"{inter} loop closures from {cb.pairs_matched} matched pairs, {solves} solves, "
          f"{wall:.1f} s wall; constraint search {cb.match_seconds:.2f} s, solves "
          f"{pg.solve_seconds:.2f} s; launches {launches}")
    _check_launched(launches, KERNELS_2D, "global SLAM")
    if inter < 100 or solves < 3:
        _fail(f"global SLAM ran {inter} loop closures and {solves} solves (need >= 100, >= 3)")
    # Node (trajectory, index) -> scan index: scan i is stamped (i + 1) * 0.1 s.
    index = {nid: int(round(node.time / 1e5)) - 1 for nid, node in pg.nodes.items()}
    local_err = np.mean([np.linalg.norm(node.local_pose_translation[:2] - gt[index[nid], :2])
                         for nid, node in pg.nodes.items()])
    global_err = np.mean([np.linalg.norm(node.global_pose_2d[:2] - gt[index[nid], :2])
                          for nid, node in pg.nodes.items()])
    print(f"global: mean error of the optimized poses {global_err:.4f} m, of the frontend's "
          f"{local_err:.4f} m (limits 0.25 m and the frontend's)")
    if not (global_err <= 0.25 and global_err <= local_err):
        _fail("optimized poses are not within 0.25 m of the truth and the frontend's error")

    # The first loop-closure pairs again, on the CPU's plain path.
    params = cb._bnb_params
    depth = params.branch_and_bound_depth
    for r in recorded:
        pts, mask = _pow2_points([r.points])
        g_cpu = Grid2D(r.grid.log_odds.cpu(), r.grid.known.cpu(), r.grid.origin.cpu(),
                       r.grid.resolution)
        init = np.asarray(r.init, np.float32)
        card = bnb_2d.fast_correlative_match_2d(
            cb._pyramid_for(r.submap_id, r.grid), r.grid, torch.from_numpy(pts[0]).to(dev),
            torch.from_numpy(mask[0]).to(dev), torch.from_numpy(init).to(dev), params,
            0.0).cpu()
        cpu = bnb_2d.fast_correlative_match_2d(
            bnb_2d.pyramid_plain(g_cpu, depth), g_cpu, torch.from_numpy(pts[0]),
            torch.from_numpy(mask[0]), torch.from_numpy(init), params, 0.0)
        err = float((card[0] - cpu[0]).abs())
        print(f"global: pair {r.node_id}/{r.submap_id} card {float(card[0]):.5f} CPU "
              f"{float(cpu[0]):.5f} (tolerance 1e-5), certificates {bool(card[5])}, "
              f"{bool(cpu[5])}")
        if err > 1e-5 or bool(card[5]) != bool(cpu[5]):
            _fail("a loop-closure pair differs between the card and the CPU's plain path")

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
    return dict(scans=len(scans), nodes=len(pg.nodes), submaps=len(pg.submap_data),
                loop_closures=inter, matched_pairs=cb.pairs_matched, solves=solves,
                wall_seconds=wall, constraint_search_seconds=cb.match_seconds,
                solve_seconds=pg.solve_seconds, launches=launches,
                mean_error_optimized_m=float(global_err), mean_error_frontend_m=float(local_err),
                global_localization_error_m=loc_err, global_localization_seconds=loc_s,
                global_localization_beam=beam)


def _events_3d(num_scans, **scene):
    """Simulated 3D scans as (IMU messages up to the scan's time that no
    earlier scan took, the scan), and the ground truth in the first pose's
    frame; `scene` goes to `simulate_scans_3d`."""
    from cartographer_tpu_torch.sensor.data import ImuData, TimedPointCloudData
    from cartographer_tpu_torch.simulation import relative_to_first, simulate_scans_3d

    scans, imu, truth = simulate_scans_3d(num_scans, seed=0, **scene)
    stamp = lambda t: TIME_OFFSET_US + int(round(t * 1e6))  # noqa: E731
    events, k = [], 0
    for ts, pts, rel in scans:
        batch = []
        while k < len(imu) and imu[k][0] <= ts:
            batch.append(ImuData(time=stamp(imu[k][0]), linear_acceleration=imu[k][1],
                                 angular_velocity=imu[k][2]))
            k += 1
        events.append((batch, TimedPointCloudData(
            time=stamp(ts), origin=np.zeros(3, np.float32), ranges=pts, times=rel)))
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


def _slice_phase_3d(torch, dev):
    """The 3D frontend on the card at the default options, over simulated
    scans of a 16-ring sensor with an IMU in the floor plan's hall."""
    from cartographer_tpu_torch.core.config import TrajectoryBuilder3DOptions
    from cartographer_tpu_torch.mapping.local_trajectory_builder_3d import (
        LocalTrajectoryBuilder3D,
    )
    from cartographer_tpu_torch.ops import cuda
    from cartographer_tpu_torch.transform import nquat

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

    # The first scans again on the CPU's plain path, with the same permutations.
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
    print(f"3D frontend: first {CPU_SCANS_3D} scans against the CPU plain path: max "
          f"{worst[0]:.3g} m, {worst[1]:.3g} rad (tolerance 0.02 m, 0.01 rad), "
          f"{time.monotonic() - t_cpu:.1f} s")
    if worst[0] > 0.02 or worst[1] > 0.01:
        _fail("card and CPU plain path disagree in 3D")

    profile = _profile(torch, lambda e: _feed_3d(builder, e), events[n:n + PROFILED_SCANS],
                       "3D profile")
    # One more scan, keeping what its step read and left on the card (the dense
    # windows, the packed result, the insertion's tensors) for the kernel phase.
    step, kept = builder._fused_step, []

    def keeping_step(high_grid, low_grid, upload, perm):
        out = step(high_grid, low_grid, upload, perm)
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


def _full_hall_phase_3d(torch, dev):
    """The 3D frontend again, over the hall at the floor plan's full size
    (36 m x 20 m) from the start of the path, where the robot's heading,
    and with it the local frame and the voxel grids, lie along the walls.
    The default LM-only matcher has nothing but the constant-velocity
    prediction along a corridor's axis there, so this run's error against
    the truth is reported and not limited; what is checked is that every
    scan is placed with one blocking copy and that the page pools hold a
    submap of this hall."""
    from cartographer_tpu_torch.core.config import TrajectoryBuilder3DOptions
    from cartographer_tpu_torch.mapping.local_trajectory_builder_3d import (
        LocalTrajectoryBuilder3D,
    )

    opts, n = TrajectoryBuilder3DOptions(), NUM_SCANS_3D
    events, gt = _events_3d(n, scale=1.0, start=0.0)
    builder = LocalTrajectoryBuilder3D(opts, ["points"], device=dev)
    est, offset, yaw_err, finished, walls, inserted = _drive_3d(
        torch, builder, events, gt, "3D full-size hall")
    errors = np.linalg.norm(offset, axis=1)
    if len(finished) < 1:
        _fail("3D full-size hall: no submap finished")
    pages = [finished[0].high_paged.num_allocated, finished[0].low_paged.num_allocated]
    result = dict(
        scans=n, inserted=inserted, mean_error_m=float(errors.mean()),
        max_error_m=float(errors.max()), mean_yaw_error_rad=float(yaw_err.mean()),
        error_by_100_scans_m=[float(errors[i:i + 100].mean()) for i in range(0, n, 100)],
        final_offset_m=offset[-20:].mean(0).tolist(), finished_submap_pages=pages,
        pool_pages=opts.tpu.max_pages, scans_per_sec=len(walls[10:]) / sum(walls[10:]))
    print("3D full-size hall (reported, no limit on the error): " + json.dumps(result))
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
    (high_grid, low_grid), packed, (est_t, local_points, keep, in_high) = last_step
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
    del run["submap"], run["nodes"]
    run3d = _slice_phase_3d(torch, dev)
    rows3d = _kernel_phase_3d(torch, dev, run3d.pop("builder"), run3d.pop("last_step"))
    full_hall = _full_hall_phase_3d(torch, dev)

    sources = {k.symbol: k.source for k in cuda.KERNELS.values()}
    kernels = []
    for name, row in {**rows, **rows3d}.items():
        bound_ms, bound_by = row["bound"]
        launches = run3d["launches"] if name in rows3d else slam["launches"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"cartographer_tpu_torch/csrc/{sources[name]}",
            "replaces": row["replaces"], "launches": launches[name],
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
        "frontend_3d": {
            **{k: v for k, v in run3d.items() if k not in ("profile", "launches")},
            "launches_per_scan": {k: v / run3d["scans"] for k, v in run3d["launches"].items()
                                  if k in KERNELS_3D},
            "profile": run3d["profile"]},
        "frontend_3d_full_size_hall": full_hall,
        "bnb_match_ms": backend["bnb_match_ms"],
        "schur_50_iterations_ms": backend["schur_50_iterations_ms"],
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
