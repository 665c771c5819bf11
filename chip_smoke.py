#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `cartographer_tpu_torch/csrc/` and runs,
on the card, at full width (the reference's default 2D options):

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
   again on the CPU's plain path; one certified global localization.

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

    profile = _profile(torch, builder, profiled)
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
    _check_launched(launches, list(launches), "global SLAM")
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


def _profile(torch, builder, data):
    """Device busy share and kernel time by name over a window of scans
    that continues the main run (its launches are not counted there)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for d in data:
            builder.add_range_data("laser", d)
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
    print("profile: " + json.dumps(result))
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

    sources = {k.symbol: k.source for k in cuda.KERNELS.values()}
    kernels = []
    for name, row in rows.items():
        bound_ms, bound_by = row["bound"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"cartographer_tpu_torch/csrc/{sources[name]}",
            "replaces": row["replaces"], "launches": slam["launches"][name],
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
