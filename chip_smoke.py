#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `cartographer_tpu_torch/csrc/`, holds
each kernel against its plain PyTorch twin on the card at the shapes the
2D frontend gives it, then drives `LocalTrajectoryBuilder2D` (default
configuration, full width) over simulated scans of a multi-room floor plan
and checks it: every kernel launched on the main path, one blocking
device-to-host copy per scan, agreement with the plain path on the CPU,
accuracy against ground truth and at least two finished submaps.

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
    return rows


def _slice_phase(torch, dev):
    """The 2D frontend on the card over simulated scans of a floor plan."""
    from cartographer_tpu_torch.core.config import TrajectoryBuilder2DOptions, apply_overrides
    from cartographer_tpu_torch.mapping.local_trajectory_builder_2d import (
        LocalTrajectoryBuilder2D,
    )
    from cartographer_tpu_torch.ops import cuda
    from cartographer_tpu_torch.sensor.data import TimedPointCloudData
    from cartographer_tpu_torch.simulation import relative_to_first, simulate_scans
    from cartographer_tpu_torch.transform import nquat

    opts = apply_overrides(TrajectoryBuilder2DOptions(), {"use_imu_data": False})
    scans, truth = simulate_scans(NUM_SCANS + PROFILED_SCANS, seed=0)
    gt = relative_to_first(truth)[:NUM_SCANS]
    data = [TimedPointCloudData(time=int(round(ts * 1e6)), origin=np.zeros(3, np.float32),
                                ranges=pts, times=rel) for ts, pts, rel in scans]
    data, profiled = data[:NUM_SCANS], data[NUM_SCANS:]

    builder = LocalTrajectoryBuilder2D(opts, ["laser"], device=dev)
    cuda.reset_launch_counts()
    est, finished, walls = [], 0, []
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for d in data:
            t0 = time.monotonic()
            r = builder.add_range_data("laser", d)
            walls.append(time.monotonic() - t0)
            est.append([*r.local_pose_translation[:2], nquat.get_yaw(r.local_pose_rotation)])
            if r.insertion_result is not None:
                finished += len(r.insertion_result.finished_submaps)
    torch.cuda.set_sync_debug_mode("default")
    launches = cuda.launch_counts()
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    print(f"slice: {len(data)} scans, {builder.device_fetches} fetches, {syncs} synchronizing "
          f"operations, {finished} finished submaps, launches {launches}")
    for name, count in launches.items():
        if count == 0:
            _fail(f"kernel {name} was not launched on the main path")
    if builder.device_fetches != len(data) or syncs != len(data):
        _fail(f"expected one blocking copy per scan, got {syncs} synchronizing operations "
              f"for {len(data)} scans")
    if finished < 2:
        _fail(f"only {finished} submaps finished (need >= 2)")
    est = np.asarray(est)
    errors = np.linalg.norm(est[:, :2] - gt[:, :2], axis=1)
    print(f"slice: mean error {errors.mean():.4f} m, max {errors.max():.4f} m against ground truth")
    if errors.mean() > 0.25:
        _fail(f"mean error {errors.mean()} m against ground truth (limit 0.25 m)")

    # The first scans again on the CPU's plain path, with the same permutations.
    def card_permutation(seed, n):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randperm(n, generator=g, device=dev, dtype=torch.int32).cpu().numpy()

    cpu = LocalTrajectoryBuilder2D(opts, ["laser"], device="cpu",
                                   permutation_fn=card_permutation)
    worst = np.zeros(2)
    for k, d in enumerate(data[:CPU_SCANS]):
        r = cpu.add_range_data("laser", d)
        c = np.array([*r.local_pose_translation[:2], nquat.get_yaw(r.local_pose_rotation)])
        worst = np.maximum(worst, [np.linalg.norm(c[:2] - est[k, :2]), abs(c[2] - est[k, 2])])
    print(f"slice: first {CPU_SCANS} scans against the CPU plain path: max {worst[0]:.3g} m, "
          f"{worst[1]:.3g} rad (tolerance 0.02 m, 0.01 rad)")
    if worst[0] > 0.02 or worst[1] > 0.01:
        _fail("card and CPU plain path disagree")

    profile = _profile(torch, builder, profiled)
    steady = walls[10:]
    return dict(
        profile=profile,
        scans=len(data), finished_submaps=finished, mean_error_m=float(errors.mean()),
        frontend_2d_builder_scans_per_sec=len(steady) / sum(steady),
        host_seconds=builder.host_seconds, device_seconds=builder.device_seconds,
        launches=launches)


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
    rows = _kernel_phase(torch, dev)
    run = _slice_phase(torch, dev)

    sources = {k.symbol: k.source for k in cuda.KERNELS.values()}
    kernels = []
    for name, row in rows.items():
        bound_ms, bound_by = row["bound"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"cartographer_tpu_torch/csrc/{sources[name]}",
            "replaces": row["replaces"], "launches": run["launches"][name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": row["library_ms"]})
    smi = _smi()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "card": smi, "build_seconds": build_s, "scans": run["scans"],
        "frontend_2d_builder_scans_per_sec": run["frontend_2d_builder_scans_per_sec"],
        "host_seconds": run["host_seconds"], "device_seconds": run["device_seconds"],
        "finished_submaps": run["finished_submaps"], "mean_error_m": run["mean_error_m"],
        "launches_per_scan": {k: v / run["scans"] for k, v in run["launches"].items()},
        "profile": {k: v for k, v in run["profile"].items()
                    if k != "device_ms_per_scan_by_kernel"},
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
