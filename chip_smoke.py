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
   submap and node clouds and on a full-width synthetic pose graph (K8's
   launches one by one in an iteration, its kernels per iteration in
   captured graphs, 2- and 50-iteration times by CUDA events, its reduced
   Cholesky alone against torch.linalg's);
4. global SLAM through `MapBuilder` over three laps of the floor plan
   (default pose-graph options, background searches): K1-K8 launched, at
   least 100 loop closures and 3 solves, optimized poses within 0.25 m of
   the truth and no worse than the frontend's; the first loop-closure pairs
   again on the CPU's plain path; one 50-iteration K8 solve of the run's
   last problem by CUDA events; one certified global localization; then
   K7 (the whole beam descent of a group of pairs in one launch) on the
   run's largest group of local requests and on its global localization's
   full-submap wave, every row equal to the twin's bit for bit, one descent
   kernel a group and a wave (captured CUDA graphs), the group's times;
5. the 3D frontend, `LocalTrajectoryBuilder3D`, over 400 simulated scans of
   a 16-ring sensor with an IMU in the same floor plan extruded to a hall
   (paged submaps, dense crops of 256^3 and 192^3 per scan): K2 and K9-K12
   launched, one crop launch per scan after the first (both windows) and
   per lazy crop, one blocking copy per scan, every scan's K12 launch (the
   histogram of the levelled cloud and its rotation by the matched yaw)
   bit for bit against its twin after the scan, accuracy against ground
   truth, one finished submap with its dense crops, the first scans again
   on the CPU's plain path;
6. the 3D kernels K9-K12, each against its plain twin, on that run's pools,
   windows and clouds (K10: the scan's two windows in one launch, beside a
   zero_() of the same bytes; K12 one kernel a call, its standalone
   rotation too);
7. 3D global SLAM through `MapBuilder(use_trajectory_builder_3d=True)` at
   the default options over 700 scans of that hall (three laps; background
   searches and solves): K2 and K9-K16 launched, at least 50 loop closures
   and 3 solves, optimized poses no worse than the frontend's plus 0.02 m,
   and one certified global localization of a third-lap node against the
   first submap with its yaw unknown;
8. the 3D backend kernels K13-K16, each against its plain twin, on that
   run's state (its node, finished submap and a local pair) and on a
   synthetic SE(3) pose graph with IMU terms at the solver's capacity; K15
   (the whole 3D beam descent of a group of pairs in one launch) also on
   the run's first 64 local requests as one group and on each widening
   round of its global localization as a wave, every row equal to the
   twin's bit for bit, one descent kernel a group (a captured CUDA graph),
   the group's times;
9. the 3D frontend once more over the hall at full size with the robot's
   heading along the walls, where the LM-only matcher tracks worst: its
   error and its page count are reported, not limited;
10. the 3D frontend at its full options (the online correlative search,
    intensities) over 400 scans of the half-scale hall with intensities:
    K2 and K9-K12 and K17-K19 launched (K17 and K11 once per scan, the
    crops of K10 and K19 one launch per scan after the first, K18 once per
    active submap and inserted scan), one blocking copy per scan, every
    scan's K17 (flat index, score and offsets bit for bit, quaternion 1e-6)
    and K12 (bit for bit) against their twins after the scan, accuracy
    against ground truth (0.25 m; a mean yaw error of 0.03 rad, above the
    JAX builder's and the plain path's on the CPU), the first scans again
    on the CPU's plain path;
11. K17 (one kernel a call), K18, K19 and K11 with its intensity rows,
    each against its plain twin, on that run's pools, windows and clouds
    (K19: the scan's three
    windows in K10's one launch); K18 also timed by CUDA
    events, its kernel launches per call counted, and `index_add_` of the
    sums and the counts into both pools timed beside it;
12. the full-size hall of phase 9 with the correlative search on (error and
    pages reported, not limited);
13. 100 scans of the half-scale hall with the IMU-based extrapolator (a
    1 s pose queue) and intensities: error reported, the first scans again
    on the CPU's plain path; then 60 scans with the default 5 s queue, its
    host cost read once the queue is full;
14. the 2D frontend of phase 2 on TSDF submaps (`submaps.grid_type =
    "TSDF"`, the TSDF inserter at its defaults): K1, K2, K20, K21, K22 and
    K5's TSDF form launched, one blocking copy per scan, accuracy against
    ground truth, the first 100 scans again in a fresh builder (the poses
    repeat bit for bit: K21 adds in input order), the first scans again on
    the CPU's plain path;
15. K20, K21 (bit for bit), K22 and the TSDF forms of K3, K5 and K6, each
    against its plain twin, on that run's state;
16. global SLAM through `MapBuilder` on TSDF submaps over the three laps of
    phase 4: loop closures, solves, optimized poses no worse than the
    frontend's; the first pairs again on the CPU's plain path;
17. the 3D frontend at the default options plus intensities with a
    16-ring x 1024-azimuth sensor (`tpu.scan_capacity` 16,384, above K2's
    and K18's one-block sizes) over 100 scans, the first 20 again on the
    CPU's plain path, K2 and K18 at that size against their twins (K18
    timed as in phase 11);
18. K5, K7, K12, K13 and K17 at their former one-block limits and above
    (K5 to 16,384 points, K7 to 4,096, K12 to 8,192 points and 2,048 bins,
    K13 at 2,048 bins, K17 to 8,192 points), each equal to its twin bit for
    bit; the 2D frontend with 16,384-beam scans and `tpu.matcher_capacity`
    8,192, `tpu.loop_closure_capacity` 2,048, and the 3D frontend at its
    full options with `tpu.filtered_capacity_high` 4,096, over 40 scans each;
19. the scan-match testbed, `python -m cartographer_tpu_torch.io.scan_match_main`,
    on two 28,800-return scans of the hall written as binary PCD files
    (padded to 32,768): one call of `main` in a subprocess, `run` for `icp`
    (K23, K24) and `ceres` (K25, K11), each within 1e-3 m and 1e-3 rad of
    the JAX package's result on the CPU witness (`SCAN_MATCH_WITNESS`,
    tests/scan_match_witness_3d.py) and no further from the truth than it
    plus 0.01 m; K23, K24 and K25 against their twins on the run's own
    inputs, the whole card icp_match within 1e-4 m and 1e-4 rad of its twin;
20. the testbed's `gicp` and `ndt` modes on phase 19's two scans: one call of
    `main --mode gicp` in a subprocess, `run` for `gicp` (K26 once, K23 seven
    times, K27 six times, K24's stats once), `ndt` at 1 m cells (K28, K29
    once each) and `ndt` at the CLI's 0.3 m (held to JAX's near-start pose,
    its error reported), each within 1e-3 m and 1e-3 rad of the JAX witness
    and no further from the truth than it plus 0.01 m; K26 (neighbours exact,
    normals within 1e-5 up to sign), K27 and K29 (1e-4 m, rad and cost) and
    K28 (valid and means exact, L within 1e-5 of its scale) against their
    twins on the run's own inputs;
21. K30 (the dense intensity insert) and K31 (the edge voxel filter) at the
    path's shapes (K31 on a 2D scan, 3D scans of 4,096 and 16,384 returns and
    the testbed's 28,800-return cloud padded to 32,768; K30 on scans of
    4,096, 16,384 and 32,768 returns into a 256^3 window), each equal to its
    twin bit for bit, and K30 over phase 10's first scans against K18 -> K19's
    crop of the same window (counts and sums exact); both timed by the
    profiler and by CUDA events, K30's kernel launches per call counted and
    `index_add_` into clones of its grid's sums and counts timed beside it;
22. state interchange: phase 4's 2D map and phase 7's 3D map written as
    native and reference-schema pbstreams and loaded by fresh card
    MapBuilders (poses, constraints and trajectory data exact, grids equal
    after the format's quantization and on the card, clouds within 1 mm); a
    fresh card MapBuilder loads the 2D map frozen and localizes a new
    trajectory of LOCALIZE_SCANS scans started at a pose it is not told (at
    least 100 loop closures to the frozen map, mean error within 0.1 m of
    the truth, every frozen pose unmoved bit for bit); the pbstream CLI's
    `info` counts in subprocesses; a v1 twin of the 3D reference-schema
    stream loads with its submap histograms rebuilt by K12's rotation on the
    card, within 1e-5 of the plain path's;
23. cross-robot batched serving at bench.py's shape: 16 robot threads
    (1,024-beam scans, 512^2 grids at 5 cm, matcher cloud 512, loop-closure
    cloud 256) through one `ScanBatcher` and through 16 separate builders,
    with the default options and with the correlative search on: every
    robot's poses equal its single-robot run bit for bit, mean errors
    reported (alone the frontend loses some of these robots at this shape,
    in the JAX package too: tests/batched_serving_witness_2d.py), scans/s
    of both, host and wait seconds per scan, K1-K5 launches per tick equal
    at R = 1, 4 and 16 (and every kernel counted in a captured CUDA graph),
    device ms per tick, GPU activities per tick.
Phase 10 also runs the scans of two more seeds and reports their yaw error.

Prints a `kernels` JSON line, a timing JSON line, the card's name and power
limit, and as its last line `{"ok": true, "device": {...}}`. Any failed
check raises, so the exit code is non-zero. Without a CUDA device, or
outside the repository, it exits non-zero before printing a result.
"""

from __future__ import annotations

import json
import os
import re
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
GROUP_PAIRS = 32  # K7 is held on the first pairs of the 2D global run's largest group
REFINE_EVERY = 150  # the TSDF global run's loop-closure refines held against the twin
TSDF_REPEAT_SCANS = 100  # the TSDF frontend's first scans, run again in a fresh builder
# Cross-robot batched serving (phase 23) at bench.py's shape.
BATCH_ROBOTS = 16
BATCH_SCANS = 60  # per robot, timed
BATCH_PROFILED = 20  # per robot, profiled
BATCH_BEAMS = 1024
BATCH_TICK_ROBOTS = (1, 4, 16)
BATCH_OPTIONS = {"use_imu_data": False, "tpu.scan_capacity": 1024,
                 "tpu.submap_grid_size": 512, "submaps.resolution": 0.05,
                 "tpu.matcher_capacity": 512, "tpu.loop_closure_capacity": 256}
BATCH_ERROR_LIMIT = 0.25  # m, a robot's mean error over its BATCH_SCANS (PERF.md section 2)
# Each robot's mean error [m] over the first BATCH_SCANS scans, (JAX, the
# port's plain path), on the CPU with the JAX package's permutations, with
# the default options, with the search on, and on TSDF submaps with the
# search on, there with a third entry, the worst of JAX's means over 4 runs
# with N(0, 1e-6 m) added to the ranges: tests/batched_serving_witness_2d.py.
BATCH_WITNESS = {
    "default": [
        (0.0307, 0.0305), (0.0227, 0.0226), (0.05, 0.0507), (0.2781, 0.2728),
        (0.0198, 0.0197), (0.0312, 0.0814), (0.9243, 0.8809), (0.0171, 0.0169),
        (1.5228, 1.5791), (0.0268, 0.0274), (0.0447, 0.0433), (0.0128, 0.0127),
        (0.043, 0.0403), (0.0231, 0.0224), (1.5693, 1.5418), (0.0157, 0.0154),
    ],
    "correlative": [
        (0.0294, 0.0291), (0.019, 0.0191), (0.0164, 0.0172), (0.1608, 0.1608),
        (0.0225, 0.0254), (1.8396, 1.4606), (0.017, 0.0172), (0.0139, 0.0139),
        (0.0222, 0.0198), (0.0189, 0.0194), (0.0345, 1.0453), (0.0124, 0.0122),
        (0.0285, 0.029), (0.017, 0.0211), (0.0201, 0.0201), (0.0138, 0.0144),
    ],
    "tsdf": [
        (0.0122, 0.0124, 0.0124), (0.0149, 0.0146, 0.0187), (0.0175, 0.0176, 0.0177),
        (0.0181, 0.0185, 0.0181), (0.0223, 0.0222, 0.0222), (0.0168, 0.018, 0.0198),
        (0.0115, 0.0116, 0.0136), (0.0129, 0.013, 0.013), (0.0157, 0.0159, 0.0161),
        (0.0152, 0.0146, 0.0152), (0.0195, 0.0187, 0.0196), (0.0203, 0.0197, 0.0199),
        (0.0214, 0.0226, 0.0214), (0.0187, 0.0221, 0.0188), (0.0164, 0.0188, 0.0164),
        (0.0132, 0.0119, 0.0132),
    ],
}
NUM_SCANS_3D = 400  # one submap finishes at 320 insertions
CPU_SCANS_3D = 20
TIME_OFFSET_US = 10_000_000  # the simulated IMU starts before t = 0
# The 2D step's K1 and K2 are one launch (`scan_filter_2d`, csrc/voxel_filter.cu).
KERNELS_2D = ("scan_filter_2d", "scan_matcher_2d", "insert_2d",
              "correlative_2d", "bnb_pyramid", "bnb_descent", "schur_spa_2d")
# The 3D step's histogram and its rotation are one K12 launch (`rot_histogram`);
# the standalone rotation (`rot_histogram_rotate`) runs in phase 22.
KERNELS_3D = ("voxel_filter", "paged_insert_3d", "paged_crop_3d", "scan_matcher_3d",
              "rot_histogram")
CROP_KERNEL_NAME = "crop_rows"  # K10's kernel (csrc/paged_grid_3d.cu), in profiler records
GLOBAL_SCANS_3D = 700  # three laps of the half-scale hall
NUM_SCANS_IMU = 100
IMU_DEFAULT_QUEUE_SCANS = 60  # the 5 s queue fills at scan 50
FULL_FRONTEND_YAW_LIMIT = 0.03  # rad, mean over the 400 scans (see _slice_phase_3d_full)
# K19, the intensity window, is a window of K10's launch (`paged_crop_3d`).
FULL_FRONTEND_KERNELS = KERNELS_3D + ("correlative_3d", "paged_intensity_insert_3d")
KERNELS_3D_GLOBAL = KERNELS_3D + ("rot_match", "bnb3d_stack", "bnb3d_descent", "schur_spa_3d")
YAW_SEEDS = (1, 2)  # the full frontend's phase again over these seeds' scans
TSDF_FRONTEND_KERNELS = ("scan_filter_2d", "correlative_2d_tsdf",
                         "lm_match_tsdf_2d", "tsdf_normals_2d", "tsdf_insert_2d")
TSDF_KERNELS = TSDF_FRONTEND_KERNELS + ("bnb_pyramid_tsdf", "bnb_descent",
                                        "scan_matcher_2d_tsdf", "schur_spa_2d")
TSDF_ERROR_LIMIT = 0.25  # m, the TSDF frontend's mean error (see PERF.md, PR 6)
TSDF_GLOBAL_LIMITS = (100, 3, 0.25)  # loop closures, solves, optimized mean error [m]
LARGE_SCAN_CAPACITY = 16384  # 16 rings x 1024 azimuths
LARGE_SCANS_3D = 100
# Capacities above the former one-block limits of K5 (4,096 points), K7
# (1,024), K12 (1,024) and K17 (2,048), and the scans each frontend runs at them.
RAISED_2D = {"tpu.scan_capacity": 16384, "tpu.matcher_capacity": 8192,
             "tpu.loop_closure_capacity": 2048}
RAISED_3D = {"tpu.filtered_capacity_high": 4096}
RAISED_SCANS = 40
RAISED_BEAMS_2D = 16384
# The sizes each kernel is held at: its former limit first, then above it.
ABOVE_ONE_BLOCK = {"correlative_2d": (4096, 8192, 16384), "bnb_descent": (1024, 2048, 4096),
                   "rot_histogram": ((1024, 120), (2048, 120), (8192, 120), (2048, 2048)),
                   "rot_match": (1024, 2048), "correlative_3d": (2048, 4096, 8192)}
K16_CAPACITY = (64, 4096, 16384)  # reduced slots, nodes, binary terms
SCAN_MATCH_AZIMUTHS = 1800  # 16 rings x 1,800 = 28,800 returns, padded to 32,768
# The JAX package's results on the phase's two scans (28,800 returns each),
# from tests/scan_match_witness_3d.py on a CPU; the port's plain path there
# came within 2.4e-5 m and 5.4e-6 rad of them (`gicp` 2.4e-5 m, the others
# within 1.4e-5 m). `ndt` runs at 1 m cells (`NdtParams`' own default);
# `ndt_0.3` at the CLI's default 0.3 m, where NDT stays near its start.
SCAN_MATCH_WITNESS = {
    "icp": {"translation": [-0.2975173890590668, 0.015327480621635914, 0.0031256440561264753],
            "rotation_axis_angle": [-0.00010325784387532622, 0.0007269812049344182,
                                    -0.09223847836256027],
            "error_against_truth": [0.05208039034827474, 0.0023057987602942698]},
    "ceres": {"translation": [-0.3259914219379425, 0.016334345564246178, -0.06265384703874588],
              "rotation_axis_angle": [-0.018975865095853806, -0.006681465078145266,
                                      -0.08618146926164627],
              "error_against_truth": [0.06691846726395673, 0.02173406413777845]},
    "gicp": {"translation": [-0.30435681343078613, 0.014649390242993832, -0.0003316214424557984],
             "rotation_axis_angle": [0.00011036113573936746, 0.001007847604341805,
                                     -0.09181549400091171],
             "error_against_truth": [0.04516654607883488, 0.0027987845096616153]},
    "ndt": {"translation": [-0.3293704688549042, 0.021773548796772957, 0.012046853080391884],
            "rotation_axis_angle": [-0.004455555696040392, -0.001060257782228291,
                                    -0.08957352489233017],
            "error_against_truth": [0.02412409415223021, 0.006670145893141986]},
    "ndt_0.3": {"translation": [-0.004539962392300367, 0.00036251291749067605,
                                -1.8983097106684e-05],
                "rotation_axis_angle": [4.909468043479137e-05, -2.0628696802305058e-05,
                                        4.0910555981099606e-05],
                "error_against_truth": [0.3453181890257144, 0.09446525490689732]},
}
SCAN_MATCH_KERNELS = {"icp": ("icp_nearest", "icp_kabsch", "icp_stats"),
                      "ceres": ("dense_insert_3d", "scan_matcher_3d")}
# Phase 20's runs: (mode, resolution, witness, the exact launches of each kernel).
LOCALIZE_SCANS = 250  # the new trajectory against the frozen map (phase 22)
# m of arc into the path: 3 m before the map's first pose and 25 degrees off
# its heading. Both packages' full-submap search keeps the 30-degree angular
# window of the fast matcher (the reference's searches +-pi), so a start
# further round the lap never localizes (tests/localization_witness_2d.py).
LOCALIZE_START = 56.5
LOCALIZE_LIMITS = (100, 0.1)  # least loop closures to the frozen map, largest mean error [m]
LOCALIZE_SEED = 3
LOCALIZE_TIME_OFFSET = 1000.0  # s: the new run comes after the map's
EDGE_FILTER = (0.3, 0.5)  # K31's resolution [m] and ratio (the JAX test's values)
K30_RETURNS = (4096, 16384, 32768)  # returns per scan at K30's shapes
K30_PATH_SCANS = 20  # phase 10's first scans into K30's window
GICP_NDT_RUNS = (
    ("gicp", 0.3, "gicp", {"icp_normals": 1, "icp_nearest": 7, "gicp_lm": 6, "icp_stats": 1}),
    ("ndt", 1.0, "ndt", {"ndt_grid": 1, "ndt_lm": 1}),
    ("ndt", 0.3, "ndt_0.3", {"ndt_grid": 1, "ndt_lm": 1}),
)


def _fail(msg):
    raise AssertionError(msg)


def _cuda_ms(fn, reps=30, warmup=3, attempts=3):
    """Device milliseconds per call of fn(): the GPU activity (kernels and
    copies) the profiler records, or, where it records none in `attempts`
    windows (it has dropped a whole window), the median time between two
    CUDA events around the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        device_ms = _window_device_us(prof) / 1e3 / reps
        if device_ms > 0:
            return device_ms
    return _event_ms(fn, reps, warmup=0)


def _window_device_us(prof):
    """Device microseconds of a profiled window: the summed durations of
    its GPU activities, read from the trace's records without building the
    profiler's event tree (seconds per 10,000 operations, which a plain
    tick of many small operations would take a minute for)."""
    import torch

    results = getattr(prof.profiler, "kineto_results", None)
    if results is None:
        return sum(_device_us(e) for e in prof.key_averages())
    on_card = torch._C._autograd.DeviceType.CUDA
    return sum(e.duration_ns() for e in results.events() if e.device_type() == on_card) / 1e3


def _event_ms(fn, reps=30, warmup=3):
    """The median device milliseconds between two CUDA events around fn():
    its kernels and the gaps between them."""
    import torch

    for _ in range(warmup):
        fn()
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
    perm = torch.randperm(n, generator=torch.Generator(device=dev).manual_seed(3),
                          device=dev, dtype=torch.int32)
    filters = (opts.adaptive_voxel_filter, opts.loop_closure_adaptive_voxel_filter)
    pair = [(f.max_length, f.min_num_points, f.max_range) for f in filters]

    def k1_k2():  # the 2D step's one launch of K1 and K2
        return scan_pipeline_2d._scan_filter_kernel(*args, perm, pair)

    got, (keep, *adaptive) = k1_k2()
    ref = scan_pipeline_2d.align_scan_plain(*args)
    err = max(float((got[k] - ref[k]).abs().max()) for k in (0, 1, 4))
    if err > 1e-5:
        _fail(f"K1 points differ by {err} m (tolerance 1e-5)")
    for k in (2, 3):
        if not torch.equal(got[k], ref[k]):
            _fail("K1 masks differ from the plain twin")
    alone = scan_pipeline_2d.align_scan(*args)  # K1's standalone launch
    if not all(torch.equal(a, b) for a, b in zip(got, alone)):
        _fail("K1's outputs from K2's launch differ from its standalone launch's bits")
    k1_k2_kernels = _launches_per_call(k1_k2, 1, "K1 and K2")
    print(f"K1 scan_preprocess_2d in K2's launch: max |err| {err:.3g} m (tolerance 1e-5), "
          f"masks equal, bit-equal to the standalone K1, {k1_k2_kernels} kernel a call")

    # K2: the preprocess filter (3D keys) and both adaptive filters (2D) over
    # its output, from the step's launch; alone (the unfused launch) for its row.
    hits, is_return = got[0], got[2]

    def k2_scan():
        return voxel_filter.voxel_filter_masks(hits, is_return, pre.voxel_filter_size, perm,
                                               pair, 2)

    plain_keep = voxel_filter.voxel_filter_mask_plain(hits, is_return, pre.voxel_filter_size,
                                                      perm)
    mism = int((keep != plain_keep).sum())
    returns = PointCloud(hits[:, 0:2], keep, torch.zeros(n, device=dev))
    for f, a in zip(filters, adaptive):
        b = voxel_filter.adaptive_voxel_filter_mask_plain(
            returns.points, plain_keep, f.max_length, f.min_num_points, f.max_range, perm)
        mism += int((a != b).sum())
    if mism:
        _fail(f"K2's three masks differ from the plain twins in {mism} points (tolerance 0)")
    # The separate entry points too (the 3D path's): the random filter alone
    # and both adaptive filters over its output.
    mism = int((voxel_filter.voxel_filter_mask(hits, is_return, pre.voxel_filter_size, perm)
                != keep).sum())
    for a, b in zip(voxel_filter.adaptive_voxel_filter_masks(returns.points, keep, pair, perm),
                    adaptive):
        mism += int((a != b).sum())
    mism += sum(int((a != b).sum()) for a, b in zip(k2_scan(), (keep, *adaptive)))
    if mism:
        _fail(f"K2's separate and unfused launches differ from the step's launch in {mism} "
              "points")
    print("K2 voxel_filter: the step's launch's three masks equal the plain twins' "
          "(tolerance: exact), the unfused launch's and the separate launches' masks")
    avf = filters[0]

    def k2_plain():
        m = voxel_filter.voxel_filter_mask_plain(hits, is_return, pre.voxel_filter_size, perm)
        for f in filters:
            voxel_filter.adaptive_voxel_filter_mask_plain(hits[:, 0:2], m, f.max_length,
                                                          f.min_num_points, f.max_range, perm)

    k2_work = _k2_work(torch, hits, keep, filters, perm)
    # K1's row is the step's launch (K1 in K2's), against the plain
    # composition; the 2D path's K2 launches are that launch's.
    rows["scan_preprocess_2d"] = dict(
        symbol="scan_filter_2d", replaces="cartographer_tpu/ops/scan_pipeline_2d.py:40",
        max_abs_err=err, ms=_cuda_ms(k1_k2),
        plain_ms=_cuda_ms(lambda: (scan_pipeline_2d.align_scan_plain(*args), k2_plain()),
                          reps=5),
        bound=_bound(*_k1k2_work(n, k2_work)), library_ms=None)

    key_sets = [voxel_filter._packed_voxel_keys(hits, is_return, pre.voxel_filter_size)] + [
        voxel_filter._packed_voxel_keys(hits[:, 0:2], keep, f.max_length) for f in filters]
    rows["voxel_filter"] = dict(
        symbol="scan_filter_2d", replaces="cartographer_tpu/sensor/voxel_filter.py:67",
        max_abs_err=float(mism), ms=_cuda_ms(k2_scan), plain_ms=_cuda_ms(k2_plain, reps=5),
        bound=_bound(*k2_work),
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
    # The last scan once more into fresh grids: the cells it marks known
    # against the cells the twin touches.
    marked, want, apart = _k4_marks_against_twin(torch, scratch, grids, rd, active, samples)
    if apart > 1e-3 * want or int((scratch.bits != 0).sum()):
        _fail(f"K4 marked {marked} cells against the twin's {want} touched, {apart} apart "
              "(tolerance 0.1%), or left bits set")
    k4_kernels = _launches_per_call(lambda: grid_2d.insert_into_slots(
        grids, rd, active, yes, ins.hit_probability, ins.miss_probability, True, samples,
        scratch), 2, "K4")
    print(f"K4 insert_2d: {marked} cells marked in the last scan's two slots against the "
          f"twin's {want} touched ({apart} apart, tolerance 0.1%), {k4_kernels} kernels per "
          f"call (at most 2)")
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
    rows["insert_2d"] = dict(
        replaces="cartographer_tpu/ops/grid_2d.py:105", max_abs_err=err,
        ms=_cuda_ms(lambda: grid_2d.insert_into_slots(
            grids, rd, active, yes, ins.hit_probability, ins.miss_probability, True,
            samples, scratch)),
        plain_ms=_cuda_ms(lambda: grid_2d._insert_plain(
            plain_grids, rd, active, yes, probability_to_log_odds(ins.hit_probability),
            probability_to_log_odds(ins.miss_probability), True, samples), reps=5),
        bound=_bound(*_k4_work(torch, grids, rd, active, True, samples)),
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
    print(f"K3 scan_matcher_2d: max |pose err| {err:.3g} (tolerance 1e-4), cost rel err "
          f"{rel_cost:.3g} (rtol 1e-4), {int(itk)} iterations (plain {int(itp)})")
    rows["scan_matcher_2d"] = dict(
        replaces="cartographer_tpu/ops/scan_matcher_2d.py:70", max_abs_err=err,
        ms=_cuda_ms(lambda: scan_matcher_2d.lm_match_2d(*margs)),
        plain_ms=_cuda_ms(lambda: scan_matcher_2d._match_plain(*margs), reps=5),
        bound=_bound(*_k3_work(int(cloud.mask.sum()), int(itk))), library_ms=None)
    return rows, dict(grid=grid0, cloud=cloud)


# Bytes each kernel must move and operations it must do on one robot's
# inputs, for the bounds of its row and of the batched tick (row 6b).
def _k1_work(n):
    return n * 51 + 18 * 4, n * 250


def _k1k2_work(n, k2_work):
    """K1 and K2 in one launch: both kernels' work, less K2's reads of K1's
    hits and flags (13 bytes a point), which stay on chip."""
    return n * 51 + 18 * 4 + k2_work[0] - 13 * n, n * 250 + k2_work[1]


def _k2_work(torch, hits, keep, filters, perm):
    """K2's launch for a scan: the hits, flags and permutation read once and
    the three masks written once; the preprocess filter's pass over the 3D
    keys, then the two adaptive filters' hashing passes, as many as this
    scan's sequential search needs (it ends early; the kernel counts the
    bisection's 31 lengths side by side, more work than this)."""
    from cartographer_tpu_torch.sensor import voxel_filter

    n, passes = hits.shape[0], 1
    for f in filters:
        base = keep & (hits[:, 0:2].norm(dim=-1) <= f.max_range)
        if int(base.sum()) <= f.min_num_points:
            continue
        coarse = [int(voxel_filter.voxel_filter_mask_plain(
            hits[:, 0:2], base, f.max_length / 2 ** k, perm).sum()) >= f.min_num_points
            for k in range(7)]
        first = coarse.index(True) if any(coarse) else 7
        passes += min(first + 1, 7) + (5 if 0 < first < 7 else 0) + 1
    return n * (12 + 1 + 4) + 3 * n, passes * int(keep.sum()) * 20


def _k3_work(valid, iterations):
    """K3 on one robot's solve: the points and flags, 16 cells of log-odds
    and known per bicubic sample; some 12 operations per cell and pass, one
    pass per iteration and one at the start."""
    return valid * (8 + 1 + 16 * 5), (1 + iterations) * valid * 16 * 12


def _k4_work(torch, grids, rd, active, insert_free_space, samples):
    """K4 on one robot's slots: in place, it reads and writes the
    log-odds and known of the cells the scan touches, and nothing else."""
    from cartographer_tpu_torch.ops import grid_2d
    from cartographer_tpu_torch.ops.grid_2d import Grid2D

    fresh = Grid2D(torch.zeros_like(grids.log_odds), torch.zeros_like(grids.known),
                   grids.origin, grids.resolution)
    yes = torch.ones((), dtype=torch.bool, device=grids.log_odds.device)
    grid_2d._insert_plain(fresh, rd, active, yes, 0.0, 0.0, insert_free_space, samples)
    cells = int(fresh.known.sum())
    num_samples = (int(active.sum()) * samples
                   * int(rd.returns.mask.sum() + rd.misses.mask.sum()))
    return cells * 2 * (4 + 1) + rd.returns.points.shape[0] * 18, num_samples * 10 + cells * 4


def _k4_marks_against_twin(torch, scratch, grids, rd, active, samples):
    """K4 inserting a scan into fresh grids at `grids`' origins: the cells
    it marks known against the cells the twin touches with that scan ->
    (cells marked, cells the twin touches, cells in one set only)."""
    from cartographer_tpu_torch.ops import grid_2d
    from cartographer_tpu_torch.ops.grid_2d import Grid2D

    fresh = Grid2D(torch.zeros_like(grids.log_odds), torch.zeros_like(grids.known),
                   grids.origin, grids.resolution)
    yes = torch.ones((), dtype=torch.bool, device=grids.log_odds.device)
    grid_2d.insert_into_slots(fresh, rd, active, yes, 0.55, 0.49, True, samples, scratch)
    marked = want = apart = 0
    for slot in range(grids.log_odds.shape[0]):
        hit, free = grid_2d._masks_plain(grids.origin[slot], grids.resolution, grids.size, rd,
                                         True, samples)
        twin = torch.nonzero((hit | free).reshape(-1)).reshape(-1)
        got = torch.nonzero(fresh.known[slot].reshape(-1)).reshape(-1)
        marked += got.numel()
        want += twin.numel()
        apart += int((~torch.isin(got, twin)).sum()) + int((~torch.isin(twin, got)).sum())
    return marked, want, apart


def _k5_blocks(fn, scores):
    """K5's angles inside the window, and the score blocks that sum points,
    of a call fn() whose scores are (A, W, W) or (R, A, W, W): its largest
    launch, read from a captured graph, has a block per (robot, angle, tile
    of shifts), and those of the angles inside the window sum."""
    import torch

    inside = int(torch.isfinite(scores[..., 0, 0]).sum())
    launched = max(_graph_grids(fn, "K5"))
    return inside, launched // scores[..., 0, 0].numel() * inside


def _k5_work(torch, grid, points, mask, x0, scores, params):
    """K5 on one robot's search: the distinct grid cells its candidates
    read, the points, the scores written; a product per (angle, shift,
    valid point)."""
    from cartographer_tpu_torch.ops import correlative_2d

    w = 2 * params.num_linear(grid.resolution) + 1
    finite = torch.isfinite(scores[:, 0, 0])
    _, _, cells = correlative_2d.candidate_cells(grid, points, mask, x0, scores.shape[0],
                                                 params.angular_search_window)
    cells = cells[finite][:, mask]
    shifts = torch.arange(w, device=points.device) - w // 2
    lin = ((cells[:, None, None, :, 0] + shifts[None, :, None, None]) * grid.size
           + cells[:, None, None, :, 1] + shifts[None, None, :, None])
    return (_distinct_cells(torch, [lin]) * 5 + points.shape[0] * 9 + scores.numel() * 4,
            int(finite.sum()) * w * w * int(mask.sum()) * 14)


FRONTEND_KERNELS = ("scan_filter_2d", "scan_matcher_2d", "insert_2d", "correlative_2d")


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
    repeated = None
    if grid_type == "TSDF":
        # K21 adds in input order: a fresh builder repeats the run's poses.
        again = LocalTrajectoryBuilder2D(opts, ["laser"], device=dev)
        rerun = []
        for d in data[:TSDF_REPEAT_SCANS]:
            r = again.add_range_data("laser", d)
            rerun.append([*r.local_pose_translation[:2], nquat.get_yaw(r.local_pose_rotation)])
        repeated = bool(np.array_equal(np.asarray(rerun), est[:TSDF_REPEAT_SCANS]))
        print(f"{label}: the first {TSDF_REPEAT_SCANS} scans again in a fresh builder: poses "
              f"{'repeat bit for bit' if repeated else 'differ'}")
        if not repeated:
            _fail(f"{label}: a second run does not repeat the poses")
        del again

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
    restore = [_recording(ltb, "real_time_correlative_match", kept["correlative"],
                          transform=_robot0),
               _recording(ltb, "lm_match_tsdf_2d" if grid_type == "TSDF" else "lm_match_2d",
                          kept["lm"], transform=_robot0)]
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
        cpu_agreement=[float(worst[0]), float(worst[1])], repeats_bit_for_bit=repeated)


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
    best_k, scores_k = correlative_2d.correlative_match(*args)
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
    inside, summing = _k5_blocks(lambda: correlative_2d.correlative_match(*args), scores_k)
    k5_kernels = _launches_per_call(lambda: correlative_2d.correlative_match(*args), 3, "K5")
    print(f"K5 correlative_2d: {inside} of {scores_k.shape[0]} angles inside the window, "
          f"{summing} summing blocks, {k5_kernels} kernels per call (at most 3)")
    rows["correlative_2d"] = dict(
        replaces="cartographer_tpu/ops/correlative_2d.py:138", max_abs_err=max(err, score_err),
        ms=_cuda_ms(lambda: correlative_2d.correlative_match(*args)),
        plain_ms=_cuda_ms(lambda: correlative_2d.correlative_match_plain(*args), reps=5),
        bound=_bound(*_k5_work(torch, grid, cloud.points, cloud.mask, x0, scores_k, cparams)),
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
    # frontend run whose cloud lies in the finished submap (the group of
    # one); the row comes from the global run's own groups (_descent_phase).
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
    out_k = bnb_2d.fast_correlative_match_2d(pyr, submap_grid, pts, mask, init, bparams, 0.0)
    out_p = bnb_2d.match_plain(pyr, submap_grid, pts, mask, init, bparams, 0.0)
    if not torch.equal(out_k, out_p):
        _fail(f"K7 match differs from the plain twin: {out_k} vs {out_p} (tolerance: exact)")
    print(f"K7 bnb_descent: one pair's row equal to the plain twin's (exact): score "
          f"{float(out_k[0]):.4f}, found and certificate ({bool(out_k[4])}, {bool(out_k[5])})")
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
    extra["schur_2d"] = _schur_2d_timing(torch, dev, q, hs)
    return rows, extra


def _schur_2d_timing(torch, dev, q, hs):
    """K8 on the capacity problem `q`: each launch of a one-iteration call in
    order (the profiler, median of 5 calls), kernels per iteration (captured
    graphs of one and two iterations), 2 and 50 iterations by CUDA events,
    and its reduced Cholesky alone at 3S = 192 rows against
    torch.linalg.cholesky_ex + torch.cholesky_solve (the same solve), by
    events, within a float64 solve's 1e-4 of the solution's scale."""
    from cartographer_tpu_torch.parallel import schur_spa

    solve = lambda n: schur_spa._solve_kernel(q, n, hs, 1e-6)  # noqa: E731
    steps, counted = _launch_breakdown(lambda: solve(1))
    groups = {}
    for name, ms in steps:
        count, total = groups.get(name, (0, 0.0))
        groups[name] = (count + 1, total + ms)
    one, two = _graph_kernels(lambda: solve(1), "K8"), _graph_kernels(lambda: solve(2), "K8")
    ms2, ms50 = _event_ms(lambda: solve(2), reps=5, warmup=1), _event_ms(lambda: solve(50),
                                                                         reps=3, warmup=1)
    n = 3 * q.submap_poses.shape[0]
    rng = np.random.RandomState(n)
    R = rng.randn(n, n)
    P64 = R @ R.T / n + np.eye(n)
    b64 = rng.randn(n)
    P = torch.from_numpy(P64.astype(np.float32)).to(dev)
    b = torch.from_numpy(b64.astype(np.float32)).to(dev)
    ref = np.linalg.solve(P64, b64)
    err = float(np.abs(schur_spa.reduced_cholesky_solve(P, b).cpu().numpy() - ref).max()
                / np.abs(ref).max())
    if not err <= 1e-4:
        _fail(f"K8's reduced Cholesky at {n} rows is {err} from a float64 solve (1e-4)")
    alone = _event_ms(lambda: schur_spa.reduced_cholesky_solve(P, b), reps=50)
    library = _event_ms(lambda: torch.cholesky_solve(b[:, None], torch.linalg.cholesky_ex(P)[0]),
                        reps=50)
    print(f"K8 one iteration at capacity, per launch (profiler, median of {counted} calls; the "
          f"call's first launch and copies included): " + ", ".join(
              f"{name} {total:.4f} ms" + (f" ({count} launches)" if count > 1 else "")
              for name, (count, total) in groups.items()))
    print(f"K8: {two - one} kernels per iteration ({one} in a one-iteration call; captured "
          f"graphs); by CUDA events 2 iterations {ms2:.3f} ms, 50 iterations {ms50:.3f} ms; the "
          f"reduced {n}^2 Cholesky solve alone {alone:.4f} ms (within {err:.3g} of a float64 "
          f"solve) against torch.linalg.cholesky_ex + torch.cholesky_solve {library:.4f} ms")
    return {"breakdown_ms": [[name, ms] for name, ms in steps],
            "kernels_per_iteration": two - one, "event_ms": {"2": ms2, "50": ms50},
            "reduced_cholesky_ms": {"kernel": alone, "cholesky_ex_cholesky_solve": library,
                                    "max_rel_err": err}}


def _global_phase(torch, dev, grid_type="PROBABILITY_GRID", kernels=KERNELS_2D,
                  limits=(100, 3, 0.25), localize=True, label="global", refines=None,
                  groups=None):
    """Global SLAM through MapBuilder on the card over three laps, on
    submaps of `grid_type`; `limits` are the least loop closures and solves
    and the largest mean error of the optimized poses. The arguments of
    every REFINE_EVERY-th loop-closure refine go into `refines` if given;
    `groups`, if given, gets the run's largest group of local requests, the
    global localization's request and the beam that certified it, and the
    constraint builder (for _descent_phase)."""
    from cartographer_tpu_torch.core.config import MapBuilderOptions, TrajectoryBuilderOptions
    from cartographer_tpu_torch.mapping import constraint_builder_2d, pose_graph_2d
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
        local = [r for r in requests if not r.match_full and len(r.points) > 0]
        if groups is not None and len(local) > len(groups.get("local", ())):
            groups["local"] = local
        return compute(requests)

    cb.compute_constraints = recording
    restore = (_recording(constraint_builder_2d, "lm_match_2d", refines, REFINE_EVERY)
               if refines is not None else lambda: None)
    solve_2d, solves_seen = pose_graph_2d.solve_spa_2d_schur, []

    def recording_solve(problem, **kwargs):
        solves_seen[:] = [(problem, kwargs)]  # the last solve (K8)
        return solve_2d(problem, **kwargs)

    pose_graph_2d.solve_spa_2d_schur = recording_solve
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
    pose_graph_2d.solve_spa_2d_schur = solve_2d
    inter, solves = pg.num_inter_constraints(), pg.solves
    # One K8 launch as the run makes it: its last problem (padded to powers
    # of two), one whole solve of 50 iterations, by CUDA events.
    problem, kwargs = solves_seen[0]
    solve_shape = {"S": problem.submap_poses.shape[0], "N": problem.node_poses.shape[0],
                   "C": problem.a_idx.shape[0], "D": problem.j_idx.shape[0]}
    solve_ms = _event_ms(lambda: solve_2d(problem, **dict(kwargs, num_iterations=50)), reps=5,
                         warmup=1)
    print(f"{label}: K8 at the run's last problem {solve_shape}: one 50-iteration solve "
          f"{solve_ms:.3f} ms by CUDA events")
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

    summary = dict(map_builder=mb, scans=len(scans), nodes=len(pg.nodes),
                   submaps=len(pg.submap_data), loop_closures=inter,
                   matched_pairs=cb.pairs_matched, solves=solves,
                   wall_seconds=wall, constraint_search_seconds=cb.match_seconds,
                   solve_seconds=pg.solve_seconds, launches=launches,
                   solve_shape=solve_shape, solve_50_iterations_ms=solve_ms,
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
    if groups is not None:
        groups.update(builder=cb, global_request=cb.begin_global_constraint(
            SubmapId(*sid), entry.submap.grid, NodeId(*nid), node.filtered_points),
            global_beam=beam)
    loc_err = float(np.linalg.norm(row[1:3] - gt[index[nid], :2]))
    print(f"global localization: node {nid} (scan {index[nid]}) in submap {sid}: score "
          f"{row[0]:.4f}, certified {certified} at beam {beam}, {loc_err:.4f} m from the truth "
          f"(limit 0.1 m), {loc_s:.2f} s")
    if not certified or not loc_err <= 0.1:
        _fail("global localization did not come back certified within 0.1 m")
    return dict(summary, global_localization_error_m=loc_err,
                global_localization_seconds=loc_s, global_localization_beam=beam)


def _descent_work(torch, pairs, params, min_score):
    """(bytes, operations, the levels' score lists) of K7's descent on
    `pairs` [(pyramid, grid, points, mask, start pose, window)], counted on
    the twin's own live candidates: each level cell they touch read once,
    each pair's cells at every angle and its mask read once, its row
    written; 10 operations a gathered point and one a candidate a level
    for its selection. The score lists (each level's, -inf for the dead
    candidates) are what the twin sorts."""
    from cartographer_tpu_torch.ops import bnb_2d

    calls, lists, seen = [], [], {}
    distinct = torch.zeros(0, dtype=torch.int64, device=pairs[0][2].device)
    nbytes = ops = 0

    def recorded(level, cells, mask, a_idx, ox, oy):
        out = bnb_2d.score_candidates_plain(level, cells, mask, a_idx, ox, oy)
        calls.append((level, cells, mask, a_idx, ox, oy, out))
        return out

    for pyr, grid, pts, mask, init, window in pairs:
        calls.clear()
        bnb_2d.match_plain(pyr, grid, pts, mask, init, params, min_score,
                           linear_window_override=window, score=recorded)
        depth, size = pyr.shape[0], grid.size
        key = seen.setdefault(pyr.data_ptr(), len(seen))
        nbytes += calls[0][1].numel() * 4 + mask.numel() + 24
        top = calls[0][1].shape[0] * bnb_2d._num_off(window, grid.resolution, depth) ** 2
        for j, (level, cells, m, a, ox, oy, out) in enumerate(calls):
            h = depth - 1 - j
            cx = cells[a.long()][:, m, 0] + ox[:, None]
            cy = cells[a.long()][:, m, 1] + oy[:, None]
            inside = (cx >= 0) & (cx < size) & (cy >= 0) & (cy < size)
            lin = (cx * size + cy)[inside].long() + (key * depth + h) * size * size
            distinct = torch.unique(torch.cat([distinct, torch.unique(lin)]))
            total = top if j == 0 else 4 * params.beam_width
            ops += a.shape[0] * int(m.sum()) * 10 + total
            lists.append(torch.cat([out, torch.full((total - out.shape[0],), -float("inf"),
                                                    device=out.device)]))
    return nbytes + int(distinct.numel()) * 4, ops, lists


def _descent_phase(torch, dev, groups):
    """K7 on the first GROUP_PAIRS pairs of the 2D global run's own largest
    group of local requests and on its global localization's full-submap
    wave (at the beam that certified it): every row equal to the twin's
    (exact), one descent kernel a group (a captured CUDA graph) and the
    group's kernels with its torch glue; the group's device time (the
    kernel, and the whole call), its wall time by CUDA events, the twin's
    time, the bound and the stable sorts."""
    import dataclasses

    from cartographer_tpu_torch.mapping.constraint_builder_2d import _pow2_points
    from cartographer_tpu_torch.ops import bnb_2d

    cb, group = groups["builder"], groups["local"][:GROUP_PAIRS]
    params = cb._bnb_params
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    pts, mask = (t(a) for a in _pow2_points([r.points for r in group]))
    inits = t(np.stack([r.init for r in group]).astype(np.float32))
    pyrs = [cb._pyramid_for(r.submap_id, r.grid) for r in group]
    grids = [r.grid for r in group]
    windows = [params.linear_search_window] * len(group)
    call = lambda: bnb_2d.fast_correlative_match_2d_batch(  # noqa: E731
        pyrs, grids, pts, mask, inits, params, 0.0)
    rows_k = call()
    for b in range(len(group)):
        ref = bnb_2d.match_plain(pyrs[b], grids[b], pts[b], mask[b], inits[b], params, 0.0)
        if not torch.equal(rows_k[b], ref):
            _fail(f"K7: pair {b} of the global run's group differs from the twin: "
                  f"{rows_k[b]} vs {ref} (tolerance: exact)")
    d = bnb_2d.descent_inputs(pyrs, grids, pts, mask, inits, params, windows)
    launch = lambda: bnb_2d.descent_launch(d, params.beam_width, 0.0)  # noqa: E731
    kernels = _graph_kernels(launch, "K7 group")
    with_glue = _graph_kernels(call, "K7 group with its glue")
    if kernels != 1:
        _fail(f"K7: {kernels} kernels a group (the source states 1)")
    # The full-submap wave of the run's global localization.
    req, beam = groups["global_request"], groups["global_beam"]
    wparams = dataclasses.replace(params, beam_width=beam)
    wpts, wmask = (t(a) for a in _pow2_points([req.points]))
    wpyr = cb._pyramid_for(req.submap_id, req.grid)
    wargs = ([wpyr], [req.grid], wpts, wmask, bnb_2d.grid_center_pose(req.grid)[None], wparams,
             cb._options.global_localization_min_score, [bnb_2d.full_submap_window(req.grid)])
    wave = bnb_2d.fast_correlative_match_2d_batch(*wargs)
    wref = bnb_2d.match_plain(wpyr, req.grid, wpts[0], wmask[0], wargs[4][0], wparams,
                              wargs[6], linear_window_override=wargs[7][0])
    if not torch.equal(wave[0], wref):
        _fail(f"K7: the full-submap wave differs from the twin: {wave[0]} vs {wref}")
    wd = bnb_2d.descent_inputs(*wargs[:6], wargs[7])
    wave_kernels = _graph_kernels(lambda: bnb_2d.descent_launch(wd, beam, wargs[6]),
                                  "K7 full-submap wave")
    if wave_kernels != 1:
        _fail(f"K7: {wave_kernels} kernels a full-submap wave (the source states 1)")
    nbytes, ops, lists = _descent_work(
        torch, [(pyrs[b], grids[b], pts[b], mask[b], inits[b], windows[b])
                for b in range(len(group))], params, 0.0)
    ms = _cuda_ms(launch, reps=10)
    group_ms = _cuda_ms(call, reps=10)
    group_event_ms = _event_ms(call, reps=10)
    wave_ms = _event_ms(lambda: bnb_2d.fast_correlative_match_2d_batch(*wargs), reps=5)
    plain_ms = _cuda_ms(lambda: [bnb_2d.match_plain(pyrs[b], grids[b], pts[b], mask[b],
                                                    inits[b], params, 0.0)
                                 for b in range(len(group))], reps=2, warmup=1)
    library_ms = _cuda_ms(lambda: [torch.sort(x, descending=True, stable=True)
                                   for x in lists], reps=5)
    bound = _bound(nbytes, ops)
    n = len(group)
    print(f"K7 bnb_descent: the global run's largest group, {n} pairs, every row equal to the "
          f"twin's (exact), {int(rows_k[:, 4].sum())} found; the full-submap wave at beam "
          f"{beam} equal (exact); {kernels} kernel a group ({with_glue} with the glue), "
          f"{wave_kernels} a wave; the kernel {ms:.4f} ms a group ({ms / n:.4f} a pair), the "
          f"whole call {group_ms:.4f} device ms, {group_event_ms:.4f} ms by CUDA events, the "
          f"wave {wave_ms:.4f} ms by events; the twin {plain_ms:.2f} ms, the sorts "
          f"{library_ms:.4f} ms; bound {bound[0]:.3g} ms ({bound[1]})")
    return {"bnb_descent": dict(
        replaces="cartographer_tpu/ops/bnb_2d.py:101", max_abs_err=0.0, ms=ms,
        plain_ms=plain_ms, bound=bound, library_ms=library_ms, pairs=n,
        kernels_per_group=kernels, kernels_per_group_with_glue=with_glue,
        group_device_ms=group_ms, group_event_ms=group_event_ms, wave_beam=beam,
        wave_event_ms=wave_ms)}


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
        bound=_bound(*_k20_work(n)),
        library_ms=_cuda_ms(lambda: torch.argsort(keys, stable=True)))

    # K21: the scan into both active grids, on clones for the twin.
    grids = builder._active_submaps.grids
    params = builder._active_submaps._tsdf_params
    card = grids.clone()
    twin = grids.clone()
    active = torch.ones(2, dtype=torch.bool, device=dev)
    yes = torch.ones((), dtype=torch.bool, device=dev)
    tsdf_2d.insert_into_slots_tsdf(card, rd, active, yes, params, normals=got)
    tsdf_2d._insert_plain(twin, rd, got, active, yes, params)
    known_diff = int(((card.weight > 0) != (twin.weight > 0)).sum())
    exact = torch.equal(card.tsd, twin.tsd) and torch.equal(card.weight, twin.weight)
    err = float(max((card.tsd - twin.tsd).abs().max(), (card.weight - twin.weight).abs().max()))
    k21_bytes, k21_ops, lins = _k21_work(torch, grids, rd, got, active, params)
    size = grids.size
    touched = sum(int(torch.unique(lin).numel()) for lin, _, _ in lins)
    print(f"K21 tsdf_insert_2d: {touched} cells touched in 2 slots, known sets "
          f"{'equal' if not known_diff else f'differ in {known_diff} cells'}, max |err| "
          f"{err:.3g} (tolerance: exact, both add in input order)")
    if known_diff or not exact:
        _fail("K21 differs from the plain twin")
    sums = [torch.zeros(size * size, device=dev) for _ in range(4)]
    rows["tsdf_insert_2d"] = dict(
        replaces="cartographer_tpu/ops/tsdf_2d.py:115", max_abs_err=err,
        ms=_cuda_ms(lambda: tsdf_2d.insert_into_slots_tsdf(card, rd, active, yes, params,
                                                           normals=got)),
        plain_ms=_cuda_ms(lambda: tsdf_2d._insert_plain(twin, rd, got, active, yes, params),
                          reps=5),
        bound=_bound(k21_bytes, k21_ops),
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
        bound=_bound(*_k22_work(lvalid, int(itk))),
        library_ms=None)

    # K5's TSDF form: the scan's search.
    cgrid, cpts, cmask, cpose, cparams = kept["correlative"][0]
    cargs = (cgrid, cpts, cmask, cpose, cparams)
    best_k, scores_k = correlative_2d.correlative_match(*cargs)
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
    _, summing = _k5_blocks(lambda: correlative_2d.correlative_match(*cargs), scores_k)
    k5_kernels = _launches_per_call(lambda: correlative_2d.correlative_match(*cargs), 3,
                                    "K5's TSDF form")
    print(f"correlative_2d_tsdf: scores and argmax equal to the twin (exact), {angles} valid "
          f"angles of {scores_k.shape[0]}, {summing} summing blocks, {k5_kernels} kernels per "
          f"call (at most 3), best score {float(best_k[0]):.5f}")
    rows["correlative_2d_tsdf"] = dict(
        symbol="correlative_2d_tsdf", replaces="cartographer_tpu/ops/correlative_2d.py:138",
        max_abs_err=0.0, ms=_cuda_ms(lambda: correlative_2d.correlative_match(*cargs)),
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
    import dataclasses

    from cartographer_tpu_torch.ops import scan_matcher_2d

    if not calls:
        _fail("the TSDF global run made no loop-closure refine")
    errs, ms, plain_ms, nbytes, ops = [], [], [], 0, 0
    for args in calls:
        xk, ck, itk = scan_matcher_2d.lm_match_2d(*args)
        xp, cp, itp = scan_matcher_2d._match_plain(*args)
        rel_cost = abs(float(ck) - float(cp)) / max(abs(float(cp)), 1e-30)
        common = ""
        if int(itk) != int(itp):
            # A near-tie in the stop test (relative improvement under 1e-6)
            # ends one solve an iteration before the other: both are held
            # after the iterations they share, on one path, and the whole
            # runs' costs above.
            cap = (*args[:5], dataclasses.replace(args[5], num_iterations=min(int(itk),
                                                                              int(itp))))
            common = f"; both capped at {cap[5].num_iterations} iterations"
            xk = scan_matcher_2d.lm_match_2d(*cap)[0]
            xp = scan_matcher_2d._match_plain(*cap)[0]
        err = float((xk - xp).abs().max())
        valid = int(args[2].sum())
        print(f"scan_matcher_2d_tsdf: loop-closure refine of {valid} of {args[1].shape[0]} "
              f"points: max |pose err| {err:.3g} (tolerance 1e-4{common}), cost rel err "
              f"{rel_cost:.3g} (rtol 1e-4), {int(itk)} iterations (plain {int(itp)})")
        if err > 1e-4 or rel_cost > 1e-4:
            _fail("scan_matcher_2d_tsdf differs from the plain twin")
        errs.append(err)
        # Per valid point: the point and flag, 16 cells of tsd and weight per
        # bicubic sample; some 12 operations per cell and pass, a pass per
        # iteration and one at the start.
        nbytes += valid * (8 + 1 + 16 * 8)
        ops += (1 + int(itk)) * valid * 16 * 12
        # One kernel a call: the mean of its records, which a short window
        # that drops some leaves whole.
        kernel_ms, records = _kernel_ms(lambda: scan_matcher_2d.lm_match_2d(*args),
                                        "scan_matcher_2d_kernel", reps=50)
        event_ms = _event_ms(lambda: scan_matcher_2d.lm_match_2d(*args), reps=20)
        print(f"scan_matcher_2d_tsdf: that refine {kernel_ms:.5f} ms a kernel ({records} records "
              f"of 50 calls), {event_ms:.5f} ms by CUDA events (the call's host gaps included)")
        ms.append(kernel_ms)
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


def _drive_3d(torch, builder, events, gt, label, after_scan=None):
    """Feeds the events to the builder, counting the synchronizing
    operations; checks that no scan is dropped and that each makes one
    blocking copy. `after_scan()`, where given, runs after each scan, outside
    the timed and counted calls. Returns the poses [x, y, z, yaw], their
    position and yaw errors against the truth, the finished submaps, the wall
    seconds of each `add_range_data` and the number of inserted scans."""
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
            if after_scan is not None:
                torch.cuda.set_sync_debug_mode("default")
                after_scan()
                torch.cuda.set_sync_debug_mode("warn")
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


class _ScanChecks:
    """Holds each scan's K12 call (`scan_histograms`: the histogram and its
    rotation bit for bit) and, with `correlative`, its K17 call (the flat
    index, the score and the offsets bit for bit, the quaternion within
    1e-6) against their twins on the same inputs, after the scan while its
    window is still live: installed on the 3D builder module `ltb`, called
    as `_drive_3d`'s after_scan. The wrappers launch what the step launches
    and only keep the arguments and results."""

    def __init__(self, torch, ltb, correlative, label):
        from cartographer_tpu_torch.ops import rot_histogram, scan_matcher_3d

        self.torch, self.ltb, self.label = torch, ltb, label
        self.rh, self.sm = rot_histogram, scan_matcher_3d
        self.pending, self.checked, self.mismatches = [], {"K12": 0, "K17": 0}, []
        self.saved = {"scan_histograms": ltb.scan_histograms}
        ltb.scan_histograms = self._histograms
        if correlative:
            self.saved["correlative_match_3d"] = ltb.correlative_match_3d
            ltb.correlative_match_3d = self._search

    def _histograms(self, *args):
        out = self.rh.scan_histograms(*args)
        self.pending.append(("K12", args, out))
        return out

    def _search(self, grid, points, mask, x0, params):
        score, x, key = self.sm._correlative_kernel(grid, points, mask, x0.contiguous(), params)
        self.pending.append(("K17", (grid, points, mask, x0, params), (score, x, key)))
        return score, x

    def __call__(self):
        torch = self.torch
        for name, args, out in self.pending:
            scan = self.checked[name]
            if name == "K12":
                ref = self.rh.scan_histograms_plain(*args)
                if not (torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])):
                    self.mismatches.append(f"K12 scan {scan}: histogram or rotation differs")
            else:
                score, x, key = out
                ref_score, ref_x, ref_index = self.sm.correlative_match_3d_plain(*args)
                index = ~int(key.cpu()) & 0xFFFFFFFF
                q_err = float((x[3:7] - ref_x[3:7]).abs().max())
                if (index != ref_index or float(score) != float(ref_score)
                        or not torch.equal(x[0:3], ref_x[0:3]) or q_err > 1e-6):
                    self.mismatches.append(
                        f"K17 scan {scan}: index {index} (twin {ref_index}), score "
                        f"{float(score)!r} ({float(ref_score)!r}), quaternion err {q_err:.3g}")
            self.checked[name] += 1
        self.pending = []

    def finish(self):
        """Restores the module's functions; prints the counts and fails on a
        mismatch."""
        for name, fn in self.saved.items():
            setattr(self.ltb, name, fn)
        for m in self.mismatches:
            print(f"{self.label}: MISMATCH {m}")
        print(f"{self.label}: scans checked against the twins {json.dumps(self.checked)} "
              f"(K12 histogram and rotation bit for bit; K17 index, score and offsets bit for "
              f"bit, quaternion 1e-6), {len(self.mismatches)} mismatches")
        if self.mismatches:
            _fail(f"{self.label}: {len(self.mismatches)} scans differ from the twins")
        return dict(self.checked, mismatches=len(self.mismatches))


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
    from cartographer_tpu_torch.mapping import local_trajectory_builder_3d as ltb
    from cartographer_tpu_torch.mapping.local_trajectory_builder_3d import (
        LocalTrajectoryBuilder3D,
    )
    from cartographer_tpu_torch.ops import cuda

    opts, n = TrajectoryBuilder3DOptions(), NUM_SCANS_3D
    t_sim = time.monotonic()
    events, gt = _events_3d(n + PROFILED_SCANS + 1)
    print(f"3D frontend: {time.monotonic() - t_sim:.1f} s to simulate {len(events)} scans")

    builder = LocalTrajectoryBuilder3D(opts, ["points"], device=dev)
    checks = _ScanChecks(torch, ltb, False, "3D frontend")
    cuda.reset_launch_counts()
    try:
        est, offset, yaw_err, finished, walls, inserted = _drive_3d(
            torch, builder, events[:n], gt, "3D frontend", after_scan=checks)
    finally:
        launches = cuda.launch_counts()
        twin_checks = checks.finish()
    print(f"3D frontend: launches {launches}")
    _check_launched(launches, KERNELS_3D, "3D frontend")
    _check_crop_launches(launches, n, finished, "3D frontend")
    _check_insert_launches(launches, inserted, "3D frontend")
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
                       "3D profile", watch=CROP_KERNEL_NAME)
    # One more scan, keeping what its step read and left on the card (the dense
    # windows and their center, the packed result, the insertion's tensors) for
    # the kernel phase.
    step, kept, centers = builder._fused_step, [], []

    def keeping_step(high_grid, low_grid, intensity_grid, upload, perm):
        out = step(high_grid, low_grid, intensity_grid, upload, perm)
        kept.append(((high_grid, low_grid), *out))
        return out

    builder._fused_step = keeping_step
    undo = _recording_windows(builder._active_submaps, centers)
    histograms = []
    restore = _recording(ltb, "scan_histograms", histograms)
    try:
        _feed_3d(builder, events[n + PROFILED_SCANS])
    finally:
        restore()
        undo()
        del builder._fused_step
    steady = walls[10:]
    return dict(
        builder=builder, last_step=(*kept[0], centers[0], histograms[0]), profile=profile,
        scans=n,
        inserted=inserted,
        finished_submaps=len(finished), mean_error_m=float(errors.mean()),
        mean_yaw_error_rad=float(yaw_err.mean()),
        mean_offset_m=offsets,
        frontend_3d_builder_scans_per_sec=len(steady) / sum(steady),
        host_seconds=builder.host_seconds, device_seconds=builder.device_seconds,
        allocator_ms_per_inserted_scan=builder.allocator_seconds * 1e3 / max(inserted, 1),
        new_pages_per_inserted_scan=builder.pages_allocated / max(inserted, 1),
        finished_submap_pages=[f.high_paged.num_allocated, f.low_paged.num_allocated],
        launches=launches, lm_iterations_per_scan=float(np.mean(builder.lm_iterations[1:n])),
        cpu_agreement=[float(worst[0]), float(worst[1])], twin_checks=twin_checks)


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


def _submap_insertions(builder, finished):
    """The (scan, submap) insertions of a 3D run: the insertions of every
    submap it made (the finished ones and the active ones not finished)."""
    submaps = {id(s): s for s in finished}
    for s in builder._active_submaps.submaps:
        submaps.setdefault(id(s), s)
    return sum(s.num_range_data for s in submaps.values())


def _check_insert_launches(launches, inserted, label):
    """One K9 launch an inserted 3D scan, whatever the active submaps."""
    if launches["paged_insert_3d"] != inserted:
        _fail(f"{label}: {launches['paged_insert_3d']} K9 launches for {inserted} inserted "
              "scans (one a scan)")


def _check_crop_launches(launches, n, finished, label):
    """One crop launch a 3D scan (the matching windows of every scan after
    the first) and one per lazy crop of a finished submap (its high and low
    windows, which _drive_3d makes)."""
    expected = n - 1 + 2 * len(finished)
    if launches["paged_crop_3d"] != expected:
        _fail(f"{label}: {launches['paged_crop_3d']} crop launches, expected {expected} (one "
              f"a scan after the first, one per lazy crop)")


def _recording_windows(active, centers):
    """Record into `centers` each center that `active.matching_grids_at`
    crops around; returns the undo."""
    original = active.matching_grids_at

    def recorded(center):
        centers.append(np.asarray(center, np.float32).copy())
        return original(center)

    active.matching_grids_at = recorded
    return lambda: delattr(active, "matching_grids_at")


def _window_tensors(grid):
    """A crop's two dense tensors and its origin."""
    if hasattr(grid, "sums"):
        return grid.sums, grid.counts, grid.origin
    return grid.log_odds, grid.known, grid.origin


def _crop_work(torch, windows):
    """The bytes a crop of `windows` [(paged grid, center, size)] must move:
    each window's two dense tensors and origin written once, the window's
    cells that lie on a page and its part of the page table read once.
    -> (bytes, cells, [(pools, pages under the window)])."""
    nbytes, cells, gathers = 0, 0, []
    for grid, center, size in windows:
        B, nb = grid.page_size, grid.num_blocks
        pools = (grid.sums, grid.counts) if hasattr(grid, "sums") else (grid.pages, grid.known)
        per_cell = sum(p.element_size() for p in pools)
        c = torch.from_numpy(np.asarray(center, np.float32).copy()).to(grid.origin.device)
        start = grid.world_to_cell(c).cpu().numpy().astype(np.int64) - size // 2
        lo, hi = np.clip(start // B, 0, nb), np.clip((start + size - 1) // B + 1, 0, nb)
        table = grid.page_table[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
        has = ((table >= 0) & (table < pools[0].shape[0])).cpu().numpy()
        # The cells of each block under the window, axis by axis.
        span = [np.minimum((np.arange(lo[a], hi[a]) + 1) * B, start[a] + size)
                - np.maximum(np.arange(lo[a], hi[a]) * B, start[a]) for a in range(3)]
        on_pages = int((has * span[0][:, None, None] * span[1][None, :, None]
                        * span[2][None, None, :]).sum())
        nbytes += size ** 3 * per_cell + 12 + on_pages * per_cell + int(table.numel()) * 4
        cells += size ** 3
        gathers.append((pools, table[torch.from_numpy(has).to(table.device)].long()))
    return nbytes, cells, gathers


def _crop_row(torch, dev, windows, label, replaces, **extra):
    """The crop launch of `windows` against the plain twins (tolerance 0)
    and its row: device ms of the launch and of one zero_() of as many
    bytes as the windows hold (the card's store ceiling), each the mean of
    its kernel's profiler records (the profiler drops records of short
    windows, which a window's sum would lose), and of the twins and the
    library's gather of the windows' pages."""
    from cartographer_tpu_torch.ops import paged_grid_3d

    def twins():
        return [(paged_grid_3d.crop_dense_intensity_plain if hasattr(grid, "sums")
                 else paged_grid_3d.crop_dense_plain)(
                     grid, torch.from_numpy(np.asarray(center, np.float32).copy()).to(dev), size)
                for grid, center, size in windows]

    got = paged_grid_3d.crop_windows(windows)
    differ = sum(int((a != b).sum()) for g, r in zip(got, twins())
                 for a, b in zip(_window_tensors(g), _window_tensors(r)))
    if differ:
        _fail(f"{label}: {differ} cells differ from the plain twins (tolerance 0)")
    nbytes, cells, gathers = _crop_work(torch, windows)
    flat = torch.empty(sum(x.numel() * x.element_size() for g in got
                           for x in _window_tensors(g)[:2]) // 4,
                       dtype=torch.float32, device=dev)
    print(f"{label}: windows {[size for _, _, size in windows]} in one launch, 0 differing "
          f"cells, {[int(p.numel()) for _, p in gathers]} pages under them, "
          f"{nbytes / 1e6:.1f} MB to move")
    return dict(
        replaces=replaces, max_abs_err=float(differ), **extra,
        ms=_kernel_ms(lambda: paged_grid_3d.crop_windows(windows), CROP_KERNEL_NAME)[0],
        plain_ms=_cuda_ms(twins, reps=3, warmup=1),
        bound=_bound(nbytes, cells * 20),
        # Advanced indexing gathers the windows' pages; it does not assemble them.
        library_ms=_cuda_ms(lambda: [(p[0][pages], p[1][pages]) for p, pages in gathers]),
        zero_ms=_kernel_ms(flat.zero_, "FillFunctor")[0])


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
    (high_grid, low_grid), packed, (est_t, local_points, keep, in_high, _), crop_center, \
        hist_args = last_step
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
    filters = (opts.high_resolution_adaptive_voxel_filter,
               opts.low_resolution_adaptive_voxel_filter)
    both = voxel_filter.adaptive_voxel_filter_masks(  # the 3D step's one launch of both
        centered, keep, [(f.max_length, f.min_num_points, f.max_range) for f in filters], perm)
    for f, a in zip(filters, both):
        b = voxel_filter.adaptive_voxel_filter_mask_plain(centered, keep, f.max_length,
                                                          f.min_num_points, f.max_range, perm)
        mism += int((a != (b & keep)).sum())
    if mism:
        _fail(f"K2 (3D keys, {n} points) differs from the plain twin in {mism} points")
    print(f"K2 voxel_filter at 3D shapes ({n} points): masks equal to the plain twin")

    # K10: the scan's two windows in one launch, around the step's own center.
    center = host["translation"].astype(np.float32)  # K9's sensor origin below
    submaps = builder._active_submaps.submaps
    rows["paged_crop_3d"] = _crop_row(torch, dev, [
        (submaps[0].high_paged.grid, crop_center, opts.tpu.high_grid_size),
        (submaps[0].low_paged.grid, crop_center, opts.tpu.low_grid_size)],
        "K10 paged_crop_3d", "cartographer_tpu/ops/paged_grid_3d.py:287")

    # K9: the scan's inserts into the active submaps' grids, one launch with
    # their new page-table entries (the host's allocation first), against
    # the twin on clones of the pools (the table is shared: the twin reads
    # the entries the launch wrote).
    ins = opts.submaps.range_data_inserter
    args = (ins.hit_probability, ins.miss_probability, ins.num_free_space_voxels)
    jobs, twins = [], []
    for submap in submaps:
        for paged, mask_t, mask_h in ((submap.high_paged, in_high, host["high_range_mask"]),
                                      (submap.low_paged, keep, host["local_mask"])):
            twins.append(dataclasses.replace(paged.grid, pages=paged.grid.pages.clone(),
                                             known=paged.grid.known.clone()))
            jobs.append((paged.grid, mask_t, paged.allocate(
                host["local_points"], mask_h, ins.num_free_space_voxels)))
    paged_grid_3d.insert_paged_grids(jobs, est_t, local_points, *args)
    marks = [paged_grid_3d.insert_paged_plain(w, est_t, local_points, mk, *args)
             for w, (_, mk, _) in zip(twins, jobs)]  # the cells each grid's insert touches
    differ = sum(int((g.pages != w.pages).sum() + (g.known != w.known).sum())
                 for (g, _, _), w in zip(jobs, twins))
    if differ:
        _fail(f"K9 pools differ from the plain twin in {differ} cells (tolerance 0)")
    touched = [int(m.sum()) for m in marks]
    jobs = [(g, mk, None) for g, mk, _ in jobs]  # the table holds the scan's pages now

    def k9():
        paged_grid_3d.insert_paged_grids(jobs, est_t, local_points, *args)

    k9_kernels = _launches_per_call(k9, 1, "K9")
    print(f"K9 paged_insert_3d: {len(jobs)} pools of {opts.tpu.max_pages} x {B}^3 in one "
          f"launch, 0 differing cells, {touched} cells touched, {k9_kernels} kernel a call")
    lins = [m.nonzero()[:, 0] for m in marks]
    ones = [torch.ones(x.shape[0], dtype=torch.bool, device=dev) for x in lins]
    per = ins.num_free_space_voxels + 1
    rows["paged_insert_3d"] = dict(
        replaces="cartographer_tpu/ops/paged_grid_3d.py:235", max_abs_err=float(differ),
        ms=_cuda_ms(k9),
        plain_ms=_cuda_ms(lambda: [paged_grid_3d.insert_paged_plain(
            w, est_t, local_points, mk, *args) for w, (_, mk, _) in zip(twins, jobs)], reps=3,
            warmup=1),
        bound=_bound(sum(c * 10 for c in touched) + len(jobs) * (n * 13 + 12 + n * per * 4),
                     len(jobs) * n * per * 40),
        # index_put_ sets the marks of the touched cells; it applies nothing.
        library_ms=_cuda_ms(lambda: [mk.index_put_((x,), o)
                                     for mk, x, o in zip(marks, lins, ones)]))
    del marks, jobs, twins

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
    passes = 1 + iters  # one pass an LM iteration and one at the start
    rows["scan_matcher_3d"] = dict(
        replaces="cartographer_tpu/ops/scan_matcher_3d.py:61", max_abs_err=max(err_t, err_r),
        ms=_cuda_ms(lambda: scan_matcher_3d.lm_match_3d(*margs)),
        plain_ms=_cuda_ms(lambda: scan_matcher_3d._match_plain(*margs), reps=3, warmup=1),
        bound=_bound(sum(valid) * (13 + 8 * 5) + 44, passes * sum(valid) * 8 * 40),
        library_ms=None)

    # K12: the step's one launch, the histogram of the levelled high-resolution
    # cloud and its rotation by the matched yaw, on the step's own inputs.
    pts, mask, gravity, est_q, bins = hist_args
    got = rot_histogram.scan_histograms(*hist_args)
    ref = rot_histogram.scan_histograms_plain(*hist_args)
    bin_err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    empty = rot_histogram.scan_histograms(pts, torch.zeros_like(mask), gravity, est_q, bins)
    nv = int(mask.sum())
    print(f"K12 rot_histogram (the step's launch, with the levelling and the rotation): {nv} "
          f"points, {bins} bins, sum {float(ref[0].sum()):.3f}: largest bin difference "
          f"{bin_err:.3g} (tolerance: bit for bit); empty cloud sum {float(empty[0].sum())}; "
          f"kernels a call {_graph_kernels(lambda: rot_histogram.scan_histograms(*hist_args), 'K12')}")
    if (not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]))
            or not float(ref[0].sum()) > 0 or float(empty[0].abs().sum())):
        _fail("K12 differs from the plain twin")
    if _graph_kernels(lambda: rot_histogram.scan_histograms(*hist_args), "K12") != 1:
        _fail("K12: the step's histogram and rotation are not one kernel")
    k12_ms, records = _kernel_ms(lambda: rot_histogram.scan_histograms(*hist_args),
                                 "histogram_kernel")
    print(f"K12 rot_histogram: {k12_ms:.5f} ms a kernel ({records} records of 50 calls)")
    rows["rot_histogram"] = dict(
        replaces="cartographer_tpu/ops/rot_histogram.py:27", max_abs_err=bin_err, ms=k12_ms,
        plain_ms=_cuda_ms(lambda: rot_histogram.scan_histograms_plain(*hist_args),
                          reps=2, warmup=1),
        bound=_bound(*_k12_work(torch, pts.shape[0], nv, bins, rotated=True)),
        library_ms=None)
    hist = got[0]
    yaw = quat.get_yaw(u["rotation"]).contiguous()
    rot_err = float((rot_histogram.rotate_histogram(hist, yaw)
                     - rot_histogram.rotate_histogram_plain(hist, yaw)).abs().max())
    if rot_err > 1e-6:
        _fail(f"K12's rotation differs from the plain twin by {rot_err} (tolerance 1e-6)")
    print(f"K12 rot_histogram_rotate (the standalone rotation, phase 22's): max |err| "
          f"{rot_err:.3g} (tolerance 1e-6)")
    rows["rot_histogram_rotate"] = dict(
        replaces="cartographer_tpu/ops/rot_histogram.py:94", max_abs_err=rot_err,
        ms=_cuda_ms(lambda: rot_histogram.rotate_histogram(hist, yaw)),
        plain_ms=_cuda_ms(lambda: rot_histogram.rotate_histogram_plain(hist, yaw)),
        bound=_bound(bins * 8 + 4, bins * 10), library_ms=None)
    return rows


def _k12_work(torch, n, valid, bins, rotated=False):
    """(bytes, operations) of one K12 call: the points and mask read, the
    histogram (and its rotation) written; some 114 operations a valid point
    (the levelling rotation 30, the slice 6, the centroid sums 2, the angle
    and its test 30, the walk 6, the emitted direction 40), log2 of the valid
    points a point for its sorted place, 10 a bin for the rotation."""
    sort = valid * max(int(np.ceil(np.log2(max(valid, 2)))), 1)
    nbytes = n * 13 + 32 + bins * 4 * (2 if rotated else 1)
    return nbytes, n * 2 + valid * 114 + sort + (bins * 10 if rotated else 0)


def _full_frontend_options(**extra):
    """The default 3D options with the online correlative search and
    intensities on (trajectory_builder_3d.lua: a 0.15 m and 1 degree window,
    both weights 0.1; intensity weight 0.5, threshold 40)."""
    from cartographer_tpu_torch.core.config import TrajectoryBuilder3DOptions, apply_overrides

    return apply_overrides(TrajectoryBuilder3DOptions(), {
        "use_online_correlative_scan_matching": True, "use_intensities": True, **extra})


def _robot0(args):
    """Robot 0's arguments of a call from the 2D builder's robot-batched
    step (a list of grids and tensors with a leading robot dimension)."""
    import torch

    return tuple(a[0] if isinstance(a, (list, torch.Tensor)) else a for a in args)


def _recording(module, name, calls, every=1, transform=None, result=False):
    """Wrap module.name so the arguments of every `every`-th call (through
    `transform`, if given; with the call's result, if `result`) are
    appended to `calls`; returns a function that restores it."""
    original = getattr(module, name)
    seen = [0]

    def recorded(*args):
        keep = seen[0] % every == 0
        seen[0] += 1
        kept = (transform(args) if transform else args) if keep else None
        out = original(*args)
        if keep:
            calls.append((kept, out) if result else kept)
        return out

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
    # Every scan's K17 and K12 calls against their twins (ROADMAP.md, Queue 3's
    # yaw item: the card's own searches, recomputed by the twin).
    checks = _ScanChecks(torch, ltb, True, label)
    cuda.reset_launch_counts()
    try:
        est, offset, yaw_err, finished, walls, inserted = _drive_3d(
            torch, builder, events[:n], gt, label, after_scan=checks)
    finally:
        launches = cuda.launch_counts()
        twin_checks = checks.finish()
    print(f"{label}: launches {launches}")
    _check_launched(launches, FULL_FRONTEND_KERNELS, label)
    _check_crop_launches(launches, n, finished, label)
    # K9 once an inserted scan; K18 once a scan and active submap.
    expected = {"correlative_3d": n, "scan_matcher_3d": n, "paged_insert_3d": inserted,
                "paged_intensity_insert_3d": _submap_insertions(builder, finished)}
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
                       f"{label} profile", watch=CROP_KERNEL_NAME)
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
    centers = []
    restore.append(_recording_windows(builder._active_submaps, centers))
    try:
        _feed_3d(builder, events[n + PROFILED_SCANS])
    finally:
        del builder._fused_step
        for r in restore:
            r()
    kept["center"] = centers[0]
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
        cpu_agreement=[float(worst[0]), float(worst[1])], twin_checks=twin_checks)


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
    from cartographer_tpu_torch.ops import in_order_scatter, paged_grid_3d, scan_matcher_3d
    from cartographer_tpu_torch.transform import quaternion as quat

    opts = builder._options
    rows = {}
    (high_grid, _, intensity_grid), packed, device_tensors = kept["step"]
    est_t, local_points, keep, in_high, intensities = device_tensors
    bins = opts.rotational_histogram_size
    host = unpack_step_result(packed.cpu().numpy(), bins, builder._caps, True)
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
    per_call = _graph_kernels(lambda: scan_matcher_3d._correlative_kernel(*cargs), "K17")
    print(f"K17 correlative_3d: {valid} points, {rotations} valid rotations of {a3}, "
          f"best {index} (twin {ref_index}), score {float(score):.7g} (twin "
          f"{float(ref_score):.7g}), quaternion err {q_err:.3g} (tolerance: index and score "
          f"bit for bit, offsets equal, quaternion 1e-6), {cells} window cells read, "
          f"{per_call} kernel a call")
    if per_call != 1:
        _fail(f"K17: {per_call} kernels a call, one expected")
    if (index != ref_index or float(score) != float(ref_score)
            or not torch.equal(x[0:3], ref_x[0:3]) or q_err > 1e-6):
        _fail("K17 differs from the plain twin")
    # One kernel a call: the mean of its records, which a short window that
    # drops some leaves whole.
    k17_ms, records = _kernel_ms(lambda: scan_matcher_3d._correlative_kernel(*cargs),
                                 "correlative_kernel")
    print(f"K17 correlative_3d: {k17_ms:.5f} ms a kernel ({records} records of 50 calls)")
    rows["correlative_3d"] = dict(
        replaces="cartographer_tpu/ops/scan_matcher_3d.py:144", max_abs_err=q_err, ms=k17_ms,
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

    # K19: the scan's three windows (K10's two and the intensity window) in
    # one launch, around the step's own center.
    size = opts.tpu.high_grid_size
    s0 = builder._active_submaps.submaps[0]
    windows = [(s0.high_paged.grid, kept["center"], size),
               (s0.low_paged.grid, kept["center"], opts.tpu.low_grid_size),
               (s0.intensity_paged.grid, kept["center"], size)]
    if not torch.equal(paged_grid_3d.crop_windows(windows)[2].origin, cgrid.origin):
        _fail("K19's window is not the step's high occupancy window")
    rows["paged_intensity_crop_3d"] = _crop_row(
        torch, dev, windows, "K19 paged_intensity_crop_3d (with K10's two windows)",
        "cartographer_tpu/ops/paged_grid_3d.py:410", symbol="paged_crop_3d")

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
    lins, values = [], []
    for p, _ in jobs:
        lin, found = paged_grid_3d._pool_index(p.grid, p.grid.world_to_cell(local_points), ok)
        lins.append(lin[found])
        values.append(intensities[found])
    touched = [int(torch.unique(x).numel()) for x in lins]
    ones = [torch.ones_like(v) for v in values]
    print(f"K18 paged_intensity_insert_3d: {len(jobs)} pools, counts equal, sums within "
          f"{sum_err:.3g} relative (tolerance 1e-5), {touched} cells touched")
    ms, ev, flag = _timed(lambda: [paged_grid_3d.insert_intensity_paged(
        p.grid, local_points, intensities, in_high, threshold) for p, _ in jobs])
    per_call = _launches_per_call(lambda: paged_grid_3d.insert_intensity_paged(
        jobs[0][0].grid, local_points, intensities, in_high, threshold),
        in_order_scatter.launches(n), "K18")
    rows["paged_intensity_insert_3d"] = dict(
        replaces="cartographer_tpu/ops/paged_grid_3d.py:385", max_abs_err=sum_err,
        ms=ms, event_ms=ev, timers_differ_2x=flag, returns=n, launches_per_call=per_call,
        plain_ms=_cuda_ms(lambda: [paged_grid_3d.insert_intensity_paged_plain(
            w, local_points, intensities, in_high, threshold) for _, w in jobs], reps=3,
            warmup=1),
        bound=_bound(len(jobs) * (n * 17 + 12) + sum(c * 16 for c in touched),
                     len(jobs) * n * 12),
        # index_add_ of the sums and of the counts into both pools, the pool
        # indices computed beforehand: the same function (float atomics, so
        # not the input order).
        library_ms=_cuda_ms(lambda: [(p.grid.sums.view(-1).index_add_(0, x, v),
                                      p.grid.counts.view(-1).index_add_(0, x, o))
                                     for (p, _), x, v, o in zip(jobs, lins, values, ones)]))
    r = rows["paged_intensity_insert_3d"]
    print(f"K18 paged_intensity_insert_3d at {n} returns, {len(jobs)} pools: {ms:.4f} ms by the "
          f"profiler, {ev:.4f} by CUDA events{' (DIFFER by more than 2x)' if flag else ''}, "
          f"{per_call} launches per call, index_add_ of sums and counts {r['library_ms']:.4f}, "
          f"bound {r['bound'][0]:.2e}")
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
    passes = 1 + iters  # one pass an LM iteration and one at the start
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
    from cartographer_tpu_torch.ops import cuda, in_order_scatter, paged_grid_3d
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
                               "scan_matcher_3d", "paged_intensity_insert_3d"), label)
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
    filters = (opts.high_resolution_adaptive_voxel_filter,
               opts.low_resolution_adaptive_voxel_filter)
    pair = [(f.max_length, f.min_num_points, f.max_range) for f in filters]
    for f, a in zip(filters, voxel_filter.adaptive_voxel_filter_masks(pts, keep, pair, perm)):
        b = voxel_filter.adaptive_voxel_filter_mask_plain(pts, keep, f.max_length,
                                                          f.min_num_points, f.max_range, perm)
        mism += int((a != b).sum())
    print(f"K2 voxel_filter at {size} points (tables in device memory): {mism} points differ "
          f"from the twin (tolerance: exact)")
    if mism:
        _fail(f"K2 at {size} points differs from the plain twin")

    def k2_scan():  # the 3D step's two launches
        m = voxel_filter.voxel_filter_mask(pts, mask, opts.voxel_filter_size, perm)
        voxel_filter.adaptive_voxel_filter_masks(pts, m, pair, perm)

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
    ok = in_high & (intensities <= threshold)
    lins, values = [], []
    for b in before:
        lin, found = paged_grid_3d._pool_index(b, b.world_to_cell(local_points), ok)
        lins.append(lin[found])
        values.append(intensities[found])
    touched = [int(torch.unique(x).numel()) for x in lins]
    ones = [torch.ones_like(v) for v in values]
    nret = local_points.shape[0]
    print(f"K18 paged_intensity_insert_3d at {nret} returns: {differ} pool cells differ from "
          f"the CPU twin (tolerance: exact), {touched} cells touched")
    if differ:
        _fail(f"K18 at {nret} returns differs from the CPU twin")
    ms, ev, flag = _timed(lambda: [paged_grid_3d.insert_intensity_paged(
        b, local_points, intensities, in_high, threshold) for b in before])
    per_call = _launches_per_call(lambda: paged_grid_3d.insert_intensity_paged(
        before[0], local_points, intensities, in_high, threshold),
        in_order_scatter.launches(nret), f"K18 at {nret} returns")
    rows["paged_intensity_insert_3d"] = dict(
        max_abs_err=float(differ), ms=ms, event_ms=ev, timers_differ_2x=flag, returns=nret,
        launches_per_call=per_call,
        plain_ms=_cuda_ms(lambda: [paged_grid_3d.insert_intensity_paged_plain(
            b, local_points, intensities, in_high, threshold) for b in before], reps=3,
            warmup=1),
        bound=_bound(len(jobs) * (nret * 17 + 12) + sum(c * 16 for c in touched),
                     len(jobs) * nret * 12),
        # index_add_ of the sums and the counts into both pools (indices
        # computed beforehand): the same function in atomic order.
        library_ms=_cuda_ms(lambda: [(b.sums.view(-1).index_add_(0, x, v),
                                      b.counts.view(-1).index_add_(0, x, o))
                                     for b, x, v, o in zip(before, lins, values, ones)]))
    r = rows["paged_intensity_insert_3d"]
    print(f"K18 paged_intensity_insert_3d at {nret} returns, {len(before)} pools: {ms:.4f} ms "
          f"by the profiler, {ev:.4f} by CUDA events"
          f"{' (DIFFER by more than 2x)' if flag else ''}, {per_call} launches per call, "
          f"index_add_ of sums and counts {r['library_ms']:.4f}, bound {r['bound'][0]:.2e}")
    steady = walls[10:]
    return dict(scans=n, returns_per_scan=nret, inserted=inserted,
                mean_error_m=float(errors.mean()), mean_yaw_error_rad=float(yaw_err.mean()),
                frontend_3d_builder_scans_per_sec=len(steady) / sum(steady),
                host_seconds=builder.host_seconds, device_seconds=builder.device_seconds,
                cpu_agreement=[float(worst[0]), float(worst[1])], launches=launches,
                kernels=rows)


def _imu_based_phase_3d(torch, dev):
    """The 3D frontend with the IMU-based extrapolator and intensities over
    NUM_SCANS_IMU scans of the half-scale hall with a 1 s pose queue (error reported,
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


def _global_phase_3d(torch, dev, kernels=KERNELS_3D_GLOBAL):
    """3D global SLAM through MapBuilder on the card over three laps of the
    half-scale hall, then one global localization. Records the run's first
    64 local requests (for K15's group) and the localization's inputs."""
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
          f"{pg.solve_seconds:.2f} s ({pg.solve_seconds / max(solves, 1):.3f} s per solve, "
          f"{pg.snapshot_seconds:.3f} s of host snapshots); launches {launches}")
    _check_launched(launches, kernels, "3D global SLAM")
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
    localization = dict(matcher=matcher, clouds=(hp, hm, lp, lm, hist), node_q=node_q,
                        identity=identity)
    return dict(
        pose_graph=pg, request=request, node=node, node_rotation=unknown_yaw, group=recorded,
        localization=localization,
        summary=dict(
            scans=len(events), nodes=len(pg.nodes), submaps=len(pg.submap_data),
            loop_closures=inter, pairs_tried=cb.pairs_matched, solves=solves,
            wall_seconds=wall, constraint_search_seconds=cb.match_seconds,
            solve_seconds=pg.solve_seconds,
            solve_seconds_per_solve=pg.solve_seconds / max(solves, 1),
            snapshot_seconds=pg.snapshot_seconds,
            wall_ms_per_pair=cb.match_seconds * 1e3 / max(cb.pairs_matched, 1),
            launches=launches, mean_error_optimized_m=global_err,
            mean_error_frontend_m=local_err, global_localization_score=score,
            global_localization_certified=certified, global_localization_error_m=loc_err,
            global_localization_error_rad=rot_err, global_localization_seconds=loc_s))


def _descent_work_3d(torch, searches, params, min_score):
    """(bytes, operations) of K15's searches, counted on the twin's own live
    candidates: each level cell and low-grid cell they touch read once, each
    pair's clouds, masks and yaw data read once, its row written; 25
    operations a gathered point, 60 a point and yaw discretized and one a
    candidate a selection."""
    from cartographer_tpu_torch.ops import bnb_3d

    calls, seen = [], {}
    distinct = torch.zeros(0, dtype=torch.int64, device=searches[0].points.device)
    nbytes = ops = 0

    def recorded(level, re, window, size, cells, mask, a_idx, ox, oy, oz):
        calls.append((level, re, size, cells, mask, a_idx, ox, oy, oz))
        return bnb_3d.score_plain(level, re, window, size, cells, mask, a_idx, ox, oy, oz)

    for s in searches:
        calls.clear()
        touched = [distinct]
        bnb_3d._match_tail(s, params, min_score, score=recorded)
        a = s.yaw_q.shape[0]
        n, nl = s.points.shape[0], s.low_points.shape[0]
        nbytes += (n + nl) * 13 + a * 25 + 40 + 48
        ops += a * (n + nl) * 60
        for j, (level, re, size, cells, mask, a_idx, ox, oy, oz) in enumerate(calls):
            key = seen.setdefault((level.data_ptr(), level.element_size()), len(seen))
            c = [cells[a_idx.long()][:, mask, k] + o[:, None] for k, o in enumerate((ox, oy, oz))]
            inside = (c[0] >= 0) & (c[0] < size) & (c[1] >= 0) & (c[1] < size) & (c[2] >= 0) & (
                c[2] < size)
            dim = level.shape[-1]
            lin = (((c[0] >> re) * dim + (c[1] >> re)) * dim + (c[2] >> re))[inside].long()
            touched.append((torch.unique(lin) + key * (1 << 40)) * 8 + level.element_size())
            ops += a_idx.shape[0] * int(mask.sum()) * 25 + a_idx.shape[0]
        distinct = torch.unique(torch.cat(touched))
    item = distinct % 8
    return nbytes + int(item.sum()), ops


def _descent_phase_3d(torch, ctx, extra):
    """K15 on the 3D global run's state: its first recorded local pair (the
    whole call, kernel against twin, bit for bit), its first 64 local
    requests as one group (every row equal to the twin's), its global
    localization's widening rounds as waves (each round's row equal to the
    twin's), one descent kernel a group in a captured graph and the group's
    kernels with its glue; the group's device ms per pair (the kernel, and
    the whole call), its wall by CUDA events, the twin's time, the bound."""
    import dataclasses

    from cartographer_tpu_torch.ops import bnb_3d

    pg, req = ctx["pose_graph"], ctx["request"]
    cb = pg.constraint_builder
    params, min_score = cb.bnb_params, cb._options.min_score
    args = _pair_args(cb, req)
    before = bnb_3d._DESCENT.launches
    out_k = bnb_3d.fast_correlative_match_3d(*args)
    one_launches = bnb_3d._DESCENT.launches - before
    out_p = bnb_3d.fast_correlative_match_3d(*args, plain=True)
    if not torch.equal(out_k, out_p) or one_launches != 1:
        _fail(f"K15: the pair's match differs from the plain twin ({one_launches} launches): "
              f"{out_k} vs {out_p} (tolerance: exact)")
    print(f"K15 bnb3d_descent: pair {req.node_id}/{req.submap_id}: score "
          f"{float(out_k[1]):.6f}, found {bool(out_k[0])}, certified {bool(out_k[11])}, equal "
          f"to the twin (exact), 1 launch")

    group = ctx["group"]
    n = len(group)
    hp, hm, lp, lm, hist, init = cb._clouds(group)
    ms = [r.matcher for r in group]
    gargs = ([m.stack for m in ms], [m.high_grid for m in ms], [m.low_grid for m in ms], hp, hm,
             lp, lm, hist, [m.histogram for m in ms], init[:, 0:3], init[:, 3:7], params)
    lows = [m.low_probability for m in ms]
    call = lambda: bnb_3d.fast_correlative_match_3d_batch(  # noqa: E731
        *gargs, min_score, low_probabilities=lows)
    rows_k = call()
    for b, r in enumerate(group):
        ref = bnb_3d.fast_correlative_match_3d(*_pair_args(cb, r), plain=True)
        if not torch.equal(rows_k[b], ref):
            _fail(f"K15: pair {b} of the global run's group differs from the twin: "
                  f"{rows_k[b]} vs {ref} (tolerance: exact)")
    searches, clouds = bnb_3d.local_searches(*gargs, low_probabilities=lows)
    d = bnb_3d.descent_inputs(searches, *clouds)
    launch = lambda: bnb_3d.descent_launch(d, params, min_score)  # noqa: E731
    kernels = _graph_kernels(launch, "K15 group")
    with_glue = _graph_kernels(call, "K15 group with its glue")
    if kernels != 1:
        _fail(f"K15: {kernels} kernels a group of {n} pairs (the source states 1)")

    # The localization's widening rounds, each as a wave of one request.
    loc = ctx["localization"]
    m = loc["matcher"]
    lhp, lhm, llp, llm, lhist = (x[None] for x in loc["clouds"])
    global_min = pg._options.constraint_builder.global_localization_min_score
    beam, top_k, rounds = params.beam_width, 64, []
    while True:
        wargs = ([m.stack], [m.high_grid], [m.low_grid], lhp, lhm, llp, llm, lhist,
                 [m.histogram], loc["node_q"][None], loc["identity"][None],
                 dataclasses.replace(params, beam_width=beam), global_min)
        wave = bnb_3d.match_full_submap_3d_batch(*wargs, top_k_yaws=top_k,
                                                 low_probabilities=[m.low_probability])
        wref = bnb_3d.match_full_submap_3d_batch(*wargs, top_k_yaws=top_k,
                                                 low_probabilities=[m.low_probability],
                                                 plain=True)
        if not torch.equal(wave, wref):
            _fail(f"K15: the localization's wave at beam {beam}, {top_k} yaws differs from the "
                  f"twin: {wave} vs {wref}")
        rounds.append((beam, top_k))
        if float(wave[0, 11]) > 0.5 or (beam >= 32768 and top_k >= 512):
            break
        beam, top_k = min(2 * beam, 32768), min(2 * top_k, 512)
    wave_ms = _event_ms(lambda: bnb_3d.match_full_submap_3d_batch(
        *wargs, top_k_yaws=top_k, low_probabilities=[m.low_probability]), reps=5)

    nbytes, ops = _descent_work_3d(torch, searches, params, min_score)
    bound = _bound(nbytes, ops)
    # The mean of the kernel's profiler records: a summed window loses records.
    kernel_ms, records = _kernel_ms(launch, "descent_kernel", reps=10)
    group_ms = _cuda_ms(call, reps=10)
    group_event_ms = _event_ms(call, reps=10)
    plain_ms = _cuda_ms(lambda: [bnb_3d._match_tail(x, params, min_score) for x in searches],
                        reps=2, warmup=1)
    one_ms = _cuda_ms(lambda: bnb_3d.fast_correlative_match_3d(*args), reps=10)
    one_event_ms = _event_ms(lambda: bnb_3d.fast_correlative_match_3d(*args), reps=10)
    print(f"K15 bnb3d_descent: the global run's first {n} local pairs in one group, every row "
          f"equal to the twin's (exact), {int(rows_k[:, 0].sum())} found; the localization's "
          f"waves at (beam, yaws) {rounds} equal (exact), the last {wave_ms:.4f} ms by events; "
          f"{kernels} kernel a group ({with_glue} with the glue); the kernel {kernel_ms:.4f} ms "
          f"a group ({kernel_ms / n:.4f} a pair; the mean of {records} profiler records of 10 "
          f"launches), the whole call {group_ms:.4f} device ms "
          f"({group_ms / n:.4f} a pair), {group_event_ms:.4f} ms by CUDA events; a lone pair's "
          f"call {one_ms:.4f} device ms, {one_event_ms:.4f} by events; the twin "
          f"{plain_ms:.2f} ms; bound {bound[0]:.3g} ms ({bound[1]}) a group")
    extra["bnb3d_match_ms"] = one_ms
    extra["bnb3d"] = dict(
        pairs=n, kernels_per_group=kernels, kernels_per_group_with_glue=with_glue,
        kernel_ms_per_group=kernel_ms, kernel_records=records, group_device_ms=group_ms,
        group_event_ms=group_event_ms,
        one_pair_device_ms=one_ms, one_pair_event_ms=one_event_ms, wave_rounds=rounds,
        wave_event_ms=wave_ms, bound_ms_per_group=bound[0], plain_ms_per_group=plain_ms)
    # Per pair: the kernel's device time, the twin's and the bound over the group's inputs.
    return {"bnb3d_descent": dict(
        replaces="cartographer_tpu/ops/bnb_3d.py:182", max_abs_err=0.0, ms=kernel_ms / n,
        plain_ms=plain_ms / n, bound=(bound[0] / n, bound[1]), library_ms=None)}


def _backend_kernel_phase_3d(torch, dev, ctx):
    """K13-K16 against their twins on the card, on the 3D global run's node,
    finished submap and first local pair, and on a synthetic SE(3) pose
    graph with IMU terms at the solver's capacity."""
    import torch.nn.functional as F

    from cartographer_tpu_torch.ops import bnb_3d, rot_histogram
    from cartographer_tpu_torch.parallel import schur_spa, schur_spa_3d
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
    def shift_max(a, d):  # max(a[i], a[i + d]) along each axis, zero beyond: one 2^3 pool
        return F.max_pool3d(F.pad(a, (0, d) * 3), 2, stride=1, dilation=d)

    def pooled():
        """K14's function through max_pool3d: the quantized level (the twin's
        elementwise operations), then a 2^3 pool of the zero-padded level per
        full level, and three (a shift, a halving, a shift) per coarse
        level."""
        x = bnb_3d.quantize_plain(grid.log_odds, grid.known).float()[None, None]
        full, coarse = [x], []
        for h in range(1, frd):
            x = shift_max(x, 1 << (h - 1))
            full.append(x)
        for _ in range(depth - frd):
            x = shift_max(F.max_pool3d(shift_max(x, 1 << (frd - 1)), 2, 2), 1)
            coarse.append(x)
        return full, coarse

    full, coarse = pooled()
    pool_differ = sum(int((f[0, 0] != got.full[h].float()).sum()) for h, f in enumerate(full))
    for j, c in enumerate(coarse):
        n = c.shape[-1]
        pool_differ += int((c[0, 0] != got.coarse[j, :n, :n, :n].float()).sum())
    pools = (frd - 1) + 3 * (depth - frd)
    print(f"K14's function through {pools} max_pool3d calls: {pool_differ} differing cells")
    if pool_differ:
        _fail("K14's library composition differs from K14")
    del full, coarse
    rows["bnb3d_stack"] = dict(
        replaces="cartographer_tpu/ops/bnb_3d.py:113", max_abs_err=float(differ),
        ms=_cuda_ms(lambda: bnb_3d.build_precomputation_stack_3d(grid, depth, frd), reps=10),
        plain_ms=_cuda_ms(lambda: bnb_3d.stack_plain(grid, depth, frd), reps=3, warmup=1),
        bound=_bound(S ** 3 * 5 + frd * S ** 3 + (depth - frd) * (S // 2) ** 3,
                     S ** 3 * (12 + 8 * (frd - 1)) + (depth - frd) * S ** 3 * 2),
        # The whole stack through max_pool3d (from the log-odds and known).
        library_ms=_cuda_ms(pooled, reps=10), library_pools=pools)
    del got, ref

    # K15: one local pair of the run, its first 64 local requests as one
    # group and its localization's wave, each row against the twin.
    rows.update(_descent_phase_3d(torch, ctx, extra))

    # K16: a synthetic pose graph with IMU terms at capacity.
    S, N, C = K16_CAPACITY
    arrays, truth_t, p, hs = _k16_capacity_problem(torch, dev)
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
    solve = lambda n: schur_spa_3d._solve_kernel(p, n, hs, 1e-6)  # noqa: E731
    steps, counted = _launch_breakdown(lambda: solve(1))
    groups = {}
    for name, ms in steps:
        count, total = groups.get(name, (0, 0.0))
        groups[name] = (count + 1, total + ms)
    print(f"K16 one iteration at N={N} S={S} C={C}, per launch (profiler, median of {counted} "
          f"calls; the call's first launch and copies included): " + ", ".join(
              f"{name} {total:.4f} ms" + (f" ({count} launches)" if count > 1 else "")
              for name, (count, total) in groups.items()))
    one, two = _graph_kernels(lambda: solve(1), "K16"), _graph_kernels(lambda: solve(2), "K16")
    ms2, ms50 = _event_ms(lambda: solve(2), reps=5, warmup=1), _event_ms(lambda: solve(50),
                                                                         reps=3, warmup=1)
    n6 = 6 * S
    spd = torch.randn(n6, n6, device=dev)
    spd = spd @ spd.T + n6 * torch.eye(n6, device=dev)
    rhs = torch.randn(n6, device=dev)
    chol_err = float((schur_spa.reduced_cholesky_solve(spd, rhs)
                      - torch.linalg.solve(spd.double(), rhs.double()).float()).abs().max())
    chol_ms = _event_ms(lambda: schur_spa.reduced_cholesky_solve(spd, rhs), reps=50)
    chol_lib_ms = _event_ms(lambda: torch.linalg.cholesky_ex(spd), reps=50)
    print(f"K16: {two - one} kernels per iteration ({one} in a one-iteration call; captured "
          f"graphs); by CUDA events 2 iterations {ms2:.3f} ms, 50 iterations {ms50:.3f} ms; the "
          f"reduced {n6}^2 Cholesky solve alone {chol_ms:.4f} ms (within {chol_err:.3g} of a "
          f"float64 solve) against torch.linalg.cholesky_ex {chol_lib_ms:.4f} ms")
    extra["schur_3d_breakdown_ms"] = [[name, ms] for name, ms in steps]
    extra["schur_3d_kernels_per_iteration"] = two - one
    extra["schur_3d_event_ms"] = {"2": ms2, "50": ms50}
    extra["schur_3d_reduced_cholesky_ms"] = {"kernel": chol_ms, "cholesky_ex": chol_lib_ms,
                                             "max_abs_err": chol_err}
    K, E, N2 = 6 * S + 1, C + 2 * (N - 1) + 3 * (N - 2), N // 2
    per_iteration_ops = (C * 2 * 6000 + (N - 1) * 6000 * 4 + (N - 1) * 3 * 5000
                         + (N - 2) * 4 * 5000 + N2 * 12 ** 3 * 6 + 2 * N * 12 * K * 24
                         + E * K * 72 + (6 * S) ** 3 // 3 + N * 6 * 6 * S * 2)
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


def _sizes_row(row, n, **extra):
    """One "at n" entry (points, or bins for K13) of a kernel's timing
    around its former one-block limit."""
    ms, by = row["bound"]
    return {"at": n, **extra, "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": ms,
            "bound_by": by, "max_abs_err": row["max_abs_err"]}


def _one_block_limits_phase(torch, dev):
    """K5, K7, K12, K13 and K17 at their former one-block limits and above
    (the halving fold, K12's device-memory scratch above some 3,400 points),
    each equal to its twin bit for bit; and the 2D and 3D frontends built
    with capacities above those limits (`RAISED_2D`, `RAISED_3D`) and driven
    over RAISED_SCANS scans, which a builder refused before."""
    from cartographer_tpu_torch.core.config import apply_overrides
    from cartographer_tpu_torch.mapping import local_trajectory_builder_2d as ltb2
    from cartographer_tpu_torch.mapping import local_trajectory_builder_3d as ltb3
    from cartographer_tpu_torch.ops import bnb_2d, correlative_2d, cuda, rot_histogram
    from cartographer_tpu_torch.ops import scan_matcher_3d
    from cartographer_tpu_torch.sensor.data import TimedPointCloudData
    from cartographer_tpu_torch.simulation import relative_to_first, simulate_scans
    from cartographer_tpu_torch.transform import nquat

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    out = {}

    # The 2D frontend: 16,384-beam scans, the matcher cloud 8,192 points.
    label = "2D frontend at raised capacities"
    opts = apply_overrides(_frontend_options(), RAISED_2D)
    scans, truth = simulate_scans(RAISED_SCANS, beams=RAISED_BEAMS_2D, seed=0)
    gt = relative_to_first(truth)
    builder = ltb2.LocalTrajectoryBuilder2D(opts, ["laser"], device=dev)
    calls, est, lc_points = [], [], []
    restore = _recording(ltb2, "real_time_correlative_match", calls, transform=_robot0)
    cuda.reset_launch_counts()
    try:
        for ts, pts, rel in scans:
            r = builder.add_range_data("laser", TimedPointCloudData(
                time=int(round(ts * 1e6)), origin=np.zeros(3, np.float32), ranges=pts,
                times=rel))
            est.append([*r.local_pose_translation[:2], nquat.get_yaw(r.local_pose_rotation)])
            if r.insertion_result is not None:
                lc_points.append(int(r.insertion_result.filtered_gravity_aligned_point_cloud
                                     .mask.sum()))
    finally:
        restore()
    launches = cuda.launch_counts()
    _check_launched(launches, FRONTEND_KERNELS, label)
    errors = np.linalg.norm(np.asarray(est)[:, :2] - gt[:, :2], axis=1)
    matcher = [int(c[2].sum()) for c in calls]
    print(f"{label}: {len(scans)} scans of {RAISED_BEAMS_2D} beams, K5 on {calls[0][1].shape[0]} "
          f"padded points ({min(matcher)}-{max(matcher)} valid), loop-closure cloud "
          f"{opts.tpu.loop_closure_capacity} ({min(lc_points)}-{max(lc_points)} valid), mean "
          f"error {errors.mean():.4f} m (limit 0.25), launches {launches}")
    if errors.mean() > 0.25 or calls[0][1].shape[0] != opts.tpu.matcher_capacity:
        _fail(f"{label}: lost the ground truth or the matcher cloud has the wrong size")
    out["frontend_2d"] = dict(scans=len(scans), beams=RAISED_BEAMS_2D,
                              k5_padded_points=calls[0][1].shape[0],
                              matcher_valid_points=[min(matcher), max(matcher)],
                              loop_closure_valid_points=[min(lc_points), max(lc_points)],
                              mean_error_m=float(errors.mean()),
                              correlative_2d_launches=launches["correlative_2d"])

    # K5 on the run's last grid and pose, on the last scan's returns: 4,096
    # (the former limit), 8,192 and 16,384 points.
    grid, _, _, x0, cparams = calls[-1]
    raw = scans[-1][1][:, :2]
    rows = {"correlative_2d": [], "bnb_descent": [], "rot_histogram": [], "rot_match": [],
            "correlative_3d": []}
    for n in ABOVE_ONE_BLOCK["correlative_2d"]:
        pts, mask = t(raw[:n]), t(np.isfinite(raw[:n]).all(1) & (np.abs(raw[:n]).max(1) < 29))
        args = (grid, pts, mask, x0, cparams)
        best_k, scores_k = correlative_2d.correlative_match(*args)
        best_p, scores_p = correlative_2d.correlative_match_plain(*args)
        if not (torch.equal(scores_k, scores_p) and torch.equal(best_k, best_p)):
            _fail(f"K5 at {n} points differs from the twin (tolerance: exact)")
        angles = int(torch.isfinite(scores_k[:, 0, 0]).sum())
        w, valid = scores_k.shape[-1], int(mask.sum())
        rows["correlative_2d"].append(_sizes_row(dict(
            ms=_cuda_ms(lambda: correlative_2d.correlative_match(*args)),
            plain_ms=_cuda_ms(lambda: correlative_2d.correlative_match_plain(*args), reps=3,
                              warmup=1),
            bound=_bound(n * 9 + scores_k.numel() * 4 + min(angles * w * w * valid,
                                                            grid.size ** 2) * 5,
                         angles * w * w * valid * 14),
            max_abs_err=0.0), n))
    # K7 on the pyramid of that grid: a pair's descent (a 1 m and 10 degree
    # window, beam 512) of the scan's first n returns at 1,024 (the former
    # limit), 2,048 and 4,096 points.
    pyr = bnb_2d.build_precomputation_pyramid(grid, 7)
    rng = np.random.RandomState(7)
    bparams = bnb_2d.FastCorrelativeMatcherParams2D(1.0, np.radians(10.0), 7, 512, 30.0)
    for n in ABOVE_ONE_BLOCK["bnb_descent"]:
        pts, mask = t(raw[:n]), t(np.isfinite(raw[:n]).all(1) & (np.abs(raw[:n]).max(1) < 29))
        dargs = (pyr, grid, pts, mask, x0, bparams, 0.0)
        got = bnb_2d.fast_correlative_match_2d(*dargs)
        if not torch.equal(got, bnb_2d.match_plain(*dargs)):
            _fail(f"K7 at {n} points differs from the twin (exact)")
        nbytes, ops, _ = _descent_work(torch, [(pyr, grid, pts, mask, x0, 1.0)], bparams, 0.0)
        rows["bnb_descent"].append(_sizes_row(dict(
            ms=_cuda_ms(lambda: bnb_2d.fast_correlative_match_2d(*dargs)),
            plain_ms=_cuda_ms(lambda: bnb_2d.match_plain(*dargs), reps=3, warmup=1),
            bound=_bound(nbytes, ops), max_abs_err=0.0), n, beam=512))
    del builder, calls, pyr

    # The 3D frontend at its full options with the high-resolution cloud at
    # 4,096 points: K12 (its arrays in a device scratch) and K17 above their
    # former one-block limits on the frontend's path.
    label = "3D full frontend at raised capacities"
    opts3 = _full_frontend_options(**RAISED_3D)
    events, gt3 = _events_3d(RAISED_SCANS, intensities=True)
    builder = ltb3.LocalTrajectoryBuilder3D(opts3, ["points"], device=dev)
    kept = []
    restore = _recording(ltb3, "correlative_match_3d", kept)
    cuda.reset_launch_counts()
    try:
        _, offset, yaw_err, _, _, _ = _drive_3d(torch, builder, events, gt3, label)
    finally:
        restore()
    launches = cuda.launch_counts()
    _check_launched(launches, FULL_FRONTEND_KERNELS, label)
    high = [int(c[2].sum()) for c in kept]
    errors = np.linalg.norm(offset, axis=1)
    print(f"{label}: K12 and K17 on {kept[0][1].shape[0]} padded points ({min(high)}-"
          f"{max(high)} valid), mean error {errors.mean():.4f} m (limit 0.25), mean yaw error "
          f"{yaw_err.mean():.5f} rad (reported)")
    if errors.mean() > 0.25 or kept[0][1].shape[0] != RAISED_3D["tpu.filtered_capacity_high"]:
        _fail(f"{label}: lost the ground truth or the high cloud has the wrong size")
    out["frontend_3d"] = dict(scans=len(events), high_padded_points=kept[0][1].shape[0],
                              high_valid_points=[min(high), max(high)],
                              mean_error_m=float(errors.mean()),
                              mean_yaw_error_rad=float(yaw_err.mean()),
                              launches={k: launches[k] for k in ("rot_histogram",
                                                                 "correlative_3d")})

    # K12 on the last scan's returns (the raw 16 x 256 scan, padded to the
    # sizes), K13 on random histograms of 1,024 and 2,048 bins.
    raw3 = events[-1][1].ranges[:, :3]
    for n, bins in ABOVE_ONE_BLOCK["rot_histogram"]:
        reps = -(-n // raw3.shape[0])
        cloud = np.concatenate([raw3 + np.float32(0.013 * k) for k in range(reps)])[:n]
        pts = t(cloud.astype(np.float32))
        mask = t(np.linalg.norm(cloud, axis=1) < 40.0)
        got = rot_histogram.compute_rotational_histogram(pts, mask, bins)
        if not torch.equal(got, rot_histogram.rotational_histogram_plain(pts, mask, bins)):
            _fail(f"K12 at {n} points and {bins} bins differs from the twin (exact)")
        nv = int(mask.sum())
        rows["rot_histogram"].append(_sizes_row(dict(
            ms=_cuda_ms(lambda: rot_histogram.compute_rotational_histogram(pts, mask, bins)),
            plain_ms=_cuda_ms(lambda: rot_histogram.rotational_histogram_plain(pts, mask, bins),
                              reps=1, warmup=0),
            bound=_bound(*_k12_work(torch, n, nv, bins)), max_abs_err=0.0), n, bins=bins))
    for bins in ABOVE_ONE_BLOCK["rot_match"]:
        scan_h, sub_h = (t(rng.rand(bins).astype(np.float32)) for _ in range(2))
        angles = t(rng.uniform(-4.0, 4.0, 1259).astype(np.float32))
        got = rot_histogram.match_histograms(sub_h, scan_h, angles)
        if not torch.equal(got, rot_histogram.match_histograms_plain(sub_h, scan_h, angles)):
            _fail(f"K13 at {bins} bins differs from the twin (exact)")
        rows["rot_match"].append(_sizes_row(dict(
            ms=_cuda_ms(lambda: rot_histogram.match_histograms(sub_h, scan_h, angles)),
            plain_ms=_cuda_ms(lambda: rot_histogram.match_histograms_plain(sub_h, scan_h,
                                                                           angles)),
            bound=_bound(2 * bins * 4 + 2 * 1259 * 4, 1259 * bins * 14),
            max_abs_err=0.0), bins, yaws=1259))
    # K17 on the run's last search: its 4,096 points, the first 2,048 (the
    # former limit) and 8,192 (the cloud and a copy 2 cm off).
    cgrid, cpoints, cmask, cx0, cparams3 = kept[-1]
    for n in ABOVE_ONE_BLOCK["correlative_3d"]:
        if n <= cpoints.shape[0]:
            pts, mask = cpoints[:n].contiguous(), cmask[:n].contiguous()
        else:
            pts = torch.cat([cpoints, cpoints + 0.02]).contiguous()
            mask = torch.cat([cmask, cmask]).contiguous()
        cargs = (cgrid, pts, mask, cx0, cparams3)
        score, x, best = scan_matcher_3d._correlative_kernel(*cargs)
        ref_score, ref_x, ref_index = scan_matcher_3d.correlative_match_3d_plain(*cargs)
        q_err = float((x[3:7] - ref_x[3:7]).abs().max())
        if (~int(best.cpu()) & 0xFFFFFFFF != ref_index or float(score) != float(ref_score)
                or not torch.equal(x[0:3], ref_x[0:3]) or q_err > 1e-6):
            _fail(f"K17 at {n} points differs from the twin")
        cells, rotations = _correlative_cells(torch, *cargs)
        valid = int(mask.sum())
        nl, _ = scan_matcher_3d.search_sizes(cgrid.resolution, cparams3)
        translations = (2 * nl + 1) ** 3
        rows["correlative_3d"].append(_sizes_row(dict(
            ms=_cuda_ms(lambda: scan_matcher_3d._correlative_kernel(*cargs)),
            plain_ms=_cuda_ms(lambda: scan_matcher_3d.correlative_match_3d_plain(*cargs),
                              reps=2, warmup=1),
            bound=_bound(n * 13 + 28 + cells * 5, valid * 7 + rotations * valid * 36
                         + rotations * translations * valid * 12),
            max_abs_err=q_err), n, rotations=rotations))
    for name, entries in rows.items():
        print(f"{name} above its former one-block limit (equal to the twin): "
              + json.dumps(entries))
    out["kernels"] = rows
    return out


def _write_binary_pcd(path, points):
    points = np.ascontiguousarray(points, np.float32)
    n = len(points)
    header = ("VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
              f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA binary\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii") + points.tobytes())


def _rotation_angle_between(q_a, q_b):
    import torch

    from cartographer_tpu_torch.transform import quaternion as quat

    dq = quat.multiply(quat.conjugate(torch.as_tensor(q_a, dtype=torch.float64)),
                       torch.as_tensor(q_b, dtype=torch.float64))
    return float(quat.to_axis_angle(dq).norm())


def _quaternion_of(result):
    import torch

    from cartographer_tpu_torch.transform import quaternion as quat

    return quat.from_axis_angle(torch.tensor(result["rotation_axis_angle"],
                                             dtype=torch.float64))


def _pose_error(result, translation, yaw):
    """(translation [m], rotation angle [rad]) from a CLI result to the
    planar true pose (as tests/scan_match_witness_3d.py measures it)."""
    q_true = [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)]
    return (float(np.linalg.norm(np.asarray(result["translation"]) - translation)),
            _rotation_angle_between(q_true, _quaternion_of(result)))


def _pose_difference(a, b):
    """(translation [m], rotation angle [rad]) between two CLI results."""
    return (float(np.linalg.norm(np.subtract(a["translation"], b["translation"]))),
            _rotation_angle_between(_quaternion_of(a), _quaternion_of(b)))


def _write_scan_pair(tmp):
    """The testbed's two full-width scans of the hall as binary PCD files in
    `tmp`: -> (paths, returns, true translation, true yaw)."""
    import os

    from cartographer_tpu_torch.simulation import simulate_scan_pair_3d

    source, target, t_true, yaw_true = simulate_scan_pair_3d(azimuths=SCAN_MATCH_AZIMUTHS)
    paths = [os.path.join(tmp, name) for name in ("source.pcd", "target.pcd")]
    _write_binary_pcd(paths[0], source)
    _write_binary_pcd(paths[1], target)
    return paths, len(source), t_true, yaw_true


def _main_subprocess(paths, mode):
    """`python -m cartographer_tpu_torch.io.scan_match_main` on the pair in a
    fresh process: -> its printed result with the wall seconds."""
    from pathlib import Path

    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", "cartographer_tpu_torch.io.scan_match_main",
                           "--source", paths[0], "--target", paths[1], "--mode", mode],
                          cwd=str(Path(__file__).resolve().parent), capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        _fail(f"scan_match_main --mode {mode} failed: {proc.stderr[-2000:]}")
    printed = json.loads(proc.stdout.strip().splitlines()[-1])
    return dict(printed, wall_seconds=time.monotonic() - t0)


def _padded_pair(torch, dev, paths):
    """The run's own inputs, as `run` builds them: -> (src, sm, tgt, tm, the
    target's returns as numpy)."""
    from cartographer_tpu_torch.io.pcd import read_pcd

    src_np, tgt_np = read_pcd(paths[0]), read_pcd(paths[1])
    cap = 1 << int(np.ceil(np.log2(max(len(src_np), len(tgt_np), 16))))

    def pad(p):
        buf = np.zeros((cap, 3), np.float32)
        buf[:len(p)] = p
        return (torch.from_numpy(buf).to(dev),
                torch.from_numpy(np.arange(cap) < len(p)).to(dev))

    return (*pad(src_np), *pad(tgt_np), tgt_np)


def _scan_match_phase(torch, dev):
    """The scan-match testbed (`io/scan_match_main.py`) on two full-width
    scans of the simulated hall written as binary PCD files: one call of
    `main` in a subprocess, then `run` in this process for `icp` and
    `ceres`, each against the CPU witness's JAX result and the simulator's
    truth; K23, K24 and its stats form, K25 and the whole card icp_match
    against their twins on the run's own inputs."""
    import tempfile

    from cartographer_tpu_torch.io import scan_match_main
    from cartographer_tpu_torch.ops import cuda, icp
    from cartographer_tpu_torch.ops.grid_3d import (
        Grid3D,
        _flat_index,
        insert_range_data_3d,
        insert_range_data_3d_plain,
    )
    from cartographer_tpu_torch.transform import quaternion as quat

    args = dict(init=[0, 0, 0, 0, 0, 0], max_iterations=30, resolution=0.3,
                max_correspondence_distance=1.0)
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths, returns, t_true, yaw_true = _write_scan_pair(tmp)
        out = {"returns": returns, "true_translation": t_true.tolist(), "true_yaw": yaw_true,
               "modes": {}}
        printed = _main_subprocess(paths, "icp")
        out["main_subprocess"] = printed
        for mode in ("icp", "ceres"):
            cuda.reset_launch_counts()
            t0 = time.monotonic()
            result = scan_match_main.run(*paths, mode=mode, **args, device=dev)
            wall = time.monotonic() - t0
            launches = {k: v for k, v in cuda.launch_counts().items() if v}
            _check_launched(launches, SCAN_MATCH_KERNELS[mode], f"scan match {mode}")
            witness = SCAN_MATCH_WITNESS[mode]
            err = _pose_error(result, t_true, yaw_true)
            dt, dr = _pose_difference(result, witness)
            print(f"scan match {mode}: {json.dumps(result)}; {wall:.2f} s wall, launches "
                  f"{launches}; error against truth {err[0]:.4f} m, {err[1]:.5f} rad (limit the "
                  f"JAX witness's {witness['error_against_truth'][0]:.4f} m + 0.01); against the "
                  f"JAX witness {dt:.3g} m, {dr:.3g} rad (limits 1e-3 each)")
            if dt > 1e-3 or dr > 1e-3 or err[0] > witness["error_against_truth"][0] + 0.01:
                _fail(f"scan match {mode}: departs from the JAX witness")
            out["modes"][mode] = dict(result, wall_seconds=wall, launches=launches,
                                      error_against_truth=list(err),
                                      against_jax_witness=[dt, dr])
        if printed["translation"] != out["modes"]["icp"]["translation"]:
            _fail("scan match: main's printed result differs from run's")
        src, sm, tgt, tm, tgt_np = _padded_pair(torch, dev, paths)
    n = src.shape[0]
    x0 = torch.tensor([0, 0, 0, 1, 0, 0, 0], dtype=torch.float32, device=dev)
    max_dist = args["max_correspondence_distance"]

    # K23: the first round's correspondences.
    got = icp.nearest(src, sm, tgt, tm, x0, max_dist)
    ref = icp.nearest_plain(src, sm, tgt, tm, x0, max_dist)
    differ = sum(int((a != b).sum()) for a, b in zip(got, ref))
    print(f"K23 icp_nearest at {n} x {n} points: {differ} entries differ from the twin "
          f"(tolerance: exact), {int(got[2].sum())} valid")
    if differ:
        _fail("K23 differs from the plain twin")
    nn, world, valid = got
    b2 = (tgt * tgt).sum(1)[None, :].contiguous()
    rows["icp_nearest"] = dict(
        replaces="cartographer_tpu/ops/icp.py:44", max_abs_err=0.0,
        ms=_cuda_ms(lambda: icp.nearest(src, sm, tgt, tm, x0, max_dist), reps=10),
        plain_ms=_cuda_ms(lambda: icp.nearest_plain(src, sm, tgt, tm, x0, max_dist), reps=3,
                          warmup=1),
        # 28 bytes in and 17 out per source point, 13 per target; 10
        # operations per pair (the cross term, the form, the compare).
        bound=_bound(n * (13 + 28 + 17), n * n * 10),
        # |b|^2 - 2 a.b by one matrix product, then the row minima.
        library_ms=_cuda_ms(lambda: torch.addmm(b2, src, tgt.T, alpha=-2.0).min(dim=1),
                            reps=5))

    # K24: one round from those correspondences; its stats form.
    pose_k, R_k, t_k = icp.kabsch(world, tgt, nn, valid, x0)
    pose_p, R_p, t_p = icp.kabsch_plain(world, tgt, nn, valid, x0)
    err24 = max(float((R_k - R_p).abs().max()), float((t_k - t_p).abs().max()),
                float((pose_k - pose_p).abs().max()))
    print(f"K24 icp_kabsch: one round's R, t and pose within {err24:.3g} of the twin "
          f"(tolerance 1e-5)")
    if err24 > 1e-5:
        _fail("K24 differs from the plain twin")
    matched = tgt[nn.long()]
    w = valid.to(torch.float32)
    H = ((world - (world * w[:, None]).sum(0) / w.sum())[:, :, None] * w[:, None, None]
         * (matched - (matched * w[:, None]).sum(0) / w.sum())[:, None, :]).sum(0)
    nv = int(valid.sum())
    rows["icp_kabsch"] = dict(
        replaces="cartographer_tpu/ops/icp.py:53", max_abs_err=err24,
        ms=_cuda_ms(lambda: icp.kabsch(world, tgt, nn, valid, x0)),
        plain_ms=_cuda_ms(lambda: icp.kabsch_plain(world, tgt, nn, valid, x0)),
        # world, nn, valid and the matched targets once; the 16 sums.
        bound=_bound(n * (12 + 4 + 1) + nv * 12 + 28 * 2, n * 7 * 2 + n * 9 * 4),
        # The 3x3 SVD alone: a part of the function.
        library_ms=_cuda_ms(lambda: torch.linalg.svd(H)))
    def stats_kernel():
        return torch.stack(icp.stats(world, sm, tgt, nn, valid))

    err_s = float((stats_kernel() - torch.stack(icp.stats_plain(world, sm, tgt, nn, valid))
                   ).abs().max())
    print(f"K24 icp_stats: fitness and RMSE within {err_s:.3g} of the twin (tolerance: exact)")
    if err_s:
        _fail("K24's stats form differs from the plain twin")
    rows["icp_stats"] = dict(
        replaces="cartographer_tpu/ops/icp.py:82", max_abs_err=err_s, ms=_cuda_ms(stats_kernel),
        plain_ms=_cuda_ms(lambda: icp.stats_plain(world, sm, tgt, nn, valid)),
        bound=_bound(n * (12 + 1 + 4 + 1) + nv * 12 + 8, n * 12), library_ms=None)

    # The whole card icp_match against the twin's on the card.
    pose_c, fit_c, rmse_c = icp.icp_match_vector(src, sm, tgt, tm, x0)
    pose_t, fit_t, rmse_t = icp.icp_match_plain(src, sm, tgt, tm, x0, icp.IcpParams())
    dq = quat.multiply(quat.conjugate(pose_t[3:7]), pose_c[3:7])
    icp_err = (float((pose_c[0:3] - pose_t[0:3]).abs().max()),
               float(quat.to_axis_angle(dq).norm()))
    print(f"icp_match on the card against its twin on the card: {icp_err[0]:.3g} m, "
          f"{icp_err[1]:.3g} rad (tolerance 1e-4 each); fitness {float(fit_c):.6f} / "
          f"{float(fit_t):.6f}, rmse {float(rmse_c):.6f} / {float(rmse_t):.6f}")
    if icp_err[0] > 1e-4 or icp_err[1] > 1e-4:
        _fail("the card's icp_match departs from its twin")
    out["icp_match_against_twin"] = list(icp_err)
    out["icp_match_device_ms"] = _cuda_ms(lambda: icp.icp_match_vector(src, sm, tgt, tm, x0),
                                          reps=3, warmup=1)

    # K25: the first insert into each grid, as `run` makes them.
    center = tgt_np.mean(0)
    origin = torch.from_numpy(np.asarray(center, np.float32)).to(dev)
    touched, inserts = [], []
    for size, res in ((128, args["resolution"]), (64, args["resolution"] * 3)):
        grid = Grid3D.create(size, res, center, dev)
        a = insert_range_data_3d(grid, origin, tgt, tm)
        b = insert_range_data_3d_plain(grid, origin, tgt, tm)
        differ = int((a.log_odds != b.log_odds).sum() + (a.known != b.known).sum())
        print(f"K25 dense_insert_3d into {size}^3 at {res:.2f} m: {differ} cells differ from the "
              f"twin (tolerance: exact), {int(a.known.sum())} known")
        if differ:
            _fail(f"K25 into {size}^3 differs from the plain twin")
        hit = grid.world_to_cell(tgt).long()
        o = grid.world_to_cell(origin).long()
        delta = hit - o
        ns = delta.abs().amax(-1)
        ks = torch.arange(1, 3, device=dev)
        pos = (ns[:, None] - ks).clamp(min=0)
        miss = o + torch.div(delta[:, None] * pos[..., None], ns.clamp(min=1)[:, None, None],
                             rounding_mode="floor")
        lin = torch.cat([_flat_index(hit, tm, size),
                         _flat_index(miss, (tm & (ns > 0))[:, None].expand(-1, 2),
                                     size).reshape(-1)])
        inserts.append((grid, lin))
        touched.append(int(torch.unique(lin[lin < size ** 3]).numel()))
    marks = [torch.zeros(g.size ** 3 + 1, dtype=torch.bool, device=dev) for g, _ in inserts]
    ones = torch.ones((), dtype=torch.bool, device=dev)
    rows["dense_insert_3d"] = dict(
        replaces="cartographer_tpu/ops/grid_3d.py:95", max_abs_err=0.0,
        ms=_cuda_ms(lambda: [insert_range_data_3d(g, origin, tgt, tm) for g, _ in inserts]),
        plain_ms=_cuda_ms(lambda: [insert_range_data_3d_plain(g, origin, tgt, tm)
                                   for g, _ in inserts], reps=5),
        # Each grid read and written whole (the function returns new ones:
        # 5 bytes a cell each way), the returns and the origin once.
        bound=_bound(sum(2 * 5 * g.size ** 3 for g, _ in inserts) + 2 * (n * 13 + 12),
                     2 * n * 3 * 20),
        # index_put_ sets the marks of both grids; it applies nothing.
        library_ms=_cuda_ms(lambda: [mk.index_put_((lin,), ones)
                                     for mk, (_, lin) in zip(marks, inserts)]))
    out["dense_insert_touched_cells"] = touched

    # K11 on the `ceres` mode's grids (four inserts each) and clouds, from
    # the identity, against its twin on the card.
    from cartographer_tpu_torch.ops import scan_matcher_3d

    grids = []
    for grid, _ in inserts:
        for _ in range(4):
            grid = insert_range_data_3d(grid, origin, tgt, tm)
        grids.append(grid)
    params = scan_matcher_3d.GaussNewtonMatcherParams3D(
        num_iterations=args["max_iterations"], translation_weight=0.1, rotation_weight=1.0)
    margs = (*grids, src, sm, src, sm, x0, x0[0:3].clone(), params)
    xk, ck, itk = scan_matcher_3d.lm_match_3d(*margs)
    xp, cp, itp = scan_matcher_3d._match_plain(*margs)
    dq = quat.multiply(quat.conjugate(xp[3:7]), xk[3:7])
    k11_err = (float((xk[0:3] - xp[0:3]).abs().max()), float(quat.to_axis_angle(dq).norm()))
    print(f"K11 scan_matcher_3d on the ceres mode's grids, 2 x {n} points: {int(itk)} "
          f"iterations (the twin {int(itp)}), pose within {k11_err[0]:.3g} m, {k11_err[1]:.3g} "
          f"rad of its twin on the card (tolerance 1e-4 each)")
    if max(k11_err) > 1e-4:
        _fail("K11 on the ceres mode's inputs differs from its twin")
    out["scan_matcher_3d_at_ceres"] = dict(
        iterations=int(itk), twin_iterations=int(itp), against_twin=list(k11_err),
        ms=_cuda_ms(lambda: scan_matcher_3d.lm_match_3d(*margs), reps=5, warmup=1),
        plain_ms=_cuda_ms(lambda: scan_matcher_3d._match_plain(*margs), reps=1, warmup=0))
    out["kernels"] = {k: {"ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                          "library_ms": r["library_ms"]} for k, r in rows.items()}
    return rows, out


def _gicp_ndt_phase(torch, dev):
    """The testbed's `gicp` and `ndt` modes on phase 19's two scans: one call
    of `main --mode gicp` in a subprocess, then `run` for `gicp`, `ndt` at 1 m
    and `ndt` at the CLI's 0.3 m, each against the CPU witness's JAX result
    and the simulator's truth with its exact launch counts; K26-K29 against
    their twins on the run's own inputs, timed beside their bounds."""
    import tempfile

    from cartographer_tpu_torch.io import scan_match_main
    from cartographer_tpu_torch.ops import cuda, icp
    from cartographer_tpu_torch.transform import quaternion as quat

    args = dict(init=[0, 0, 0, 0, 0, 0], max_iterations=30, max_correspondence_distance=1.0)
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths, returns, t_true, yaw_true = _write_scan_pair(tmp)
        out = {"returns": returns, "runs": {}, "launches": {}}
        printed = _main_subprocess(paths, "gicp")
        out["main_subprocess"] = printed
        for mode, resolution, key, expected in GICP_NDT_RUNS:
            cuda.reset_launch_counts()
            t0 = time.monotonic()
            result = scan_match_main.run(*paths, mode=mode, resolution=resolution, **args,
                                         device=dev)
            wall = time.monotonic() - t0
            launches = {k: v for k, v in cuda.launch_counts().items() if v}
            if launches != expected:
                _fail(f"scan match {key}: launches {launches}, expected {expected}")
            witness = SCAN_MATCH_WITNESS[key]
            err = _pose_error(result, t_true, yaw_true)
            dt, dr = _pose_difference(result, witness)
            limit = witness["error_against_truth"][0] + 0.01
            print(f"scan match {key}: {json.dumps(result)}; {wall:.3f} s wall, launches "
                  f"{launches}; error against truth {err[0]:.4f} m, {err[1]:.5f} rad (limit "
                  f"{limit:.4f} m: the JAX witness's + 0.01); against the JAX witness {dt:.3g} m, "
                  f"{dr:.3g} rad (limits 1e-3 each)")
            if dt > 1e-3 or dr > 1e-3 or err[0] > limit:
                _fail(f"scan match {key}: departs from the JAX witness")
            out["runs"][key] = dict(result, wall_seconds=wall, launches=launches,
                                    error_against_truth=list(err), against_jax_witness=[dt, dr])
            if key != "ndt_0.3":  # the kernel line counts the 1 m run's launches
                out["launches"].update(launches)
        if printed["translation"] != out["runs"]["gicp"]["translation"]:
            _fail("scan match: main's printed gicp result differs from run's")
        src, sm, tgt, tm, _ = _padded_pair(torch, dev, paths)
    n = src.shape[0]
    x0 = torch.tensor([0, 0, 0, 1, 0, 0, 0], dtype=torch.float32, device=dev)

    def pose_gap(a, b):
        dq = quat.multiply(quat.conjugate(b[3:7]), a[3:7])
        return float((a[0:3] - b[0:3]).abs().max()), float(quat.to_axis_angle(dq).norm())

    # K26: the target's normals and neighbour lists.
    normals, idx = icp.normals_with_neighbours(tgt, tm)
    normals_p, idx_p = icp.normals_plain(tgt, tm)
    differ = int((idx != idx_p).sum())
    err26 = float(torch.minimum((normals - normals_p).abs().amax(1),
                                (normals + normals_p).abs().amax(1)).max())
    print(f"K26 icp_normals at {n} x {n} points: {differ} neighbour entries differ from the "
          f"twin (tolerance: exact), normals within {err26:.3g} up to sign (tolerance 1e-5)")
    if differ or err26 > 1e-5:
        _fail("K26 differs from the plain twin")
    b2 = (tgt * tgt).sum(1)[None, :].contiguous()

    def library_normals():
        d2 = torch.addmm(b2, tgt, tgt.T, alpha=-2.0)
        d2.masked_fill_(~tm[None, :], float("inf"))
        nb = tgt[torch.topk(d2, 10, dim=1, largest=False).indices]
        e = nb - nb.mean(1, keepdim=True)
        cov = torch.einsum("nki,nkj->nij", e, e) / 10
        # cuSOLVER's batched eigh refuses 32,768 matrices at once.
        return [torch.linalg.eigh(c).eigenvectors[:, :, 0] for c in cov.split(4096)]

    rows["icp_normals"] = dict(
        replaces="cartographer_tpu/ops/icp.py:118", max_abs_err=err26,
        ms=_cuda_ms(lambda: icp.normals_with_neighbours(tgt, tm), reps=10),
        plain_ms=_cuda_ms(lambda: icp.normals_plain(tgt, tm), reps=2, warmup=1),
        # 13 bytes in per point, 12 + 40 out; 10 operations per pair (the
        # cross term, the form, the list's compare).
        bound=_bound(n * (13 + 12 + 40), n * n * 10),
        # |b|^2 - 2 a.b by one matrix product, the row top-10, the
        # covariances and batched eighs of 4,096.
        library_ms=_cuda_ms(library_normals, reps=3, warmup=1))

    # K27: the first round's LM on its correspondences, from the identity.
    nn, world, valid = icp.nearest(src, sm, tgt, tm, x0, args["max_correspondence_distance"])
    k27 = icp.gicp_lm(src, tgt, normals, nn, valid, x0, 10)
    k27_p = icp.gicp_lm_plain(src, tgt, normals, nn, valid, x0, 10)
    gap27 = pose_gap(k27[0], k27_p[0])
    cost27 = abs(float(k27[1]) - float(k27_p[1])) / max(abs(float(k27_p[1])), 1e-30)
    print(f"K27 gicp_lm, the first round on {n} rows: {int(k27[2])} iterations, pose within "
          f"{gap27[0]:.3g} m, {gap27[1]:.3g} rad and cost within {cost27:.3g} relative of the "
          f"twin (tolerance 1e-4 each)")
    if max(*gap27, cost27) > 1e-4:
        _fail("K27 differs from the plain twin")
    nv, its27 = int(valid.sum()), int(k27[2])
    rows["gicp_lm"] = dict(
        replaces="cartographer_tpu/ops/icp.py:150", max_abs_err=max(gap27),
        ms=_cuda_ms(lambda: icp.gicp_lm(src, tgt, normals, nn, valid, x0, 10), reps=10),
        plain_ms=_cuda_ms(lambda: icp.gicp_lm_plain(src, tgt, normals, nn, valid, x0, 10),
                          reps=3, warmup=1),
        # The points, indices and flags once, the matched points and normals
        # of the valid rows once; per valid row 31 operations for the first
        # cost, then per iteration 113 (residual, gradient, 27 sums) + 31.
        bound=_bound(n * (12 + 4 + 1) + nv * 24 + 2 * 28, nv * (31 + 144 * its27)),
        library_ms=None)
    # A whole match by CUDA events: the profiler's total over these
    # multi-launch calls has read below their own kernels' sum.
    out["gicp_match_event_ms"] = _event_ms(lambda: icp.gicp_match_vector(src, sm, tgt, tm, x0),
                                           reps=5, warmup=1)
    out["icp_normals_event_ms"] = _event_ms(lambda: icp.normals_with_neighbours(tgt, tm),
                                            reps=5, warmup=1)

    # K28 and K29 at the 1 m run's parameters.
    params = icp.NdtParams(resolution=1.0, max_iterations=args["max_iterations"])
    center = icp.ndt_center(tgt, tm)
    grid = icp.build_ndt_grid(tgt, tm, params, center)
    grid_p = icp.build_ndt_grid_plain(tgt, tm, params, center)
    means, L, valid_cells, origin = grid
    exact = (torch.equal(valid_cells, grid_p[2]) and torch.equal(means, grid_p[0])
             and torch.equal(origin, grid_p[3]))
    scale = float(grid_p[1][valid_cells].abs().max())
    err28 = float((L - grid_p[1])[valid_cells].abs().max())
    C = params.grid_extent ** 3
    print(f"K28 ndt_grid, {int(tm.sum())} points into {C} cells: {int(valid_cells.sum())} valid; "
          f"valid, means and origin {'equal to' if exact else 'DIFFER from'} the twin's "
          f"(tolerance: exact), L within {err28:.3g} (tolerance 1e-5 x {scale:.3g})")
    if not exact or err28 > 1e-5 * scale:
        _fail("K28 differs from the plain twin")
    library_grid, inb = _ndt_library(torch, tgt, tm, origin, params)
    k28_kernels = _launches_per_call(lambda: icp.build_ndt_grid(tgt, tm, params, center), 2,
                                     "K28")
    out["ndt_grid_kernels_per_call"] = k28_kernels
    out["ndt_grid_event_ms"] = _event_ms(lambda: icp.build_ndt_grid(tgt, tm, params, center),
                                         reps=100)
    out["ndt_grid_library_event_ms"] = _event_ms(library_grid, reps=100)
    print(f"K28: {k28_kernels} kernels per call (a captured graph); by CUDA events "
          f"{out['ndt_grid_event_ms']:.4f} ms against the library composition's "
          f"{out['ndt_grid_library_event_ms']:.4f} ms")
    # Its two kernels one by one, from calls whose profiled window kept both
    # (a window of many short calls has read below a third of this).
    k28_steps, _ = _launch_breakdown(lambda: icp.build_ndt_grid(tgt, tm, params, center))
    rows["ndt_grid"] = dict(
        replaces="cartographer_tpu/ops/icp.py:179", max_abs_err=err28,
        ms=sum(ms for _, ms in k28_steps),
        plain_ms=_cuda_ms(lambda: icp.build_ndt_grid_plain(tgt, tm, params, center), reps=2,
                          warmup=1),
        # The points and the mask once; per cell a mean, a factor and a flag.
        bound=_bound(n * 13 + C * (12 + 36 + 1), int(inb.sum()) * 25 + C * 120),
        # index_add_ of the count, sum and products, then the batched
        # inverse and Cholesky.
        library_ms=_cuda_ms(library_grid))
    print("K28 by the profiler, kernel by kernel: " + ", ".join(
        f"{name} {ms:.4f} ms" for name, ms in k28_steps))

    k29 = icp.ndt_lm(grid, src, sm, x0, params)
    k29_p = icp.ndt_lm_plain(grid, src, sm, x0, params)
    gap29 = pose_gap(k29[0], k29_p[0])
    cost29 = abs(float(k29[1]) - float(k29_p[1])) / max(abs(float(k29_p[1])), 1e-30)
    print(f"K29 ndt_lm on {n} points x 3 rows: {int(k29[2])} iterations, pose within "
          f"{gap29[0]:.3g} m, {gap29[1]:.3g} rad and cost within {cost29:.3g} relative of the "
          f"twin (tolerance 1e-4 each)")
    if max(*gap29, cost29) > 1e-4:
        _fail("K29 differs from the plain twin")
    world = icp.transform_points(k29[0], src)
    lin29, inb29 = icp._ndt_cells(world, sm, origin, params.resolution, params.grid_extent)
    lin29 = torch.where(inb29, lin29, torch.zeros_like(lin29))
    ok = inb29 & valid_cells[lin29]
    cells29, its29 = int(torch.unique(lin29[ok]).numel()), int(k29[2])
    rows["ndt_lm"] = dict(
        replaces="cartographer_tpu/ops/icp.py:219", max_abs_err=max(gap29),
        ms=_cuda_ms(lambda: icp.ndt_lm(grid, src, sm, x0, params), reps=5, warmup=1),
        plain_ms=_cuda_ms(lambda: icp.ndt_lm_plain(grid, src, sm, x0, params), reps=2,
                          warmup=1),
        # The points and the mask once, the cells they land in (a mean, a
        # factor, a flag) once; per point in a valid cell 54 operations for
        # the first cost, then per iteration 300 (3 rows, 3 gradients, 27
        # sums of 3) + 54.
        bound=_bound(n * 13 + cells29 * 52 + 2 * 28, int(ok.sum()) * (54 + 354 * its29)),
        library_ms=None)
    out["ndt_match_event_ms"] = _event_ms(
        lambda: icp.ndt_match_vector(src, sm, tgt, tm, x0, params), reps=5, warmup=1)
    out["ndt_lm_event_ms"] = _event_ms(lambda: icp.ndt_lm(grid, src, sm, x0, params), reps=5,
                                       warmup=1)
    print(f"gicp and ndt by CUDA events: gicp_match {out['gicp_match_event_ms']:.3f} ms, K26 "
          f"{out['icp_normals_event_ms']:.3f}; ndt_match {out['ndt_match_event_ms']:.3f} ms, K29 "
          f"{out['ndt_lm_event_ms']:.3f}")
    out["kernels"] = {k: {"ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                          "library_ms": r["library_ms"]} for k, r in rows.items()}
    return rows, out


def _ndt_library(torch, tgt, tm, origin, params):
    """K28's function as library calls on the same inputs: -> (fn, the
    in-bounds mask). fn is `index_add_` of the count, sum and products
    into their cells, then the batched inverse and Cholesky factor."""
    from cartographer_tpu_torch.ops import icp

    C = params.grid_extent ** 3
    lin, inb = icp._ndt_cells(tgt, tm, origin, params.resolution, params.grid_extent)
    lin = torch.where(inb, lin, torch.full_like(lin, C))
    rows_sums = torch.cat([torch.ones_like(tgt[:, :1]), tgt,
                           (tgt[:, :, None] * tgt[:, None, :]).reshape(-1, 9)], 1)
    eye = params.regularization * torch.eye(3, device=tgt.device)

    def library_grid():
        sums = torch.zeros((C + 1, 13), device=tgt.device).index_add_(0, lin, rows_sums)[:C]
        n_ = sums[:, 0].clamp(min=1.0)
        mu = sums[:, 1:4] / n_[:, None]
        cov = (sums[:, 4:13].reshape(-1, 3, 3) / n_[:, None, None]
               - mu[:, :, None] * mu[:, None, :] + eye)
        return torch.linalg.cholesky(torch.linalg.inv(cov))

    return library_grid, inb


def _k16_capacity_problem(torch, dev):
    """K16's synthetic SE(3) pose graph with IMU terms at the solver's
    capacity (S 64, N 4,096, C 16,384; a gyro term per consecutive pair, an
    acceleration triplet per triple): -> (arrays, truth node translations,
    the weight-normalized problem on `dev`, the Huber scale)."""
    from cartographer_tpu_torch.interop import schur_problem_3d_from_numpy
    from cartographer_tpu_torch.parallel import schur_spa_3d
    from cartographer_tpu_torch.simulation import synthetic_pose_graph_3d

    arrays, truth_t, _ = synthetic_pose_graph_3d(*K16_CAPACITY, seed=3)
    problem = schur_problem_3d_from_numpy(arrays, dev)
    wmax = schur_spa_3d.max_weight(problem)
    return (arrays, truth_t, schur_spa_3d.pad_even(schur_spa_3d.normalized(problem, wmax)),
            10.0 / wmax)


def _timed(fn, reps=20, warmup=2):
    """(profiler ms, CUDA-event ms, flag) of fn(): the profiler's total has
    dropped device events on some calls, so the new rows are read both
    ways and flagged where the two differ by more than 2x."""
    profiler = _cuda_ms(fn, reps, warmup)
    events = _event_ms(fn, reps, warmup)
    return profiler, events, max(profiler, events) > 2.0 * max(min(profiler, events), 1e-9)


def _graph_grids(fn, label):
    """The blocks of each kernel one call of fn() launches: the kernel nodes
    of a CUDA graph captured around the call (the profiler dropped kernels
    of short sessions), each node's grid read back through libcuda."""
    import ctypes

    import torch

    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    driver = ctypes.CDLL("libcuda.so.1")
    raw, count = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if driver.cuGraphGetNodes(raw, None, ctypes.byref(count)) != 0:
        _fail(f"{label}: cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    driver.cuGraphGetNodes(raw, nodes, ctypes.byref(count))
    blocks = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        driver.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: the function, then gridDimX, Y, Z.
        params = (ctypes.c_uint32 * 64)()
        if driver.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), params) != 0:
            _fail(f"{label}: cuGraphKernelNodeGetParams failed")
        blocks.append(params[2] * params[3] * params[4])
    del graph
    return blocks


def _graph_kernels(fn, label):
    """Kernels one call of fn() launches (_graph_grids)."""
    return len(_graph_grids(fn, label))


def _launches_per_call(fn, expected, label):
    """_graph_kernels of fn(); fails above `expected`, the count the
    kernel's source states."""
    launched = _graph_kernels(fn, label)
    if launched > expected:
        _fail(f"{label}: {launched} kernel launches per call, the source states {expected}")
    return launched


def _short_name(name):
    """A GPU activity's kernel name without its namespaces, template
    arguments and parameters ("Memset" for a memset)."""
    found = re.search(r"(\w+)\s*[<(]", name.replace("(anonymous namespace)::", ""))
    return found.group(1) if found else name


def _launch_breakdown(fn, reps=5):
    """Each GPU activity of one call of fn() in launch order: -> ([(name,
    median device ms)], calls counted). Each of `reps` calls is profiled
    alone and read from the trace's raw records; a call whose window holds
    fewer activities than the fullest (the profiler drops records of short
    sessions) is not counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    on_card = torch._C._autograd.DeviceType.CUDA
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = sorted((e.start_ns(), _short_name(e.name()), e.duration_ns() / 1e6)
                        for e in prof.profiler.kineto_results.events()
                        if e.device_type() == on_card)
        runs.append([(name, ms) for _, name, ms in events])
    longest = max(len(r) for r in runs)
    full = [r for r in runs if len(r) == longest]
    return ([(full[0][i][0], statistics.median(r[i][1] for r in full))
             for i in range(longest)], len(full))


def _kernel_ms(fn, kernel, reps=50, warmup=3):
    """(mean device ms of the GPU kernels whose name holds `kernel`, their
    records counted) over `reps` calls of fn() in one profiled window, or
    (CUDA events' median ms per call, 0) where the window holds none. A mean
    per record stays whole where the profiler drops records of a short
    window; a sum per call falls with them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    on_card = torch._C._autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ns = [e.duration_ns() for e in prof.profiler.kineto_results.events()
          if e.device_type() == on_card and kernel in e.name()]
    if not ns:
        return _event_ms(fn, reps, warmup=0), 0
    return sum(ns) / len(ns) / 1e6, len(ns)


def _edge_intensity_phase(torch, dev):
    """Phase 21: K30 and K31 at the path's shapes, each equal to its twin bit
    for bit; K30 over phase 10's first scans against K18 -> K19's crop of
    the same window; both timed by the profiler and by CUDA events beside
    their bounds and library calls. Launches count the path's run: K31 once
    per shape, K30 once per scan."""
    from cartographer_tpu_torch.core.config import INTENSITY_THRESHOLD as INTENSITY_THRESHOLD_3D
    from cartographer_tpu_torch.core.config import TpuOptions3D
    from cartographer_tpu_torch.ops import cuda, in_order_scatter
    from cartographer_tpu_torch.ops.grid_3d import (
        IntensityGrid3D,
        _intensity_cells,
        insert_intensities,
        insert_intensities_plain,
    )
    from cartographer_tpu_torch.ops.paged_grid_3d import PagedIntensitySubmapGrid3D
    from cartographer_tpu_torch.sensor import voxel_filter
    from cartographer_tpu_torch.simulation import (
        simulate_scan_pair_3d,
        simulate_scans,
        simulate_scans_3d,
    )

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    out, rows = {}, {}

    # K31's inputs: a 2D scan, 3D frontend scans of 4,096 and 16,384
    # returns, and the testbed's 28,800-return cloud padded to 32,768.
    scan_2d = simulate_scans(1, seed=0)[0][0][1][:, :2]
    clouds = {"2d_1081": (scan_2d, np.ones(len(scan_2d), bool)),
              "3d_4096": (simulate_scans_3d(1)[0][0][1], np.ones(4096, bool)),
              "3d_16384": (simulate_scans_3d(1, azimuths=1024)[0][0][1], np.ones(16384, bool))}
    source = simulate_scan_pair_3d()[0]
    padded = np.zeros((32768, 3), np.float32)
    padded[:len(source)] = source
    clouds["3d_32768"] = (padded, np.arange(32768) < len(source))
    inputs = {k: (t(p), t(m)) for k, (p, m) in clouds.items()}
    res, ratio = EDGE_FILTER
    # K30's inputs: the 256^3 window at 0.1 m (the 3D frontend's intensity
    # crop) around the sensor, scans with intensities of 4,096, 16,384 and
    # 32,768 returns.
    tpu = TpuOptions3D()
    window = tpu.high_grid_size
    scans = {n: simulate_scans_3d(1, azimuths=n // 16, intensities=True)[0][0]
             for n in K30_RETURNS}
    k30 = {n: (t(s[1]), t(s[3]), t(np.ones(n, bool))) for n, s in scans.items()}
    # Phase 10's first scans (the full frontend's scene) in the map frame,
    # gated at the high resolution's range as the frontend gates them.
    # The returns within 1e-3 of a cell's border are left out: the dense
    # window's origin is the pool's plus whole cells in float32, so a
    # return on a border may fall on either side in the two grids.
    events = simulate_scans_3d(K30_PATH_SCANS, intensities=True)
    center = np.float32([events[2][0][0], events[2][0][1], 0.0])
    paged = PagedIntensitySubmapGrid3D(0.1, center, dev, page_size=tpu.page_size,
                                       max_pages=tpu.max_pages, num_blocks=tpu.num_blocks)
    window_origin = paged.crop_dense(center, window).origin
    dense = IntensityGrid3D(torch.zeros((window,) * 3, device=dev),
                            torch.zeros((window,) * 3, device=dev), window_origin.clone(), 0.1)
    origin_host = window_origin.cpu().numpy().astype(np.float64)
    path_inputs = []
    for (ts, pts, rel, intens), (x, y, yaw) in zip(events[0], events[2]):
        c, s_ = np.cos(yaw), np.sin(yaw)
        world = np.stack([x + c * pts[:, 0] - s_ * pts[:, 1], y + s_ * pts[:, 0] + c * pts[:, 1],
                          pts[:, 2]], -1).astype(np.float32)
        frac = np.mod((world.astype(np.float64) - origin_host) / 0.1, 1.0)
        near = ((np.linalg.norm(pts, axis=1) <= 20.0)
                & ((frac > 1e-3) & (frac < 1 - 1e-3)).all(axis=1))
        path_inputs.append((world, intens, near))

    # The path's run, with the counts set to 0 just before.
    cuda.reset_launch_counts()
    masks = {k: voxel_filter.voxel_filter_edge_mask(p, m, res, ratio) for k, (p, m) in
             inputs.items()}
    for world, intens, near in path_inputs:
        insert_intensities(dense, t(world), t(intens), t(near), INTENSITY_THRESHOLD_3D)
    torch.cuda.synchronize()
    launches = {k: v for k, v in cuda.launch_counts().items() if v}
    if launches != {"voxel_filter_edge": len(inputs), "dense_intensity_insert_3d":
                    len(path_inputs)}:
        _fail(f"phase 21: launches {launches}")
    out["launches"] = launches

    # K30 against K18 -> K19 on the same scans and window.
    for world, intens, near in path_inputs:
        paged.insert(world, intens, near, INTENSITY_THRESHOLD_3D)
    crop = paged.crop_dense(center, window)
    differing = int((crop.counts != dense.counts).sum())
    differing_sums = int((crop.sums != dense.sums).sum())
    cells = int((dense.counts > 0).sum())
    print(f"K30 over {len(path_inputs)} scans of phase 10's scene into the {window}^3 window: "
          f"{cells} cells, counts differ from K18 -> K19's crop in {differing}, sums in "
          f"{differing_sums} (tolerance: exact, both add each cell in input order)")
    if differing or differing_sums:
        _fail("K30 differs from K18 -> K19's crop of the same window")
    out["against_paged"] = dict(scans=len(path_inputs), cells=cells,
                                differing_counts=differing, differing_sums=differing_sums)

    # K31 against its twin at each shape.
    sizes = {}
    for k, (p, m) in inputs.items():
        want = voxel_filter.voxel_filter_edge_plain(p, m, res, ratio)
        if not torch.equal(masks[k], want):
            _fail(f"K31 at {k} differs from its twin")
        n = p.shape[0]
        keys = voxel_filter._packed_voxel_keys(p, m, res)
        ms, ev, flag = _timed(lambda: voxel_filter.voxel_filter_edge_mask(p, m, res, ratio))
        sizes[k] = dict(
            points=n, kept=int(masks[k].sum()), valid=int(m.sum()), ms=ms, event_ms=ev,
            timers_differ_2x=flag,
            plain_ms=_cuda_ms(lambda: voxel_filter.voxel_filter_edge_plain(p, m, res, ratio),
                              reps=5, warmup=1),
            # The points and flags read once, the keep flags written once.
            bound=_bound(n * (4 * p.shape[1] + 1) + n, 0),
            # torch.unique of the packed keys with inverse and counts: the
            # runs' lengths per point, not the threshold.
            library_ms=_cuda_ms(lambda: torch.unique(keys, return_inverse=True,
                                                     return_counts=True)))
        print(f"K31 voxel_filter_edge at {k}: {sizes[k]['kept']} of {sizes[k]['valid']} kept, "
              f"equal to the twin (tolerance: exact); {ms:.4f} ms by the profiler, {ev:.4f} by "
              f"CUDA events{' (DIFFER by more than 2x)' if flag else ''}, plain "
              f"{sizes[k]['plain_ms']:.3f}, torch.unique {sizes[k]['library_ms']:.4f}, bound "
              f"{sizes[k]['bound'][0]:.2e}")
    row = sizes["3d_4096"]
    rows["voxel_filter_edge"] = dict(
        replaces="cartographer_tpu/sensor/voxel_filter.py:145", max_abs_err=0.0, ms=row["ms"],
        plain_ms=row["plain_ms"], bound=row["bound"], library_ms=row["library_ms"])
    out["voxel_filter_edge"] = {k: dict(v, bound_ms=v["bound"][0]) for k, v in sizes.items()}

    # K30 against its twin: two inserts at each size into a fresh window.
    sizes = {}
    for n, (pts, intens, m) in k30.items():
        got = IntensityGrid3D.create(window, 0.1, np.zeros(3, np.float32), dev)
        ref = IntensityGrid3D.create(window, 0.1, np.zeros(3, np.float32), dev)
        for _ in range(2):
            insert_intensities(got, pts, intens, m, INTENSITY_THRESHOLD_3D)
            insert_intensities_plain(ref, pts, intens, m, INTENSITY_THRESHOLD_3D)
        if not (torch.equal(got.sums, ref.sums) and torch.equal(got.counts, ref.counts)):
            _fail(f"K30 at {n} returns differs from its twin")
        lin, ok = _intensity_cells(got, pts, intens, m, INTENSITY_THRESHOLD_3D)
        lin_ok, intens_ok = lin[ok], intens[ok]
        touched = int(torch.unique(lin_ok).numel())
        ones = torch.ones_like(intens_ok)
        sums, counts = got.sums.view(-1).clone(), got.counts.view(-1).clone()

        def library():  # into the grid's existing sums and counts: nothing allocated
            return sums.index_add_(0, lin_ok, intens_ok), counts.index_add_(0, lin_ok, ones)

        ms, ev, flag = _timed(lambda: insert_intensities(got, pts, intens, m,
                                                         INTENSITY_THRESHOLD_3D))
        per_call = _launches_per_call(
            lambda: insert_intensities(got, pts, intens, m, INTENSITY_THRESHOLD_3D),
            in_order_scatter.launches(n), f"K30 at {n} returns")
        sizes[n] = dict(
            returns=n, cells_touched=touched, ms=ms, event_ms=ev, timers_differ_2x=flag,
            launches_per_call=per_call,
            plain_ms=_cuda_ms(lambda: insert_intensities_plain(ref, pts, intens, m,
                                                               INTENSITY_THRESHOLD_3D),
                              reps=5, warmup=1),
            # The returns, intensities and flags read once; each touched
            # cell's sum and count read and written once.
            bound=_bound(n * 17 + touched * 16, 0),
            # index_add_ of the contributing returns' sums and counts into
            # clones of the grid's (float atomics: not the input order).
            library_ms=_cuda_ms(library))
        print(f"K30 dense_intensity_insert_3d at {n} returns ({touched} cells): equal to the "
              f"twin bit for bit; {ms:.4f} ms by the profiler, {ev:.4f} by CUDA events"
              f"{' (DIFFER by more than 2x)' if flag else ''}, {per_call} launches per call, "
              f"plain {sizes[n]['plain_ms']:.3f}, index_add_ {sizes[n]['library_ms']:.4f}, "
              f"bound {sizes[n]['bound'][0]:.2e}")
    row = sizes[K30_RETURNS[0]]
    rows["dense_intensity_insert_3d"] = dict(
        replaces="cartographer_tpu/ops/grid_3d.py:144", max_abs_err=0.0, ms=row["ms"],
        plain_ms=row["plain_ms"], bound=row["bound"], library_ms=row["library_ms"])
    out["dense_intensity_insert_3d"] = {n: dict(v, bound_ms=v["bound"][0])
                                        for n, v in sizes.items()}
    for v in (*out["voxel_filter_edge"].values(), *out["dense_intensity_insert_3d"].values()):
        del v["bound"]
    return rows, out


def _same_cloud(a, b, reordered):
    """Largest gap between two node clouds (the reference schema groups the
    points by block, so there both are sorted by their millimetre cells)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    if reordered and len(a):
        a = a[np.lexsort(np.round(a * 1000).T)]
        b = b[np.lexsort(np.round(b * 1000).T)]
    return float(np.abs(a - b).max()) if len(a) else 0.0


def _check_loaded(torch, fmt, dim, src, loaded):
    """The state a fresh card MapBuilder loaded against the graph that wrote
    it: poses, constraints and trajectory data exactly (the reference
    schema carries a 2D yaw as a quaternion: within 1e-12 rad there), grids
    equal after the format's quantization and on the card, clouds within
    the 1 mm compression. Returns the largest cloud gap."""
    from cartographer_tpu_torch.io import carto_pbstream

    label = f"{dim}D {fmt}"
    carto = fmt == "carto"

    def same(a, b, what, yaw_tolerance=False):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if yaw_tolerance and carto:
            ok = np.array_equal(a[:2], b[:2]) and abs(a[2] - b[2]) <= 1e-12
        else:
            ok = np.array_equal(a, b)
        if not ok:
            _fail(f"state interchange {label}: {what} differs: {a} against {b}")

    if ([k for k, _ in src.nodes.items()] != [k for k, _ in loaded.nodes.items()]
            or [k for k, _ in src.submap_data.items()]
            != [k for k, _ in loaded.submap_data.items()]):
        _fail(f"state interchange {label}: node or submap ids differ")
    cloud_gap = 0.0
    for (key, a), (_, b) in zip(src.nodes.items(), loaded.nodes.items()):
        if a.time != b.time:
            _fail(f"state interchange {label}: node {key} time differs")
        for f in ("gravity_alignment", "local_pose_translation", "local_pose_rotation"):
            same(getattr(a, f), getattr(b, f), f"node {key} {f}")
        if dim == 2:
            same(a.global_pose_2d, b.global_pose_2d, f"node {key} pose", True)
            cloud_gap = max(cloud_gap, _same_cloud(a.filtered_points, b.filtered_points, carto))
        else:
            same(a.global_t, b.global_t, f"node {key} translation")
            same(a.global_q, b.global_q, f"node {key} rotation")
            same(a.scan_histogram, b.scan_histogram, f"node {key} histogram")
            for f in ("high_res_cloud", "low_res_cloud"):
                cloud_gap = max(cloud_gap, _same_cloud(getattr(a, f), getattr(b, f), carto))
    if cloud_gap > 1e-3:
        _fail(f"state interchange {label}: node clouds {cloud_gap:.3g} m apart (limit 1 mm)")
    grids = 0
    for (key, a), (_, b) in zip(src.submap_data.items(), loaded.submap_data.items()):
        sa, sb = a.submap, b.submap
        same(sa.local_pose_translation, sb.local_pose_translation, f"submap {key} origin")
        same(sa.local_pose_rotation, sb.local_pose_rotation, f"submap {key} rotation")
        if (sa.num_range_data, sa.insertion_finished) != (sb.num_range_data,
                                                          sb.insertion_finished):
            _fail(f"state interchange {label}: submap {key} counters differ")
        if dim == 2:
            same(a.global_pose_2d, b.global_pose_2d, f"submap {key} pose", True)
            pairs = [(sa.grid, sb.grid)]
        else:
            same(a.global_t, b.global_t, f"submap {key} translation")
            same(a.global_q, b.global_q, f"submap {key} rotation")
            pairs = [(sa.high_grid, sb.high_grid), (sa.low_grid, sb.low_grid)]
            if (sa.histogram is None) != (sb.histogram is None):
                _fail(f"state interchange {label}: submap {key} histogram lost")
            if sa.histogram is not None:
                same(np.asarray(sa.histogram, np.float32), sb.histogram, f"submap {key} histogram")
        for ga, gb in pairs:
            if (ga is None) != (gb is None):
                _fail(f"state interchange {label}: submap {key} grid lost")
            if ga is None:
                continue
            grids += 1
            if not gb.log_odds.is_cuda:
                _fail(f"state interchange {label}: a loaded grid is not on the card")
            if carto and dim == 2:  # uint16 probabilities: the format's own round trip
                want = carto_pbstream._grid2d_from_proto(carto_pbstream._grid2d_to_proto(ga), "cpu")
                ok = all(torch.equal(getattr(want, f), getattr(gb, f).cpu())
                         for f in ("log_odds", "known", "origin"))
            elif carto:  # the sparse cell lists, their uint16 values, a float resolution
                pa, pb = (carto_pbstream._grid3d_to_proto(g) for g in (ga, gb))
                ok = (np.float32(pa.pop("resolution")) == np.float32(pb.pop("resolution"))
                      and pa == pb)
            else:  # float16 log-odds
                lo = ga.log_odds.cpu().numpy().astype(np.float16).astype(np.float32)
                ok = (np.array_equal(gb.log_odds.cpu().numpy(), lo)
                      and torch.equal(ga.known.cpu(), gb.known.cpu())
                      and torch.equal(ga.origin.cpu(), gb.origin.cpu()))
            if not ok:
                _fail(f"state interchange {label}: submap {key} grid differs after the "
                      f"format's quantization")
    if len(src.constraints) != len(loaded.constraints):
        _fail(f"state interchange {label}: constraint count differs")
    for ca, cb in zip(src.constraints, loaded.constraints):
        if ((ca.submap_id, ca.node_id, ca.tag, ca.translation_weight, ca.rotation_weight)
                != (cb.submap_id, cb.node_id, cb.tag, cb.translation_weight,
                    cb.rotation_weight)):
            _fail(f"state interchange {label}: a constraint differs")
        if dim == 2:
            same(ca.rel, cb.rel, "a constraint's pose", True)
        else:
            same(ca.rel_t, cb.rel_t, "a constraint's translation")
            same(ca.rel_q, cb.rel_q, "a constraint's rotation")
    if dim == 3:
        for tid, td in src.trajectory_data.items():
            for f in ("gravity_constant", "imu_calibration"):
                if f in td:
                    same(td[f], loaded.trajectory_data[tid][f], f"trajectory {tid} {f}")
    return cloud_gap, grids


def _pbstream_info(paths):
    """`python -m cartographer_tpu_torch.io.pbstream_main info` on each file,
    in parallel subprocesses: -> {path: {kind: count}}."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = {p: subprocess.Popen([sys.executable, "-m", "cartographer_tpu_torch.io.pbstream_main",
                                  "info", p], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True, cwd=root, env=env) for p in paths}
    out = {}
    for p, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        if proc.returncode != 0:
            _fail(f"pbstream info failed on {p}: {stderr}")
        counts = {}
        for line in stdout.splitlines():
            kind, _, value = line.partition(": ")
            if kind not in ("schema", "format_version"):
                counts[kind] = int(value)
        out[p] = counts
    return out


def _localize_phase(torch, dev, path):
    """A fresh card MapBuilder loads the 2D map frozen and runs a new
    trajectory of LOCALIZE_SCANS scans of the floor plan from LOCALIZE_START
    metres of arc, at a pose it is not told; the frozen poses must not move."""
    from cartographer_tpu_torch.core.config import MapBuilderOptions, TrajectoryBuilderOptions
    from cartographer_tpu_torch.mapping.map_builder import MapBuilder
    from cartographer_tpu_torch.ops import cuda
    from cartographer_tpu_torch.sensor.data import TimedPointCloudData
    from cartographer_tpu_torch.simulation import relative_to_first, simulate_scans

    _, map_truth = simulate_scans(1, seed=2)  # phase 4's first pose: the map frame
    scans, truth = simulate_scans(LOCALIZE_SCANS, seed=LOCALIZE_SEED, start=LOCALIZE_START)
    gt = relative_to_first(truth, first=map_truth[0])
    mb = MapBuilder(MapBuilderOptions(use_trajectory_builder_2d=True), device=dev)
    pg, cb = mb.pose_graph, mb.pose_graph.constraint_builder
    cuda.reset_launch_counts()
    t0 = time.monotonic()
    remap = mb.load_state(path)
    load_s = time.monotonic() - t0
    frozen_nodes = {k: n.global_pose_2d.copy() for k, n in pg.nodes.items()}
    frozen_submaps = {k: e.global_pose_2d.copy() for k, e in pg.submap_data.items()}
    searches = [0]
    begin = cb.begin_global_constraint

    def counting(*args, **kwargs):
        searches[0] += 1
        return begin(*args, **kwargs)

    cb.begin_global_constraint = counting
    tid = mb.add_trajectory_builder(["laser"], TrajectoryBuilderOptions(_frontend_options()))
    t0 = time.monotonic()
    for ts, pts, rel in scans:
        mb.add_sensor_data(tid, "laser", TimedPointCloudData(
            time=int(round((ts + LOCALIZE_TIME_OFFSET) * 1e6)), origin=np.zeros(3, np.float32),
            ranges=pts, times=rel))
    mb.finish_trajectory(tid)
    pg.run_final_optimization()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    cb.begin_global_constraint = begin
    launches = cuda.launch_counts()
    _check_launched(launches, KERNELS_2D, "localization")
    moved = [k for k, n in pg.nodes.items() if k in frozen_nodes
             and not np.array_equal(n.global_pose_2d, frozen_nodes[k])]
    moved += [k for k, e in pg.submap_data.items() if k in frozen_submaps
              and not np.array_equal(e.global_pose_2d, frozen_submaps[k])]
    nodes = [(i, n) for (t, i), n in pg.nodes.items() if t == tid]
    index = np.array([int(round(n.time / 1e5 - LOCALIZE_TIME_OFFSET * 10)) - 1
                      for _, n in nodes])
    errors = np.array([np.linalg.norm(n.global_pose_2d[:2] - gt[k, :2])
                       for (_, n), k in zip(nodes, index)])
    links = sum(1 for c in pg.constraints if c.tag == "INTER_SUBMAP"
                and {c.node_id.trajectory_id, c.submap_id.trajectory_id} == {0, tid})
    out = dict(remapping={str(k): v for k, v in remap.items()}, trajectory_id=tid,
               scans=len(scans), nodes=len(nodes), global_searches=searches[0],
               constraints_to_frozen_map=links, solves=pg.solves,
               mean_error_m=float(errors.mean()),
               mean_error_last_100_scans_m=float(errors[index >= len(scans) - 100].mean()),
               load_seconds=load_s, localize_seconds=wall,
               frozen_poses_moved=len(moved), launches={k: v for k, v in launches.items() if v})
    min_links, max_error = LOCALIZE_LIMITS
    print(f"localization against the frozen map: trajectory {tid}, {len(nodes)} nodes, "
          f"{searches[0]} global searches, {links} loop closures to the frozen map (limit >= "
          f"{min_links}), {pg.solves} solves, mean error {errors.mean():.4f} m (limit "
          f"{max_error}; {out['mean_error_last_100_scans_m']:.4f} over the last 100 scans), "
          f"load {load_s:.2f} s, {wall:.1f} s; {len(moved)} frozen poses moved (limit 0, bit "
          f"for bit)")
    if moved or tid != 1 or links < min_links or errors.mean() > max_error:
        _fail("localization against the frozen map failed its limits")
    return out


def _state_interchange_phase(torch, dev, mb2d, pg3d):
    """Phase 22: phase 4's 2D map and phase 7's 3D map written as native and
    reference-schema pbstreams and loaded by fresh card MapBuilders (checked
    field by field); localization against the frozen 2D map; the pbstream
    CLI's counts; a v1 stream's submap histograms rebuilt by K12's rotation
    on the card."""
    import tempfile

    from cartographer_tpu_torch.core.config import MapBuilderOptions
    from cartographer_tpu_torch.io import carto_pbstream, carto_protos, serialization
    from cartographer_tpu_torch.io.pbstream import ProtoStreamReader, ProtoStreamWriter
    from cartographer_tpu_torch.io.proto_wire import decode_message, encode_message
    from cartographer_tpu_torch.mapping.map_builder import MapBuilder
    from cartographer_tpu_torch.ops import cuda

    out = {"write_seconds": {}, "load_seconds": {}, "bytes": {}}
    pg3d.wait_for_optimization()
    pg3d.wait_for_all_computations()
    writers = {"native": serialization.serialize_state, "carto": carto_pbstream.write_carto_state}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for dim, fmt in ((2, "native"), (2, "carto"), (3, "native"), (3, "carto")):
            key = f"{dim}d_{fmt}"
            path = paths[key] = f"{tmp}/{key}.pbstream"
            t0 = time.monotonic()
            if dim == 2:
                mb2d.serialize_state(path, format=fmt)
            else:
                writer = ProtoStreamWriter(path)
                writers[fmt](pg3d, writer)
                writer.close()
            out["write_seconds"][key] = time.monotonic() - t0
            out["bytes"][key] = os.path.getsize(path)
            fresh = MapBuilder(MapBuilderOptions(use_trajectory_builder_2d=dim == 2,
                                                 use_trajectory_builder_3d=dim == 3), device=dev)
            t0 = time.monotonic()
            remap = fresh.load_state(path)
            torch.cuda.synchronize()
            out["load_seconds"][key] = time.monotonic() - t0
            if remap != {0: 0}:
                _fail(f"state interchange {key}: remapping {remap}")
            src = mb2d.pose_graph if dim == 2 else pg3d
            gap, grids = _check_loaded(torch, fmt, dim, src, fresh.pose_graph)
            print(f"state interchange {key}: {len(src.nodes)} nodes, {len(src.submap_data)} "
                  f"submaps, {len(src.constraints)} constraints, {grids} grids on the card: equal "
                  f"(poses exact, grids after the format's quantization, clouds within {gap:.2e} m); "
                  f"{out['bytes'][key] / 1e6:.1f} MB, write {out['write_seconds'][key]:.2f} s, load "
                  f"{out['load_seconds'][key]:.2f} s")
            del fresh

        out["localization"] = _localize_phase(torch, dev, paths["2d_native"])

        # The pbstream CLI in subprocesses: its counts against the graphs.
        info = _pbstream_info(list(paths.values()))
        for key, path in paths.items():
            pg = mb2d.pose_graph if key.startswith("2d") else pg3d
            nodes, submaps = len(pg.nodes), len(pg.submap_data)
            if key == "2d_native":
                want = {"header": 1, "pose_graph": 1, "trajectory_builder_options": 1,
                        "submap": submaps, "node": nodes, "trajectory_data": 1}
            elif key == "3d_native":
                want = {"header": 1, "pose_graph": 1, "trajectory_builder_options": 1,
                        "submap3d": submaps, "node3d": nodes, "trajectory_data": 1}
            else:
                want = {"pose_graph": 1, "all_trajectory_builder_options": 1, "submap": submaps,
                        "node": nodes}
                if key == "3d_carto" and pg.trajectory_data:
                    want["trajectory_data"] = len(pg.trajectory_data)
            if info[path] != want:
                _fail(f"pbstream info on {key}: {info[path]}, expected {want}")
        print(f"pbstream info (subprocesses): {json.dumps({k: info[p] for k, p in paths.items()})}")
        out["pbstream_info"] = {k: info[p] for k, p in paths.items()}

        # A v1 twin of the 3D reference-schema stream: header version 1, the
        # submap histograms stripped (tests/test_v1_migration.py's
        # _write_v1_twin).
        reader = ProtoStreamReader(paths["3d_carto"])
        records = list(reader)
        reader.close()
        v1 = f"{tmp}/3d_v1.pbstream"
        writer = ProtoStreamWriter(v1)
        writer.write(encode_message(carto_protos.SERIALIZATION_HEADER, {"format_version": 1}))
        for rec in records[1:]:
            msg = decode_message(carto_protos.SERIALIZED_DATA, rec)
            if "submap" in msg and "submap_3d" in msg["submap"]:
                msg["submap"]["submap_3d"].pop("rotational_scan_matcher_histogram", None)
            writer.write(encode_message(carto_protos.SERIALIZED_DATA, msg))
        writer.close()
        options = MapBuilderOptions(use_trajectory_builder_3d=True)
        card = MapBuilder(options, device=dev)
        cuda.reset_launch_counts()
        t0 = time.monotonic()
        card.load_state(v1, load_frozen_state=False)
        torch.cuda.synchronize()
        v1_s = time.monotonic() - t0
        rotations = cuda.launch_counts()["rot_histogram_rotate"]
        intra = sum(1 for c in card.pose_graph.constraints if c.tag == "INTRA_SUBMAP")
        plain = MapBuilder(options, device="cpu")
        plain.load_state(v1, load_frozen_state=False)
        twin_err = v2_err = 0.0
        for (key, e), (_, p), (_, s) in zip(card.pose_graph.submap_data.items(),
                                            plain.pose_graph.submap_data.items(),
                                            pg3d.submap_data.items()):
            h, hp = np.asarray(e.submap.histogram), np.asarray(p.submap.histogram)
            twin_err = max(twin_err, float(np.abs(h - hp).max() / max(np.abs(hp).max(), 1e-30)))
            if s.submap.histogram is not None:
                hs = np.asarray(s.submap.histogram)
                v2_err = max(v2_err, float(np.abs(h - hs).max() / max(np.abs(hs).max(), 1e-30)))
        print(f"v1 migration on the card: {rotations} K12 rotations for {intra} INTRA constraints, "
              f"{v1_s:.2f} s; rebuilt histograms within {twin_err:.3g} of the plain path's "
              f"(tolerance 1e-5, relative to the largest bin), {v2_err:.3g} from the v2 stream's "
              f"(reported: the port's node histograms leave the IMU's yaw out, which the "
              f"reference's migration rotates away)")
        if rotations != intra or twin_err > 1e-5:
            _fail("v1 migration: K12 was not launched per INTRA constraint or departs from the "
                  "plain path")
        out["v1_migration"] = dict(rotations=rotations, intra_constraints=intra, seconds=v1_s,
                                   relative_to_plain=twin_err, relative_to_v2=v2_err)
    return out


def _keeping_tick(torch, tsdf=False):
    """Record the kernels' arguments and results through one robot-batched
    step: K1, K2 (its one launch of three filters), K5, then K3 and K4, or
    with `tsdf` K22, K20 and K21
    (grids cloned where a later kernel of the step writes them: K5 and the
    refine read the grids the insertion then updates; the insertion keeps
    its grids from before). -> (the calls by kernel, a function that
    restores the wrappers)."""
    from cartographer_tpu_torch.mapping import local_trajectory_builder_2d as ltb
    from cartographer_tpu_torch.mapping import submap_2d
    from cartographer_tpu_torch.ops import correlative_2d, scan_pipeline_2d, tsdf_2d

    def cloned(args):
        return ([g.clone() for g in args[0]], *args[1:])

    kept = {k: [] for k in ("scan_filter", "correlative", "lm", "insert", "normals")}
    restore = [_recording(scan_pipeline_2d, "_scan_filter_kernel", kept["scan_filter"],
                          result=True),
               _recording(correlative_2d, "correlative_match", kept["correlative"],
                          transform=cloned, result=True),
               _recording(ltb, "lm_match_tsdf_2d" if tsdf else "lm_match_2d", kept["lm"],
                          transform=cloned, result=True),
               _recording(submap_2d, "insert_into_slots_tsdf" if tsdf else "insert_into_slots",
                          kept["insert"], transform=lambda a: (a, cloned(a)[0]))]
    if tsdf:
        restore.append(_recording(tsdf_2d, "estimate_normals_2d", kept["normals"],
                                  result=True))

    def undo():
        for r in restore:
            r()
    return kept, undo


def _k20_work(n):
    """K20 on one scan of n points: the points, masks, origin and normals;
    atan2 and the key (20 operations), a sort's log2 n comparisons and the
    window's mean, covariance and eigenvector (60) per point."""
    return n * 17 + 8, n * (80 + int(np.log2(n)))


def _k21_work(torch, grids, rd, normals, active, params):
    """K21 on one robot's slots: it reads the returns, masks, normals and
    origin and reads and writes the tsd and weight of the cells its samples
    touch; 16 samples per return and active slot at some 60 operations,
    10 per touched cell. -> (bytes, operations, the touched cells' (index,
    weight, weight x sdf) per active slot, for the library call)."""
    from cartographer_tpu_torch.core.tensor import true_div
    from cartographer_tpu_torch.ops import tsdf_2d

    sample_pts, sdf, w = tsdf_2d._samples(rd, normals, grids.truncation_distance, params)
    lins, touched, size = [], 0, grids.size
    for slot in range(grids.tsd.shape[0]):
        if not bool(active[slot]):
            continue
        c = torch.floor(true_div(sample_pts - grids.origin[slot], grids.resolution)).long()
        inside = ((c >= 0) & (c < size)).all(-1) & (w > 0)
        lin = (c[..., 0] * size + c[..., 1])[inside]
        lins.append((lin, w[inside], (w * sdf)[inside]))
        touched += int(torch.unique(lin).numel())
    n, valid = rd.returns.points.shape[0], int(rd.returns.mask.sum())
    return (n * 17 + 8 + touched * 16, len(lins) * 16 * valid * 60 + touched * 10, lins)


def _k22_work(valid, iterations):
    """K22 on one robot's refine: the points and flags, 16 tsd cells per
    bicubic sample; some 12 operations per cell and pass, one pass per
    iteration and one at the start."""
    return valid * (8 + 1 + 16 * 4), (1 + iterations) * valid * 16 * 12


def _tick_against_twins(torch, opts, kept, tsdf=False):
    """Each robot's slice of a recorded robot-batched tick (`kept` by
    _keeping_tick) against its kernels' plain twins, at the tolerances of
    the card tests test_robot_batched_kernels and, with `tsdf`, of the
    single-robot TSDF kernel tests: K2, K5 (its TSDF form too) and K21
    exact, K1 1e-5 m with its masks exact, K3's and K22's cost 1e-4
    relative and pose 1e-4 (1e-3 where the twin's LM path takes another
    number of iterations), K4 0.1% of the known cells, K20 1e-5 where a
    return's normal is defined. -> (the worst deviation by kernel, the
    tick's work (bytes, operations) by kernel, a function that runs the
    twins on the tick)."""
    from cartographer_tpu_torch.ops import correlative_2d, grid_2d, scan_matcher_2d, tsdf_2d
    from cartographer_tpu_torch.ops.probability import probability_to_log_odds
    from cartographer_tpu_torch.ops.scan_pipeline_2d import align_scan_plain
    from cartographer_tpu_torch.sensor import voxel_filter
    from cartographer_tpu_torch.transform.rigid import Rigid3

    # The step's launch of K1 and K2: its arguments (K1's, the params, the
    # permutations, the adaptive filters), K1's outputs and the masks.
    (a1, (got1, (keep, *adaptive))), = kept["scan_filter"]
    (a5, (best, scores)), = kept["correlative"]
    (a4, (pose, cost, iterations)), = kept["lm"]
    (args_ins, before), = kept["insert"]
    if tsdf:
        (an, normals), = kept["normals"]
        grids_after, rd, active, do_insert, tparams = args_ins[:5]
        names = ("scan_preprocess_2d", "voxel_filter", "correlative_2d_tsdf",
                 "lm_match_tsdf_2d", "tsdf_normals_2d", "tsdf_insert_2d")  # K1, K2 one launch
        match_plain = tsdf_2d._match_plain
    else:
        grids_after, rd, active, do_insert, hit_p, miss_p, free, samples = args_ins[:8]
        lo = (probability_to_log_odds(hit_p), probability_to_log_odds(miss_p))
        names = ("scan_preprocess_2d", "voxel_filter", "correlative_2d", "scan_matcher_2d",
                 "insert_2d")  # K1 and K2 one launch
        match_plain = scan_matcher_2d._match_plain
    k1, k2, k5, k3 = names[:4]
    filters = (opts.adaptive_voxel_filter, opts.loop_closure_adaptive_voxel_filter)
    robots, n = a1[0].shape[0], a1[0].shape[1]

    def plain_args(r):
        """Robot r's arguments of every twin."""
        ps, pe = a1[4], a1[5]
        args = dict(
            align=(a1[0][r], a1[1][r], a1[2][r], a1[3][r],
                   Rigid3(ps.translation[r], ps.rotation[r]),
                   Rigid3(pe.translation[r], pe.rotation[r]), a1[6][r], a1[7]),
            voxel=(got1[0][r], got1[2][r], a1[7].voxel_filter_size, a1[8][r]),
            adaptive=[(got1[0][r][:, 0:2], keep[r], *f, a1[8][r]) for f in a1[9]],
            correlative=(a5[0][r], a5[1][r], a5[2][r], a5[3][r], a5[4]),
            lm=(a4[0][r], a4[1][r], a4[2][r], a4[3][r], a4[4][r], a4[5]))
        if tsdf:
            args["normals"] = (an[0][r], an[1][r], an[2][r])
            args["insert"] = (rd.robot(r), normals[r], active[r], do_insert[r], tparams)
        else:
            args["insert"] = (rd.robot(r), active[r], do_insert[r], *lo, free, samples)
        return args

    worst = dict.fromkeys(names, 0.0)
    work = {k: [0, 0] for k in names}
    for r in range(robots):
        p = plain_args(r)
        ref = align_scan_plain(*p["align"])
        err = max(float((got1[k][r] - ref[k]).abs().max()) for k in (0, 1, 4))
        if err > 1e-5 or not all(torch.equal(got1[k][r], ref[k]) for k in (2, 3)):
            _fail(f"batched tick: K1 (in K2's launch) robot {r} differs from its twin ({err} m, "
                  "tolerance 1e-5; masks exact)")
        worst[k1] = max(worst[k1], err)
        mism = int((keep[r] != voxel_filter.voxel_filter_mask_plain(*p["voxel"])).sum())
        mism += sum(int((adaptive[f][r] != voxel_filter.adaptive_voxel_filter_mask_plain(
            *p["adaptive"][f])).sum()) for f in range(len(filters)))
        if mism:
            _fail(f"batched tick: K2 robot {r} differs from its twin in {mism} points")
        bp, sp = correlative_2d.correlative_match_plain(*p["correlative"])
        if not (torch.equal(best[r], bp) and torch.equal(scores[r], sp)):
            _fail(f"batched tick: {k5} robot {r} differs from its twin (tolerance: exact)")
        xp, cp, ip = match_plain(*p["lm"])
        same_path = int(iterations[r]) == int(ip)
        pose_err = float((pose[r] - xp).abs().max())
        rel_cost = abs(float(cost[r]) - float(cp)) / max(abs(float(cp)), 1e-30)
        if rel_cost > 1e-4 or pose_err > (1e-4 if same_path else 1e-3):
            _fail(f"batched tick: {k3} robot {r} differs from its twin: pose {pose_err}, cost "
                  f"{rel_cost} relative; {int(iterations[r])} iterations, the twin {int(ip)}")
        worst[k3] = max(worst[k3], pose_err)
        inserted = bool(do_insert[r]) and bool(active[r].any())
        if tsdf:
            pts, mask, origin = p["normals"]
            defined = torch.from_numpy(_defined_normals(
                pts.cpu().numpy(), mask.cpu().numpy(), origin.cpu().numpy())).to(pts.device)
            nerr = float(((normals[r] - tsdf_2d._normals_plain(*p["normals"])).abs().max(-1)
                          .values * defined).max())
            if nerr > 1e-5:
                _fail(f"batched tick: K20 robot {r} differs from its twin by {nerr} where the "
                      "normal is defined (tolerance 1e-5)")
            worst["tsdf_normals_2d"] = max(worst["tsdf_normals_2d"], nerr)
            plain = before[r].clone()
            tsdf_2d._insert_plain(plain, *p["insert"])
            if not (torch.equal(grids_after[r].tsd, plain.tsd)
                    and torch.equal(grids_after[r].weight, plain.weight)):
                _fail(f"batched tick: K21 robot {r}'s grids differ from its twin's "
                      "(tolerance: exact)")
            ins_work = (_k21_work(torch, before[r], rd.robot(r), normals[r], active[r],
                                  tparams)[:2] if inserted else (0, 0))
            rows = (("tsdf_normals_2d", _k20_work(n)), ("tsdf_insert_2d", ins_work),
                    (k3, _k22_work(int(a4[2][r].sum()), int(iterations[r]))))
        else:
            plain = before[r].clone()
            grid_2d._insert_plain(plain, *p["insert"])
            touched = int(plain.known.sum())
            differ = int(((grids_after[r].log_odds - plain.log_odds).abs() > 1e-6).sum()
                         + (grids_after[r].known != plain.known).sum())
            if differ > 1e-3 * touched:
                _fail(f"batched tick: K4 robot {r}'s grids differ in {differ} of {touched} "
                      "known cells (tolerance 0.1%)")
            worst["insert_2d"] = max(worst["insert_2d"], differ / max(touched, 1))
            rows = (("insert_2d", _k4_work(torch, before[r], rd.robot(r), active[r], free,
                                           samples) if inserted else (0, 0)),
                    (k3, _k3_work(int(a4[2][r].sum()), int(iterations[r]))))

        # The work this robot's inputs need of each kernel.
        for name, (b, o) in (
                (k1, _k1_work(n)),
                (k2, _k2_work(torch, got1[0][r], keep[r], filters, a1[8][r])),
                (k5, _k5_work(torch, *p["correlative"][:4], scores[r], a5[4])), *rows):
            work[name][0] += b
            work[name][1] += o
    spare = [g.clone() for g in before]
    args = [plain_args(r) for r in range(robots)]

    def plain_tick():
        for r, p in enumerate(args):
            align_scan_plain(*p["align"])
            voxel_filter.voxel_filter_mask_plain(*p["voxel"])
            for f in p["adaptive"]:
                voxel_filter.adaptive_voxel_filter_mask_plain(*f)
            correlative_2d.correlative_match_plain(*p["correlative"])
            match_plain(*p["lm"])
            if tsdf:
                tsdf_2d._normals_plain(*p["normals"])
                tsdf_2d._insert_plain(spare[r], *p["insert"])
            else:
                grid_2d._insert_plain(spare[r], *p["insert"])
    return worst, work, plain_tick


def _batched_serving_phase(torch, dev):
    """Cross-robot batched serving at bench.py's shape: BATCH_ROBOTS robot
    threads (1,024-beam scans, 512^2 grids at 5 cm, matcher cloud 512,
    loop-closure cloud 256), each through its own builder and through one
    shared ScanBatcher, with the default options, with the correlative
    search on, and on TSDF submaps with the search on: every robot's poses
    in the batched run equal its single-robot builder's bit for bit; scans/s
    of both runs timed over the whole run (and of the separate builders from
    one thread); on the JAX package's permutations, every robot that the CPU
    witness keeps within BATCH_ERROR_LIMIT stays within it; one tick's
    kernels (K1-K5, or K1, K2, K5's TSDF form, K22, K20, K21) against their
    twins robot by robot, and that tick's bound and plain time (rows 6b and
    6c); the step's launches and all kernel launches per tick (counters,
    and the kernel nodes of a captured CUDA graph; K20's and K21's alone on
    TSDF) and device ms per tick at R = 1, 4 and 16; GPU activities and
    busy ms per tick in a profiled window."""
    import threading

    from cartographer_tpu_torch.core.config import TrajectoryBuilder2DOptions, apply_overrides
    from cartographer_tpu_torch.mapping import local_trajectory_builder_2d as ltb
    from cartographer_tpu_torch.mapping.scan_batcher import ScanBatcher
    from cartographer_tpu_torch.ops import correlative_2d, cuda, grid_2d, tsdf_2d
    from cartographer_tpu_torch.sensor.data import TimedPointCloudData
    from cartographer_tpu_torch.simulation import (
        reference_permutation,
        relative_to_first,
        simulate_scans,
    )
    from cartographer_tpu_torch.transform import nquat

    streams = []
    for r in range(BATCH_ROBOTS):
        scans, truth = simulate_scans(BATCH_SCANS + BATCH_PROFILED, beams=BATCH_BEAMS, seed=r,
                                      start=4.0 * r)
        data = [TimedPointCloudData(time=int(round(ts * 1e6)), origin=np.zeros(3, np.float32),
                                    ranges=pts, times=rel) for ts, pts, rel in scans]
        streams.append((data, relative_to_first(truth)))
    out = {}
    for label, correlative, grid_type in (("default", False, "PROBABILITY_GRID"),
                                          ("correlative", True, "PROBABILITY_GRID"),
                                          ("tsdf", True, "TSDF")):
        marks, seconds = [time.monotonic()], {}

        def lap(part):  # the wall seconds of each part of the label's run
            marks.append(time.monotonic())
            seconds[part] = marks[-1] - marks[-2]

        tsdf = grid_type == "TSDF"
        step_kernels = TSDF_FRONTEND_KERNELS if tsdf else FRONTEND_KERNELS
        opts = apply_overrides(TrajectoryBuilder2DOptions(), {
            **BATCH_OPTIONS, "use_online_correlative_scan_matching": correlative,
            "submaps.grid_type": grid_type})

        def run(batcher, count=BATCH_SCANS, first=0, permutation_fn=None, threads=True):
            """BATCH_ROBOTS builders each fed its robot's scans, from a
            thread per robot (or, with `threads` False, one thread taking
            the robots in turn, scan by scan)."""
            builders = [ltb.LocalTrajectoryBuilder2D(opts, ["laser"], device=dev,
                                                     batcher=batcher,
                                                     permutation_fn=permutation_fn)
                        for _ in range(BATCH_ROBOTS)]
            poses = [[] for _ in range(BATCH_ROBOTS)]
            failures = []

            def feed(r, d):
                res = builders[r].add_range_data("laser", d)
                poses[r].append([np.nan] * 3 if res is None else
                                [*res.local_pose_translation[:2],
                                 nquat.get_yaw(res.local_pose_rotation)])

            def robot(r):
                try:
                    for d in streams[r][0][first:first + count]:
                        feed(r, d)
                except Exception as e:  # noqa: BLE001 — raised below
                    failures.append(e)

            t0 = time.monotonic()
            if threads:
                workers = [threading.Thread(target=robot, args=(r,))
                           for r in range(BATCH_ROBOTS)]
                for t in workers:
                    t.start()
                for t in workers:
                    t.join()
            else:
                for k in range(first, first + count):
                    for r in range(BATCH_ROBOTS):
                        feed(r, streams[r][0][k])
            wall = time.monotonic() - t0
            if failures:
                raise failures[0]
            return builders, np.asarray(poses), wall

        def mean_errors(poses):
            return [float(np.linalg.norm(poses[r][:, :2] - streams[r][1][:len(poses[r]), :2],
                                         axis=1).mean()) for r in range(BATCH_ROBOTS)]

        # Warm both paths (first launches, pinned pools), then the timed runs.
        warm = ScanBatcher(max_batch=BATCH_ROBOTS)
        run(warm, count=3)
        warm.close()
        run(None, count=3)
        lap("warm")
        alone_builders, alone, wall_alone = run(None)
        lap("separate")
        batcher = ScanBatcher(max_batch=BATCH_ROBOTS)
        cuda.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            builders, batched, wall = run(batcher)
        torch.cuda.set_sync_debug_mode("default")
        launches = cuda.launch_counts()
        batcher.close()
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        ticks, scans = batcher.num_batches, batcher.num_scans
        _check_launched(launches, step_kernels if correlative else
                        tuple(k for k in step_kernels if k != "correlative_2d"),
                        f"batched serving ({label})")
        same = [bool(np.array_equal(batched[r], alone[r])) for r in range(BATCH_ROBOTS)]
        errors = mean_errors(batched)
        per_tick = {k: launches.get(k, 0) / ticks for k in step_kernels}
        res = dict(
            robots=BATCH_ROBOTS, scans_per_robot=BATCH_SCANS, ticks=ticks,
            scans_per_tick=scans / ticks,
            batched_scans_per_sec=scans / wall, separate_scans_per_sec=scans / wall_alone,
            batched_wall_s=wall, separate_wall_s=wall_alone,
            host_s_per_scan=float(np.mean([(b.host_seconds - b.device_seconds) / BATCH_SCANS
                                           for b in builders])),
            wait_s_per_scan=float(np.mean([b.device_seconds / BATCH_SCANS for b in builders])),
            separate_host_s_per_scan=float(np.mean(
                [(b.host_seconds - b.device_seconds) / BATCH_SCANS for b in alone_builders])),
            separate_wait_s_per_scan=float(np.mean(
                [b.device_seconds / BATCH_SCANS for b in alone_builders])),
            dispatch_s_per_tick=batcher.dispatch_seconds / ticks,
            fetch_s_per_tick=batcher.fetch_seconds / ticks,
            collect_s_per_tick=batcher.collect_seconds / ticks,
            synchronizing_operations=syncs, step_launches_per_tick=per_tick,
            robots_equal_to_single=sum(same), mean_error_m=errors)
        print(f"batched serving ({label}): {scans} scans of {BATCH_ROBOTS} robots in {ticks} "
              f"ticks ({scans / ticks:.2f} scans per tick): {scans / wall:.1f} scans/s against "
              f"{scans / wall_alone:.1f} for {BATCH_ROBOTS} separate builders; {sum(same)} of "
              f"{BATCH_ROBOTS} robots' poses equal to their single-robot run bit for bit; mean "
              f"errors on the card's permutations {min(errors):.4f}-{max(errors):.4f} m "
              f"({sum(e <= BATCH_ERROR_LIMIT for e in errors)} robots within "
              f"{BATCH_ERROR_LIMIT} m; reported, and held below on the reference's); {syncs} "
              f"synchronizing operations; launches per tick {per_tick}")
        if not all(same):
            differ = [r for r in range(BATCH_ROBOTS) if not same[r]]
            _fail(f"batched serving ({label}): robots {differ} differ from their single-robot "
                  "runs")
        if syncs > ticks:
            _fail(f"batched serving ({label}): {syncs} synchronizing operations in {ticks} ticks")

        # Accuracy on the reference's own inputs: the batched run again with
        # the JAX package's voxel-filter permutations, the inputs of
        # tests/batched_serving_witness_2d.py. At this shape the frontend
        # loses some robots on the CPU too, in both packages; each robot
        # that the witness keeps within the limit in both must stay within
        # it here, and the others are reported beside the witness.
        lap("batched")
        rb = ScanBatcher(max_batch=BATCH_ROBOTS)
        _, on_reference, _ = run(rb, permutation_fn=reference_permutation)
        rb.close()
        lap("reference")
        ref_errors = mean_errors(on_reference)
        witness = BATCH_WITNESS[label]
        kept = [r for r in range(BATCH_ROBOTS) if max(witness[r]) <= BATCH_ERROR_LIMIT]
        lost = [r for r in kept if ref_errors[r] > BATCH_ERROR_LIMIT]
        res["reference_inputs"] = dict(
            mean_error_m=ref_errors, witness_kept=kept,
            witness_lost={r: dict(card=ref_errors[r], jax=witness[r][0], plain=witness[r][1],
                                  **({"jax_noisy_worst": witness[r][2]}
                                     if len(witness[r]) > 2 else {}))
                          for r in range(BATCH_ROBOTS) if r not in kept})
        print(f"batched serving ({label}) on the reference's permutations: mean errors "
              f"{[round(e, 4) for e in ref_errors]} m; the {len(kept)} robots the CPU witness "
              f"keeps within {BATCH_ERROR_LIMIT} m (both packages"
              f"{', and JAX under range noise' if tsdf else ''}): "
              f"{len(kept) - len(lost)} within it here; the others: "
              f"{res['reference_inputs']['witness_lost']}")
        if lost:
            _fail(f"batched serving ({label}): robots {lost} lose the ground truth on the "
                  f"reference's inputs ({[ref_errors[r] for r in lost]} m; the witness keeps "
                  f"them within {BATCH_ERROR_LIMIT} m)")

        if not correlative:
            # The separate builders' work again from one thread taking the
            # robots in turn: the same kernels, fetches and stream, without
            # 16 threads contending for the host.
            serial_builders, serial, wall_serial = run(None, threads=False)
            if not np.array_equal(serial, alone):
                _fail(f"batched serving ({label}): one thread's run differs from the threads'")
            res["separate_one_thread_scans_per_sec"] = scans / wall_serial
            res["separate_one_thread_wait_s_per_scan"] = float(np.mean(
                [b.device_seconds / BATCH_SCANS for b in serial_builders]))
            print(f"batched serving ({label}): {BATCH_ROBOTS} separate builders from one "
                  f"thread: {scans / wall_serial:.1f} scans/s (from {BATCH_ROBOTS} threads "
                  f"{scans / wall_alone:.1f})")

        if correlative:
            # One tick of all the robots with its kernels' calls recorded:
            # each robot's slice against the plain twins, and the tick's own
            # bound and plain time (rows 6b and 6c).
            group = builders
            staging = torch.cat([b._staging for b in group])
            # Every robot inserts (the motion filter's first-scan flag), so
            # the insertion is held on all of them.
            staging[:, 8 * opts.tpu.scan_capacity + ltb._MF_FIRST] = 1.0
            staging = staging.pin_memory()
            calls, undo = _keeping_tick(torch, tsdf)
            try:
                ltb.batched_step(group, staging, [b._seed_counter for b in group])
            finally:
                undo()
            worst, work, plain_tick = _tick_against_twins(torch, opts, calls, tsdf)
            lap("tick_against_twins")
            bounds = {k: _bound(*v) for k, v in work.items()}
            res["tick_against_twins"] = dict(
                robots=BATCH_ROBOTS, worst=worst, work=work,
                bound_ms=sum(b[0] for b in bounds.values()),
                bound_ms_by_kernel={k: b[0] for k, b in bounds.items()},
                # The profiler's device time of one run, as every plain
                # time (the twin checks above ran the same operations).
                plain_ms=_cuda_ms(plain_tick, reps=1, warmup=0))
            del calls, plain_tick
            print(f"batched tick ({label}) of {BATCH_ROBOTS} robots against the twins: "
                  f"{res['tick_against_twins']}")

        # One tick at R = 1, 4 and 16 on the run's robots (their last rows):
        # the step's launches by the counters, every kernel by a captured
        # graph (and on TSDF K20's and K21's alone), device ms by the
        # profiler and by CUDA events.
        lap("tick_plain_ms" if correlative else "one_thread")
        per_r = {}
        for robots in BATCH_TICK_ROBOTS:
            group = builders[:robots]
            staging = torch.cat([b._staging for b in group]).pin_memory()
            seeds = [b._seed_counter for b in group]
            upload = staging.to(dev)
            perms = torch.stack([torch.randperm(opts.tpu.scan_capacity, device=dev,
                                                dtype=torch.int32) for _ in group])
            cuda.reset_launch_counts()
            _, rd = ltb.device_step(group, upload, perms)
            counted = {k: v for k, v in cuda.launch_counts().items() if v}
            kernels = _launches_per_call(lambda: ltb.device_step(group, upload, perms),
                                         100000, f"batched step at R = {robots}")
            tick = lambda: ltb.batched_step(group, staging, seeds)  # noqa: E731
            per_r[robots] = dict(step_launches=counted, kernel_launches=kernels,
                                 device_ms=_cuda_ms(tick, reps=20),
                                 event_ms=_event_ms(tick, reps=20))
            # K5 (its TSDF form on TSDF) and K4 alone, on the tick's robots.
            windows = [b._active_submaps for b in group]
            m = opts.tpu.matcher_capacity
            corr = opts.real_time_correlative_scan_matcher
            cparams = correlative_2d.CorrelativeSearchParams(
                corr.linear_search_window, corr.angular_search_window,
                corr.translation_delta_cost_weight, corr.rotation_delta_cost_weight,
                opts.max_range)
            cpts = rd.returns.points[:, :m].contiguous()
            cmask = rd.returns.mask[:, :m].contiguous()
            start = torch.zeros((robots, 3), device=dev)
            per_r[robots]["k5_kernels"] = _launches_per_call(
                lambda: correlative_2d.correlative_match(
                    [w.grids.slot(0) for w in windows], cpts, cmask, start, cparams), 3,
                f"K5 at R = {robots}")
            if not tsdf:
                ins = opts.submaps.probability_grid_range_data_inserter
                on = torch.ones((robots, 2), dtype=torch.bool, device=dev)
                yes = torch.ones(robots, dtype=torch.bool, device=dev)
                per_r[robots]["k4_kernels"] = _launches_per_call(
                    lambda: grid_2d.insert_into_slots(
                        [w.grids for w in windows], rd, on, yes, ins.hit_probability,
                        ins.miss_probability, True, opts.tpu.ray_samples,
                        [w._scratch for w in windows]), 2, f"K4 at R = {robots}")
            if tsdf:
                pts, mask = rd.returns.points, rd.returns.mask
                normals = tsdf_2d.estimate_normals_2d(pts, mask, rd.origin)
                windows = [b._active_submaps for b in group]
                active = upload[:, 8 * opts.tpu.scan_capacity + ltb._ACTIVE.start:
                                8 * opts.tpu.scan_capacity + ltb._ACTIVE.stop] > 0.5
                yes = torch.ones(robots, dtype=torch.bool, device=dev)
                per_r[robots]["k20_kernels"] = _launches_per_call(
                    lambda: tsdf_2d.estimate_normals_2d(pts, mask, rd.origin), 1,
                    f"K20 at R = {robots}")
                per_r[robots]["k21_kernels"] = _launches_per_call(
                    lambda: tsdf_2d.insert_into_slots_tsdf(
                        [w.grids for w in windows], rd, active, yes, windows[0]._tsdf_params,
                        normals=normals), 1, f"K21 at R = {robots}")
            print(f"batched step ({label}) at R = {robots}: {per_r[robots]}")
        base = per_r[BATCH_TICK_ROBOTS[0]]
        for robots, v in per_r.items():
            if v["step_launches"] != base["step_launches"]:
                _fail(f"batched step ({label}): the step's launches grow with R: {per_r}")
            if v["k5_kernels"] != base["k5_kernels"] or v.get("k4_kernels") != base.get(
                    "k4_kernels"):
                _fail(f"batched step ({label}): K5's or K4's kernels per call grow with R: "
                      f"{per_r}")
            if tsdf and (v["k21_kernels"] != 1 or v["k20_kernels"] != 1):
                _fail(f"batched step ({label}): K21 takes {v['k21_kernels']} kernel launches "
                      f"at R = {robots}, K20 {v['k20_kernels']} (1 each at every R)")
        res["per_tick"] = per_r
        lap("per_tick")

        # GPU activities and busy ms per tick over a profiled window.
        pb = ScanBatcher(max_batch=BATCH_ROBOTS)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            run(pb, count=BATCH_PROFILED, first=BATCH_SCANS)
            pwall = time.monotonic() - t0
        pb.close()
        busy, activities, by_name = 0.0, 0, {}
        for e in prof.key_averages():
            us = _device_us(e)
            if us > 0:
                busy += us / 1e3
                activities += e.count
                name = e.key.replace("(anonymous namespace)::", "").split("(")[0][-60:]
                by_name[name] = by_name.get(name, 0.0) + us / 1e3 / pb.num_batches
        res["profile"] = dict(
            ticks=pb.num_batches, scans=pb.num_scans,
            gpu_activities_per_tick=activities / pb.num_batches,
            device_busy_ms_per_tick=busy / pb.num_batches if busy else "not measured",
            device_busy_share=busy / (pwall * 1e3) if busy else "not measured",
            device_ms_per_tick_by_kernel=dict(sorted(by_name.items(),
                                                     key=lambda kv: -kv[1])[:12]))
        print(f"batched serving ({label}) profile: {res['profile']}")
        lap("profile")
        res["seconds"] = dict(seconds, all=marks[-1] - marks[0])
        print(f"batched serving ({label}): seconds {res['seconds']}")
        out[label] = res

    # Rows 6b and 6c: a tick of BATCH_ROBOTS robots with the search, on
    # probability grids and on TSDF submaps, its bound and plain time from
    # that tick's own inputs.
    for row, label in (("row_6b", "correlative"), ("row_6c", "tsdf")):
        tick = out[label]["tick_against_twins"]
        out[row] = dict(
            robots=BATCH_ROBOTS, bound_ms=tick["bound_ms"], plain_ms=tick["plain_ms"],
            device_ms_per_tick=out[label]["per_tick"][BATCH_ROBOTS]["device_ms"],
            kernels_per_tick={r: v["kernel_launches"] for r, v in out[label]["per_tick"].items()})
    return out


def _profile(torch, feed, data, label="profile", watch=None):
    """Device busy share and kernel time by name over a window of scans
    that continues the main run (its launches are not counted there);
    `feed(d)` hands one scan to the builder. With `watch`, also the device
    ms per scan of the kernels whose name holds it."""
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
    if watch:
        result[f"{watch}_device_ms_per_scan"] = sum(
            ms for name, ms in by_name.items() if watch in name)
    print(f"{label}: " + json.dumps(result))
    return result


def _clocked(seconds, phase, fn, *args, **kwargs):
    """fn(*args, **kwargs), its wall seconds kept in seconds[phase] and printed."""
    t0 = time.monotonic()
    out = fn(*args, **kwargs)
    seconds[str(phase)] = time.monotonic() - t0
    print(f"phase {phase}: {seconds[str(phase)]:.1f} s")
    return out


def main() -> int:
    t_main = time.monotonic()
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
    seconds = {}  # wall seconds per phase (the docstring's numbers)
    rows, ctx = _clocked(seconds, 1, _kernel_phase, torch, dev)
    run = _clocked(seconds, 2, _slice_phase, torch, dev)
    backend_rows, backend = _clocked(seconds, 3, _backend_kernel_phase, torch, dev, ctx, run)
    rows.update(backend_rows)
    groups = {}
    slam = _clocked(seconds, 4, _global_phase, torch, dev, groups=groups)
    rows.update(_clocked(seconds, "4, K7", _descent_phase, torch, dev, groups))
    del groups
    map_2d = slam.pop("map_builder")  # phase 22 saves and reloads its map
    for key in ("submap", "nodes", "builder", "kept"):
        del run[key]
    run_tsdf = _clocked(seconds, 14, _slice_phase, torch, dev, "TSDF", TSDF_FRONTEND_KERNELS,
                        TSDF_ERROR_LIMIT, "TSDF frontend")
    rows_tsdf = _clocked(seconds, 15, _kernel_phase_tsdf, torch, dev, run_tsdf)
    for key in ("submap", "nodes", "builder", "kept"):
        del run_tsdf[key]
    refines = []
    slam_tsdf = _clocked(seconds, 16, _global_phase, torch, dev, "TSDF", TSDF_KERNELS,
                         TSDF_GLOBAL_LIMITS, localize=False, label="TSDF global",
                         refines=refines)
    del slam_tsdf["map_builder"]
    rows_tsdf.update(_clocked(seconds, "15, refines", _refine_phase_tsdf, torch, refines))
    del refines
    run3d = _clocked(seconds, 5, _slice_phase_3d, torch, dev)
    rows3d = _clocked(seconds, 6, _kernel_phase_3d, torch, dev, run3d.pop("builder"),
                      run3d.pop("last_step"))
    slam3d = _clocked(seconds, 7, _global_phase_3d, torch, dev)
    rows3g, backend3d = _clocked(seconds, 8, _backend_kernel_phase_3d, torch, dev, slam3d)
    map_3d = slam3d.pop("pose_graph")  # phase 22 saves and reloads it
    for key in ("request", "group", "localization"):
        del slam3d[key]
    full_hall = _clocked(seconds, 9, _full_hall_phase_3d, torch, dev)
    run3f = _clocked(seconds, 10, _slice_phase_3d_full, torch, dev)
    rows3f = _clocked(seconds, 11, _kernel_phase_3d_full, torch, dev, run3f.pop("builder"),
                      run3f.pop("kept"))
    full_hall_corr = _clocked(seconds, 12, _full_hall_phase_3d, torch, dev, correlative=True)
    imu_based = _clocked(seconds, 13, _imu_based_phase_3d, torch, dev)
    large = _clocked(seconds, 17, _large_scan_phase_3d, torch, dev)
    raised = _clocked(seconds, 18, _one_block_limits_phase, torch, dev)
    rows_sm, scan_match = _clocked(seconds, 19, _scan_match_phase, torch, dev)
    rows_gn, gicp_ndt = _clocked(seconds, 20, _gicp_ndt_phase, torch, dev)
    rows_sm.update(rows_gn)
    rows_ei, edge_intensity = _clocked(seconds, 21, _edge_intensity_phase, torch, dev)
    interchange = _clocked(seconds, 22, _state_interchange_phase, torch, dev, map_2d, map_3d)
    del map_2d, map_3d
    batched = _clocked(seconds, 23, _batched_serving_phase, torch, dev)
    # K23 and its stats form count the `icp` run's launches, as before.
    scan_match_launches = {**gicp_ndt["launches"], **scan_match["modes"]["ceres"]["launches"],
                           **scan_match["modes"]["icp"]["launches"]}

    sources = {k.symbol: k.source for k in cuda.KERNELS.values()}
    kernels = []
    for name, row in {**rows, **rows_tsdf, **rows3d, **rows3g, **rows3f, **rows_sm,
                      **rows_ei}.items():
        bound_ms, bound_by = row["bound"]
        # The standalone rotation's launches are phase 22's (the v1 migration):
        # the 3D step's rotation is in K12's one launch.
        launches = ({"rot_histogram_rotate": interchange["v1_migration"]["rotations"]}
                    if name == "rot_histogram_rotate"
                    else edge_intensity["launches"] if name in rows_ei
                    else scan_match_launches if name in rows_sm
                    else run3f["launches"] if name in rows3f
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
            "library_ms": row["library_ms"],
            **({"zero_ms": row["zero_ms"]} if "zero_ms" in row else {})})
    smi = _smi()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "card": smi, "build_seconds": build_s, "phase_seconds": seconds,
        "seconds": time.monotonic() - t_main,
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
        "above_one_block": raised,
        "scan_match": scan_match,
        "scan_match_gicp_ndt": gicp_ndt,
        "edge_filter_and_dense_intensity": edge_intensity,
        "paged_intensity_insert_3d": {
            phase: {k: v for k, v in r.items() if k not in ("bound", "replaces")}
            for phase, r in (("phase_11", rows3f["paged_intensity_insert_3d"]),
                             ("phase_17", large["kernels"]["paged_intensity_insert_3d"]))},
        "state_interchange": interchange,
        "batched_serving": batched,
        "bnb_match_ms": backend["bnb_match_ms"],
        "schur_50_iterations_ms": backend["schur_50_iterations_ms"],
        "schur_2d": backend["schur_2d"],
        "bnb3d_match_ms": backend3d["bnb3d_match_ms"],
        "bnb3d_descent": backend3d["bnb3d"],
        "schur_3d_50_iterations_ms": backend3d["schur_3d_50_iterations_ms"],
        "schur_3d": {k: backend3d[k] for k in (
            "schur_3d_breakdown_ms", "schur_3d_kernels_per_iteration", "schur_3d_event_ms",
            "schur_3d_reduced_cholesky_ms")},
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
