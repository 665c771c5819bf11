"""Device times of K11 (scan_matcher_3d), K7 (the 2D branch and bound,
bnb_2d.cu) and K15 (the 3D one, bnb_3d.cu) at the main path's shapes (not
collected by pytest).

    python tests/bnb_lm3d_timing.py LABEL [TREE]
        [k11|k7|global|stamps|clusters|parity|k15|global3d|stamps3d|variants3d]

K11 at the 3D frontend's shape (the match of the 40th scan of a default-
options run over `simulate_scans_3d`, 512 high and 1,024 low points, from
5 cm and 0.6 degrees off the frontend's own pose), at the full options
(the same with intensity rows, the frontend run at the full options) and at
the `ceres` testbed's (two 28,800-return scans of `simulate_scan_pair_3d`
padded to 32,768 each, the testbed's grids and weights): the profiler's
device time per call (the window's sum and the mean of the kernel's
records), CUDA events, and the LM iterations.

K7 on pairs of the 2D frontend's scans against its first finished submap
(300 scans of `simulate_scans` at the default options): each pair's loop-
closure cloud (128 points) from its node's pose 0.4 m and 0.05 rad off, the
default matcher (7 m, 30 degrees, depth 7, beam 4,096). Groups of 1, 8 and
64 pairs: the whole group's device time (profiler) and wall time (CUDA
events) per pair, and the kernels a group launches (a captured CUDA graph).
The tree's own entry points: a loop of `fast_correlative_match_2d` where
the tree has no batched entry point, else `fast_correlative_match_2d_batch`.
With no mode, both K11 and K7; with `k11` or `k7`, one of them.

With `global`, the 2D global run of `chip_smoke.py` phase 4 (900 scans
through `MapBuilder`) with TREE's package instead: its constraint search's
wall seconds (`match_seconds`) and pairs, its solves and loop closures.
With `stamps`, a copy of TREE's `bnb_2d.cu` that stamps the global timer
(block 0) after every grid barrier and every barrier of a selection, built
into `csrc/_build/variant/`: the microseconds of each phase of K7 (a
level's scoring, its selection) for groups of 1 and 8 pairs. With
`clusters`, where TREE's K7 picks the cluster that selects a pair by the
group's size, a copy built for each fixed cluster of 1, 2, 4, 8 and 16
blocks: device ms per pair at groups of 1, 8 and 64. With
`parity`, K11 and its float32 twin on the card against the twin run in
float64 on the CPU (the same inputs widened), on the card tests' inputs
with intensities drawn at random (a rough Huber cost), at the frontend's
shapes and at `ceres`: the LM iterations of each, each float32 pose's
largest difference from the float64 one, and the float64 cost at each of
the three end poses (the lower, the better minimum).

With `k15`, K15 on the 3D global run's first 64 local pairs (`chip_smoke.py`
phase 7's 700 scans of the hall through TREE's `MapBuilder`, the default
options: 256 and 512 points, 107 yaws, depth 8, beam 2,048): groups of 1, 8
and 64 pairs, the whole group's device time (profiler) and wall time (CUDA
events) per pair and the kernels a group launches (a captured CUDA graph, or
the profiler's records where the tree's search cannot be captured); TREE's
own entry points, a loop of `fast_correlative_match_3d` where the tree has
no batched one. With `global3d`, that run's constraint search:
`match_seconds`, pairs tried, loop closures. With `stamps3d`, a copy of
TREE's `bnb_3d.cu` stamped as `stamps` stamps K7's: each phase's us of K15
(discretization, then each level's scoring and selection) for groups of 1
and 8 of those pairs. With `variants3d`, patched copies of TREE's
`bnb_3d.cu` (`K15_VARIANTS`: a warp's yaw held in registers across a
parent's 8 children instead of a candidate a warp; the scorer's two halves
of a lane's points loaded together; clusters of 4 and of 1 block a pair at
every group size) beside the kept
kernel: device ms per pair at groups of 1, 8 and 64, rows against the kept
kernel's.

Prints LABEL and one JSON object. TREE (default: the current directory) is
the root of the checkout whose package is timed; the helpers are this
checkout's `chip_smoke.py`. Unpack the parent with `git archive` into a
git-ignored directory and run, in one call on the card, parent, change,
change, parent.
"""

import ctypes
import importlib.util
import json
import os
import subprocess
import sys

TREE = os.path.abspath(sys.argv[2] if len(sys.argv) > 2 else ".")
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [TREE]

import numpy as np  # noqa: E402
import torch  # noqa: E402

_spec = importlib.util.spec_from_file_location("smoke_helpers",
                                               os.path.join(HERE, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

from cartographer_tpu_torch.core.config import (  # noqa: E402
    ConstraintBuilderOptions,
    TrajectoryBuilder3DOptions,
)
from cartographer_tpu_torch.mapping import local_trajectory_builder_3d as ltb3  # noqa: E402
from cartographer_tpu_torch.ops import bnb_2d, correlative_2d, cuda  # noqa: E402
from cartographer_tpu_torch.ops import scan_matcher_3d  # noqa: E402
from cartographer_tpu_torch.transform import quaternion as quat  # noqa: E402


def _frontend_match(dev, full):
    """The lm_match_3d arguments of the 40th scan of a 3D frontend run, from
    5 cm and 0.6 degrees off the pose it found."""
    opts = cs._full_frontend_options() if full else TrajectoryBuilder3DOptions()
    events, _ = cs._events_3d(40, intensities=full)
    builder = ltb3.LocalTrajectoryBuilder3D(opts, ["points"], device=dev)
    kept = []
    for e in events[:-1]:
        cs._feed_3d(builder, e)
    restore = cs._recording(ltb3, "lm_match_3d", kept, result=True)
    try:
        cs._feed_3d(builder, events[-1])
    finally:
        restore()
    args, (x, _, _) = kept[-1]
    q0 = quat.normalize(quat.multiply(x[3:7], quat.from_axis_angle(
        torch.tensor([0.004, -0.003, 0.01], device=dev))))
    x0 = torch.cat([x[0:3] + torch.tensor([0.04, -0.03, 0.02], device=dev), q0])
    return (*args[:6], x0, x0[0:3].clone(), *args[8:])


def _ceres_match(dev):
    """The `ceres` testbed's lm_match_3d arguments (io/scan_match_main.py)."""
    from cartographer_tpu_torch.ops.grid_3d import Grid3D, insert_range_data_3d
    from cartographer_tpu_torch.simulation import simulate_scan_pair_3d

    source, target, _, _ = simulate_scan_pair_3d()
    cap = 1 << int(np.ceil(np.log2(max(len(source), len(target)))))

    def pad(pts):
        out = np.zeros((cap, 3), np.float32)
        out[: len(pts)] = pts
        return (torch.from_numpy(out).to(dev),
                torch.from_numpy(np.arange(cap) < len(pts)).to(dev))

    src, sm = pad(source)
    tgt, tm = pad(target)
    center = target.mean(0)
    high = Grid3D.create(128, 0.3, center, dev)
    low = Grid3D.create(64, 0.9, center, dev)
    origin = torch.from_numpy(np.asarray(center, np.float32)).to(dev)
    for _ in range(4):
        high = insert_range_data_3d(high, origin, tgt, tm)
        low = insert_range_data_3d(low, origin, tgt, tm)
    x0 = torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0], device=dev)
    params = scan_matcher_3d.GaussNewtonMatcherParams3D(num_iterations=30,
                                                        translation_weight=0.1,
                                                        rotation_weight=1.0)
    return (high, low, src, sm, src, sm, x0, x0[0:3].clone(), params)


def k11(dev):
    cases = {"frontend": _frontend_match(dev, False),
             "full options": _frontend_match(dev, True),
             "ceres": _ceres_match(dev)}

    def timed(args):
        fn = lambda: scan_matcher_3d.lm_match_3d(*args)  # noqa: E731
        x, cost, it = fn()
        xp, cp, _ = scan_matcher_3d._match_plain(*args)
        kernel_ms, records = cs._kernel_ms(fn, "scan_matcher_3d_kernel", reps=100)
        return {"profiler_ms": cs._cuda_ms(fn, reps=100), "kernel_record_ms": kernel_ms,
                "kernel_records_of_100": records, "event_ms": cs._event_ms(fn, reps=100),
                "iterations": int(it), "points": [int(args[3].sum()), int(args[5].sum())],
                "rows": [int(args[2].shape[0]), int(args[4].shape[0])],
                "twin_err_m": float((x[0:3] - xp[0:3]).abs().max()),
                "twin_cost_rel": abs(float(cost) - float(cp)) / max(abs(float(cp)), 1e-30)}

    return {name: timed(args) for name, args in cases.items()}


def _pairs(dev, count):
    """`count` pairs of a 2D frontend run's nodes (the default options, the
    correlative search on, 300 scans of `simulate_scans`) against its first
    finished submap: (pyramid, grid, cloud (128, 2), mask, start pose)."""
    from cartographer_tpu_torch.mapping.local_trajectory_builder_2d import (
        LocalTrajectoryBuilder2D,
    )
    from cartographer_tpu_torch.mapping.pose_graph_2d import TrajectoryNode, _pose2d_of_node
    from cartographer_tpu_torch.sensor.data import TimedPointCloudData
    from cartographer_tpu_torch.simulation import simulate_scans

    scans, _ = simulate_scans(300, seed=0)
    builder = LocalTrajectoryBuilder2D(cs._frontend_options(), ["laser"], device=dev)
    finished, nodes = [], []
    for ts, pts, rel in scans:
        r = builder.add_range_data("laser", TimedPointCloudData(
            time=int(round(ts * 1e6)), origin=np.zeros(3, np.float32), ranges=pts, times=rel))
        if r.insertion_result is not None:
            finished += r.insertion_result.finished_submaps
            nodes.append(r.insertion_result)
    grid = finished[0].grid
    depth = ConstraintBuilderOptions().fast_correlative_scan_matcher.branch_and_bound_depth
    pyr = bnb_2d.build_precomputation_pyramid(grid, depth)
    out = []
    for k in range(count):
        node = nodes[(k * 37) % len(nodes)]
        lc = node.filtered_gravity_aligned_point_cloud
        pts, mask = correlative_2d.pad_points(lc.points.to(dev), lc.mask.to(dev))
        pose2d = _pose2d_of_node(TrajectoryNode(
            node.time, node.gravity_alignment, None, node.local_pose_translation,
            node.local_pose_rotation))
        init = torch.from_numpy(pose2d.astype(np.float32)
                                + np.float32([0.4, -0.3, 0.05])).to(dev)
        out.append((pyr, grid, pts, mask, init))
    return out


def k7(dev):
    fc = ConstraintBuilderOptions().fast_correlative_scan_matcher
    params = bnb_2d.FastCorrelativeMatcherParams2D(
        fc.linear_search_window, fc.angular_search_window, fc.branch_and_bound_depth,
        fc.beam_width, fc.max_scan_range)
    pairs = _pairs(dev, 64)
    batched = hasattr(bnb_2d, "fast_correlative_match_2d_batch")
    out = {"batched_entry_point": batched}
    for size in (1, 8, 64):
        group = pairs[:size]
        if batched:
            pts = torch.stack([p[2] for p in group])
            mask = torch.stack([p[3] for p in group])
            inits = torch.stack([p[4] for p in group])
            fn = lambda g=group, pts=pts, mask=mask, inits=inits: (  # noqa: E731
                bnb_2d.fast_correlative_match_2d_batch([p[0] for p in g], [p[1] for p in g],
                                                       pts, mask, inits, params, 0.0))
        else:
            fn = lambda g=group: [bnb_2d.fast_correlative_match_2d(  # noqa: E731
                p[0], p[1], p[2], p[3], p[4], params, 0.0) for p in g]
        device_ms = cs._cuda_ms(fn, reps=10 if size < 64 else 3, warmup=2)
        event_ms = cs._event_ms(fn, reps=10 if size < 64 else 3, warmup=1)
        out[f"group of {size}"] = {
            "device_ms_per_pair": device_ms / size, "event_ms_per_pair": event_ms / size,
            "device_ms_per_group": device_ms, "event_ms_per_group": event_ms,
            "kernels_per_group": (cs._graph_kernels(fn, f"K7 group of {size}") if batched
                                  else _profiled_kernels(fn))}
    return out


_RULE = "    int k = count == 1 ? 2 : 1;\n    while (k > 0 && clusters[k] < count) --k;\n"


def clusters(dev):
    """K7 built with each fixed cluster size (2^k blocks select a pair)."""
    src = os.path.join(TREE, "cartographer_tpu_torch", "csrc")
    with open(os.path.join(src, "bnb_2d.cu")) as f:
        text = f.read()
    if _RULE not in text:
        return "TREE's bnb_2d.cu picks no cluster size"
    out_dir = os.path.join(src, "_build", "variant")
    os.makedirs(out_dir, exist_ok=True)
    builds = []
    for k in range(5):
        path = os.path.join(out_dir, f"bnb_2d_cluster{1 << k}.cu")
        with open(path, "w") as f:
            f.write(text.replace(_RULE, f"    int k = {k};\n"))
        builds.append((path[:-3] + ".so", subprocess.Popen(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", src, "-o", path[:-3] + ".so", path])))
    for _, proc in builds:
        assert proc.wait() == 0
    fc = ConstraintBuilderOptions().fast_correlative_scan_matcher
    params = bnb_2d.FastCorrelativeMatcherParams2D(
        fc.linear_search_window, fc.angular_search_window, fc.branch_and_bound_depth,
        fc.beam_width, fc.max_scan_range)
    pairs = _pairs(dev, 64)
    kernel = bnb_2d._DESCENT
    saved = kernel._load()
    out = {}
    try:
        for k, (lib, _) in enumerate(builds):
            fn = getattr(ctypes.CDLL(lib), kernel.symbol)
            fn.argtypes, fn.restype = kernel._argtypes, ctypes.c_int
            kernel._fn = fn
            row = {}
            for size in (1, 8, 64):
                g = pairs[:size]
                pts = torch.stack([p[2] for p in g])
                mask = torch.stack([p[3] for p in g])
                inits = torch.stack([p[4] for p in g])
                call = lambda g=g, pts=pts, mask=mask, inits=inits: (  # noqa: E731
                    bnb_2d.fast_correlative_match_2d_batch([p[0] for p in g], [p[1] for p in g],
                                                           pts, mask, inits, params, 0.0))
                try:
                    row[f"group of {size}"] = cs._cuda_ms(call, reps=10 if size < 64 else 3,
                                                          warmup=2) / size
                except RuntimeError as e:  # a cluster size the card cannot hold
                    row[f"group of {size}"] = str(e)[:200]
            out[f"cluster of {1 << k}"] = row
    finally:
        kernel._fn = saved
    return out


def _profiled_kernels(fn):
    """Kernels one call of fn() launches, from the profiler's records (the
    parent's search syncs the host, so it cannot be captured in a graph)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    on_card = torch._C._autograd.DeviceType.CUDA
    return sum(1 for e in prof.events() if e.device_type == on_card
               and "memcpy" not in e.name.lower() and "memset" not in e.name.lower())


def global_run(dev):
    slam = cs._global_phase(torch, dev, kernels=())
    return {k: slam[k] for k in ("constraint_search_seconds", "matched_pairs", "loop_closures",
                                 "solves", "wall_seconds", "mean_error_optimized_m",
                                 "mean_error_frontend_m", "launches")}


def _stamped(source, header):
    """A kernel source and beam_select.cuh with global-timer stamps: after
    every grid barrier into `stamps`, after every barrier of a selection
    into `sort_stamps` (block 0)."""
    timer = ("__device__ unsigned long long stamps[64];\n"
             "__device__ unsigned long long sort_stamps[4096];\n__device__ int sort_n;\n"
             "__device__ inline unsigned long long now() { unsigned long long t; "
             "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); return t; }\n")
    source = source.replace('#include "beam_select.cuh"\n',
                            timer + '#include "beam_select.cuh"\n', 1)
    source = source.replace(
        "  __shared__ Shared s;\n",
        "  __shared__ Shared s;\n  int stamp = 0;\n  if (blockIdx.x == 0 && threadIdx.x == 0) "
        "{ stamps[stamp++] = now(); sort_n = 0; }\n", 1)
    source = source.replace("grid_sync(g.barrier);", "{ grid_sync(g.barrier); if (blockIdx.x == 0 "
                            "&& threadIdx.x == 0) stamps[stamp++] = now(); }")
    a, e = header.index("__device__ unsigned int block_select("), header.index(
        "// The argmax of the m keys")
    body = header[a:e].replace(
        "__syncthreads();", "__syncthreads(); if (blockIdx.x == 0 && threadIdx.x == 0 && "
        "sort_n < 4000) sort_stamps[sort_n++] = now();")
    header = header[:a] + body + header[e:]
    reader = ("extern \"C\" int stamps_read(void* a, void* b) { cudaMemcpyFromSymbol(a, stamps, "
              "sizeof(stamps)); return (int)cudaMemcpyFromSymbol(b, sort_stamps, "
              "sizeof(sort_stamps)); }\n")
    return source.replace("}  // namespace\n", "}  // namespace\n" + reader, 1), header


def _stamped_kernel(source, kernel):
    """Builds a stamped copy of TREE's csrc/`source` into csrc/_build/variant/
    and points `kernel` at it: -> the library (its `stamps_read`)."""
    src = os.path.join(TREE, "cartographer_tpu_torch", "csrc")
    out_dir = os.path.join(src, "_build", "variant")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(src, source)) as f, open(os.path.join(src, "beam_select.cuh")) as h:
        text, header = _stamped(f.read(), h.read())
    path = os.path.join(out_dir, source[:-3] + "_stamped.cu")
    with open(path, "w") as f:
        f.write(text)
    with open(os.path.join(out_dir, "beam_select.cuh"), "w") as f:
        f.write(header)
    subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", src, "-o", path[:-3] + ".so", path],
                   check=True)
    lib = ctypes.CDLL(path[:-3] + ".so")
    kernel._load()
    fn = getattr(lib, kernel.symbol)
    fn.argtypes, fn.restype = kernel._argtypes, ctypes.c_int
    kernel._fn = fn
    return lib


def _read_stamps(lib, launch, phases):
    """Each phase's and each first selection step's us over 5 launches after
    a warm-up (medians)."""
    per_phase, steps = [], []
    for _ in range(6):
        launch()
        torch.cuda.synchronize()
        a, b = (ctypes.c_ulonglong * 64)(), (ctypes.c_ulonglong * 4096)()
        lib.stamps_read(a, b)
        per_phase.append(np.diff(np.array(a[:phases + 1], np.float64)))
        steps.append(np.diff(np.array(b[:64], np.float64)))
    return {"us_per_phase": (np.median(per_phase[1:], 0) / 1e3).round(2).tolist(),
            "us_per_barrier_step (the first selections)":
                (np.median(steps[1:], 0) / 1e3).round(2).tolist()}


def stamps(dev):
    lib = _stamped_kernel("bnb_2d.cu", bnb_2d._DESCENT)
    fc = ConstraintBuilderOptions().fast_correlative_scan_matcher
    params = bnb_2d.FastCorrelativeMatcherParams2D(
        fc.linear_search_window, fc.angular_search_window, fc.branch_and_bound_depth,
        fc.beam_width, fc.max_scan_range)
    pairs, out = _pairs(dev, 8), {}
    for size in (1, 8):
        g = pairs[:size]
        d = bnb_2d.descent_inputs([p[0] for p in g], [p[1] for p in g],
                                  torch.stack([p[2] for p in g]), torch.stack([p[3] for p in g]),
                                  torch.stack([p[4] for p in g]), params,
                                  [params.linear_search_window] * size)
        out[f"group of {size} (score, select, ... by level from the top)"] = _read_stamps(
            lib, lambda: bnb_2d.descent_launch(d, params.beam_width, 0.0),
            2 * params.branch_and_bound_depth - 1)
    return out


def _pairs_3d(dev, count=64):
    """The 3D global run of `chip_smoke.py` phase 7 (700 scans of the hall)
    through TREE's `MapBuilder`: (its constraint builder, its first `count`
    local requests, its summary)."""
    from cartographer_tpu_torch.core.config import MapBuilderOptions, TrajectoryBuilderOptions
    from cartographer_tpu_torch.mapping.map_builder import MapBuilder

    events, _ = cs._events_3d(cs.GLOBAL_SCANS_3D)
    mb = MapBuilder(MapBuilderOptions(use_trajectory_builder_3d=True), device=dev)
    pg = mb.pose_graph
    cb = pg.constraint_builder
    recorded, compute = [], cb.compute_constraints

    def recording(requests):
        recorded.extend(r for r in requests[:count - len(recorded)] if not r.match_full)
        return compute(requests)

    cb.compute_constraints = recording
    tid = mb.add_trajectory_builder(["points", "imu"], TrajectoryBuilderOptions())
    cuda.reset_launch_counts()
    for imus, scan in events:
        for message in imus:
            mb.add_sensor_data(tid, "imu", message)
        mb.add_sensor_data(tid, "points", scan)
    mb.finish_trajectory(tid)
    pg.run_final_optimization()
    torch.cuda.synchronize()
    cb.compute_constraints = compute
    summary = {"match_seconds": cb.match_seconds, "pairs_tried": cb.pairs_matched,
               "match_ms_per_pair": cb.match_seconds * 1e3 / max(cb.pairs_matched, 1),
               "loop_closures": pg.num_inter_constraints(), "solves": pg.solves,
               "launches": {k: v for k, v in cuda.launch_counts().items() if v}}
    return cb, recorded, summary


def _group_call(cb, group):
    """One call of TREE's search on the group: its batched entry point, or a
    loop of the one-pair search. -> (fn, batched)."""
    from cartographer_tpu_torch.ops import bnb_3d

    if not hasattr(bnb_3d, "fast_correlative_match_3d_batch"):
        args = [cs._pair_args(cb, r) for r in group]
        return (lambda: [bnb_3d.fast_correlative_match_3d(*a) for a in args]), False
    hp, hm, lp, lm, hist, init = cb._clouds(group)
    ms = [r.matcher for r in group]
    gargs = ([m.stack for m in ms], [m.high_grid for m in ms], [m.low_grid for m in ms], hp, hm,
             lp, lm, hist, [m.histogram for m in ms], init[:, 0:3], init[:, 3:7], cb.bnb_params,
             cb._options.min_score)
    lows = [m.low_probability for m in ms]
    return (lambda: bnb_3d.fast_correlative_match_3d_batch(*gargs, low_probabilities=lows)), True


# K15's variants, patched copies of bnb_3d.cu: (name, [(old text, new text)]).
# "a yaw held across 8 candidates": a warp's yaw held in registers across a
# task of up to 8 candidates that share it (a parent's 8 children; at the top
# level 8 consecutive ones), a form measured and dropped (PERF.md).
_K15_HELD = [
    ("  __shared__ int start[2][kMaxPairs + 1];",
     "  __shared__ int first_task[2][kMaxPairs + 1];\n  __shared__ int start[2][kMaxPairs + 1];"),
    ("      start[1][b] = below;\n",
     "      start[1][b] = below;\n      first_task[0][b] = tasks;\n"
     "      first_task[1][b] = below / 8;\n      tasks += (m0 + 7) / 8;\n"),
    ("    int above = 0, below = 0;\n", "    int above = 0, below = 0, tasks = 0;\n"),
    ("    start[1][g.pairs] = below;\n",
     "    start[1][g.pairs] = below;\n    first_task[0][g.pairs] = tasks;\n"
     "    first_task[1][g.pairs] = below / 8;\n"),
    ("      const int* first = start[t == 0 ? 0 : 1];",
     "      const int* first = first_task[t == 0 ? 0 : 1];"),
    ("""        const int j = i - first[b];
        bool alive;
        const int4 c = candidate(g, nxy, nz, b, par, t, h, beam_b, j, alive);
        const float sc = alive ? score(L, cells + (size_t)c.x * g.n, mask, g.n, count, c.y, c.z,
                                       c.w, g.q_scale, g.q_min)
                               : -INFINITY;
        if (lane == 0) __stcg(&items[j], make_uint2(score_key(sc), (unsigned int)j));
""", """        const int task = i - first[b], m0 = start[0][b + 1] - start[0][b];
        int hx[8], hy[8], hz[8];
        unsigned int bits = 0;
        const int r = (g.n + 31) >> 5;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (u < r && lane + 32 * u < g.n && mask[lane + 32 * u]) bits |= 1u << u;
        int yaw = -1;
        for (int q = 0; q < 8; ++q) {
          const int j = t == 0 ? 8 * task + q : q * beam_b + task;
          if (j >= (t == 0 ? m0 : 8 * beam_b)) break;
          bool alive;
          const int4 c = candidate(g, nxy, nz, b, par, t, h, beam_b, j, alive);
          float sc = -INFINITY;
          if (alive && g.n <= kTile) {
            if (c.x != yaw) {
#pragma unroll
              for (int u = 0; u < 8; ++u) {
                const int4 cc = (bits >> u) & 1u ? cells[(size_t)c.x * g.n + lane + 32 * u]
                                                 : make_int4(0, 0, 0, 0);
                hx[u] = cc.x;
                hy[u] = cc.y;
                hz[u] = cc.z;
              }
              yaw = c.x;
            }
            float v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u)
              v[u] = (bits >> u) & 1u ? point_value(L, make_int4(hx[u], hy[u], hz[u], 0), c.y,
                                                    c.z, c.w, g.q_scale, g.q_min) : 0.0f;
            halve(v, r);
            float s = v[0];
            for (int off = 16; off > 0; off >>= 1) s = s + __shfl_down_sync(0xffffffffu, s, off);
            sc = __shfl_sync(0xffffffffu, s, 0) / (float)max(count, 1);
          } else if (alive) {
            sc = score(L, cells + (size_t)c.x * g.n, mask, g.n, count, c.y, c.z, c.w, g.q_scale,
                       g.q_min);
          }
          if (lane == 0) __stcg(&items[j], make_uint2(score_key(sc), (unsigned int)j));
        }
"""),
]
# "halves": the scorer's points k + 32 j and k + 32 (j + 4) loaded and added
# together (the tree's first halving), for fewer live registers.
_K15_TILE = """    const int r = (n + 31) >> 5;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = lane + 32 * j;
      const bool valid = j < r && k < n && mask[k];
      v[j] = valid ? point_value(L, cells[k], ox, oy, oz, q_scale, q_min) : 0.0f;
    }
    halve(v, r);
"""
_K15_HALVES = """    const int r = (n + 31) >> 5;
    if (r == 8) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = lane + 32 * j;
        const bool ma = mask[k] != 0, mb = mask[k + 128] != 0;
        const int4 ca = ma ? cells[k] : make_int4(0, 0, 0, 0);
        const int4 cb = mb ? cells[k + 128] : make_int4(0, 0, 0, 0);
        const float a = ma ? point_value(L, ca, ox, oy, oz, q_scale, q_min) : 0.0f;
        const float b = mb ? point_value(L, cb, ox, oy, oz, q_scale, q_min) : 0.0f;
        v[j] = a + b;
      }
      halve(v, 4);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = lane + 32 * j;
        const bool valid = j < r && k < n && mask[k];
        v[j] = valid ? point_value(L, cells[k], ox, oy, oz, q_scale, q_min) : 0.0f;
      }
      halve(v, r);
    }
"""
_K15_RULE = "    int k = count == 1 ? 2 : 1;\n"
K15_VARIANTS = [("kept", []), ("a yaw held across 8 candidates", _K15_HELD),
                ("halves", [(_K15_TILE, _K15_HALVES)]),
                ("clusters of 4", [(_K15_RULE, "    int k = 2;\n")]),
                ("clusters of 1", [(_K15_RULE, "    int k = 0;\n")])]


def variants3d(dev):
    """K15's variants, each a patched copy of TREE's bnb_3d.cu built into
    csrc/_build/variant/: device ms per pair at groups of 1, 8 and 64 of
    the 3D global run's local pairs, every group's rows against the kept
    kernel's."""
    from cartographer_tpu_torch.ops import bnb_3d

    src = os.path.join(TREE, "cartographer_tpu_torch", "csrc")
    with open(os.path.join(src, "bnb_3d.cu")) as f:
        text = f.read()
    out_dir = os.path.join(src, "_build", "variant")
    os.makedirs(out_dir, exist_ok=True)
    builds = []
    for k, (name, patches) in enumerate(K15_VARIANTS):
        variant = text
        for old, new in patches:
            if variant.count(old) != 1:
                return f"variant {name}: its text is not once in TREE's bnb_3d.cu"
            variant = variant.replace(old, new)
        path = os.path.join(out_dir, f"bnb_3d_variant{k}.cu")
        with open(path, "w") as f:
            f.write(variant)
        builds.append((path[:-3] + ".so", subprocess.Popen(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", src, "-o", path[:-3] + ".so", path])))
    for _, proc in builds:
        assert proc.wait() == 0
    cb, pairs, _ = _pairs_3d(dev)
    kernel = bnb_3d._DESCENT
    saved = kernel._load()
    out, kept = {}, {}
    try:
        for (name, _), (lib, _) in zip(K15_VARIANTS, builds):
            fn = getattr(ctypes.CDLL(lib), kernel.symbol)
            fn.argtypes, fn.restype = kernel._argtypes, ctypes.c_int
            kernel._fn = fn
            row = {}
            for size in (1, 8, 64):
                call, _ = _group_call(cb, pairs[:size])
                rows = call()
                if name == "kept":
                    kept[size] = rows
                row[f"group of {size}"] = {
                    "device_ms_per_pair": cs._cuda_ms(call, reps=10 if size < 64 else 3,
                                                      warmup=2) / size,
                    "rows_equal_to_kept": bool(torch.equal(rows, kept[size]))}
            out[name] = row
    finally:
        kernel._fn = saved
    return out


def k15(dev):
    cb, pairs, summary = _pairs_3d(dev)
    out = {"pairs_recorded": len(pairs)}
    for size in (1, 8, 64):
        group = pairs[:size]
        fn, batched = _group_call(cb, group)
        device_ms = cs._cuda_ms(fn, reps=10 if size < 64 else 3, warmup=2)
        event_ms = cs._event_ms(fn, reps=10 if size < 64 else 3, warmup=1)
        try:
            kernels = cs._graph_kernels(fn, f"K15 group of {size}")
        except Exception:  # a search that syncs the host cannot be captured
            kernels = f"{_profiled_kernels(fn)} (profiler)"
        out[f"group of {len(group)}"] = {
            "batched_entry_point": batched,
            "device_ms_per_pair": device_ms / len(group),
            "event_ms_per_pair": event_ms / len(group),
            "device_ms_per_group": device_ms, "event_ms_per_group": event_ms,
            "kernels_per_group": kernels}
    return out


def stamps3d(dev):
    from cartographer_tpu_torch.ops import bnb_3d

    cb, pairs, _ = _pairs_3d(dev, 8)
    lib = _stamped_kernel("bnb_3d.cu", bnb_3d._DESCENT)
    params, out = cb.bnb_params, {}
    for size in (1, 8):
        group = pairs[:size]
        hp, hm, lp, lm, hist, init = cb._clouds(group)
        ms = [r.matcher for r in group]
        searches, clouds = bnb_3d.local_searches(
            [m.stack for m in ms], [m.high_grid for m in ms], [m.low_grid for m in ms], hp, hm,
            lp, lm, hist, [m.histogram for m in ms], init[:, 0:3], init[:, 3:7], params,
            [m.low_probability for m in ms])
        d = bnb_3d.descent_inputs(searches, *clouds)
        out[f"group of {size} (discretize, score, select, ... by level from the top)"] = \
            _read_stamps(lib, lambda: bnb_3d.descent_launch(d, params, cb._options.min_score),
                         2 * params.branch_and_bound_depth)
    return out


def _against_float64(args, kt):
    """K11 and its float32 twin against the twin in float64 on the CPU."""
    xk, _, itk = scan_matcher_3d.lm_match_3d(*args)
    xp, _, itp = scan_matcher_3d._match_plain(*args)
    xd, itd, cost = kt._float64_twin(args)
    return {"iterations": {"kernel": int(itk), "twin": int(itp), "twin_float64": itd},
            "pose_diff_from_float64": {"kernel": float((kt._widened(xk) - xd).abs().max()),
                                       "twin": float((kt._widened(xp) - xd).abs().max())},
            "kernel_from_twin": float((xk - xp).abs().max()),
            "float64_cost_at": {"kernel": cost(xk), "twin": cost(xp), "twin_float64": cost(xd)}}


def parity(dev):
    spec = importlib.util.spec_from_file_location(
        "kernel_tests", os.path.join(HERE, "tests", "test_torch_cuda_kernels.py"))
    kt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kt)
    high, _ = kt._paged_pair(dev, 0.1)
    low, _ = kt._paged_pair(dev, 0.3)
    inten, _ = kt._intensity_pair(dev)
    center = np.float32([0.3, 0.0, 0.0])
    hg, lg, ig = (high.crop_dense(center, 96), low.crop_dense(center, 48),
                  inten.crop_dense(center, 96))
    shift = np.float32([0.313, -0.079, 0.037])
    out = {}
    for nh, nl in ((127, 128), (128, 128), (512, 1024), (2048, 2048)):
        rng = np.random.RandomState(nh + nl)
        hp, hm = kt._hall_scan(rng, shift, nh)
        lp, lm = kt._hall_scan(rng, shift, nl)
        x0 = kt._t(np.float32([0.05, -0.04, 0.02, np.cos(0.01), 0.0, 0.0, np.sin(0.01)]), dev)
        args = (hg, lg, kt._t(hp - shift, dev), kt._t(hm, dev), kt._t(lp - shift, dev),
                kt._t(lm, dev), x0, x0[0:3].clone(),
                scan_matcher_3d.GaussNewtonMatcherParams3D(intensity_weight=0.5), ig,
                kt._t((rng.rand(nh) * 50.0).astype(np.float32), dev))
        out[f"random intensities {nh} + {nl}"] = _against_float64(args, kt)
    out["frontend"] = _against_float64(_frontend_match(dev, False), kt)
    out["full options"] = _against_float64(_frontend_match(dev, True), kt)
    out["ceres"] = _against_float64(_ceres_match(dev), kt)
    return out


def main(label, mode):
    cuda.build()
    dev = torch.device("cuda:0")
    out = {"card": cs._smi(), "tree": TREE}
    if mode == "global":
        out["global"] = global_run(dev)
    elif mode == "global3d":
        out["global3d"] = _pairs_3d(dev, 0)[2]
    elif mode == "k15":
        out["k15"] = k15(dev)
    elif mode == "stamps3d":
        out["stamps3d"] = stamps3d(dev)
    elif mode == "variants3d":
        out["variants3d"] = variants3d(dev)
    elif mode == "stamps":
        out["stamps"] = stamps(dev)
    elif mode == "clusters":
        out["clusters"] = clusters(dev)
    elif mode == "parity":
        out["parity"] = parity(dev)
    else:
        if mode in ("kernels", "k11"):
            out["k11"] = k11(dev)
            print(label, json.dumps(out["k11"]), flush=True)
        if mode in ("kernels", "k7"):
            out["k7"] = k7(dev)
    print(label)
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[3] if len(sys.argv) > 3 else "kernels")
