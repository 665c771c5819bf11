"""Device times of K11 (scan_matcher_3d) and K7 (the 2D branch and bound,
bnb_2d.cu) at the main path's shapes (not collected by pytest).

    python tests/bnb_lm3d_timing.py LABEL [TREE] [k11|k7|global|stamps|clusters|parity]

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


def _stamped(source):
    """bnb_2d.cu with global-timer stamps: after every grid barrier into
    k7_stamps, after every barrier of a selection into k7_sort (block 0)."""
    timer = ("__device__ unsigned long long k7_stamps[64];\n"
             "__device__ unsigned long long k7_sort[4096];\n__device__ int k7_sort_n;\n"
             "__device__ inline unsigned long long now() { unsigned long long t; "
             "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); return t; }\n")
    source = source.replace('#include "halving_fold.cuh"\n',
                            '#include "halving_fold.cuh"\n' + timer, 1)
    source = source.replace(
        "  __shared__ Shared s;\n",
        "  __shared__ Shared s;\n  int stamp = 0;\n  if (blockIdx.x == 0 && threadIdx.x == 0) "
        "{ k7_stamps[stamp++] = now(); k7_sort_n = 0; }\n", 1)
    source = source.replace("grid_sync(g.barrier);", "{ grid_sync(g.barrier); if (blockIdx.x == 0 "
                            "&& threadIdx.x == 0) k7_stamps[stamp++] = now(); }")
    a, e = source.index("__device__ unsigned int block_select("), source.index(
        "// The argmax of the m keys")
    body = source[a:e].replace(
        "__syncthreads();", "__syncthreads(); if (blockIdx.x == 0 && threadIdx.x == 0 && "
        "k7_sort_n < 4000) k7_sort[k7_sort_n++] = now();")
    source = source[:a] + body + source[e:]
    reader = ("extern \"C\" int k7_read(void* a, void* b) { cudaMemcpyFromSymbol(a, k7_stamps, "
              "sizeof(k7_stamps)); return (int)cudaMemcpyFromSymbol(b, k7_sort, sizeof(k7_sort)); }\n")
    return source.replace("}  // namespace\n", "}  // namespace\n" + reader, 1)


def stamps(dev):
    src = os.path.join(TREE, "cartographer_tpu_torch", "csrc")
    out_dir = os.path.join(src, "_build", "variant")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "bnb_2d_stamped.cu")
    with open(os.path.join(src, "bnb_2d.cu")) as f, open(path, "w") as g:
        g.write(_stamped(f.read()))
    subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", src, "-o", path[:-3] + ".so", path],
                   check=True)
    lib = ctypes.CDLL(path[:-3] + ".so")
    kernel = bnb_2d._DESCENT
    kernel._load()
    fn = lib.bnb_descent
    fn.argtypes, fn.restype = kernel._argtypes, ctypes.c_int
    kernel._fn = fn
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
        phases, steps = [], []
        for _ in range(6):
            bnb_2d.descent_launch(d, params.beam_width, 0.0)
            torch.cuda.synchronize()
            a, b = (ctypes.c_ulonglong * 64)(), (ctypes.c_ulonglong * 4096)()
            lib.k7_read(a, b)
            phases.append(np.diff(np.array(a[:2 * params.branch_and_bound_depth], np.float64)))
            steps.append(np.diff(np.array(b[:64], np.float64)))
        out[f"group of {size}"] = {  # the first call warms up
            "us_per_phase (score, select, ... by level from the top)":
                (np.median(phases[1:], 0) / 1e3).round(2).tolist(),
            "us_per_barrier_step (the first selections)":
                (np.median(steps[1:], 0) / 1e3).round(2).tolist()}
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
