"""Device times of K8 (schur_spa_2d) and of K3's LM template (K3, its TSDF
form, K22) at the main path's shapes (not collected by pytest).

    python tests/lm_schur_timing.py LABEL [TREE]

K8 solves `chip_smoke.py`'s synthetic 2D pose graph at the solver's
capacity (S 64, N 4,096, C 16,384): each GPU activity of a one-iteration
call in launch order (the profiler, median over calls) with their sum beside
CUDA events around the same call, the kernels per iteration (captured CUDA
graphs of one and two iterations), 2- and 50-iteration calls by CUDA events,
and a 50-iteration call at the 2D global run's last padded shape (S 16, N 1,024,
C 4,096). Its reduced 192^2 solve alone (where the tree has it: through the
port's entry, and in clusters of 1-8 blocks and at 32-384 rows in 1 and 8
through a harness of this script built on the tree's
`csrc/schur_reduced.cuh`) against `torch.linalg.cholesky_ex` +
`torch.cholesky_solve`, by events.

K3 and K22 refine one simulated scan against a 1,024^2 submap holding the
scan before it, from 0.33 m off: at the frontend's 512 points (20 iterations
at most), at the loop-closure refine's 128 points, and for 16 robots in one
call (512 points each); K3 on the probability grid and on the TSDF score
surface, K22 on the TSDF. K3 and its TSDF form also as the loop-closure
refine runs them (`ConstraintBuilderOptions`' matcher: 10 iterations at
most, 128 points) from 0.33 m, 5 cm and 1 cm off the plain twin's optimum.
Each by the profiler (the window's sum per call, over 200 calls and over
10 as `chip_smoke.py` phase 15 took them before, and the mean of the
kernel's records with their count) and by CUDA events, with its LM
iterations. Where TREE's `scan_matcher_2d.cu` still loads a tap after the
one before (the two-pass form), a copy that issues every tap's loads first
and changes nothing else is built and timed beside it ("loads moved").

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
    TrajectoryBuilder2DOptions,
)
from cartographer_tpu_torch.interop import schur_problem_from_numpy  # noqa: E402
from cartographer_tpu_torch.ops import (  # noqa: E402
    cuda,
    grid_2d,
    scan_matcher_2d,
    scan_pipeline_2d,
    tsdf_2d,
)
from cartographer_tpu_torch.ops.grid_2d import Grid2D  # noqa: E402
from cartographer_tpu_torch.parallel import schur_spa, schur_spa_3d  # noqa: E402
from cartographer_tpu_torch.sensor import voxel_filter  # noqa: E402
from cartographer_tpu_torch.sensor.point_cloud import PointCloud, RangeData  # noqa: E402
from cartographer_tpu_torch.simulation import simulate_scans, synthetic_pose_graph  # noqa: E402
from cartographer_tpu_torch.transform.rigid import Rigid3  # noqa: E402


def _problem(S, N, C, dev):
    arrays, _, _ = synthetic_pose_graph(S, N, C, seed=3)
    problem = schur_problem_from_numpy(arrays, dev)
    wmax = schur_spa.max_weight(problem)
    return schur_spa.normalized(problem, wmax), 10.0 / wmax


CLUSTER_HARNESS = r"""
#include "schur_reduced.cuh"

extern "C" int cholesky_in_cluster(int n, int blocks, float* system, float* zeros,
                                   float* panels, float* x, void* stream) {
  const schur::System sys{n, 1, zeros, zeros + n, system, panels, x};
  return (int)schur::launch_cholesky(sys, blocks, (cudaStream_t)stream);
}
"""


def _cluster_solve():
    """solve(P, b, blocks): P^-1 b by the reduced Cholesky of TREE's
    `csrc/schur_reduced.cuh` in a cluster of `blocks`, built with a harness
    of its own (the port's entry takes the solves' rule), or None where TREE
    has no such header."""
    csrc = os.path.join(TREE, "cartographer_tpu_torch", "csrc")
    if not os.path.exists(os.path.join(csrc, "schur_reduced.cuh")):
        return None
    out_dir = os.path.join(csrc, "_build", "variant")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "cholesky_in_cluster.cu")
    with open(path, "w") as f:
        f.write(CLUSTER_HARNESS)
    lib = path[:-3] + ".so"
    subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", csrc, "-o", lib, path], check=True)
    fn = ctypes.CDLL(lib).cholesky_in_cluster
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int

    def solve(P, b, blocks):
        n = P.shape[0]
        system = torch.cat([-P, b[None]]).contiguous()
        zeros = P.new_zeros(2 * n)
        panels = P.new_empty(16 * 32 * (n + 1))
        x = P.new_empty(n)
        err = fn(n, blocks, system.data_ptr(), zeros.data_ptr(), panels.data_ptr(),
                 x.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"cholesky_in_cluster: CUDA error {err}")
        return x

    return solve


def k8(dev):
    q, hs = _problem(64, 4096, 16384, dev)
    solve = lambda n: schur_spa._solve_kernel(q, n, hs, 1e-6)  # noqa: E731
    steps, counted = cs._launch_breakdown(lambda: solve(1))
    one, two = cs._graph_kernels(lambda: solve(1), "K8"), cs._graph_kernels(lambda: solve(2),
                                                                            "K8")
    g, ghs = _problem(16, 1024, 4096, dev)
    out = {
        "one_iteration": [{"kernel": name, "ms": ms} for name, ms in steps],
        "one_iteration_profiled_calls": counted,
        "one_iteration_sum_ms": sum(ms for _, ms in steps),
        "one_iteration_event_ms": cs._event_ms(lambda: solve(1), reps=5, warmup=1),
        "kernels_per_iteration": two - one, "kernels_first_iteration": one,
        "two_iterations_event_ms": cs._event_ms(lambda: solve(2), reps=5, warmup=1),
        "fifty_iterations_event_ms": cs._event_ms(lambda: solve(50), reps=3, warmup=1),
        "global_shape_fifty_iterations_event_ms": cs._event_ms(
            lambda: schur_spa._solve_kernel(g, 50, ghs, 1e-6), reps=5, warmup=1)}
    n = 192
    spd = torch.randn(n, n, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    spd = spd @ spd.T + n * torch.eye(n, device=dev)
    rhs = torch.randn(n, device=dev)
    out["library_cholesky_solve_event_ms"] = cs._event_ms(
        lambda: torch.cholesky_solve(rhs[:, None], torch.linalg.cholesky_ex(spd)[0]), reps=50)
    alone = getattr(schur_spa, "reduced_cholesky_solve", None)  # absent before the redesign
    if alone is not None:
        out["reduced_solve_event_ms"] = {"in the solve": cs._event_ms(lambda: alone(spd, rhs),
                                                                      reps=50)}
    cluster = _cluster_solve()
    if cluster is not None:
        out["reduced_solve_event_ms"].update({
            f"{blocks} blocks": cs._event_ms(lambda: cluster(spd, rhs, blocks), reps=50)
            for blocks in (1, 2, 4, 8)})
        by_rows = {}  # growth with the panels: a chain per panel, or the trailing update
        for m in (32, 64, 96, 128, 160, 192, 384):
            a = spd[:m, :m].contiguous() if m <= n else None
            if a is None:
                a = torch.randn(m, m, device=dev)
                a = a @ a.T + m * torch.eye(m, device=dev)
            b = torch.randn(m, device=dev)
            by_rows[m] = {f"{blocks} blocks": cs._event_ms(lambda: cluster(a, b, blocks),
                                                           reps=50) for blocks in (1, 8)}
        out["reduced_solve_by_rows_event_ms"] = by_rows
    if hasattr(schur_spa_3d, "reduced_cholesky_solve"):  # K16's own entry, before the header
        out["k16_reduced_solve_event_ms"] = cs._event_ms(
            lambda: schur_spa_3d.reduced_cholesky_solve(spd, rhs), reps=50)
    for name, ms in steps:
        print(f"K8 one iteration: {name} {ms:.4f} ms")
    return out


def _frontend_inputs(dev):
    """(probability grids, TSDF grids, 512-point cloud, 128-point cloud) of
    the default 2D options: the scan before the last inserted into both
    kinds of submap, the last one filtered as the frontend and the
    loop-closure search filter it."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    opts = TrajectoryBuilder2DOptions()
    n, size, samples = opts.tpu.scan_capacity, opts.tpu.submap_grid_size, opts.tpu.ray_samples
    scans, _ = simulate_scans(12, seed=1)
    pre = scan_pipeline_2d.ScanPreprocessParams2D()
    perm = torch.randperm(n, generator=torch.Generator(device=dev).manual_seed(3), device=dev,
                          dtype=torch.int32)
    clouds = []
    for _, pts, rel in scans[-2:]:
        points = np.zeros((n, 3), np.float32)
        points[:len(pts)] = pts
        times01 = np.zeros(n, np.float32)
        times01[:len(pts)] = (rel - rel.min()) / (rel.max() - rel.min())
        mask = np.zeros(n, bool)
        mask[:len(pts)] = True
        a1 = (t(points), t(times01), t(mask), t(np.zeros((n, 3), np.float32)),
              Rigid3(t(np.float32([0.3, -0.2, 0.0])), t(np.float32([1, 0, 0, 0]))),
              Rigid3(t(np.float32([0.5, -0.1, 0.0])), t(np.float32([1, 0, 0, 0]))),
              t(np.float32([1, 0, 0, 0])), pre)
        hits, _, is_return, _, origin = scan_pipeline_2d.align_scan(*a1)
        keep = voxel_filter.voxel_filter_mask(hits, is_return, pre.voxel_filter_size, perm)
        clouds.append((PointCloud(hits[:, 0:2].contiguous(), keep, torch.zeros(n, device=dev)),
                       origin[0:2]))
    (before, origin), (last, _) = clouds
    rd = RangeData(origin, before, PointCloud(t(np.zeros((n, 2), np.float32)),
                                              t(np.zeros(n, bool)), before.intensities))
    origins = t(np.float32([[-25.6, -25.6], [-24.0, -25.0]]))
    grids = Grid2D(torch.zeros((2, size, size), device=dev),
                   torch.zeros((2, size, size), dtype=torch.bool, device=dev), origins, 0.05)
    active = t(np.array([True, True]))
    yes = torch.ones((), dtype=torch.bool, device=dev)
    grid_2d.insert_into_slots(grids, rd, active, yes, 0.55, 0.49, True, samples)
    tsdf = tsdf_2d.TsdfGrid2D(torch.zeros((2, size, size), device=dev),
                              torch.zeros((2, size, size), device=dev), origins, 0.05)
    tsdf_2d.insert_into_slots_tsdf(tsdf, rd, active, yes, tsdf_2d.TsdfInserterParams())
    fronts = []
    for f, cap in ((opts.adaptive_voxel_filter, opts.tpu.matcher_capacity),
                   (opts.loop_closure_adaptive_voxel_filter, opts.tpu.loop_closure_capacity)):
        fronts.append(voxel_filter.adaptive_voxel_filter(
            last, f.max_length, f.min_num_points, f.max_range, perm).compact(cap))
    gn = opts.ceres_scan_matcher
    params = scan_matcher_2d.GaussNewtonMatcherParams2D(
        gn.occupied_space_weight, gn.translation_weight, gn.rotation_weight,
        gn.max_num_iterations, gn.use_nonmonotonic_steps)
    return grids.slot(0), tsdf.slot(0), fronts, params


def _loads_moved(source):
    """The two-pass form's source with every tap's loads issued first, or
    None where the source is not that form."""
    before = ("  float val = 0.0f, dfx = 0.0f, dfy = 0.0f;\n  for (int di = 0; di < 4; ++di) {")
    call = "      float g = cell_value<kSurface>(p, ii, jj);"
    if before not in source or call not in source:
        return None
    loads = """
template <int kSurface>
__device__ inline void load_taps(const Problem& p, int i0, int j0, float g[16]) {
  float v[16];
  float f[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const size_t idx = (size_t)min(max(i0 + t / 4 - 1, 0), p.size - 1) * p.size +
                       min(max(j0 + t % 4 - 1, 0), p.size - 1);
    v[t] = p.values[idx];
    f[t] = kSurface == kOccupancy ? (float)((const uint8_t*)p.flags)[idx]
           : kSurface == kTsdfScore ? ((const float*)p.flags)[idx] : 1.0f;
  }
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    if (kSurface == kOccupancy) g[t] = f[t] != 0.0f ? 1.0f / (1.0f + expf(-v[t])) : 0.1f;
    else if (kSurface == kTsdfScore) g[t] = f[t] > 0.0f ? 1.0f - fabsf(v[t]) / p.truncation
                                                        : 0.0f;
    else g[t] = v[t];
  }
}
"""
    anchor = "__device__ inline void catmull_rom"
    source = source.replace(anchor, loads + "\n" + anchor, 1)
    source = source.replace(before, "  float taps[16];\n  load_taps<kSurface>(p, i0, j0, taps);\n"
                            + before, 1)
    return source.replace(call, "      float g = taps[4 * di + dj];", 1)


def _build_loads_moved():
    """{symbol: loaded function} of the loads-moved copy, or None."""
    src = os.path.join(TREE, "cartographer_tpu_torch", "csrc", "scan_matcher_2d.cu")
    with open(src) as f:
        text = _loads_moved(f.read())
    if text is None:
        return None
    out_dir = os.path.join(TREE, "cartographer_tpu_torch", "csrc", "_build", "variant")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "scan_matcher_2d_loads_moved.cu")
    with open(path, "w") as f:
        f.write(text)
    lib = path[:-3] + ".so"
    subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-o", lib, path], check=True)
    return ctypes.CDLL(lib)


class _Swap:
    """Points the wrappers' K3-template kernels at another library's
    functions for the duration of a `with`."""

    def __init__(self, lib):
        self.kernels = [scan_matcher_2d._KERNELS["occupancy"], scan_matcher_2d._KERNELS["tsdf"],
                        tsdf_2d._LM]
        self.lib = lib

    def __enter__(self):
        self.saved = [k._load() for k in self.kernels]
        for k in self.kernels:
            fn = getattr(self.lib, k.symbol)
            fn.argtypes, fn.restype = k._argtypes, ctypes.c_int
            k._fn = fn

    def __exit__(self, *exc):
        for k, fn in zip(self.kernels, self.saved):
            k._fn = fn


def k3(dev):
    grid, tsdf, (c512, c128), params = _frontend_inputs(dev)
    x0 = torch.tensor([0.33, 0.02, 0.01], device=dev)
    robots = 16
    x16 = x0 + torch.tensor([[0.01 * r, -0.005 * r, 0.001 * r] for r in range(robots)],
                            device=dev)
    p16 = torch.stack([c512.points] * robots)
    m16 = torch.stack([c512.mask] * robots)
    surfaces = {"K3": (scan_matcher_2d.lm_match_2d, grid),
                "K3 TSDF form": (scan_matcher_2d.lm_match_2d, tsdf),
                "K22": (tsdf_2d.lm_match_tsdf_2d, tsdf)}
    calls = {}
    for name, (fn, g) in surfaces.items():
        calls[f"{name} 512 points"] = lambda fn=fn, g=g: fn(g, c512.points, c512.mask, x0,
                                                            x0[0:2], params)
        calls[f"{name} 128 points"] = lambda fn=fn, g=g: fn(g, c128.points, c128.mask, x0,
                                                            x0[0:2], params)
        calls[f"{name} 16 robots"] = lambda fn=fn, g=g: fn([g] * robots, p16, m16, x16,
                                                           x16[:, 0:2], params)

    lc = ConstraintBuilderOptions().ceres_scan_matcher
    refine = scan_matcher_2d.GaussNewtonMatcherParams2D(
        lc.occupied_space_weight, lc.translation_weight, lc.rotation_weight,
        lc.max_num_iterations, lc.use_nonmonotonic_steps)
    for name, g in (("K3", grid), ("K3 TSDF form", tsdf)):
        best = scan_matcher_2d._match_plain(g, c128.points, c128.mask, x0, x0[0:2], params)[0]
        for label, start in (("0.33 m", x0), ("5 cm", best + torch.tensor([0.04, -0.03, 0.005],
                                                                            device=dev)),
                             ("1 cm", best + torch.tensor([0.008, -0.006, 0.001], device=dev))):
            calls[f"{name} refine from {label}"] = (
                lambda g=g, s=start: scan_matcher_2d.lm_match_2d(g, c128.points, c128.mask, s,
                                                                 s[0:2], refine))

    def timed(fn):
        it = fn()[2]
        kernel_ms, records = cs._kernel_ms(fn, "scan_matcher_2d_kernel", reps=200)
        return {"profiler_ms": cs._cuda_ms(fn, reps=200),
                "profiler_ms_10_calls": cs._cuda_ms(fn, reps=10),
                "kernel_record_ms": kernel_ms, "kernel_records_of_200": records,
                "event_ms": cs._event_ms(fn, reps=200), "iterations": it.cpu().tolist()}

    out = {name: timed(fn) for name, fn in calls.items()}
    lib = _build_loads_moved()
    if lib is not None:
        with _Swap(lib):
            out["loads moved"] = {name: timed(fn) for name, fn in calls.items()}
    return out


def main(label):
    cuda.build(["schur_spa_2d.cu", "schur_spa_3d.cu", "scan_matcher_2d.cu", "tsdf_2d.cu",
                "insert_2d.cu", "voxel_filter.cu", "scan_preprocess_2d.cu"])
    dev = torch.device("cuda:0")
    out = {"card": cs._smi(), "tree": TREE, "k8": k8(dev), "k3": k3(dev)}
    print(label)
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1])
