"""Device times of the 2D step's kernels for one robot, K1-K5 (K5 in both
forms), K20 and K21, at the main path's shapes (the default 2D options:
2,048-point scans, 1,024^2 grids), through the wrappers both the
robot-batched port and its parent have (not collected by pytest).

    python tests/robot_batch_timing.py LABEL [TREE]
    python tests/robot_batch_timing.py tsdf-robots
    python tests/robot_batch_timing.py LABEL TREE robots
    python tests/robot_batch_timing.py LABEL . k4-forms
    python tests/robot_batch_timing.py LABEL TREE k2-k20
    python tests/robot_batch_timing.py LABEL . k2-stamps
    python tests/robot_batch_timing.py LABEL . k2-shapes
    python tests/robot_batch_timing.py LABEL TREE k1k2

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

`robots` times K5 in both forms and K4 the same way at `bench.py`'s shape:
each robot's twelfth scan of `simulate_scans(beams=1024, seed=r, start=4.0
* r)`, its first eleven inserted into both slots of its 512^2 grids at 5 cm
(and of its TSDF grids), the matcher cloud its adaptive filter's first 512
points, the default 2D options. For each R it prints [profiler ms, event
ms] and the kernels a call launches (a captured CUDA graph); with TREE the
parent's package, so one call on the card runs parent, change, change,
parent.

`k4-forms` times K4 as kept (`csrc/insert_2d.cu`: bitmaps, a sweep of the
marked words) beside its list form (a copy of `csrc/insert_2d.cu` patched
by `_LIST_FORM` and built into `csrc/_build/variant/`: each cell appended
to a list by the thread that marks it first, the apply pass walking the
lists) on the same inputs,
at `bench.py`'s shape for 1, 4 and 16 robots and at the main path's (one
robot, 2,048-point capacity, 1,024^2 grids): device ms (profiler), each
form's mark and apply kernels' mean ms, and the cells where each differs
from the twin.

`k2-k20` times K2 (all of a 2D scan's voxel filters, as TREE's step
launches them: one launch where the package has `voxel_filter_masks`, else
the random filter's launch and the adaptive filters' launch) and K20 at
the main path's shape (one robot, 2,048-point capacity, the default
filters) and at `bench.py`'s (R = 1, 4, 8 and 16 robots' 1,024-beam
scans): profiler ms, CUDA-event ms and kernels a call in a captured graph
for each. Where the package has the fused entry point it also times the
two forms side by side (one launch of three filters, or the random
filter's launch and then the adaptive filters'). Run parent, change,
change, parent in one call.

`... LABEL . k2-stamps` builds a copy of `csrc/voxel_filter.cu` stamping
the global timer at the kernel's start, after the loads, the random
filter, the range gate, phase A's counts and barrier, phase B's last
round's counts and its barrier and phase C (the first 16 blocks of each
filter's grid) into `csrc/_build/variant/` and prints each phase's
microseconds and how many dependent cluster phases ran (A, each round of
B, C), at the main path's shape and at bench R = 8 and 16.

`... LABEL . k2-shapes` builds a copy of `csrc/voxel_filter.cu` whose
launch shape can be forced (`k2_force`) into `csrc/_build/variant/` and
times, at the main path's shape and at bench R = 1, 4, 8 and 16, the
shape the kernel chooses and every shape it can choose (clusters of 16 x
1,024, 8 x 1,024, 8 x 512, 4 x 1,024 and 4 x 512 threads) with phase B in
one round and in two: profiler ms, masks checked against the kernel's.

`k1k2` times K1 and K2 as TREE's 2D step launches them (the parent: K1's
launch, then K2's; since K1 moved into K2's launch: `scan_filter_2d`) at the
main path's shape (one robot's 1,081-beam scan padded to 2,048 points, the
default filters) and at `bench.py`'s (R = 1, 4, 8 and 16 robots' 1,024-beam
scans), their inputs rows of one upload as the step lays them out: profiler
ms, CUDA-event ms and kernels a call in a captured graph, for the two
kernels alone and for the step's entry `preprocess_and_filter_scan_2d` with
its glue; where K1 is in K2's launch also the two launches on the same
inputs. Then the kernels of a captured tick (`device_step`) of 1, 4 and 16
robots at `bench.py`'s shape, at the default options and with the search,
and its device ms. Run parent, change, change, parent in one call.
"""

import ctypes
import json
import os
import subprocess
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
    a5t = (tsdf.slot(0), *a5[1:])
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
        # After K21's timing: the TSDF grids hold the scan.
        "K5 correlative_2d_tsdf": lambda: correlative_2d.real_time_correlative_match(*a5t),
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


def _bench_robots(dev, count):
    """`count` robots at bench.py's shape: their scans (RangeData with a
    leading R), grids and K4 scratches, TSDF grids, matcher clouds and
    start poses."""
    from cartographer_tpu_torch.simulation import relative_to_first

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    opts = TrajectoryBuilder2DOptions()
    n, size, m = 1024, 512, 512
    f = opts.adaptive_voxel_filter
    params = tsdf_2d.TsdfInserterParams()
    one = torch.ones((1, 2), dtype=torch.bool, device=dev)
    yes = torch.ones(1, dtype=torch.bool, device=dev)
    out = dict(rds=[], grids=[], scratch=[], tsdf=[], points=[], mask=[], x0=[])
    for r in range(count):
        scans, truth = simulate_scans(12, beams=n, seed=r, start=4.0 * r)
        rel = relative_to_first(truth)
        origins = t(np.float32([[-12.8, -12.8], [-12.0, -12.5]]))
        grids = Grid2D(torch.zeros((2, size, size), device=dev),
                       torch.zeros((2, size, size), dtype=torch.bool, device=dev), origins, 0.05)
        tsdf = tsdf_2d.TsdfGrid2D(torch.zeros((2, size, size), device=dev),
                                  torch.zeros((2, size, size), device=dev), origins.clone(),
                                  0.05)
        scratch = grid_2d.InsertScratch.create(2, size, dev)
        for i, (_, pts, _) in enumerate(scans):
            c, s = np.cos(rel[i, 2]), np.sin(rel[i, 2])
            xy = pts[:, 0:2] @ np.float32([[c, s], [-s, c]]) + rel[i, 0:2]
            ranges = np.linalg.norm(pts[:, 0:2], axis=1)
            hit = ranges <= opts.max_range
            miss = rel[i, 0:2] + (xy - rel[i, 0:2]) * (5.0 / np.maximum(ranges, 1e-6))[:, None]
            z = torch.zeros((1, n), device=dev)
            rd = RangeData(t(rel[None, i, 0:2].astype(np.float32)),
                           PointCloud(t(xy[None].astype(np.float32)), t(hit[None]), z),
                           PointCloud(t(miss[None].astype(np.float32)), t(~hit[None]), z))
            if i == len(scans) - 1:
                break
            grid_2d.insert_into_slots([grids], rd, one, yes, 0.55, 0.49, True,
                                      opts.tpu.ray_samples, [scratch])
            normals = tsdf_2d.estimate_normals_2d(rd.returns.points, rd.returns.mask,
                                                  rd.origin)
            tsdf_2d.insert_into_slots_tsdf([tsdf], rd, one, yes, params, normals=normals)
        perm = torch.randperm(n, generator=torch.Generator(device=dev).manual_seed(r),
                              device=dev, dtype=torch.int32)
        sensor = PointCloud(t(pts[:, 0:2]), t(hit), torch.zeros(n, device=dev))
        cloud = voxel_filter.adaptive_voxel_filter(sensor, f.max_length, f.min_num_points,
                                                   f.max_range, perm).compact(m)
        out["rds"].append(rd)
        out["grids"].append(grids)
        out["scratch"].append(scratch)
        out["tsdf"].append(tsdf)
        out["points"].append(cloud.points)
        out["mask"].append(cloud.mask)
        out["x0"].append(t((rel[-1] + np.float32([0.03, -0.02, 0.01])).astype(np.float32)))
    return out


def robots_of(label):
    """K5 in both forms and K4 for R robots at bench.py's shape."""
    cuda.build()
    dev = torch.device("cuda:0")
    opts = TrajectoryBuilder2DOptions()
    corr = opts.real_time_correlative_scan_matcher
    cparams = correlative_2d.CorrelativeSearchParams(
        corr.linear_search_window, corr.angular_search_window,
        corr.translation_delta_cost_weight, corr.rotation_delta_cost_weight, opts.max_range)
    b = _bench_robots(dev, 16)
    out = {"card": cs._smi(), "tree": TREE}
    for robots in (1, 4, 16):
        rd = RangeData(torch.cat([x.origin for x in b["rds"][:robots]]),
                       PointCloud(torch.cat([x.returns.points for x in b["rds"][:robots]]),
                                  torch.cat([x.returns.mask for x in b["rds"][:robots]]),
                                  torch.cat([x.returns.intensities
                                             for x in b["rds"][:robots]])),
                       PointCloud(torch.cat([x.misses.points for x in b["rds"][:robots]]),
                                  torch.cat([x.misses.mask for x in b["rds"][:robots]]),
                                  torch.cat([x.misses.intensities
                                             for x in b["rds"][:robots]])))
        pts = torch.stack(b["points"][:robots])
        mask = torch.stack(b["mask"][:robots])
        x0 = torch.stack(b["x0"][:robots])
        active = torch.ones((robots, 2), dtype=torch.bool, device=dev)
        yes = torch.ones(robots, dtype=torch.bool, device=dev)
        occupancy = [g.slot(0) for g in b["grids"][:robots]]
        tsdf = [g.slot(0) for g in b["tsdf"][:robots]]
        calls = {
            "K5 correlative_2d": lambda: correlative_2d.correlative_match(
                occupancy, pts, mask, x0, cparams),
            "K5 correlative_2d_tsdf": lambda: correlative_2d.correlative_match(
                tsdf, pts, mask, x0, cparams),
            "K4 insert_2d": lambda: grid_2d.insert_into_slots(
                b["grids"][:robots], rd, active, yes, 0.55, 0.49, True, opts.tpu.ray_samples,
                b["scratch"][:robots]),
        }
        out[robots] = {k: [cs._cuda_ms(fn, reps=200), cs._event_ms(fn, reps=200),
                           cs._graph_kernels(fn, k)] for k, fn in calls.items()}
        best, scores = calls["K5 correlative_2d"]()
        out[robots]["K5 angles inside"] = int(torch.isfinite(scores[..., 0, 0]).sum())
        print(label, robots, json.dumps(out[robots]), flush=True)
    print(label)
    print(json.dumps(out))


# K4's list form, as patches of csrc/insert_2d.cu: (start, end, new) puts
# `new` in place of the text from `start` up to `end`; (old, new) replaces
# `old`. The mark pass's atomicOrs return: the thread whose atomicOr sets a
# cell's first bit appends the cell to its (robot, slot)'s list, one
# atomicAdd a warp, two slots' atomics in flight together. The apply pass
# walks only the lists (their lengths read from device memory), taking and
# clearing each cell's bits by one atomicAnd; the last block of a list
# clears its length. The pointer table's rows gain the lists (size^2 int32
# a slot) and their state (4 int32 a slot: length, blocks done, last
# length, unused).
_LIST_FORM = [
    ("constexpr uint32_t kHit = 1u, kFree = 2u;\n",
     "constexpr uint32_t kHit = 1u, kFree = 2u;\n"
     "constexpr int kApplyBlocks = 1056;  // the apply pass's blocks over all lists: 8 an SM\n"
     "constexpr int kApplyBatch = 4;      // listed cells a thread takes at once\n"),
    ("  uint32_t* bits[kMaxRobots];\n};",
     "  uint32_t* bits[kMaxRobots];\n  int* cells[kMaxRobots];\n  int* lists[kMaxRobots];\n};"),
    ("  for (int slot = 0; slot < slots; ++slot) {\n    if (!active[slot])",
     "// A thread per bitmap word", """  constexpr int kMarks = kRun + 1;  // the samples' free marks, then the hit mark
  for (int s0 = 0; s0 < slots; s0 += 2) {
    // The cells to mark, -1 for none.
    int cell[2][kMarks];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int slot = s0 + j;
      const bool on_slot = slot < slots && active[slot];  // the same for every lane
      const float* g = grids.origins[r] + 2 * (on_slot ? slot : 0);
#pragma unroll
      for (int i = 0; i < kRun; ++i)
        cell[j][i] = on_slot && on[i] ? cell_of(g, resolution, size, sx[i], sy[i]) : -1;
      int prev = __shfl_up_sync(0xffffffffu, cell[j][kRun - 1], 1);
      if (first) prev = -1;
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        const int c = cell[j][i];
        if (c == prev) cell[j][i] = -1;
        prev = c;
      }
      cell[j][kRun] = on_slot && hit ? cell_of(g, resolution, size, px, py) : -1;
    }
    // The atomics together, then their results.
    bool add[2][kMarks];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < kMarks; ++i) {
        const int c = cell[j][i];
        const uint32_t bit = c >= 0 ? (i == kRun ? kHit : kFree) << (2 * (c & 15)) : 0u;
        uint32_t old = 3u << (2 * (c & 15));
        if (c >= 0) old = atomicOr(grids.bits[r] + (s0 + j) * words + (c >> 4), bit);
        add[j][i] = c >= 0 && ((old >> (2 * (c & 15))) & 3u) == 0u;
      }
    // One atomicAdd a warp and slot: the lanes' offsets by an inclusive scan.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      int mine = 0;
#pragma unroll
      for (int i = 0; i < kMarks; ++i) mine += add[j][i] ? 1 : 0;
      int scan = mine;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, scan, off);
        if (lane >= off) scan += v;
      }
      const int total = __shfl_sync(0xffffffffu, scan, 31);
      if (total == 0) continue;  // the same for every lane
      const int slot = s0 + j;
      int base = 0;
      if (lane == 31) base = atomicAdd(grids.lists[r] + 4 * slot, total);
      base = __shfl_sync(0xffffffffu, base, 31) + scan - mine;
      int* cells = grids.cells[r] + (size_t)slot * size * size;
#pragma unroll
      for (int i = 0; i < kMarks; ++i)
        if (add[j][i]) cells[base++] = cell[j][i];
    }
  }
}

"""),
    ("  const size_t words = (cells + 15) / 16;\n  const size_t w =", "}  // namespace",
     """  float* __restrict__ log_odds = grids.log_odds[r] + slot * cells;
  uint8_t* __restrict__ known = grids.known[r] + slot * cells;
  uint32_t* bits = grids.bits[r] + (size_t)slot * ((cells + 15) / 16);
  const int* __restrict__ listed = grids.cells[r] + slot * cells;
  int* list = grids.lists[r] + 4 * slot;
  const int length = list[0];
  const int stride = gridDim.x * blockDim.x;
  for (int i0 = blockIdx.x * blockDim.x + threadIdx.x; i0 < length;
       i0 += kApplyBatch * stride) {
    int lin[kApplyBatch];
#pragma unroll
    for (int b = 0; b < kApplyBatch; ++b) {
      const int i = i0 + b * stride;
      lin[b] = i < length ? listed[i] : -1;
    }
    uint32_t two[kApplyBatch];
    float lo[kApplyBatch];
    uint8_t kn[kApplyBatch];
#pragma unroll
    for (int b = 0; b < kApplyBatch; ++b) {
      if (lin[b] < 0) continue;
      const int shift = 2 * (lin[b] & 15);
      two[b] = (atomicAnd(bits + (lin[b] >> 4), ~(3u << shift)) >> shift) & 3u;
      lo[b] = log_odds[lin[b]];
      kn[b] = known[lin[b]];
    }
#pragma unroll
    for (int b = 0; b < kApplyBatch; ++b) {
      if (lin[b] < 0) continue;
      const bool hit = (two[b] & kHit) != 0u;
      const bool fre = (two[b] & kFree) != 0u && !hit;
      float updated = (lo[b] + (hit ? hit_log_odds : 0.0f)) + (fre ? miss_log_odds : 0.0f);
      updated = fminf(fmaxf(updated, min_log_odds), max_log_odds);
      if (updated != lo[b]) log_odds[lin[b]] = updated;
      if (!kn[b]) known[lin[b]] = 1;
    }
  }
  // Every block read the length before it counts itself done: the last one
  // clears it for the next scan.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(list + 1, 1) == (int)gridDim.x - 1) {
      list[2] = length;
      list[0] = 0;
      list[1] = 0;
    }
  }
}

"""),
    ('extern "C" int insert_2d(', 'extern "C" int insert_2d_lists('),
    ("grids + 4 * (r0 + r)", "grids + 6 * (r0 + r)"),
    ("      g.bits[r] = (uint32_t*)row[3];\n",
     "      g.bits[r] = (uint32_t*)row[3];\n      g.cells[r] = (int*)row[4];\n"
     "      g.lists[r] = (int*)row[5];\n"),
    ("    const dim3 apply_grid((unsigned)((words + kThreads - 1) / kThreads), slots, count);\n",
     "    const long long most = ((long long)size * size + kThreads - 1) / kThreads;\n"
     "    long long per = kApplyBlocks / (count * slots);\n"
     "    per = per < 1 ? 1 : per > most ? most : per;\n"
     "    const dim3 apply_grid((unsigned)per, slots, count);\n"),
]


def _list_form(text):
    """csrc/insert_2d.cu's text patched into K4's list form."""
    for patch in _LIST_FORM:
        if len(patch) == 2:
            old, new = patch
            assert text.count(old) == 1, old
            text = text.replace(old, new)
        else:
            begin, end, new = patch
            assert text.count(begin) == 1 and text.count(end) == 1, begin
            i, j = text.index(begin), text.index(end)
            text = text[:i] + new + text[j:]
    return text


def k4_forms(label):
    """K4 as kept beside its list form."""
    import ctypes
    import subprocess

    from cartographer_tpu_torch.ops.probability import (
        MAX_LOG_ODDS,
        MIN_LOG_ODDS,
        probability_to_log_odds,
    )

    cuda.build()
    dev = torch.device("cuda:0")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    out_dir = cuda.BUILD_DIR / "variant"
    out_dir.mkdir(parents=True, exist_ok=True)
    source, lib = out_dir / "insert_2d_lists.cu", out_dir / "libinsert_2d_lists.so"
    source.write_text(_list_form((cuda.CSRC_DIR / "insert_2d.cu").read_text()))
    subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-o", str(lib), str(source)], check=True)
    lists_fn = ctypes.CDLL(str(lib)).insert_2d_lists
    lists_fn.argtypes = grid_2d._KERNEL._argtypes
    lists_fn.restype = ctypes.c_int
    hit_lo, miss_lo = probability_to_log_odds(0.55), probability_to_log_odds(0.49)
    samples = TrajectoryBuilder2DOptions().tpu.ray_samples

    def batch(rds):
        cat = lambda f: torch.cat([f(x) for x in rds])  # noqa: E731
        return RangeData(cat(lambda x: x.origin),
                         PointCloud(cat(lambda x: x.returns.points),
                                    cat(lambda x: x.returns.mask),
                                    cat(lambda x: x.returns.intensities)),
                         PointCloud(cat(lambda x: x.misses.points),
                                    cat(lambda x: x.misses.mask),
                                    cat(lambda x: x.misses.intensities)))

    b = _bench_robots(dev, 16)
    cases = {f"bench R = {r}": (b["grids"][:r], batch(b["rds"][:r])) for r in (1, 4, 16)}
    scans, _ = simulate_scans(12, seed=1)
    pts = scans[-1][1][:, 0:2]
    n = TrajectoryBuilder2DOptions().tpu.scan_capacity
    ret = np.zeros((n, 2), np.float32)
    ret[:len(pts)] = pts
    ranges = np.linalg.norm(ret, axis=1)
    live = np.arange(n) < len(pts)
    z = torch.zeros((1, n), device=dev)
    size = TrajectoryBuilder2DOptions().tpu.submap_grid_size
    cases["main path"] = (
        [Grid2D(torch.zeros((2, size, size), device=dev),
                torch.zeros((2, size, size), dtype=torch.bool, device=dev),
                t(np.float32([[-25.6, -25.6], [-24.0, -25.0]])), 0.05)],
        RangeData(t(np.float32([[0.3, -0.2]])),
                  PointCloud(t(ret[None]), t((live & (ranges <= 30.0))[None]), z),
                  PointCloud(t((ret * (5.0 / np.maximum(ranges, 1e-6))[:, None])[None]),
                             t((live & (ranges > 30.0))[None]), z)))
    out = {"card": cs._smi()}
    for name, (grids, rd) in cases.items():
        robots, size = len(grids), grids[0].size
        active = torch.ones((robots, 2), dtype=torch.bool, device=dev)
        yes = torch.ones(robots, dtype=torch.bool, device=dev)
        scratch = [grid_2d.InsertScratch.create(2, size, dev) for _ in grids]
        state = [(torch.zeros((2, (size * size + 15) // 16), dtype=torch.int32, device=dev),
                  torch.empty((2, size * size), dtype=torch.int32, device=dev),
                  torch.zeros((2, 4), dtype=torch.int32, device=dev)) for _ in grids]
        table = cuda.pointer_table([(g.log_odds, g.known, g.origin, *st)
                                    for g, st in zip(grids, state)])
        inputs = ((rd.returns.points, (rd.returns.points.shape[1], 2)),
                  (rd.returns.mask, (rd.returns.points.shape[1],)),
                  (rd.misses.points, (rd.returns.points.shape[1], 2)),
                  (rd.misses.mask, (rd.returns.points.shape[1],)), (rd.origin, (2,)),
                  (active, (2,)), (yes, ()))
        strides = np.array([cuda.robot_stride(x, "input", x.dtype, inner, robots)
                            for x, inner in inputs], np.int64)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def lists():
            assert lists_fn(table, robots, *(x.data_ptr() for x, _ in inputs[:4]),
                            rd.returns.points.shape[1], rd.origin.data_ptr(),
                            active.data_ptr(), yes.data_ptr(), strides.ctypes.data, 0.05,
                            size, samples, 1, 2, hit_lo, miss_lo, MIN_LOG_ODDS, MAX_LOG_ODDS,
                            stream) == 0

        kept = lambda: grid_2d.insert_into_slots(  # noqa: E731
            grids, rd, active, yes, 0.55, 0.49, True, samples, scratch)
        row = {}
        for form, fn in (("kept", kept), ("lists", lists)):
            before = [g.clone() for g in grids]
            fn()
            differ = 0
            for r, g in enumerate(before):
                grid_2d._insert_plain(g, rd.robot(r), active[r], yes[r], hit_lo, miss_lo,
                                      True, samples)
                differ += int(((grids[r].log_odds - g.log_odds).abs() > 1e-6).sum()
                              + (grids[r].known != g.known).sum())
            row[form] = {"ms": cs._cuda_ms(fn, reps=200),
                         "mark_ms": cs._kernel_ms(fn, "mark_kernel", reps=100)[0],
                         "apply_ms": cs._kernel_ms(fn, "apply_kernel", reps=100)[0],
                         "cells_apart_from_twin": differ}
        out[name] = row
        print(label, name, json.dumps(row), flush=True)
    print(label)
    print(json.dumps(out))


def _k2_inputs(dev, robots, n):
    """R robots' 2D-step K2 inputs at bench.py's shape: each robot's
    twelfth scan of `simulate_scans(beams=n, seed=r, start=4.0 * r)` as 3D
    hits, its returns within the default max_range, a permutation."""
    opts = TrajectoryBuilder2DOptions()
    hits, ret, perms = [], [], []
    for r in range(robots):
        scans, _ = simulate_scans(12, beams=n, seed=r, start=4.0 * r)
        p = np.zeros((n, 3), np.float32)
        p[:, :scans[-1][1].shape[1]] = scans[-1][1][:n]
        hits.append(p)
        ret.append(np.linalg.norm(p[:, 0:2], axis=1) <= opts.max_range)
        perms.append(np.random.RandomState(r).permutation(n).astype(np.int32))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return t(np.stack(hits)), t(np.stack(ret)), t(np.stack(perms))


def _k2_call(hits, is_return, perm, filters):
    """A 2D scan's voxel filters as the tree's step launches them."""
    size = scan_pipeline_2d.ScanPreprocessParams2D().voxel_filter_size
    if hasattr(voxel_filter, "voxel_filter_masks"):
        return lambda: voxel_filter.voxel_filter_masks(hits, is_return, size, perm, filters, 2)
    return _k2_two(hits, is_return, perm, filters, size)


_STAMP_AT = [  # (line of voxel_filter.cu, stamp index after it)
    ("  const bool clustered = filters > 0;\n", 0),
    ("  if (clustered) cluster_arrive();\n  __syncthreads();\n", 1),
    ("  if (!clustered) return;\n", 2),
    ("  cg::cluster_group team = cg::this_cluster();  // the counts' exchange\n", 3),
    ("                     min_num_points, totals, counts, team);\n", 4),
    ("  int first_ok = -1;\n", 5),
    ("                         min_num_points, totals, level_counts, team);\n", 6),
    ("      depth += levels;\n", -1),  # a round of phase B: counted in stamp 9
    ("    resolution = low;\n", 7),
    ("  mask_write<kGlobal, Key>(s, c, cluster, slice, false, out);\n", 8),
]
# Each stamp's phase: the time since the stamp before it.
_STAMP_PHASES = ("load", "random filter", "range gate", "phase A counts", "phase A barrier",
                 "phase B counts", "phase B barrier", "phase C")


def _k2_variant(name, text, extra):
    """TREE's csrc/voxel_filter.cu as `text`, with the C functions `extra`
    appended, built into csrc/_build/variant/NAME.so. -> its library, with
    `voxel_filter` typed as K2's wrapper calls it."""
    src = os.path.join(TREE, "cartographer_tpu_torch", "csrc")
    out_dir = os.path.join(src, "_build", "variant")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name + ".cu")
    with open(path, "w") as f:
        f.write(text + extra)
    subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", src, "-o", path[:-3] + ".so", path],
                   check=True)
    lib = ctypes.CDLL(path[:-3] + ".so")
    lib.voxel_filter.argtypes = voxel_filter._KERNEL._argtypes
    lib.voxel_filter.restype = ctypes.c_int
    return lib


def _swap_k2(lib):
    """Swap `lib`'s voxel_filter into K2's wrapper -> a function restoring it."""
    original = voxel_filter._KERNEL._load()
    voxel_filter._KERNEL._fn = lib.voxel_filter
    return lambda: setattr(voxel_filter._KERNEL, "_fn", original)


def _k2_source():
    with open(os.path.join(TREE, "cartographer_tpu_torch", "csrc", "voxel_filter.cu")) as f:
        return f.read()


def _stamped_k2():
    """A copy of TREE's csrc/voxel_filter.cu with global-timer stamps (the
    first 16 blocks of each filter's grid; stamp 9 counts phase B's
    rounds), built into csrc/_build/variant/. -> (its library, a function
    reading the stamps (ns) and clearing them)."""
    text = _k2_source()
    timer = ("__device__ unsigned long long k2_stamps[2][16][10];\n"
             "__device__ inline bool k2_stamper() { return blockIdx.x < 16 && threadIdx.x == 0; }\n"
             "__device__ inline void k2_stamp(int k) { if (k2_stamper()) "
             "{ unsigned long long t; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); "
             "k2_stamps[blockIdx.y][blockIdx.x][k] = t; } }\n"
             "__device__ inline void k2_round() { if (k2_stamper()) "
             "++k2_stamps[blockIdx.y][blockIdx.x][9]; }\n")
    text = text.replace("namespace {\n", "namespace {\n" + timer, 1)
    for line, k in _STAMP_AT:
        assert line in text, line
        mark = "k2_round()" if k < 0 else f"k2_stamp({k})"
        indent = line[:len(line) - len(line.lstrip())]
        text = text.replace(line, line + f"{indent}{mark};\n", 1)
    lib = _k2_variant("voxel_filter_stamped", text, (
        "extern \"C\" int k2_read(void* a) { int e = (int)cudaMemcpyFromSymbol("
        "a, k2_stamps, sizeof(k2_stamps)); static unsigned long long zero[2][16][10]; "
        "cudaMemcpyToSymbol(k2_stamps, zero, sizeof(zero)); return e; }\n"))
    lib.k2_read.argtypes, lib.k2_read.restype = [ctypes.c_void_p], ctypes.c_int

    def read():
        torch.cuda.synchronize()
        a = np.zeros((2, 16, 10), np.uint64)
        assert lib.k2_read(a.ctypes.data) == 0
        return a
    return lib, read


def _phases(stamps, cluster=8):
    """Microseconds of each phase by filter and block (the first `cluster`
    blocks of the grid: robot 0's cluster first), from one call's stamps (a
    phase that did not run is left out), and the dependent cluster phases
    block 0 ran (A, each round of B, C)."""
    out = []
    for rows in stamps:
        if not rows[0][0]:
            continue
        blocks = []
        for row in rows[:cluster]:
            if not row[0]:
                continue
            t, last, phases = row.astype(np.int64), int(row[0]), {}
            for k, name in enumerate(_STAMP_PHASES, start=1):
                if t[k]:
                    phases[name] = (int(t[k]) - last) / 1000.0
                    last = int(t[k])
            blocks.append(phases)
        blocks[0]["cluster phases run"] = int(bool(rows[0][5])) + int(rows[0][9]) + int(
            bool(rows[0][8]))
        out.append(blocks)
    return out


def _forced_k2():
    """A copy of TREE's csrc/voxel_filter.cu whose `choose` returns the
    shape `k2_force(cluster, threads, split)` sets (cluster 0: its own
    choice), built into csrc/_build/variant/."""
    text = _k2_source()
    anchor = "Shape choose(int n, int pre_dim, int filters, int dim, int clusters) {\n"
    struct = "struct Shape {\n  int cluster, threads, split;\n};\n"
    assert anchor in text and struct in text
    text = text.replace(struct, struct + "Shape k2_forced = {0, 0, 0};\n", 1)
    text = text.replace(anchor, anchor + "  if (k2_forced.cluster) return k2_forced;\n", 1)
    lib = _k2_variant("voxel_filter_forced", text, (
        "extern \"C\" void k2_force(int c, int t, int s) { k2_forced = {c, t, s}; }\n"))
    lib.k2_force.argtypes, lib.k2_force.restype = [ctypes.c_int] * 3, None
    return lib


def k2_k20(label):
    """K2 and K20 at the main path's shape and at bench.py's, R = 1, 4, 16."""
    cuda.build()
    dev = torch.device("cuda:0")
    opts = TrajectoryBuilder2DOptions()
    filters = [(f.max_length, f.min_num_points, f.max_range)
               for f in (opts.adaptive_voxel_filter, opts.loop_closure_adaptive_voxel_filter)]
    fused = hasattr(voxel_filter, "voxel_filter_masks")
    size = scan_pipeline_2d.ScanPreprocessParams2D().voxel_filter_size
    out = {"card": cs._smi(), "tree": TREE, "fused": fused}

    def timed(fn, name):
        return [cs._cuda_ms(fn, reps=200), cs._event_ms(fn, reps=200),
                cs._graph_kernels(fn, name)]

    shapes = [("main", 1, opts.tpu.scan_capacity)] + [("bench", r, 1024) for r in (1, 4, 8, 16)]
    for shape, robots, n in shapes:
        hits, ret, perm = _k2_inputs(dev, robots, n)
        if shape == "main":  # one robot's (N, D) form
            hits, ret, perm = hits[0], ret[0], perm[0]
        pts2 = hits[..., 0:2].contiguous()
        origin = torch.zeros((robots, 2), device=dev)[0 if shape == "main" else slice(None)]
        row = {"K2": timed(_k2_call(hits, ret, perm, filters), "K2"),
               "K20": timed(lambda: tsdf_2d.estimate_normals_2d(pts2, ret, origin), "K20")}
        if fused:
            row["K2 two launches"] = timed(_k2_two(hits, ret, perm, filters, size), "K2 two")
        key = f"{shape} R={robots}"
        out[key] = row
        print(label, key, json.dumps(row), flush=True)
    print(label)
    print(json.dumps(out))


def k2_stamps(label):
    """Each of K2's phases in the first 16 blocks of each filter's grid
    (robot 0's cluster first) at the main path's shape and at bench R = 8
    and 16 (the last of 5 calls)."""
    cuda.build()
    dev = torch.device("cuda:0")
    opts = TrajectoryBuilder2DOptions()
    filters = [(f.max_length, f.min_num_points, f.max_range)
               for f in (opts.adaptive_voxel_filter, opts.loop_closure_adaptive_voxel_filter)]
    lib, read = _stamped_k2()
    restore = _swap_k2(lib)
    try:
        for shape, robots, n in (("main", 1, opts.tpu.scan_capacity), ("bench", 8, 1024),
                                 ("bench", 16, 1024)):
            hits, ret, perm = _k2_inputs(dev, robots, n)
            fn = _k2_call(hits, ret, perm, filters)
            for _ in range(5):
                read()
                fn()
                phases = _phases(read(), cluster=16)
            print(label, shape, robots, json.dumps(phases), flush=True)
    finally:
        restore()


def k2_shapes(label):
    """K2 on every launch shape, phase B in one round and in two, beside
    the shape the kernel chooses, at the main path's shape and at bench R =
    1, 4, 8 and 16."""
    cuda.build()
    dev = torch.device("cuda:0")
    opts = TrajectoryBuilder2DOptions()
    filters = [(f.max_length, f.min_num_points, f.max_range)
               for f in (opts.adaptive_voxel_filter, opts.loop_closure_adaptive_voxel_filter)]
    lib = _forced_k2()
    restore = _swap_k2(lib)
    out = {"card": cs._smi()}
    try:
        shapes = [("main", 1, opts.tpu.scan_capacity)] + [("bench", r, 1024)
                                                         for r in (1, 4, 8, 16)]
        for shape, robots, n in shapes:
            hits, ret, perm = _k2_inputs(dev, robots, n)
            if shape == "main":
                hits, ret, perm = hits[0], ret[0], perm[0]
            fn = _k2_call(hits, ret, perm, filters)
            lib.k2_force(0, 0, 0)
            chosen = [m.clone() for m in fn()]
            row = {"chosen": cs._cuda_ms(fn, reps=200)}
            for c, t in ((16, 1024), (8, 1024), (8, 512), (4, 1024), (4, 512)):
                for split in (5, 3):
                    lib.k2_force(c, t, split)
                    same = all(torch.equal(a, b) for a, b in zip(fn(), chosen))
                    row[f"{c}x{t} split {split}"] = [cs._cuda_ms(fn, reps=200), same]
            lib.k2_force(0, 0, 0)
            key = f"{shape} R={robots}"
            out[key] = row
            print(label, key, json.dumps(row), flush=True)
    finally:
        lib.k2_force(0, 0, 0)
        restore()
    print(label)
    print(json.dumps(out))


def _k2_two(hits, is_return, perm, filters, size):
    """K2's two-launch form: the random filter, then both adaptive filters."""
    def two():
        m = voxel_filter.voxel_filter_mask(hits, is_return, size, perm)
        voxel_filter.adaptive_voxel_filter_masks(hits[..., 0:2], m, filters, perm)
    return two


def _k1_rows(dev, robots, n, beams):
    """R robots' K1 inputs as rows of one (R, 8n + 33) upload, as the 2D step
    lays them out: each robot's twelfth scan of `simulate_scans(beams=beams,
    seed=r, start=4.0 * r)` padded to n points, its beams' times, sensor
    origins at zero, a start and an end pose a few centimetres and degrees
    apart, a slight gravity tilt; and a permutation per robot."""
    from cartographer_tpu_torch.mapping import local_trajectory_builder_2d as ltb

    upload = np.zeros((robots, 8 * n + 33), np.float32)
    perms = []
    for r in range(robots):
        scans, _ = simulate_scans(12, beams=beams, seed=r, start=4.0 * r)
        _, pts, rel = scans[-1]
        m = min(len(pts), n)
        upload[r, :3 * m] = pts[:m].reshape(-1)
        upload[r, 6 * n:6 * n + m] = (rel[:m] - rel.min()) / (rel.max() - rel.min())
        upload[r, 7 * n:7 * n + m] = 1.0
        yaw0, yaw1 = 0.1 * r, 0.1 * r + 0.05
        small = upload[r, 8 * n:]
        small[ltb._PS_T] = [0.3 + 0.1 * r, -0.2, 0.0]
        small[ltb._PS_Q] = [np.cos(yaw0 / 2), 0.0, 0.0, np.sin(yaw0 / 2)]
        small[ltb._PE_T] = [0.34 + 0.1 * r, -0.19, 0.0]
        small[ltb._PE_Q] = [np.cos(yaw1 / 2), 0.0, 0.0, np.sin(yaw1 / 2)]
        g = np.float32([1.0, 0.002, -0.001, 0.0])
        small[ltb._GRAVITY] = g / np.linalg.norm(g)
        perms.append(np.random.RandomState(r).permutation(n).astype(np.int32))
    up = torch.from_numpy(upload).to(dev)
    small = up[:, 8 * n:]
    args = (up[:, :3 * n].view(robots, n, 3), up[:, 6 * n:7 * n], up[:, 7 * n:8 * n] > 0.5,
            up[:, 3 * n:6 * n].view(robots, n, 3),
            Rigid3(small[:, ltb._PS_T], small[:, ltb._PS_Q]),
            Rigid3(small[:, ltb._PE_T], small[:, ltb._PE_Q]), small[:, ltb._GRAVITY])
    return args, torch.from_numpy(np.stack(perms)).to(dev)


def _tick_kernels(dev, timed):
    """The kernels of a captured 2D tick (`device_step`) of 1, 4 and 16 of
    16 robots at bench.py's shape (each fed its first 12 scans alone), at
    the default options and with the search, and the tick's device ms."""
    from cartographer_tpu_torch.core.config import apply_overrides
    from cartographer_tpu_torch.mapping import local_trajectory_builder_2d as ltb
    from cartographer_tpu_torch.sensor.data import TimedPointCloudData

    out = {}
    for name, correlative in (("default", False), ("correlative", True)):
        opts = apply_overrides(TrajectoryBuilder2DOptions(), {
            **cs.BATCH_OPTIONS, "use_online_correlative_scan_matching": correlative})
        builders = []
        for r in range(16):
            scans, _ = simulate_scans(12, beams=cs.BATCH_BEAMS, seed=r, start=4.0 * r)
            b = ltb.LocalTrajectoryBuilder2D(opts, ["laser"], device=dev)
            for ts, pts, rel in scans:
                b.add_range_data("laser", TimedPointCloudData(
                    time=int(round(ts * 1e6)), origin=np.zeros(3, np.float32), ranges=pts,
                    times=rel))
            builders.append(b)
        for robots in (1, 4, 16):
            group = builders[:robots]
            upload = torch.cat([b._staging for b in group]).to(dev)
            perms = torch.stack([torch.randperm(opts.tpu.scan_capacity, device=dev,
                                                dtype=torch.int32) for _ in group])
            out[f"{name} R={robots}"] = timed(lambda: ltb.device_step(group, upload, perms),
                                              f"tick R={robots}")
    return out


def k1k2(label):
    """K1 and K2 at the main path's shape and at bench.py's, R = 1, 4, 8, 16;
    a captured tick's kernels."""
    cuda.build()
    dev = torch.device("cuda:0")
    opts = TrajectoryBuilder2DOptions()
    filters = [(f.max_length, f.min_num_points, f.max_range)
               for f in (opts.adaptive_voxel_filter, opts.loop_closure_adaptive_voxel_filter)]
    pre = scan_pipeline_2d.ScanPreprocessParams2D(
        min_range=opts.min_range, max_range=opts.max_range, min_z=opts.min_z,
        max_z=opts.max_z, missing_data_ray_length=opts.missing_data_ray_length,
        voxel_filter_size=opts.voxel_filter_size)
    fused = hasattr(scan_pipeline_2d, "_scan_filter_kernel")
    out = {"card": cs._smi(), "tree": TREE, "fused": fused}

    def timed(fn, name, reps=200):
        return [cs._cuda_ms(fn, reps=reps), cs._event_ms(fn, reps=reps),
                cs._graph_kernels(fn, name)]

    shapes = [("main", 1, opts.tpu.scan_capacity, 1081)] + [
        ("bench", r, 1024, 1024) for r in (1, 4, 8, 16)]
    for shape, robots, n, beams in shapes:
        args, perm = _k1_rows(dev, robots, n, beams)

        def apart():  # K1's launch, then K2's
            hits, _, is_return, _, _ = scan_pipeline_2d.align_scan(*args, pre)
            return voxel_filter.voxel_filter_masks(hits, is_return, pre.voxel_filter_size,
                                                   perm, filters, 2)

        kernels = ((lambda: scan_pipeline_2d._scan_filter_kernel(*args, pre, perm, filters))
                   if fused else apart)
        row = {"K1+K2": timed(kernels, "K1+K2"),
               "step entry": timed(lambda: scan_pipeline_2d.preprocess_and_filter_scan_2d(
                   *args, pre, perm, filters), "entry")}
        if fused:
            row["K1, K2 apart"] = timed(apart, "apart")
        key = f"{shape} R={robots}"
        out[key] = row
        print(label, key, json.dumps(row), flush=True)
    out["tick"] = _tick_kernels(dev, lambda fn, name: timed(fn, name, reps=20))
    print(label)
    print(json.dumps(out))


if __name__ == "__main__":
    if sys.argv[1] == "tsdf-robots":
        tsdf_robots()
    elif len(sys.argv) > 3 and sys.argv[3] == "robots":
        robots_of(sys.argv[1])
    elif len(sys.argv) > 3 and sys.argv[3] == "k4-forms":
        k4_forms(sys.argv[1])
    elif len(sys.argv) > 3 and sys.argv[3] == "k2-shapes":
        k2_shapes(sys.argv[1])
    elif len(sys.argv) > 3 and sys.argv[3] == "k2-stamps":
        k2_stamps(sys.argv[1])
    elif len(sys.argv) > 3 and sys.argv[3] == "k2-k20":
        k2_k20(sys.argv[1])
    elif len(sys.argv) > 3 and sys.argv[3] == "k1k2":
        k1k2(sys.argv[1])

    else:
        main(sys.argv[1])
