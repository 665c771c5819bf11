"""Device times of the 3D frontend's correlative search, K17
(csrc/correlative_3d.cu), its scan histogram with the rotation by the
matched yaw, K12 (csrc/rot_histogram.cu), and its paged inserts, K9
(csrc/paged_grid_3d.cu), at the main path's shapes (not collected by
pytest).

    python tests/frontend_3d_timing.py LABEL [TREE] [kernels|k9|profile|stamps|variants]
    python tests/frontend_3d_timing.py LABEL . k9-stamps|k9-variants

`kernels` (the default): the 40th scan of a full-options 3D run over
`simulate_scans_3d` (intensities on): K17 on that scan's 256^3 high window,
its high-resolution cloud (512 points) and its prediction, as the step calls
it; the histogram of that scan's cloud levelled by its gravity quaternion at
120 bins and its rotation by the matched yaw, as TREE's step computes them
(the parent: the levelling glue, `compute_rotational_histogram` and
`rotate_histogram`; since their merge: `scan_histograms`). For each: the
profiler's device ms a call (the window's GPU activity over its calls) and
each kernel's mean ms over its records with their count, CUDA events, the
kernels a call launches (a captured CUDA graph), the host ms a call takes to
return (the median of 50 calls, the card drained between them), and for K17
the valid rotations.

`k9`: a scan's occupancy inserts as TREE's `ActiveSubmaps3D` makes them
(the parent: `insert_paged` a grid, two kernels each; since their merge:
one `insert_paged_grids` launch), on the 200th scan of a default-options
run (two active submaps: 4 grids) and on its first submap's 2 grids, the
page table holding the scan's pages: the same timings as `kernels`, and
the cells the inserts touch.

`k9-stamps` (the change's tree): a copy of K9 built with -DCARTO_STAMPS
into csrc/_build/variant/, each phase's us at 4 grids by block 0's thread 0
(0 entry, 1 tables filled and entries written, 2 the first cluster barrier,
3 its marks, 4 the second barrier: the slowest marks, 5 its applies), the
median of 5 calls after one. `k9-variants` (the change's tree): patched
copies of K9 (K9_VARIANTS) timed beside the kept kernel at 4 grids, each
pool checked equal to the kept kernel's on copies of the pools.

`profile`: the 3D frontend's profile windows as `chip_smoke.py` reads them
(30 scans after 400, at the default and at the full options): device busy
ms and GPU activities a scan, and the heaviest kernels' ms a scan.

`stamps` (a tree with csrc/stamps.cuh): copies of K17 and K12 built with
-DCARTO_STAMPS into csrc/_build/variant/, each phase's us by the global
timer (block 0's; K17's last block stamps its decode), the median of 5
calls after one: K17 (0 entry, 1 step, 2 the first rotation's cells, 3 its
rows, 4 the ticket, 5 the decode), K12 (0 entry, 1 levelled and z-minimum,
2 slices grouped, 3 centroids, 4 sorted, 5 next anchors, 6 chains marked, 7
emitted, 8 bins grouped, 9 sums and rotation; stamp 63 the doubling rounds).

`variants` (the change's tree): patched copies of TREE's correlative_3d.cu
(K17_VARIANTS) and rot_histogram.cu (K12_VARIANTS) built into
csrc/_build/variant/ and timed beside the kept kernels in one process, each
checked equal to the kept kernel's result.

Prints LABEL and one JSON object. TREE (default: the current directory) is
the root of the checkout whose package is timed; the helpers are this
checkout's `chip_smoke.py`. Unpack the parent with `git archive` into a
git-ignored directory and run, in one call on the card, parent, change,
change, parent.
"""

import ctypes
import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

TREE = os.path.abspath(sys.argv[2] if len(sys.argv) > 2 else ".")
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [TREE]

import numpy as np  # noqa: E402
import torch  # noqa: E402

_spec = importlib.util.spec_from_file_location("smoke_helpers",
                                               os.path.join(HERE, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

from cartographer_tpu_torch.core.config import TrajectoryBuilder3DOptions  # noqa: E402
from cartographer_tpu_torch.mapping import local_trajectory_builder_3d as ltb3  # noqa: E402
from cartographer_tpu_torch.ops import cuda, rot_histogram, scan_matcher_3d  # noqa: E402
from cartographer_tpu_torch.transform import quaternion as quat  # noqa: E402

BINS = 120


def _fortieth_scan(dev):
    """A full-options 3D frontend's 40th scan: K17's arguments as its step
    passed them, and the histogram's (cloud, mask, gravity, matched rotation)."""
    opts = cs._full_frontend_options()
    events, _ = cs._events_3d(40, intensities=True)
    builder = ltb3.LocalTrajectoryBuilder3D(opts, ["points"], device=dev)
    for e in events[:-1]:
        cs._feed_3d(builder, e)
    kept, calls = {}, []
    search, step = ltb3.correlative_match_3d, builder._fused_step

    def recording_search(*args):
        calls.append(args)
        return search(*args)

    def keeping_step(*args):
        out = step(*args)
        kept["gravity"] = args[3][9 * builder._caps[0]:][ltb3._GRAVITY].clone()
        kept["est_q"] = out[0][3:7].clone()
        return out

    ltb3.correlative_match_3d, builder._fused_step = recording_search, keeping_step
    try:
        cs._feed_3d(builder, events[-1])
    finally:
        ltb3.correlative_match_3d = search
        del builder._fused_step
    grid, points, mask, x0, params = calls[-1]
    return (grid, points, mask, x0.contiguous(), params), (points, mask, kept["gravity"],
                                                           kept["est_q"])


def _histograms(points, mask, gravity, est_q):
    """The step's histogram and its rotation, as TREE computes them."""
    if hasattr(rot_histogram, "scan_histograms"):
        return rot_histogram.scan_histograms(points, mask, gravity, est_q, BINS)
    level = quat.multiply(quat.from_yaw(-quat.get_yaw(gravity)), gravity)
    hist = rot_histogram.compute_rotational_histogram(quat.rotate(level, points), mask, BINS)
    return hist, rot_histogram.rotate_histogram(hist, quat.get_yaw(est_q))


def _by_kernel(fn, reps=50, warmup=3):
    """{kernel: [mean device ms of its records, records]} over `reps` calls
    of fn() in one profiled window (the mean stays whole where the profiler
    drops records of a short window)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    on_card = torch._C._autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == on_card:
            out.setdefault(cs._short_name(e.name()), []).append(e.duration_ns() / 1e6)
    return {k: [sum(v) / len(v), len(v)] for k, v in out.items()}


def _host_ms(fn, calls=50):
    host = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(host)


def _timings(fn, label):
    return {"device_ms": cs._cuda_ms(fn, reps=50), "by_kernel": _by_kernel(fn),
            "event_ms": cs._event_ms(fn, reps=50), "kernels_per_call": cs._graph_kernels(fn, label),
            "host_ms": _host_ms(fn)}


def kernels(dev):
    args17, args12 = _fortieth_scan(dev)
    _, rotations = cs._correlative_cells(torch, *args17)
    valid = int(args12[1].sum())
    return {"k17": {"valid_points": valid, "valid_rotations": rotations,
                    **_timings(lambda: scan_matcher_3d._correlative_kernel(*args17), "K17")},
            "k12": {"valid_points": valid, "bins": BINS,
                    **_timings(lambda: _histograms(*args12), "K12")}}


K9_SCANS = 200  # two submaps are active from 160 inserted scans on


def _k9_scan(dev):
    """The default-options 3D frontend's K9_SCANS-th scan: its insert's
    arguments (sensor origin, points, the full and the high-range masks on
    the device) and the active submaps' paged grids [(high, low), ...]."""
    from cartographer_tpu_torch.mapping import submap_3d

    events, _ = cs._events_3d(K9_SCANS)
    builder = ltb3.LocalTrajectoryBuilder3D(TrajectoryBuilder3DOptions(), ["points"],
                                            device=dev)
    for e in events[:-1]:
        cs._feed_3d(builder, e)
    calls, insert = [], submap_3d.ActiveSubmaps3D.insert_range_data

    def recording(self, *args, **kwargs):
        calls.append(kwargs["device_tensors"][:4])
        return insert(self, *args, **kwargs)

    submap_3d.ActiveSubmaps3D.insert_range_data = recording
    try:
        cs._feed_3d(builder, events[-1])
    finally:
        submap_3d.ActiveSubmaps3D.insert_range_data = insert
    active = builder._active_submaps
    return calls[-1], [(s.high_paged, s.low_paged) for s in active.submaps], active._options


def k9(dev):
    from cartographer_tpu_torch.ops import paged_grid_3d

    (origin, points, mask, high), submaps, options = _k9_scan(dev)
    ins = options.range_data_inserter
    args = (ins.hit_probability, ins.miss_probability, ins.num_free_space_voxels)
    out = {"returns": int(mask.sum()), "high_returns": int(high.sum())}
    for grids in (len(submaps) * 2, 2):
        pairs = [(paged, m) for hp, lp in submaps[:grids // 2] for paged, m in
                 ((hp, high), (lp, mask))]
        touched = []
        for paged, m in pairs:  # the twin on a copy whose known cells start clear
            fresh = dataclasses.replace(paged.grid, pages=paged.grid.pages.clone(),
                                        known=torch.zeros_like(paged.grid.known))
            paged_grid_3d.insert_paged_plain(fresh, origin, points, m, *args)
            touched.append(int(fresh.known.sum()))
        if hasattr(paged_grid_3d, "insert_paged_grids"):
            jobs = [(paged.grid, m, None) for paged, m in pairs]

            def call():
                paged_grid_3d.insert_paged_grids(jobs, origin, points, *args)
        else:
            def call():
                for paged, m in pairs:
                    paged_grid_3d.insert_paged(paged.grid, origin, points, m, *args,
                                               paged._scratch)
        out[f"grids_{grids}"] = {"touched_cells": touched, **_timings(call, f"K9 {grids}")}
    return out


K9_VARIANTS = {
    # the tables in device memory (L2) at every size, atomics at L2
    "global_table": [("s.shared = (1ll << s.slot_bits) <= kMaxSharedSlots;", "s.shared = false;")],
    "cluster_4": [("constexpr int kInsertCluster = 8;", "constexpr int kInsertCluster = 4;")],
    "mark_batch_1": [("constexpr int kMarkBatch = 4;", "constexpr int kMarkBatch = 1;")],
    "apply_batch_1": [("constexpr int kApplyBatch = 8;", "constexpr int kApplyBatch = 1;")],
    "apply_batch_32": [("constexpr int kApplyBatch = 8;", "constexpr int kApplyBatch = 32;")],
}


def _k9_jobs(dev):
    """The 4-grid insert of `_k9_scan` as a call, and its arguments."""
    from cartographer_tpu_torch.ops import paged_grid_3d

    (origin, points, mask, high), submaps, options = _k9_scan(dev)
    ins = options.range_data_inserter
    args = (ins.hit_probability, ins.miss_probability, ins.num_free_space_voxels)
    jobs = [(paged.grid, m, None) for hp, lp in submaps for paged, m in ((hp, high), (lp, mask))]
    return (lambda: paged_grid_3d.insert_paged_grids(jobs, origin, points, *args)), jobs


def k9_stamps(dev):
    from cartographer_tpu_torch.ops import paged_grid_3d

    call, _ = _k9_jobs(dev)
    kernel = paged_grid_3d._INSERT_KERNEL
    lib = _build_copy("paged_grid_3d.cu", "stamped", defines=("-DCARTO_STAMPS",))
    kept = _pointed(kernel, lib)
    out = _stamps(lib, call, 5)
    kernel._fn = kept
    return out


def k9_variants(dev):
    from cartographer_tpu_torch.ops import paged_grid_3d

    call, jobs = _k9_jobs(dev)
    kernel = paged_grid_3d._INSERT_KERNEL
    pools = [(g.pages.clone(), g.known.clone()) for g, _, _ in jobs]

    def once():  # one insert from the saved pools -> the pools after it
        for (g, _, _), (pages, known) in zip(jobs, pools):
            g.pages.copy_(pages)
            g.known.copy_(known)
        call()
        return [(g.pages.clone(), g.known.clone()) for g, _, _ in jobs]

    ref = once()
    runs = {"kept": cs._cuda_ms(call, reps=50)}
    scratch_bytes = paged_grid_3d._insert_scratch_bytes
    for name, patches in K9_VARIANTS.items():
        lib = _build_copy("paged_grid_3d.cu", name, patches=patches)
        kept = _pointed(kernel, lib)
        sizing = lib.paged_insert_3d_scratch_bytes  # the variant's own table sizes
        sizing.argtypes, sizing.restype = [ctypes.c_int] * 2, ctypes.c_longlong
        paged_grid_3d._insert_scratch_bytes = sizing
        try:
            same = all(torch.equal(a, c) and torch.equal(b, d)
                       for (a, b), (c, d) in zip(once(), ref))
            runs[name] = {"device_ms": cs._cuda_ms(call, reps=50), "equal_to_kept": same}
        finally:
            kernel._fn = kept
            paged_grid_3d._insert_scratch_bytes = scratch_bytes
    runs["kept_again"] = cs._cuda_ms(call, reps=50)
    return runs


def profile(dev):
    """The smoke's 3D profile windows: 30 scans after 400, both options."""
    out = {}
    for full in (False, True):
        opts = cs._full_frontend_options() if full else TrajectoryBuilder3DOptions()
        events, _ = cs._events_3d(cs.NUM_SCANS_3D + cs.PROFILED_SCANS, intensities=full)
        builder = ltb3.LocalTrajectoryBuilder3D(opts, ["points"], device=dev)
        for e in events[:cs.NUM_SCANS_3D]:
            cs._feed_3d(builder, e)
        p = cs._profile(torch, lambda e: cs._feed_3d(builder, e), events[cs.NUM_SCANS_3D:],
                        "profile")
        out["full_options" if full else "default"] = p
    return out


def _build_copy(source, name, defines=(), patches=()):
    """TREE's csrc/`source`, patched, built into csrc/_build/variant/ -> the library."""
    src = os.path.join(TREE, "cartographer_tpu_torch", "csrc")
    out_dir = os.path.join(src, "_build", "variant")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(src, source)) as f:
        text = f.read()
    for old, new in patches:
        if old not in text:
            raise RuntimeError(f"{name}: {old!r} is not in {source}")
        text = text.replace(old, new)
    path = os.path.join(out_dir, f"{source[:-3]}_{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, *defines, "-I", src, "-o", path[:-3] + ".so",
                    path], check=True)
    return ctypes.CDLL(path[:-3] + ".so")


def _pointed(kernel, lib):
    """Points `kernel` at `lib`'s function of its symbol; -> the kept function."""
    kept = kernel._load()
    fn = getattr(lib, kernel.symbol)
    fn.argtypes, fn.restype = kernel._argtypes, ctypes.c_int
    kernel._fn = fn
    return kept


def _stamps(lib, fn, phases):
    per_call = []
    for _ in range(6):
        fn()
        torch.cuda.synchronize()
        a = (ctypes.c_ulonglong * 64)()
        lib.stamps_read(a)
        per_call.append((np.diff(np.array(a[:phases + 1], np.float64)) / 1e3, a[63]))
    return {"us_per_phase": np.median([p for p, _ in per_call[1:]], 0).round(2).tolist(),
            "stamp_63": per_call[-1][1]}


def stamps(dev):
    args17, args12 = _fortieth_scan(dev)
    out = {}
    for source, kernel, fn, phases in (
            ("correlative_3d.cu", scan_matcher_3d._CORRELATIVE_KERNEL,
             lambda: scan_matcher_3d._correlative_kernel(*args17), 5),
            ("rot_histogram.cu", rot_histogram._KERNEL, lambda: _histograms(*args12), 9)):
        lib = _build_copy(source, "stamped", defines=("-DCARTO_STAMPS",))
        kept = _pointed(kernel, lib)
        out[kernel.symbol] = _stamps(lib, fn, phases)
        kernel._fn = kept
    return out


K17_VARIANTS = {
    "cell_by_cell": [("const bool by_columns = L <= kColumn && P <= kLeaves;",
                      "const bool by_columns = false;")],
    "threads_512": [("constexpr int kThreads = 800;", "constexpr int kThreads = 512;")],
    "batch_4": [("constexpr int kBatch = 2;", "constexpr int kBatch = 4;")],
    "plain_loads": [("const float4 u = __ldg(lo), v = __ldg(lo + 1);",
                     "const float4 u = lo[0], v = lo[1];"),
                    ("c.k = (unsigned long long)__ldg(kn) | ((unsigned long long)__ldg(kn + 1) << 32);",
                     "c.k = (unsigned long long)kn[0] | ((unsigned long long)kn[1] << 32);")],
}
K12_VARIANTS = {
    f"threads_{t}": [("while (threads < n && threads < kMaxThreads)",
                      f"while (threads < n && threads < {t})")] for t in (64, 128, 256)}


def variants(dev):
    args17, args12 = _fortieth_scan(dev)
    kernel = scan_matcher_3d._CORRELATIVE_KERNEL

    def call():
        return scan_matcher_3d._correlative_kernel(*args17)

    ref = [t.clone() for t in call()]
    runs = {"kept": cs._cuda_ms(call, reps=50)}
    for name, patches in K17_VARIANTS.items():
        lib = _build_copy("correlative_3d.cu", name, patches=patches)
        kept = _pointed(kernel, lib)
        got = call()
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        runs[name] = {"device_ms": cs._cuda_ms(call, reps=50), "equal_to_kept": same}
        kernel._fn = kept
    runs["kept_again"] = cs._cuda_ms(call, reps=50)
    kernel = rot_histogram._KERNEL

    def call12():
        return _histograms(*args12)

    ref = [t.clone() for t in call12()]
    runs12 = {"kept": cs._cuda_ms(call12, reps=50)}
    for name, patches in K12_VARIANTS.items():
        lib = _build_copy("rot_histogram.cu", name, patches=patches)
        kept = _pointed(kernel, lib)
        same = all(torch.equal(a, b) for a, b in zip(call12(), ref))
        runs12[name] = {"device_ms": cs._cuda_ms(call12, reps=50), "equal_to_kept": same}
        kernel._fn = kept
    runs12["kept_again"] = cs._cuda_ms(call12, reps=50)
    return {"k17": runs, "k12": runs12}


def main(label, mode):
    cuda.build()
    dev = torch.device("cuda:0")
    out = {"card": cs._smi(), "tree": TREE}
    if mode == "profile":
        out["profile"] = profile(dev)
    elif mode == "k9":
        out["k9"] = k9(dev)
    elif mode == "k9-stamps":
        out["k9_stamps"] = k9_stamps(dev)
    elif mode == "k9-variants":
        out["k9_variants"] = k9_variants(dev)
    elif mode == "stamps":
        out["stamps"] = stamps(dev)
    elif mode == "variants":
        out["variants"] = variants(dev)
    else:
        out.update(kernels(dev))
    print(label)
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[3] if len(sys.argv) > 3 else "kernels")
