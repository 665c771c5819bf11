"""Device times of the 3D frontend's matching windows, K10 and K19
(csrc/paged_grid_3d.cu), at the main path's shapes (not collected by
pytest).

    python tests/crop_3d_timing.py LABEL [TREE] [crops|profile|variants]

The windows of the 40th scan of a 3D frontend run over `simulate_scans_3d`,
at the default options (the 256^3 high and 192^3 low windows) and at the
full options (with the 256^3 intensity window), cropped around that scan's
own center as TREE's `ActiveSubmaps3D.matching_grids_at` crops them: the
profiler's device ms per call, CUDA events, the kernels a call launches (a
captured CUDA graph) and the host ms a call takes to return (the median of
50 calls, the card drained between them). Beside them a `zero_()` of the
same windows' dense tensors (the card's store ceiling, by the profiler and
by events) and the byte bound (`chip_smoke._crop_work`: the windows written
once, the cells on pages and the table under them read once).

With `profile`, the 3D frontend's profile window as `chip_smoke.py` reads
it (30 scans after 400, at both options): device busy ms, GPU activities
and the crops' device ms a scan. With `variants`, copies of TREE's
`paged_grid_3d.cu` built into `csrc/_build/variant/` and timed at the 40th
scan's windows beside the kept kernel: every row written as zeros (the
launch's floor without a read; its windows are wrong), 4 warps a block,
and 8 blocks an SM forced by the launch bounds.

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
import statistics
import subprocess
import sys
import time

TREE = os.path.abspath(sys.argv[2] if len(sys.argv) > 2 else ".")
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [TREE]

import torch  # noqa: E402

_spec = importlib.util.spec_from_file_location("smoke_helpers",
                                               os.path.join(HERE, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

from cartographer_tpu_torch.core.config import TrajectoryBuilder3DOptions  # noqa: E402
from cartographer_tpu_torch.mapping import local_trajectory_builder_3d as ltb3  # noqa: E402
from cartographer_tpu_torch.ops import cuda  # noqa: E402


def _fortieth_windows(dev, full):
    """A 3D frontend after 40 scans and the (grid, center, size) windows it
    cropped for the 40th."""
    opts = cs._full_frontend_options() if full else TrajectoryBuilder3DOptions()
    events, _ = cs._events_3d(40, intensities=full)
    builder = ltb3.LocalTrajectoryBuilder3D(opts, ["points"], device=dev)
    for e in events[:-1]:
        cs._feed_3d(builder, e)
    centers = []
    undo = cs._recording_windows(builder._active_submaps, centers)
    try:
        cs._feed_3d(builder, events[-1])
    finally:
        undo()
    s0, tpu, center = builder._active_submaps.submaps[0], opts.tpu, centers[-1]
    windows = [(s0.high_paged.grid, center, tpu.high_grid_size),
               (s0.low_paged.grid, center, tpu.low_grid_size)]
    if full:
        windows.append((s0.intensity_paged.grid, center, tpu.high_grid_size))
    return builder, windows


def crops(dev, full):
    """The 40th scan's matching windows, timed as the tree makes them."""
    builder, windows = _fortieth_windows(dev, full)
    active, center = builder._active_submaps, windows[0][1]
    nbytes, cells, gathers = cs._crop_work(torch, windows)

    def call():
        return active.matching_grids_at(center)

    dense = [x for g in call() if g is not None for x in cs._window_tensors(g)[:2]]

    def zero():
        return [x.zero_() for x in dense]

    host = []
    for _ in range(50):
        t0 = time.perf_counter()
        call()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    bound_ms, bound_by = cs._bound(nbytes, cells * 20)
    return {"windows": [size for _, _, size in windows],
            "pages_under_windows": [int(p.numel()) for _, p in gathers],
            "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
            "device_ms": cs._cuda_ms(call), "event_ms": cs._event_ms(call),
            "kernels_per_call": cs._graph_kernels(call, "crops"),
            "host_ms": statistics.median(host),
            "zero_device_ms": cs._cuda_ms(zero), "zero_event_ms": cs._event_ms(zero)}


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
                        "profile", watch="crop")
        out["full_options" if full else "default"] = {
            k: v for k, v in p.items() if k != "device_ms_per_scan_by_kernel"}
    return out


LAUNCH = "__global__ void __launch_bounds__(kCropWarps * 32)"
VARIANTS = {
    "all_rows_zeros": [("any = __any_sync(0xffffffffu, any);",
                        "any = __any_sync(0xffffffffu, any) && false;")],
    "warps_4": [("constexpr int kCropWarps = 8;", "constexpr int kCropWarps = 4;")],
    "blocks_8_an_sm": [(LAUNCH, LAUNCH[:-1] + ", 8)")],
}


def variants(dev):
    """TREE's crop kernel and its VARIANTS at the 40th scan's windows."""
    from cartographer_tpu_torch.ops import paged_grid_3d

    source = (cuda.CSRC_DIR / "paged_grid_3d.cu").read_text()
    out_dir = cuda.BUILD_DIR / "variant"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name, patches in VARIANTS.items():
        text = source
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        path = out_dir / f"paged_grid_3d_{name}.cu"
        path.write_text(text)
        subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, f"-I{cuda.CSRC_DIR}", "-o",
                        str(path.with_suffix(".so")), str(path)], check=True)
        libs[name] = path.with_suffix(".so")
    kernel = paged_grid_3d._CROP_KERNEL
    kept = kernel._load()
    out = {}
    for full in (False, True):
        builder, windows = _fortieth_windows(dev, full)
        runs = {"kept": cs._cuda_ms(lambda: paged_grid_3d.crop_windows(windows))}
        for name, lib in libs.items():
            fn = getattr(ctypes.CDLL(str(lib)), kernel.symbol)
            fn.argtypes, fn.restype = kernel._argtypes, ctypes.c_int
            kernel._fn = fn
            runs[name] = cs._cuda_ms(lambda: paged_grid_3d.crop_windows(windows))
            kernel._fn = kept
        out["full_options" if full else "default"] = runs
    return out


def main(label, mode):
    cuda.build()
    dev = torch.device("cuda:0")
    out = {"card": cs._smi(), "tree": TREE}
    if mode == "profile":
        out["profile"] = profile(dev)
    elif mode == "variants":
        out["variants"] = variants(dev)
    else:
        out.update(default=crops(dev, False), full_options=crops(dev, True))
    print(label)
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[3] if len(sys.argv) > 3 else "crops")
