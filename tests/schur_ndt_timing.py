"""Device times of K16 (schur_spa_3d) and K28 (ndt_grid) at the main path's
shapes (not collected by pytest).

    python tests/schur_ndt_timing.py LABEL [TREE]

K16 solves `chip_smoke.py`'s synthetic SE(3) pose graph at the solver's
capacity (S 64, N 4,096, C 16,384, a gyro term per consecutive pair and an
acceleration triplet per triple). The script prints each GPU activity of a
one-iteration call in launch order (the profiler, median over calls) with
their sum beside CUDA events around the same call, the kernels per
iteration (captured CUDA graphs of one and two iterations), and 2- and
50-iteration calls by CUDA events. K28 builds the NDT grid of the testbed's
28,800-return target at 1 m cells (32^3, padded to 32,768 points): kernels
per call (a captured graph), and the profiler's and CUDA events' ms of K28
and of the library composition of the same function (`index_add_`, `inv`,
`cholesky`). Then LABEL and one JSON object.

TREE (default: the current directory) is the root of the checkout whose
package is timed; the helpers are this checkout's `chip_smoke.py`. Unpack
the parent with `git archive` into a git-ignored directory and run, in one
call on the card, parent, change, change, parent.
"""

import importlib.util
import json
import os
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

from cartographer_tpu_torch.ops import cuda, icp  # noqa: E402
from cartographer_tpu_torch.parallel import schur_spa, schur_spa_3d  # noqa: E402
from cartographer_tpu_torch.simulation import simulate_scan_pair_3d  # noqa: E402


def k16(dev):
    _, _, p, hs = cs._k16_capacity_problem(torch, dev)
    steps, counted = cs._launch_breakdown(lambda: schur_spa_3d._solve_kernel(p, 1, hs, 1e-6))
    one = cs._graph_kernels(lambda: schur_spa_3d._solve_kernel(p, 1, hs, 1e-6), "K16")
    two = cs._graph_kernels(lambda: schur_spa_3d._solve_kernel(p, 2, hs, 1e-6), "K16")
    out = {
        "one_iteration": [{"kernel": name, "ms": ms} for name, ms in steps],
        "one_iteration_profiled_calls": counted,
        "one_iteration_sum_ms": sum(ms for _, ms in steps),
        "one_iteration_event_ms": cs._event_ms(
            lambda: schur_spa_3d._solve_kernel(p, 1, hs, 1e-6), reps=5, warmup=1),
        "kernels_per_iteration": two - one, "kernels_first_iteration": one,
        "two_iterations_event_ms": cs._event_ms(
            lambda: schur_spa_3d._solve_kernel(p, 2, hs, 1e-6), reps=5, warmup=1),
        "fifty_iterations_event_ms": cs._event_ms(
            lambda: schur_spa_3d._solve_kernel(p, 50, hs, 1e-6), reps=3, warmup=1)}
    n = 6 * p.sub_t.shape[0]
    spd = torch.randn(n, n, device=dev)
    spd = spd @ spd.T + n * torch.eye(n, device=dev)
    out["library_cholesky_ex_event_ms"] = cs._event_ms(lambda: torch.linalg.cholesky_ex(spd))
    # Absent before K16's redesign; K8's wrapper runs the shared kernel since.
    alone = (getattr(schur_spa_3d, "reduced_cholesky_solve", None)
             or getattr(schur_spa, "reduced_cholesky_solve", None))
    if alone is not None:
        out["reduced_cholesky_event_ms"] = {}
        for m in (48, 96, 192, 384, 768):
            a = torch.randn(m, m, device=dev)
            a = a @ a.T + m * torch.eye(m, device=dev)
            b = torch.randn(m, device=dev)
            out["reduced_cholesky_event_ms"][m] = cs._event_ms(lambda: alone(a, b), reps=20)
    for name, ms in steps:
        print(f"K16 one iteration: {name} {ms:.4f} ms")
    return out


def k28(dev):
    _, target, _, _ = simulate_scan_pair_3d(azimuths=cs.SCAN_MATCH_AZIMUTHS)
    cap = 1 << int(np.ceil(np.log2(len(target))))
    buf = np.zeros((cap, 3), np.float32)
    buf[:len(target)] = target
    tgt = torch.from_numpy(buf).to(dev)
    tm = torch.from_numpy(np.arange(cap) < len(target)).to(dev)
    params = icp.NdtParams(resolution=1.0)
    center = icp.ndt_center(tgt, tm)
    origin = icp.build_ndt_grid(tgt, tm, params, center)[3]
    library, _ = cs._ndt_library(torch, tgt, tm, origin, params)
    grid = lambda: icp.build_ndt_grid(tgt, tm, params, center)  # noqa: E731
    steps, _ = cs._launch_breakdown(grid)
    by_resolution = {}
    for res in (0.5, 0.3):  # shorter runs: the cells' most points fall with the cell's size
        p = icp.NdtParams(resolution=res)
        by_resolution[res] = [[name, ms] for name, ms in cs._launch_breakdown(
            lambda: icp.build_ndt_grid(tgt, tm, p, center))[0]]
    return {"points": len(target), "kernels_per_call": cs._graph_kernels(grid, "K28"),
            "per_kernel_ms": [[name, ms] for name, ms in steps],
            "per_kernel_ms_by_resolution": by_resolution,
            "profiler_ms": cs._cuda_ms(grid, reps=200),
            "event_ms": cs._event_ms(grid, reps=200),
            "library_profiler_ms": cs._cuda_ms(library, reps=200),
            "library_event_ms": cs._event_ms(library, reps=200)}


def main(label):
    cuda.build(["schur_spa_3d.cu", "ndt.cu"])
    dev = torch.device("cuda:0")
    out = {"card": cs._smi(), "tree": TREE, "k16": k16(dev), "k28": k28(dev)}
    print(label)
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1])
