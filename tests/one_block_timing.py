"""Device times of K5, K7, K12, K13 and K17 at their one-block sizes, on
the inputs of their card tests (not collected by pytest).

    python tests/one_block_timing.py LABEL [TREE]

Times each kernel's wrapper over 200 calls with `chip_smoke._cuda_ms` on the
card and prints LABEL and one JSON object. TREE (default: the current
directory) is the root of the checkout whose package, `chip_smoke.py` and
`tests/test_torch_cuda_kernels.py` are used, so one script times two
commits: unpack the parent with `git archive` and run, in one call on the
card, parent, change, change, parent.
"""

import json
import os
import sys

TREE = os.path.abspath(sys.argv[2] if len(sys.argv) > 2 else ".")
sys.path[:0] = [TREE, os.path.join(TREE, "tests")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import test_torch_cuda_kernels as t  # noqa: E402
from cartographer_tpu_torch.ops import (  # noqa: E402
    bnb_2d,
    correlative_2d,
    cuda,
    rot_histogram,
    scan_matcher_3d,
)


def main(label):
    cuda.build()
    dev = torch.device("cuda:0")
    out = {}
    grid, rd = t._card_grid(dev)
    params = correlative_2d.CorrelativeSearchParams(max_scan_range=12.0)
    x0 = t._t(np.float32([0.23, -0.12, 0.02]), dev)
    a5 = (grid, rd.returns.points, rd.returns.mask, x0, params)
    out["K5 correlative_2d (512 points)"] = cs._cuda_ms(
        lambda: correlative_2d.real_time_correlative_match(*a5), reps=200)
    pyr = bnb_2d.build_precomputation_pyramid(grid, 7)
    x7 = t._t(np.float32([0.3, -0.2, 0.05]), dev)
    p7 = bnb_2d.FastCorrelativeMatcherParams2D(linear_search_window=2.0, beam_width=512,
                                               max_scan_range=12.0)
    if hasattr(bnb_2d, "fast_correlative_match_2d_batch"):  # the descent in one launch
        a7 = (pyr, grid, rd.returns.points[:128], rd.returns.mask[:128], x7, p7, 0.3)
        out["K7 bnb_descent (128 points, beam 512, one pair)"] = cs._cuda_ms(
            lambda: bnb_2d.fast_correlative_match_2d(*a7), reps=200)
    else:
        rng = np.random.RandomState(4)
        n, b = 128, 5000
        cells = t._t(rng.randint(-20, t.SIZE + 20, (31, n, 2)).astype(np.int32), dev)
        mask = t._t(rng.rand(n) < 0.8, dev)
        a7 = (pyr[3], cells, mask, t._t(rng.randint(0, 31, b).astype(np.int32), dev),
              t._t(rng.randint(-64, 64, b).astype(np.int32), dev),
              t._t(rng.randint(-64, 64, b).astype(np.int32), dev))
        out["K7 bnb_score (128 points, 5,000 candidates)"] = cs._cuda_ms(
            lambda: bnb_2d.score_candidates(*a7), reps=200)
    rng = np.random.RandomState(512)
    pts, m = t._hall_scan(rng, np.zeros(3, np.float32), 512)
    pts, m = t._t(pts, dev), t._t(m, dev)
    out["K12 rot_histogram (512 points, 120 bins)"] = cs._cuda_ms(
        lambda: rot_histogram.compute_rotational_histogram(pts, m, 120), reps=200)
    rng = np.random.RandomState(13)
    scan, sub = (t._t(rng.rand(120).astype(np.float32), dev) for _ in range(2))
    angles = t._t(rng.uniform(-4.0, 4.0, 1259).astype(np.float32), dev)
    out["K13 rot_match (1,259 yaws, 120 bins)"] = cs._cuda_ms(
        lambda: rot_histogram.match_histograms(sub, scan, angles), reps=200)
    high, _ = t._paged_pair(dev, 0.1)
    g3 = high.crop_dense(np.float32([0.3, 0.0, 0.0]), 96)
    rng = np.random.RandomState(23)
    shift = np.float32([0.313, -0.079, 0.037])
    p3, m3 = t._hall_scan(rng, shift, 512)
    sparams = scan_matcher_3d.CorrelativeSearchParams3D(
        linear_search_window=0.15, angular_search_window=np.radians(1.0), max_scan_range=60.0)
    x3 = t._t(np.float32([0.04, -0.03, 0.01, np.cos(0.005), 0.0, 0.0, np.sin(0.005)]), dev)
    a17 = (g3, t._t(p3 - shift, dev), t._t(m3, dev), x3, sparams)
    out["K17 correlative_3d (512 points)"] = cs._cuda_ms(
        lambda: scan_matcher_3d._correlative_kernel(*a17), reps=200)
    print(label, json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
