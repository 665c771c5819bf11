"""Device times of K18 and K30 at 4,096, 16,384 and 32,768 returns (not
collected by pytest).

    python tests/intensity_insert_timing.py LABEL [TREE]

K18 inserts one simulated 3D scan with intensities (16 rings, the high
resolution's 20 m gate) into two intensity pools of the default size that
earlier scans have paged, as the 3D frontend does for its two active
submaps; K30 inserts the same scan into a 256^3 window at 0.1 m. Each is
timed over 200 calls by the profiler (`chip_smoke._cuda_ms`), by CUDA
events (`chip_smoke._event_ms`) and by the host's clock around 200 calls
that are not waited for (the wrapper's own cost per call); the script
prints LABEL and one JSON object. TREE (default: the current directory) is
the root of the checkout whose package and `chip_smoke.py` are timed, so
one script times two commits on the same inputs: unpack the parent with
`git archive` into a git-ignored directory and run, in one call on the
card, parent, change, change, parent.
"""

import json
import os
import sys
import time

TREE = os.path.abspath(sys.argv[2] if len(sys.argv) > 2 else ".")
sys.path[:0] = [TREE]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from cartographer_tpu_torch.core.config import INTENSITY_THRESHOLD, TpuOptions3D  # noqa: E402
from cartographer_tpu_torch.ops import cuda  # noqa: E402
from cartographer_tpu_torch.ops.grid_3d import IntensityGrid3D, insert_intensities  # noqa: E402
from cartographer_tpu_torch.ops.paged_grid_3d import (  # noqa: E402
    PagedIntensitySubmapGrid3D,
    insert_intensity_paged,
)
from cartographer_tpu_torch.simulation import simulate_scans_3d  # noqa: E402

RETURNS = (4096, 16384, 32768)
REPS = 200
HIGH_RANGE = 20.0  # m, the high-resolution grid's gate


def host_us(fn, calls=REPS):
    """Host microseconds per call of fn(), the card not waited for."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - start
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def main(label):
    cuda.build()
    dev = torch.device("cuda:0")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    tpu = TpuOptions3D()
    out = {"card": cs._smi(), "tree": TREE, "reps": REPS}
    for n in RETURNS:
        scans = simulate_scans_3d(4, azimuths=n // 16, intensities=True)[0]
        pools = [PagedIntensitySubmapGrid3D(0.1, np.zeros(3, np.float32), dev,
                                            page_size=tpu.page_size, max_pages=tpu.max_pages,
                                            num_blocks=tpu.num_blocks) for _ in range(2)]
        for _, pts, _, intens in scans[:3]:
            near = np.linalg.norm(pts, axis=1) <= HIGH_RANGE
            for pool in pools:
                pool.insert(pts, intens, near, INTENSITY_THRESHOLD)
        _, pts, _, intens = scans[3]
        near = np.linalg.norm(pts, axis=1) <= HIGH_RANGE
        for pool in pools:  # pages for the timed scan's blocks
            pool.insert(pts, intens, near, INTENSITY_THRESHOLD)
        args = (t(pts), t(intens), t(near))

        def k18():
            for pool in pools:
                insert_intensity_paged(pool.grid, *args, INTENSITY_THRESHOLD)

        window = IntensityGrid3D.create(tpu.high_grid_size, 0.1, np.zeros(3, np.float32), dev)
        every = t(np.ones(n, bool))

        def k30():
            insert_intensities(window, args[0], args[1], every, INTENSITY_THRESHOLD)

        for name, fn in ((f"K18 paged_intensity_insert_3d x2 ({n} returns)", k18),
                         (f"K30 dense_intensity_insert_3d ({n} returns)", k30)):
            out[name] = {"profiler_ms": cs._cuda_ms(fn, reps=REPS),
                         "event_ms": cs._event_ms(fn, reps=REPS), "host_us": host_us(fn)}
    print(label, json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
