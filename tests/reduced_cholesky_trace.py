"""Where the reduced Cholesky of K8 and K16 (`csrc/schur_reduced.cuh`)
spends its time, on the card (not collected by pytest).

    python tests/reduced_cholesky_trace.py [ROWS ...]

Writes a copy of the header whose block 0 stamps `clock64()` at the end of
each step of each panel (the previous panel's write-back, the panel's load
from the cluster, the diagonal block's factor, the rows below it, the
trailing update, the cluster barrier) and of the back substitution, builds
it with a small harness into the kernels' git-ignored build directory, and
solves a random symmetric positive definite system of each size (default
192 and 384 rows) in clusters of 1, 8 and 16 blocks. Prints one JSON object
per size and cluster: the SM clock (`nvidia-smi`), the kernel's cycles from
its first to its last stamp, and each step's cycles summed over the panels.
Needs nvcc and a Hopper card.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "cartographer_tpu_torch", "csrc")
OUT = os.path.join(CSRC, "_build", "trace")
sys.path[:0] = [ROOT]

from cartographer_tpu_torch.ops import cuda  # noqa: E402

# (text of the header, what takes its place): a stamp at each step's end;
# P is the panel's index, stamps 10 + 6 P + step, back substitution 200 + 2 P.
STAMPS = [
    ("namespace schur {\nnamespace {\n",
     "#define STAMP(k) do { if (threadIdx.x == 0 && cluster.block_rank() == 0) "
     "g_stamps[k] = clock64(); } while (0)\nnamespace schur {\nnamespace {\n"),
    ("  Rows R{in_shared ? own : nullptr, s.M, __ffs(blocks) - 1, n};\n",
     "  Rows R{in_shared ? own : nullptr, s.M, __ffs(blocks) - 1, n};\n  STAMP(0);\n"),
    ("  cluster.sync();\n\n  int prev = -1, prev_w = 0;",
     "  cluster.sync();\n  STAMP(1);\n\n  int prev = -1, prev_w = 0;"),
    ("    if (prev >= 0) write_panel(R, panel, ld, n, rank, prev, prev_w);\n    __syncthreads();\n",
     "    if (prev >= 0) write_panel(R, panel, ld, n, rank, prev, prev_w);\n    __syncthreads();\n"
     "    STAMP(10 + 6 * (c0 / kPanel));\n"),
    ("        panel[lane * ld + i] = R.row(cluster, i)[c0 + lane];\n    __syncthreads();\n",
     "        panel[lane * ld + i] = R.row(cluster, i)[c0 + lane];\n    __syncthreads();\n"
     "    STAMP(11 + 6 * (c0 / kPanel));\n"),
    ("    __syncthreads();\n    // Rows below:",
     "    __syncthreads();\n    STAMP(12 + 6 * (c0 / kPanel));\n    // Rows below:"),
    ("    __syncthreads();\n    // This block's rows' trailing columns",
     "    __syncthreads();\n    STAMP(13 + 6 * (c0 / kPanel));\n    // This block's rows' trailing columns"),
    ("    prev = c0;\n    prev_w = wd;\n    cluster.sync();\n",
     "    prev = c0;\n    prev_w = wd;\n    __syncthreads();\n    STAMP(14 + 6 * (c0 / kPanel));\n"
     "    cluster.sync();\n    STAMP(15 + 6 * (c0 / kPanel));\n"),
    ("        if (lane < wd) vec[c0 + lane] = t;\n      }\n      __syncthreads();\n",
     "        if (lane < wd) vec[c0 + lane] = t;\n      }\n      __syncthreads();\n"
     "      STAMP(200 + 2 * (c0 / kPanel));\n"),
    ("        vec[j] = v;\n      }\n      __syncthreads();\n",
     "        vec[j] = v;\n      }\n      __syncthreads();\n      STAMP(201 + 2 * (c0 / kPanel));\n"),
    ("    for (int j = tid; j < n; j += blockDim.x) s.dx[j] = vec[j];\n",
     "    STAMP(299);\n    for (int j = tid; j < n; j += blockDim.x) s.dx[j] = vec[j];\n"),
]
STEPS = ["write-back", "panel load", "diagonal factor", "rows below", "trailing update",
         "cluster barrier"]

HARNESS = r"""
__device__ long long g_stamps[300];
#include "schur_reduced_stamped.cuh"

extern "C" int trace_cholesky(int n, int blocks, float* system, float* zeros, float* panels,
                              float* x, long long* stamps) {
  static long long none[300];
  cudaMemcpyToSymbol(g_stamps, none, sizeof(none));
  const schur::System sys{n, 1, zeros, zeros + n, system, panels, x};
  cudaError_t err = schur::launch_cholesky(sys, blocks, 0);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(stamps, g_stamps, sizeof(none));
  return (int)err;
}
"""


def build():
    with open(os.path.join(CSRC, "schur_reduced.cuh")) as f:
        text = f.read()
    for old, new in STAMPS:
        if text.count(old) != 1:
            raise RuntimeError(f"stamp anchor not found once: {old[:50]!r}")
        text = text.replace(old, new)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "schur_reduced_stamped.cuh"), "w") as f:
        f.write(text)
    src = os.path.join(OUT, "cholesky_trace.cu")
    with open(src, "w") as f:
        f.write(HARNESS)
    lib = os.path.join(OUT, "libcholesky_trace.so")
    subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", OUT, "-o", lib, src], check=True)
    fn = ctypes.CDLL(lib).trace_cholesky
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    return fn


def sm_clock():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip()


def main(rows):
    fn = build()
    dev = torch.device("cuda:0")
    for n in rows:
        rng = np.random.RandomState(n)
        R = rng.randn(n, n)
        P = torch.from_numpy((R @ R.T / n + np.eye(n)).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
        for blocks in (1, 8, 16):
            stamps = np.zeros(300, np.int64)
            for _ in range(3):  # the last of three runs
                system = torch.cat([-P, b[None]]).contiguous()
                zeros = P.new_zeros(2 * n)
                panels = P.new_empty(16 * 32 * (n + 1))
                x = P.new_empty(n)
                err = fn(n, blocks, system.data_ptr(), zeros.data_ptr(), panels.data_ptr(),
                         x.data_ptr(), stamps.ctypes.data)
                if err:
                    break
            if err:
                print(json.dumps({"rows": n, "blocks": blocks, "cuda_error": err}))
                continue
            ref = np.linalg.solve(P.double().cpu().numpy(), b.double().cpu().numpy())
            panels_n = -(-n // 32)
            steps = {name: 0 for name in STEPS}
            prev = stamps[1]
            for p in range(panels_n):
                for k, name in enumerate(STEPS):
                    t = stamps[10 + 6 * p + k]
                    steps[name] += int(t - prev)
                    prev = t
            back = int(stamps[299] - prev)
            print(json.dumps({
                "rows": n, "blocks": blocks, "clock": sm_clock(),
                "cycles": int(stamps[299] - stamps[0]), "row_build": int(stamps[1] - stamps[0]),
                "panels": panels_n, "per_step": steps, "back_substitution": back,
                "max_rel_err": float(np.abs(x.double().cpu().numpy() - ref).max()
                                     / np.abs(ref).max())}))


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [192, 384])
