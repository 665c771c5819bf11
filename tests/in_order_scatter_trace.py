"""Where the in-order scatter of K18, K30 and K21 spends its time, on the card (not
collected by pytest).

    python tests/in_order_scatter_trace.py [RETURNS ...]

Writes copies of `cartographer_tpu_torch/csrc/in_order_scatter.cuh` whose
block 0 stamps `clock64()` at each phase's closing barrier, builds each with
a small K30-like harness (returns in a shell 1-12 m around the center of a
256^3 window at 0.1 m, every one contributing) into the kernels' git-ignored
build directory, and prints one JSON object per variant and size: the best
of 20 launches by CUDA events (the C++ host loop's own launch cost
included) and the cycles of each phase. Variants: the design as committed;
ranks by `__match_any_sync` instead of eight ballots; 1 and 2 blocks at
4,096 returns (`kSpread` 8,192 and 2,048) instead of 8; clusters of at most
8 blocks instead of 16. Needs nvcc and a Hopper card.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "cartographer_tpu_torch", "csrc")
OUT = os.path.join(CSRC, "_build", "trace")
NVCC = "/usr/local/cuda/bin/nvcc"

# (text of the header, what takes its place): a stamp at each phase's end.
STAMPS = [
    ("template <class Source>\n__global__",
     "__device__ long long* g_stamps;\n#define STAMP(k) do { if (threadIdx.x == 0 && "
     "blockIdx.x == 0) g_stamps[k] = clock64(); } while (0)\ntemplate <class Source>\n"
     "__global__"),
    ("  const unsigned int below = (1u << lane) - 1u;\n",
     "  const unsigned int below = (1u << lane) - 1u;\n  STAMP(0);\n"),
    ("s.count[i] = 0;\n  __syncthreads();", "s.count[i] = 0;\n  __syncthreads(); STAMP(1);"),
    ("    at += __popc(ballot);\n  }\n  __syncthreads();",
     "    at += __popc(ballot);\n  }\n  __syncthreads(); STAMP(2);"),
    ("    sync_all(cluster, blocks);\n    unsigned int digit_all",
     "    sync_all(cluster, blocks); STAMP(10 + 10 * pass);\n    unsigned int digit_all"),
    ("    __syncthreads();\n    all = s.all;",
     "    __syncthreads(); STAMP(11 + 10 * pass);\n    all = s.all;"),
    ("// the next pass's\n    sync_all(cluster, blocks);",
     "// the next pass's\n    sync_all(cluster, blocks); STAMP(12 + 10 * pass);"),
    ("  if (blocks > 1) cluster.sync();  // no block",
     "  __syncthreads(); STAMP(50);\n  if (blocks > 1) cluster.sync();  // no block"),
]
PHASES = {1: "compaction loads", 2: "compaction", 50: "runs"}
for p in range(4):
    PHASES.update({10 + 10 * p: f"pass {p} counts", 11 + 10 * p: f"pass {p} totals",
                   12 + 10 * p: f"pass {p} scatter"})

MATCH = """__device__ inline unsigned int same_digit(unsigned int d, bool valid) {
  return __match_any_sync(0xFFFFFFFFu, valid ? d : 0x100u + (threadIdx.x & 31)) &
         __ballot_sync(0xFFFFFFFFu, valid);
}

"""
VARIANTS = {
    "design": [],
    "match": ["match"],
    "one_block": [("constexpr int kSpread = 512;", "constexpr int kSpread = 8192;")],
    "two_blocks": [("constexpr int kSpread = 512;", "constexpr int kSpread = 2048;")],
    "cluster8": [("constexpr int kMaxCluster = 16; ", "constexpr int kMaxCluster = 8; ")],
}

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <random>
#include <vector>
#include "scatter.cuh"

struct DenseReturns : in_order_scatter::SumCount {
  const float* returns;
  const float* intensities;
  float origin, resolution;
  int size;
  __device__ unsigned int cell(int i, unsigned int& payload) const {
    payload = __float_as_uint(intensities[i]);
    int c[3];
    for (int a = 0; a < 3; ++a) {
      const float f = floorf((returns[3 * (size_t)i + a] - origin) / resolution);
      if (!(f >= 0.0f && f < (float)size)) return in_order_scatter::kNone;
      c[a] = (int)f;
    }
    return (unsigned int)(((long long)c[0] * size + c[1]) * size + c[2]);
  }
};

int main(int argc, char** argv) {
  const int n = atoi(argv[1]), size = 256;
  std::mt19937 rng(1);
  std::normal_distribution<float> nd(0, 1);
  std::uniform_real_distribution<float> ud(0, 1);
  std::vector<float> pts(3 * n), inten(n);
  for (int i = 0; i < n; ++i) {
    const float x = nd(rng), y = nd(rng), z = nd(rng);
    const float r = sqrtf(x * x + y * y + z * z) + 1e-6f, d = 1.0f + 11.0f * ud(rng);
    pts[3 * i] = x / r * d;
    pts[3 * i + 1] = y / r * d;
    pts[3 * i + 2] = z / r * d * 0.2f;
    inten[i] = 40.0f * ud(rng);
  }
  float *dp, *di, *ds, *dc;
  long long* stamps;
  const size_t cells = (size_t)size * size * size;
  cudaMalloc(&dp, 12 * (size_t)n);
  cudaMalloc(&di, 4 * (size_t)n);
  cudaMalloc(&ds, 4 * cells);
  cudaMalloc(&dc, 4 * cells);
  cudaMemset(ds, 0, 4 * cells);
  cudaMemset(dc, 0, 4 * cells);
  cudaMalloc(&stamps, 64 * 8);
  cudaMemset(stamps, 0, 64 * 8);
  cudaMemcpyToSymbol(in_order_scatter::g_stamps, &stamps, sizeof(stamps));
  cudaMemcpy(dp, pts.data(), 12 * (size_t)n, cudaMemcpyHostToDevice);
  cudaMemcpy(di, inten.data(), 4 * (size_t)n, cudaMemcpyHostToDevice);
  DenseReturns src{{ds, dc}, dp, di, -12.8f, 0.1f, size};
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  float best = 1e9f;
  for (int rep = 0; rep < 20; ++rep) {
    cudaEventRecord(a);
    const cudaError_t err = in_order_scatter::launch(src, n, 3, 0);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    if (err != cudaSuccess || cudaGetLastError() != cudaSuccess) return 1;
    float ms;
    cudaEventElapsedTime(&ms, a, b);
    best = ms < best ? ms : best;
  }
  long long h[64];
  cudaMemcpy(h, stamps, 64 * 8, cudaMemcpyDeviceToHost);
  printf("{\"event_ms\": %.5f, \"stamps\": {", best);
  for (int k = 0; k < 64; ++k) printf("%s\"%d\": %lld", k ? ", " : "", k, h[k]);
  printf("}}\n");
  return 0;
}
"""


def stamped(variant):
    src = open(os.path.join(CSRC, "in_order_scatter.cuh")).read()
    for old, new in STAMPS + [r for r in VARIANTS[variant] if r != "match"]:
        if src.count(old) != 1:
            raise SystemExit(f"{variant}: the header no longer holds {old!r} once")
        src = src.replace(old, new)
    if "match" in VARIANTS[variant]:
        a = src.index("__device__ inline unsigned int same_digit(")
        src = src[:a] + MATCH + src[src.index("// The cluster's barrier"):]
    return src


def main(sizes):
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for variant in VARIANTS:
        folder = os.path.join(OUT, variant)
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, "scatter.cuh"), "w") as f:
            f.write(stamped(variant))
        with open(os.path.join(folder, "harness.cu"), "w") as f:
            f.write(HARNESS)
        procs[variant] = subprocess.Popen(
            [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-fmad=false", "-o", os.path.join(folder, "harness"),
             os.path.join(folder, "harness.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    for variant, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{variant}: nvcc failed\n{log.decode(errors='replace')}")
    for n in sizes:
        for variant in VARIANTS:
            run = subprocess.run([os.path.join(OUT, variant, "harness"), str(n)],
                                 capture_output=True, text=True, timeout=120)
            if run.returncode != 0:
                raise SystemExit(f"{variant} at {n} returns failed: {run.stdout}{run.stderr}")
            out = json.loads(run.stdout)
            stamps = {int(k): v for k, v in out["stamps"].items() if v}
            order = sorted(stamps)
            phases = {PHASES[k]: stamps[k] - stamps[p] for p, k in zip(order, order[1:])}
            print(json.dumps({"variant": variant, "returns": n, "event_ms": out["event_ms"],
                              "cycles": stamps[50] - stamps[0], "phases": phases}), flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [4096, 16384, 32768])
