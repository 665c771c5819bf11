// K25 dense_insert_3d, K30 dense_intensity_insert_3d
//
// K25 replaces: cartographer_tpu/ops/grid_3d.py:insert_range_data_3d (l.95)
// with _flat_index (l.88): RangeDataInserter3D::Insert into a dense S^3
// log-odds grid, K9's semantics on a dense index. K30 replaces
// insert_intensities (l.144); see its section at the end of this file.
//
// Two launches after a memset of two S^3 byte scratches. The mark pass runs
// one thread per return and per free-space sample: the return's cell
// (floor of a true division by the resolution) sets its hit byte; sample k
// of the last `num_free_space_voxels` before the hit sets the miss byte of
// origin_cell + floor(delta * max(num_samples - k, 0) / max(num_samples, 1)),
// the division rounding toward -inf as JAX's `//` does (C's `/` truncates
// toward 0, which moves a sample of a negative delta by one cell). Cells
// outside the grid and masked returns mark nothing; every write stores 1, so
// the races between threads are benign. The apply pass, one thread per
// cell, adds hit_lo to hit cells and miss_lo to miss cells that are not
// hits, clamps every cell to [logit(0.1), logit(0.9)] and sets `known`, into
// new output arrays (the JAX function is pure), so every cell is equal to
// the twin's and to the JAX program's.
//
// Bound: bytes. The apply pass reads and writes S^3 x 5 bytes (2.1 M cells at
// S = 128: 21 MB, about 6 us at 3.35 TB/s) and the memset clears 2 x S^3
// bytes; the mark pass reads N x 13 bytes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "in_order_scatter.cuh"

namespace {

constexpr int kThreads = 256;

__device__ inline int floor_div(int a, int b) {  // b > 0
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ inline void world_to_cell(const float* p, const float* origin, float resolution,
                                     int c[3]) {
  for (int a = 0; a < 3; ++a) c[a] = (int)floorf((p[a] - origin[a]) / resolution);
}

__device__ inline long long flat_index(const int c[3], int size) {
  for (int a = 0; a < 3; ++a)
    if (c[a] < 0 || c[a] >= size) return -1;
  return ((long long)c[0] * size + c[1]) * size + c[2];
}

__global__ void mark_kernel(const float* __restrict__ returns, const uint8_t* __restrict__ mask,
                            int n, const float* __restrict__ sensor_origin,
                            const float* __restrict__ grid_origin, float resolution, int size,
                            int free_space, uint8_t* __restrict__ hit,
                            uint8_t* __restrict__ miss) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int per = free_space + 1;
  if (idx >= (long long)n * per) return;
  const int i = (int)(idx / per), k = (int)(idx % per);
  if (!mask[i]) return;
  int h[3];
  world_to_cell(returns + 3 * (size_t)i, grid_origin, resolution, h);
  if (k == 0) {
    const long long lin = flat_index(h, size);
    if (lin >= 0) hit[lin] = 1;
    return;
  }
  int o[3], delta[3];
  world_to_cell(sensor_origin, grid_origin, resolution, o);
  int num_samples = 0;
  for (int a = 0; a < 3; ++a) {
    delta[a] = h[a] - o[a];
    num_samples = max(num_samples, abs(delta[a]));
  }
  if (num_samples <= 0) return;
  const int position = max(num_samples - k, 0);
  int c[3];
  for (int a = 0; a < 3; ++a) c[a] = o[a] + floor_div(delta[a] * position, num_samples);
  const long long lin = flat_index(c, size);
  if (lin >= 0) miss[lin] = 1;
}

__global__ void apply_kernel(const float* __restrict__ log_odds,
                             const uint8_t* __restrict__ known,
                             const uint8_t* __restrict__ hit, const uint8_t* __restrict__ miss,
                             long long cells, float hit_lo, float miss_lo, float min_lo,
                             float max_lo, float* __restrict__ out_log_odds,
                             uint8_t* __restrict__ out_known) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  const bool h = hit[i], m = miss[i] && !h;
  const float v = (log_odds[i] + (h ? hit_lo : 0.0f)) + (m ? miss_lo : 0.0f);
  out_log_odds[i] = fminf(fmaxf(v, min_lo), max_lo);
  out_known[i] = known[i] || h || m;
}

}  // namespace

// `hit` and `miss` are S^3 bytes of scratch; the outputs are new S^3 arrays.
extern "C" int dense_insert_3d(const void* log_odds, const void* known, const void* grid_origin,
                               float resolution, int size, const void* sensor_origin,
                               const void* returns, const void* mask, int n, float hit_lo,
                               float miss_lo, int free_space, float min_lo, float max_lo,
                               void* hit, void* miss, void* out_log_odds, void* out_known,
                               void* stream) {
  if (size < 1 || n < 0 || free_space < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long cells = (long long)size * size * size;
  cudaError_t err = cudaMemsetAsync(hit, 0, cells, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(miss, 0, cells, st);
  if (err != cudaSuccess) return (int)err;
  const long long marks = (long long)n * (free_space + 1);
  if (marks > 0) {
    mark_kernel<<<(unsigned int)((marks + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        (const float*)returns, (const uint8_t*)mask, n, (const float*)sensor_origin,
        (const float*)grid_origin, resolution, size, free_space, (uint8_t*)hit,
        (uint8_t*)miss);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  apply_kernel<<<(unsigned int)((cells + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      (const float*)log_odds, (const uint8_t*)known, (const uint8_t*)hit, (const uint8_t*)miss,
      cells, hit_lo, miss_lo, min_lo, max_lo, (float*)out_log_odds, (uint8_t*)out_known);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- K30
//
// InsertIntensitiesIntoGrid into a dense S^3 running-average grid (sums and
// counts, float32, in place): K18's semantics on a dense index. A return
// adds its intensity and 1 to its cell floor((p - origin) / resolution) (a
// true division) when it is masked in, its intensity is at most the
// threshold (NaN is not) and the cell is inside the cube; the others add
// nothing. XLA's scatter-add on the CPU adds each cell's returns in input
// order, and float atomics would not, so in_order_scatter.cuh does the
// adding: compaction, a stable radix sort of the cell indices (3 passes of
// 8 bits at S = 256) and one thread per run, in shared memory, each cell
// written once. No atomics: the sums equal the twin's and the JAX
// program's bit for bit, and a run on the card repeats. One launch up to
// 131,072 returns (a thread-block cluster of one block per 512 returns, up
// to 16), one more per further 131,072; no scratch.
//
// Bound: bytes, N returns read once (17 bytes each) and every touched
// cell's sum and count read and written once (16 bytes); the barriers of
// the sort and the walk of the longest run make it latency-bound. The grid
// is never swept (16.8 M cells at S = 256).

namespace {

// K30's returns for in_order_scatter: a return's flat cell, or kNone.
struct DenseReturns : in_order_scatter::SumCount {
  const float* returns;
  const float* intensities;
  const uint8_t* mask;
  const float* grid_origin;
  float resolution;
  int size;
  float threshold;

  __device__ unsigned int cell(int i, unsigned int& payload) const {
    // Every load first, so that they overlap.
    const float p[3] = {returns[3 * (size_t)i], returns[3 * (size_t)i + 1],
                        returns[3 * (size_t)i + 2]};
    const bool in = mask[i] != 0;
    const float value = intensities[i];
    payload = __float_as_uint(value);
    if (!in || !(value <= threshold)) return in_order_scatter::kNone;
    int c[3];
    for (int a = 0; a < 3; ++a) {
      const float f = floorf((p[a] - grid_origin[a]) / resolution);
      if (!(f >= 0.0f && f < (float)size)) return in_order_scatter::kNone;
      c[a] = (int)f;
    }
    return (unsigned int)(((long long)c[0] * size + c[1]) * size + c[2]);
  }
};

}  // namespace

// Adds in place into `sums` and `counts` (size^3 each, under 2^32 - 1 cells);
// `passes` radix passes of 8 bits cover the grid's cell indices.
extern "C" int dense_intensity_insert_3d(void* sums, void* counts, const void* grid_origin,
                                         float resolution, int size, const void* returns,
                                         const void* intensities, const void* mask, int n,
                                         float threshold, int passes, void* stream) {
  const long long cells = (long long)size * size * size;
  if (size < 1 || n < 0 || cells >= (long long)in_order_scatter::kNone || passes < 1 ||
      (passes < 4 && cells > (1ll << (8 * passes))))
    return (int)cudaErrorInvalidValue;
  DenseReturns src{{(float*)sums, (float*)counts},
                   (const float*)returns, (const float*)intensities, (const uint8_t*)mask,
                   (const float*)grid_origin, resolution, size, threshold};
  return (int)in_order_scatter::launch(src, n, passes, (cudaStream_t)stream);
}
