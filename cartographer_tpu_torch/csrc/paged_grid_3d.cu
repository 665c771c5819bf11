// K9 paged_insert_3d, K10 paged_crop_3d, K18 paged_intensity_insert_3d,
// K19 paged_intensity_crop_3d
//
// Replaces: cartographer_tpu/ops/paged_grid_3d.py:_insert_paged (l.235),
// crop_dense / _crop_pools (l.323, l.287), _insert_intensity_paged (l.385)
// and crop_dense_intensity (l.410).
//
// A paged grid is a pool of P pages of B^3 voxels (float32 log-odds and a
// known flag, or float32 intensity sums and counts) behind a page table of
// NB^3 int32 slots (-1: no page). Block b covers the world cells
// [b * B, (b + 1) * B) of each axis.
//
// K9, insert. Per return: the hit cell and `free_voxels` cells back along
// the ray from the sensor origin. Every cell changes at most once per scan
// and a hit wins over a miss. Two passes over the N * (1 + free_voxels)
// candidate cells, none over the pool: `mark` resolves each candidate
// through the page table to its pool index, stores it, and ORs a hit (2)
// or miss (1) bit into a per-cell state byte; `apply` takes each
// candidate's state byte with an atomic AND that clears it, so exactly one
// candidate of a cell sees it non-zero, adds the hit or the miss
// increment, clamps and sets known. The state bytes are all zero again
// when the call ends. Cell indices follow the JAX program: a true division
// by the resolution, floor, and a floor division of the signed products
// along the ray.
//
// K10 and K19, crop. One thread per cell of the dense size^3 window whose
// first cell is floor((center - origin) / resolution) - size / 2: block by
// floor division, page lookup, read both pools or write 0 where the block
// has no page or lies outside the table. The window's origin comes out with
// it. One template over the two pools' element types serves the occupancy
// pools (K10: log-odds, known) and the intensity pools (K19: sums, counts),
// so a scan's two high-resolution windows are the same cells.
//
// K18, intensity insert. Each return resolves to its pool index (true
// division, floor, block and page; no cell for a return that is masked out,
// whose intensity is above the threshold or NaN, outside the table or on a
// block without a page), and in_order_scatter.cuh adds each cell's returns
// to its sum and count in their order, the order of the plain twin's
// scatter-add on the CPU and of the JAX program: compaction, a stable radix
// sort of the pool indices (3 passes of 8 bits for the default pool of 2^23
// cells) and one thread per run, all in shared memory. No atomics: the sums
// are the same from run to run, so a run on the card repeats. One launch up
// to 131,072 returns (a thread-block cluster of one block per 512 returns,
// up to 16), one more per further 131,072; no scratch.
//
// Bound: bytes. K9 touches 3 N cells of the pool (5 bytes each, read and
// written) and reads N returns; K18 reads N returns and intensities and
// updates at most N cells (8 bytes each, read and written); K10 writes 5
// bytes and K19 8 bytes per window cell and reads as many from the pages
// the window covers. Design: K9 and K18 never sweep the pool (8.4 M cells);
// the crops run the last axis fastest so a warp reads and writes runs of a
// page row.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "in_order_scatter.cuh"

namespace {

constexpr int kThreads = 256;

struct Paged {
  const int* table;  // (nb, nb, nb)
  const float* origin;  // (3,) world position of the corner of cell (0, 0, 0)
  float resolution;
  int page_size;
  int num_blocks;
  int num_pages;
};

__device__ inline int floor_div(int a, int b) {  // b > 0
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ inline int world_to_cell(float p, float origin, float resolution) {
  return (int)floorf((p - origin) / resolution);
}

// Pool index of world cell c, or -1 where it has no page.
__device__ inline long long pool_index(const Paged& g, const int c[3]) {
  const int B = g.page_size, nb = g.num_blocks;
  int block[3], off[3];
  for (int a = 0; a < 3; ++a) {
    if (c[a] < 0 || c[a] >= nb * B) return -1;
    block[a] = c[a] / B;
    off[a] = c[a] - block[a] * B;
  }
  int page = g.table[((size_t)block[0] * nb + block[1]) * nb + block[2]];
  if (page < 0 || page >= g.num_pages) return -1;
  return (((long long)page * B + off[0]) * B + off[1]) * B + off[2];
}

__device__ inline void or_state(uint8_t* state, long long lin, unsigned int bits) {
  unsigned int* word = reinterpret_cast<unsigned int*>(state + (lin & ~3ll));
  atomicOr(word, bits << (8 * (int)(lin & 3ll)));
}

__device__ inline unsigned int take_state(uint8_t* state, long long lin) {
  unsigned int* word = reinterpret_cast<unsigned int*>(state + (lin & ~3ll));
  int shift = 8 * (int)(lin & 3ll);
  unsigned int old = atomicAnd(word, ~(0xFFu << shift));
  return (old >> shift) & 0xFFu;
}

__global__ void mark_kernel(Paged g, const float* __restrict__ sensor_origin,
                            const float* __restrict__ returns,
                            const uint8_t* __restrict__ mask, int n, int free_voxels,
                            uint8_t* __restrict__ state, long long* __restrict__ cells) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  int per = free_voxels + 1;
  if (idx >= n * per) return;
  int i = idx / per, k = idx % per;  // k = 0: the hit, k >= 1: the k-th cell back
  long long lin = -1;
  if (mask[i]) {
    int hit[3], origin_cell[3], delta[3];
    int num_samples = 0;
    for (int a = 0; a < 3; ++a) {
      hit[a] = world_to_cell(returns[3 * i + a], g.origin[a], g.resolution);
      origin_cell[a] = world_to_cell(sensor_origin[a], g.origin[a], g.resolution);
      delta[a] = hit[a] - origin_cell[a];
      num_samples = max(num_samples, abs(delta[a]));
    }
    if (k == 0) {
      lin = pool_index(g, hit);
    } else if (num_samples > 0) {
      int position = max(num_samples - k, 0);
      int c[3];
      for (int a = 0; a < 3; ++a)
        c[a] = origin_cell[a] + floor_div(delta[a] * position, num_samples);
      lin = pool_index(g, c);
    }
  }
  cells[idx] = lin;
  if (lin >= 0) or_state(state, lin, k == 0 ? 2u : 1u);
}

__global__ void apply_kernel(const long long* __restrict__ cells, int count,
                             uint8_t* __restrict__ state, float* __restrict__ pages,
                             uint8_t* __restrict__ known, float hit_increment,
                             float miss_increment, float min_log_odds, float max_log_odds) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= count) return;
  long long lin = cells[idx];
  if (lin < 0) return;
  unsigned int s = take_state(state, lin);
  if (s == 0) return;  // another candidate of this cell applied the update
  float v = pages[lin] + ((s & 2u) ? hit_increment : miss_increment);
  pages[lin] = fminf(fmaxf(v, min_log_odds), max_log_odds);
  known[lin] = 1;
}

Paged make_paged(const void* table, const void* origin, float resolution, int page_size,
                 int num_blocks, int num_pages) {
  Paged g;
  g.table = (const int*)table;
  g.origin = (const float*)origin;
  g.resolution = resolution;
  g.page_size = page_size;
  g.num_blocks = num_blocks;
  g.num_pages = num_pages;
  return g;
}

template <typename A, typename B>
__global__ void crop_kernel(Paged g, const A* __restrict__ pool_a, const B* __restrict__ pool_b,
                            float cx, float cy, float cz, int size, A* __restrict__ dense_a,
                            B* __restrict__ dense_b, float* __restrict__ window_origin) {
  const float center[3] = {cx, cy, cz};
  int start[3];
  for (int a = 0; a < 3; ++a)
    start[a] = world_to_cell(center[a], g.origin[a], g.resolution) - size / 2;
  size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < 3)
    window_origin[idx] = g.origin[idx] + (float)start[idx] * g.resolution;
  size_t total = (size_t)size * size * size;
  if (idx >= total) return;
  int k = (int)(idx % size);
  int j = (int)((idx / size) % size);
  int i = (int)(idx / ((size_t)size * size));
  int c[3] = {start[0] + i, start[1] + j, start[2] + k};
  long long lin = pool_index(g, c);
  dense_a[idx] = lin >= 0 ? pool_a[lin] : (A)0;
  dense_b[idx] = lin >= 0 ? pool_b[lin] : (B)0;
}

// K18's returns for in_order_scatter: a return's pool index, or kNone.
struct IntensityReturns {
  Paged g;
  const float* returns;
  const float* intensities;
  const uint8_t* mask;
  float threshold;

  __device__ unsigned int cell(int i, float& value) const {
    // Every load first, so that they overlap.
    const float p[3] = {returns[3 * (size_t)i], returns[3 * (size_t)i + 1],
                        returns[3 * (size_t)i + 2]};
    const bool in = mask[i] != 0;
    value = intensities[i];
    if (!in || !(value <= threshold)) return in_order_scatter::kNone;
    int c[3];
    for (int a = 0; a < 3; ++a) c[a] = world_to_cell(p[a], g.origin[a], g.resolution);
    const long long found = pool_index(g, c);
    return found >= 0 ? (unsigned int)found : in_order_scatter::kNone;
  }
};

template <typename A, typename B>
int launch_crop(const void* pool_a, const void* pool_b, const void* table,
                const void* grid_origin, float resolution, int page_size, int num_blocks,
                int num_pages, float cx, float cy, float cz, int size, void* dense_a,
                void* dense_b, void* window_origin, void* stream) {
  Paged g = make_paged(table, grid_origin, resolution, page_size, num_blocks, num_pages);
  size_t total = (size_t)size * size * size;
  if (total == 0) return 0;
  unsigned int blocks = (unsigned int)((total + kThreads - 1) / kThreads);
  crop_kernel<A, B><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      g, (const A*)pool_a, (const B*)pool_b, cx, cy, cz, size, (A*)dense_a, (B*)dense_b,
      (float*)window_origin);
  return (int)cudaGetLastError();
}

}  // namespace

// `state` holds num_pages * page_size^3 zero bytes (padded to a multiple of
// 4) and is zero again on return; `cells` holds n * (free_voxels + 1) int64.
extern "C" int paged_insert_3d(void* pages, void* known, const void* table,
                               const void* grid_origin, float resolution, int page_size,
                               int num_blocks, int num_pages, const void* sensor_origin,
                               const void* returns, const void* mask, int n,
                               float hit_increment, float miss_increment, int free_voxels,
                               float min_log_odds, float max_log_odds, void* state,
                               void* cells, void* stream) {
  Paged g = make_paged(table, grid_origin, resolution, page_size, num_blocks, num_pages);
  int count = n * (free_voxels + 1);
  if (count == 0) return 0;
  int blocks = (count + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  mark_kernel<<<blocks, kThreads, 0, s>>>(g, (const float*)sensor_origin,
                                          (const float*)returns, (const uint8_t*)mask, n,
                                          free_voxels, (uint8_t*)state, (long long*)cells);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  apply_kernel<<<blocks, kThreads, 0, s>>>((const long long*)cells, count, (uint8_t*)state,
                                           (float*)pages, (uint8_t*)known, hit_increment,
                                           miss_increment, min_log_odds, max_log_odds);
  return (int)cudaGetLastError();
}

extern "C" int paged_crop_3d(const void* pages, const void* known, const void* table,
                             const void* grid_origin, float resolution, int page_size,
                             int num_blocks, int num_pages, float cx, float cy, float cz,
                             int size, void* dense, void* dense_known, void* window_origin,
                             void* stream) {
  return launch_crop<float, uint8_t>(pages, known, table, grid_origin, resolution, page_size,
                                     num_blocks, num_pages, cx, cy, cz, size, dense,
                                     dense_known, window_origin, stream);
}

extern "C" int paged_intensity_crop_3d(const void* sums, const void* counts, const void* table,
                                       const void* grid_origin, float resolution,
                                       int page_size, int num_blocks, int num_pages, float cx,
                                       float cy, float cz, int size, void* dense_sums,
                                       void* dense_counts, void* window_origin, void* stream) {
  return launch_crop<float, float>(sums, counts, table, grid_origin, resolution, page_size,
                                   num_blocks, num_pages, cx, cy, cz, size, dense_sums,
                                   dense_counts, window_origin, stream);
}

// Adds in place into `sums` and `counts` (num_pages * page_size^3 each, under
// 2^32 - 1 cells); `passes` radix passes of 8 bits cover the pool's indices.
extern "C" int paged_intensity_insert_3d(void* sums, void* counts, const void* table,
                                         const void* grid_origin, float resolution,
                                         int page_size, int num_blocks, int num_pages,
                                         const void* returns, const void* intensities,
                                         const void* mask, int n, float threshold, int passes,
                                         void* stream) {
  const long long cells = (long long)num_pages * page_size * page_size * page_size;
  if (cells >= (long long)in_order_scatter::kNone || passes < 1 ||
      (passes < 4 && cells > (1ll << (8 * passes))))
    return (int)cudaErrorInvalidValue;
  IntensityReturns src{make_paged(table, grid_origin, resolution, page_size, num_blocks,
                                  num_pages),
                       (const float*)returns, (const float*)intensities, (const uint8_t*)mask,
                       threshold};
  return (int)in_order_scatter::launch(src, n, passes, (float*)sums, (float*)counts,
                                       (cudaStream_t)stream);
}
