// K9 paged_insert_3d, K10 and K19 paged_crop_3d (the occupancy and the
// intensity windows, one launch), K18 paged_intensity_insert_3d
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
// K10 and K19, crop: one launch for a scan's windows (2, or 3 with the
// intensity window), each a descriptor of its two pools (base pointers and
// element bytes: 4 and 1 for K10's log-odds and known, 4 and 4 for K19's
// sums and counts), page table, grid origin, resolution, center and size.
// The copy is typeless. A window's first cell is
// floor((center - origin) / resolution) - size / 2, a true division as in
// the JAX program, computed once per window in each block, and its origin
// comes out with it. Work is destination rows (window, i, j) along the
// last axis, a warp a row, over a persistent grid-stride launch sized from
// the SM count. A row's block coordinates and the page-table lookups of its
// <= size / B + 2 blocks are made once per row; a row whose blocks have no
// page (outside the table, unallocated, or >= num_pages) is written as
// zeros without a read. Otherwise the warp copies the row's page-row
// segments (B cells each) of both pools into shared memory by 16-byte
// cp.async (zeros for the blocks without a page), shifts them by the window
// start's offset within its page (two 16-byte shared loads and a funnel
// shift per 16 bytes) and writes the row with 16-byte streaming stores; the
// bytes before the first 16-byte boundary of a row and after its last are
// written one by one, so any size is taken.
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
// bytes and K19 8 bytes per window cell and read only the pages under the
// window (more than 95% of a scan's window bytes are zeros). Design: K9 and
// K18 never sweep the pool (8.4 M cells); the crops make no division and
// no page lookup per cell, and store 16 bytes a thread.

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

// K18's returns for in_order_scatter: a return's pool index, or kNone.
struct IntensityReturns : in_order_scatter::SumCount {
  Paged g;
  const float* returns;
  const float* intensities;
  const uint8_t* mask;
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
    for (int a = 0; a < 3; ++a) c[a] = world_to_cell(p[a], g.origin[a], g.resolution);
    const long long found = pool_index(g, c);
    return found >= 0 ? (unsigned int)found : in_order_scatter::kNone;
  }
};

// One window of a crop launch; ops/paged_grid_3d.py `_CROP_WINDOW` packs it.
struct CropWindow {
  const void* pool[2];  // (P, B, B, B) elements of element_bytes[q] each
  void* dense[2];       // (size, size, size)
  const int* table;     // (nb, nb, nb)
  const float* grid_origin;
  float* window_origin;  // (3,)
  float center[3];
  float resolution;
  int element_bytes[2];
  int page_size, num_blocks, num_pages, size;
};
static_assert(sizeof(CropWindow) == 96, "ops/paged_grid_3d.py _CROP_WINDOW packs this layout");

constexpr int kMaxWindows = 4;
constexpr int kCropWarps = 8;

struct CropLaunch {
  CropWindow w[kMaxWindows];
  int count;
  int page_slots;    // ints of a warp's page list
  int staged_bytes;  // bytes of a warp's staged page rows of one pool (a multiple of 16)
};

// A window's start, computed once per block.
struct CropPlan {
  int start[3];
  int first_block;  // floor(start[2] / B): the block of a row's first cell
  int shift;        // start[2] - first_block * B
  int blocks;       // the blocks a row spans
  int rows_end;     // rows of this window and those before it
};

// Bytes sh .. sh + 15 of the 32 bytes lo, hi (sh warp-uniform, 0 .. 15).
__device__ inline uint4 byte_window(uint4 lo, uint4 hi, int sh) {
  unsigned a0 = lo.x, a1 = lo.y, a2 = lo.z, a3 = lo.w, a4 = hi.x, a5 = hi.y, a6 = hi.z,
           a7 = hi.w;
  if (sh & 8) { a0 = a2; a1 = a3; a2 = a4; a3 = a5; a4 = a6; a5 = a7; }
  if (sh & 4) { a0 = a1; a1 = a2; a2 = a3; a3 = a4; a4 = a5; }
  const unsigned b = 8u * (sh & 3);
  return make_uint4(__funnelshift_r(a0, a1, b), __funnelshift_r(a1, a2, b),
                    __funnelshift_r(a2, a3, b), __funnelshift_r(a3, a4, b));
}

// The warp writes `bytes` bytes to dst: src[0 ..] from shared memory, or
// zeros where src is null. Bytes before dst's first 16-byte boundary and
// after its last go one by one; the rest as 16-byte streaming stores.
__device__ inline void write_row(unsigned char* dst, const unsigned char* src, int bytes,
                                 int lane) {
  const int head = min(bytes, (int)((16 - ((uintptr_t)dst & 15)) & 15));
  const int chunks = (bytes - head) >> 4;
  const int tail_at = head + 16 * chunks;
  if (lane < head) dst[lane] = src ? src[lane] : 0;
  if (lane < bytes - tail_at) dst[tail_at + lane] = src ? src[tail_at + lane] : 0;
  uint4* out = reinterpret_cast<uint4*>(dst + head);
  if (!src) {
    for (int c = lane; c < chunks; c += 32) __stcs(out + c, make_uint4(0, 0, 0, 0));
    return;
  }
  const int at = (int)((uintptr_t)(src + head) & 15);  // shared memory: its offset
  const uint4* in = reinterpret_cast<const uint4*>(src + head - at);
  if (at == 0) {
    for (int c = lane; c < chunks; c += 32) __stcs(out + c, in[c]);
  } else {
    for (int c = lane; c < chunks; c += 32) __stcs(out + c, byte_window(in[c], in[c + 1], at));
  }
}

// Starts pool q's page rows of one destination row on their way into
// `staged`: segment s (B elements) from page pages[s] by cp.async, zeros
// where pages[s] < 0. The caller waits for them.
__device__ inline void stage_row(const CropWindow& w, int q, const int* pages, int blocks,
                                 int off0, int off1, unsigned char* staged, int lane) {
  const int B = w.page_size;
  const int segment = B * w.element_bytes[q];
  const unsigned char* pool = static_cast<const unsigned char*>(w.pool[q]);
  const int misaligned = segment | (int)((uintptr_t)pool & 15);
  const int width = (misaligned & 15) == 0 ? 16 : (misaligned & 3) == 0 ? 4 : 1;
  const int per = segment / width;  // vectors a segment
  const int ds = 32 / per, dv = 32 - ds * per;
  int s = lane / per, v = lane - s * per;
  for (int idx = lane; idx < blocks * per; idx += 32) {
    const int page = pages[s];
    const unsigned char* from =
        pool + (((size_t)max(page, 0) * B + off0) * B + off1) * segment + (size_t)v * width;
    unsigned char* to = staged + s * segment + v * width;
    const unsigned at = (unsigned)__cvta_generic_to_shared(to);
    if (page < 0) {
      if (width == 16) *reinterpret_cast<uint4*>(to) = make_uint4(0, 0, 0, 0);
      else if (width == 4) *reinterpret_cast<unsigned*>(to) = 0u;
      else *to = 0;
    } else if (width == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(at), "l"(from));
    } else if (width == 4) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(at), "l"(from));
    } else {
      *to = __ldg(from);
    }
    s += ds;
    v += dv;
    if (v >= per) {
      v -= per;
      ++s;
    }
  }
}

__global__ void __launch_bounds__(kCropWarps * 32)
    crop_rows(const __grid_constant__ CropLaunch L) {
  __shared__ CropPlan plan[kMaxWindows];
  extern __shared__ __align__(16) unsigned char warp_memory[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < L.count) {
    const CropWindow& w = L.w[threadIdx.x];
    CropPlan p;
    for (int a = 0; a < 3; ++a)
      p.start[a] = world_to_cell(w.center[a], w.grid_origin[a], w.resolution) - w.size / 2;
    p.first_block = floor_div(p.start[2], w.page_size);
    p.shift = p.start[2] - p.first_block * w.page_size;
    p.blocks = (p.shift + w.size - 1) / w.page_size + 1;
    p.rows_end = 0;
    for (int v = 0; v <= (int)threadIdx.x; ++v) p.rows_end += L.w[v].size * L.w[v].size;
    plan[threadIdx.x] = p;
    if (blockIdx.x == 0)
      for (int a = 0; a < 3; ++a)
        w.window_origin[a] = w.grid_origin[a] + (float)p.start[a] * w.resolution;
  }
  __syncthreads();
  // The warp's shared memory: the row's page list, then its staged page
  // rows of each pool.
  unsigned char* mine = warp_memory + (size_t)warp * (L.page_slots * sizeof(int) +
                                                      2 * L.staged_bytes);
  int* pages = reinterpret_cast<int*>(mine);
  unsigned char* staged = mine + L.page_slots * sizeof(int);
  const int rows = plan[L.count - 1].rows_end;
  for (int row = blockIdx.x * kCropWarps + warp; row < rows; row += gridDim.x * kCropWarps) {
    int v = 0;
    while (row >= plan[v].rows_end) ++v;
    const CropWindow& w = L.w[v];
    const CropPlan& p = plan[v];
    const int B = w.page_size, nb = w.num_blocks, size = w.size;
    const int r = row - (v ? plan[v - 1].rows_end : 0);
    const int i = r / size, j = r - i * size;
    const int c0 = p.start[0] + i, c1 = p.start[1] + j;
    const bool inside = c0 >= 0 && c0 < nb * B && c1 >= 0 && c1 < nb * B;
    const int b0 = inside ? c0 / B : 0, b1 = inside ? c1 / B : 0;
    bool any = false;
    for (int s = lane; s < p.blocks; s += 32) {
      const int kb = p.first_block + s;
      int page = -1;
      if (inside && kb >= 0 && kb < nb) {
        page = __ldg(w.table + ((size_t)b0 * nb + b1) * nb + kb);
        if (page >= w.num_pages) page = -1;
      }
      pages[s] = page;
      any |= page >= 0;
    }
    any = __any_sync(0xffffffffu, any);
    __syncwarp();
    if (any) {  // both pools' page rows on their way at once
      for (int q = 0; q < 2; ++q)
        stage_row(w, q, pages, p.blocks, c0 - b0 * B, c1 - b1 * B, staged + q * L.staged_bytes,
                  lane);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncwarp();
    }
    for (int q = 0; q < 2; ++q) {
      const int E = w.element_bytes[q];
      write_row(static_cast<unsigned char*>(w.dense[q]) + (size_t)r * size * E,
                any ? staged + q * L.staged_bytes + p.shift * E : nullptr, size * E, lane);
    }
    __syncwarp();  // before the next row is staged
  }
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

// `windows` points to `count` (1 .. 4) CropWindow descriptors in host
// memory; they go into the launch's parameters.
extern "C" int paged_crop_3d(const void* windows, int count, void* stream) {
  if (count < 1 || count > kMaxWindows) return (int)cudaErrorInvalidValue;
  CropLaunch L;
  L.count = count;
  int page_slots = 0, staged = 0;
  long long rows = 0;
  for (int v = 0; v < count; ++v) {
    L.w[v] = static_cast<const CropWindow*>(windows)[v];
    const CropWindow& w = L.w[v];
    if (w.page_size < 1 || w.size < 0 || w.element_bytes[0] < 1 || w.element_bytes[1] < 1)
      return (int)cudaErrorInvalidValue;
    const int blocks = (w.page_size - 1 + w.size - 1) / w.page_size + 1;  // at any shift
    page_slots = max(page_slots, (blocks + 3) & ~3);
    for (int q = 0; q < 2; ++q)  // + 16: the shift's second load may pass the end
      staged = max(staged, ((blocks * w.page_size * w.element_bytes[q] + 15) & ~15) + 16);
    rows += (long long)w.size * w.size;
  }
  if (rows >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  L.page_slots = page_slots;
  L.staged_bytes = staged;
  const size_t smem = (size_t)kCropWarps * (page_slots * sizeof(int) + 2 * staged);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(crop_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, crop_rows, kCropWarps * 32,
                                                           smem)) != cudaSuccess)
    return (int)err;
  const long long needed = (rows + kCropWarps - 1) / kCropWarps;
  const int grid = (int)max(1ll, min(needed, (long long)sms * max(per_sm, 1)));
  crop_rows<<<grid, kCropWarps * 32, smem, (cudaStream_t)stream>>>(L);
  return (int)cudaGetLastError();
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
  IntensityReturns src{{(float*)sums, (float*)counts},
                       make_paged(table, grid_origin, resolution, page_size, num_blocks,
                                  num_pages),
                       (const float*)returns, (const float*)intensities, (const uint8_t*)mask,
                       threshold};
  return (int)in_order_scatter::launch(src, n, passes, (cudaStream_t)stream);
}
