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
// K9, insert: one launch for a scan's inserts into up to 4 grids (the high
// and low grids of the active submaps), each grid's descriptor in the
// launch's parameters and each grid a thread-block cluster. Per return: the
// hit cell and `free_voxels` cells back along the ray from the sensor
// origin. Every cell changes at most once per scan and a hit wins over a
// miss, so a grid's marks must all be made before any is applied; the
// grids' pools are disjoint, so that barrier spans one cluster, not the
// launch. A cluster (1) writes the grid's new page-table entries (the
// scan's allocation, one upload for all grids) and fills its hash table,
// cluster barrier; (2) marks: a thread per return resolves its candidates
// through the table to pool indices (the reads issued together) and puts
// hit (2) or miss (1) into the index's slot of an open-addressing table
// keyed by pool index, owned by the block its hash picks, through
// distributed shared memory (a compare-and-swap at the hashed slot, its
// candidates' issued together; an OR where the key is there); cluster
// barrier; (3) each block applies its own occupied slots: v = clamp(v +
// (hit ? hit : miss)), known = 1. A slot is one 32-bit word, the pool index
// (below 2^30) and the two state bits, so nothing is zeroed between calls
// and no state is sized to the pool. Each block's table holds every
// candidate of the grid (a power of two above N * (1 + free_voxels)), so no
// hash can overflow it; above kMaxSharedSlots a block's table lives in a
// device-memory slice (the wrapper's scratch), the same template with
// global atomics. Cell indices follow the JAX program: a true division by
// the resolution, floor, and a floor division of the signed products along
// the ray.
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
// Bound: bytes. K9 touches at most 3 N cells of each pool (5 bytes each,
// read and written) and reads N returns and each grid's N mask bytes; K18
// reads N returns and intensities and updates at most N cells (8 bytes
// each, read and written); K10 writes 5 bytes and K19 8 bytes per window
// cell and read only the pages under the window (more than 95% of a scan's
// window bytes are zeros). Design: K9 and
// K18 never sweep the pool (8.4 M cells), and K9's tables are sized to the
// scan, in shared memory at the 3D defaults (64 KB a block, 8 blocks a
// grid); the crops make no division and no page lookup per cell, and store
// 16 bytes a thread.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "in_order_scatter.cuh"
#include "stamps.cuh"

namespace cg = cooperative_groups;

namespace {

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

// Pool index of world cell c, or -1 where it has no page. kFresh: the table
// was written in this launch, so it is read past L1.
template <bool kFresh = false>
__device__ inline long long pool_index(const Paged& g, const int c[3]) {
  const int B = g.page_size, nb = g.num_blocks;
  int block[3], off[3];
  for (int a = 0; a < 3; ++a) {
    if (c[a] < 0 || c[a] >= nb * B) return -1;
    block[a] = c[a] / B;
    off[a] = c[a] - block[a] * B;
  }
  const int* entry = g.table + ((size_t)block[0] * nb + block[1]) * nb + block[2];
  const int page = kFresh ? __ldcg(entry) : *entry;
  if (page < 0 || page >= g.num_pages) return -1;
  return (((long long)page * B + off[0]) * B + off[1]) * B + off[2];
}

// ---------------------------------------------------------------- K9

// One grid of an insert launch; ops/paged_grid_3d.py `_INSERT_GRID` packs it.
struct InsertGrid {
  float* pages;              // (P, B, B, B) log-odds
  uint8_t* known;            // (P, B, B, B)
  int* table;                // (nb, nb, nb), the new entries written here
  const float* grid_origin;  // (3,)
  const uint8_t* mask;       // (n,) the returns this grid takes
  const int* entries;        // (entry_count, 2): flat table index, pool slot
  unsigned int* scratch;     // the cluster's tables in device memory, or null
  float resolution;
  int page_size, num_blocks, num_pages, entry_count, unused;
};
static_assert(sizeof(InsertGrid) == 80, "ops/paged_grid_3d.py _INSERT_GRID packs this layout");

constexpr int kMaxInsertGrids = 4;
constexpr int kInsertThreads = 512;
constexpr int kInsertCluster = 8;         // blocks a grid, at most
constexpr int kMaxSharedSlots = 1 << 15;  // a block's table in shared memory: 128 KB
constexpr int kMarkBatch = 4;   // steps along a ray whose cells a thread looks up together
constexpr int kApplyBatch = 8;  // slots a thread applies together
constexpr unsigned int kFree = 0xFFFFFFFFu;
constexpr unsigned int kKeyMask = (1u << 30) - 1u;  // a slot: state bits << 30 | pool index

struct InsertLaunch {
  InsertGrid g[kMaxInsertGrids];
  const float* sensor_origin;  // (3,)
  const float* returns;        // (n, 3)
  int n, free_voxels, cluster, slot_bits;  // slot_bits: log2 of a block's slots
  float hit_increment, miss_increment, min_log_odds, max_log_odds;
};

struct InsertShape {
  int cluster, slot_bits;
  bool shared;
};

InsertShape insert_shape(int n, int free_voxels) {
  InsertShape s;
  s.cluster = (n + kInsertThreads - 1) / kInsertThreads;
  s.cluster = s.cluster < 1 ? 1 : s.cluster > kInsertCluster ? kInsertCluster : s.cluster;
  const long long candidates = (long long)n * (free_voxels + 1);
  s.slot_bits = 8;
  while ((1ll << s.slot_bits) <= candidates) ++s.slot_bits;
  s.shared = (1ll << s.slot_bits) <= kMaxSharedSlots;
  return s;
}

__device__ inline unsigned int slot_hash(unsigned int key) {
  unsigned int h = key * 0x9E3779B1u;
  h ^= h >> 15;
  h *= 0x85EBCA6Bu;
  return h ^ (h >> 13);
}

// A mark of pool index `key` with `bits`: its owner's table, the slot its
// hash picks and the word it stores there.
struct Mark {
  unsigned int* table;
  unsigned int slot, want;
};

template <bool kShared>
__device__ inline Mark mark_of(const InsertLaunch& L, const InsertGrid& g, unsigned int* local,
                               cg::cluster_group& cluster, unsigned int key, unsigned int bits) {
  const unsigned int h = slot_hash(key);
  const unsigned int owner = (unsigned int)(((h & 0xFFFFu) * (unsigned int)L.cluster) >> 16);
  return {kShared ? cluster.map_shared_rank(local, owner)
                  : g.scratch + ((size_t)owner << L.slot_bits),
          h >> (32 - L.slot_bits), key | (bits << 30)};
}

// Ends a mark whose compare-and-swap at its slot found `cur` there: done
// where the slot was free or holds the key (its missing bits ORed in, not
// waited for); else the next slots, one compare-and-swap each.
__device__ inline void finish_mark(const Mark& m, unsigned int mask, unsigned int cur) {
  const unsigned int key = m.want & kKeyMask, bits = m.want & ~kKeyMask;
  for (unsigned int s = m.slot; cur != kFree; cur = atomicCAS(m.table + s, kFree, m.want)) {
    if ((cur & kKeyMask) == key) {
      if ((cur & bits) != bits) atomicOr(m.table + s, bits);
      return;
    }
    s = (s + 1u) & mask;
  }
}

// Grid (cluster x grids): blockIdx.x / cluster is the grid.
template <bool kShared>
__global__ void __launch_bounds__(kInsertThreads)
    paged_insert_kernel(const __grid_constant__ InsertLaunch L) {
  extern __shared__ unsigned int shared_slots[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned int c = cluster.block_rank();
  const InsertGrid& g = L.g[blockIdx.x / L.cluster];
  const int slots = 1 << L.slot_bits;
  unsigned int* mine = kShared ? shared_slots : g.scratch + ((size_t)c << L.slot_bits);
  STAMP(0);
  const int stride = L.cluster * blockDim.x;
  // The thread's return, read before the first barrier so that the read
  // overlaps the tables' fill; the next one read before this one is marked.
  int i = c * blockDim.x + threadIdx.x;
  bool in = false;
  float ret[3] = {0.0f, 0.0f, 0.0f};
  auto fetch = [&](int at) {
    in = at < L.n && g.mask[at];
    if (in)
      for (int a = 0; a < 3; ++a) ret[a] = L.returns[3 * (size_t)at + a];
  };
  fetch(i);
  for (int s = threadIdx.x; s < slots; s += blockDim.x) mine[s] = kFree;
  for (int e = c * blockDim.x + threadIdx.x; e < g.entry_count; e += stride)
    g.table[g.entries[2 * e]] = g.entries[2 * e + 1];
  STAMP(1);
  cluster.sync();  // the tables are empty and the new entries visible to the cluster
  STAMP(2);

  const Paged p = {g.table, g.grid_origin, g.resolution, g.page_size, g.num_blocks,
                   g.num_pages};
  int origin_cell[3];
  for (int a = 0; a < 3; ++a)
    origin_cell[a] = world_to_cell(L.sensor_origin[a], g.grid_origin[a], g.resolution);
  // A thread's cells along a ray: a batch's table reads are issued
  // together, then its first compare-and-swaps, then their ends.
  const unsigned int mask = (1u << L.slot_bits) - 1u;
  for (; i < L.n; i += stride) {
    const bool here = in;
    int hit[3], delta[3];
    int num_samples = 0;
    for (int a = 0; a < 3; ++a) {
      hit[a] = world_to_cell(ret[a], g.grid_origin[a], g.resolution);
      delta[a] = hit[a] - origin_cell[a];
      num_samples = max(num_samples, abs(delta[a]));
    }
    fetch(i + stride);
    if (!here) continue;
    // k = 0: the hit; k >= 1: the k-th cell back.
    for (int k0 = 0; k0 <= L.free_voxels; k0 += kMarkBatch) {
      long long lin[kMarkBatch];
#pragma unroll
      for (int u = 0; u < kMarkBatch; ++u) {
        const int k = k0 + u;
        lin[u] = -1;
        if (k == 0) {
          lin[u] = pool_index<true>(p, hit);
        } else if (k <= L.free_voxels && num_samples > 0) {
          const int position = max(num_samples - k, 0);
          int cell[3];
          for (int a = 0; a < 3; ++a)
            cell[a] = origin_cell[a] + floor_div(delta[a] * position, num_samples);
          lin[u] = pool_index<true>(p, cell);
        }
      }
      Mark m[kMarkBatch];
      unsigned int cur[kMarkBatch];
#pragma unroll
      for (int u = 0; u < kMarkBatch; ++u) {
        if (lin[u] < 0) continue;
        m[u] = mark_of<kShared>(L, g, shared_slots, cluster, (unsigned int)lin[u],
                                k0 + u == 0 ? 2u : 1u);
        cur[u] = atomicCAS(m[u].table + m[u].slot, kFree, m[u].want);
      }
#pragma unroll
      for (int u = 0; u < kMarkBatch; ++u)
        if (lin[u] >= 0) finish_mark(m[u], mask, cur[u]);
    }
  }
  STAMP(3);
  cluster.sync();  // every mark made; no block reads a peer's table after this
  STAMP(4);

  // A batch's pool reads (a cell most often not in L2) are issued together.
  for (int s0 = threadIdx.x; s0 < slots; s0 += kApplyBatch * blockDim.x) {
    unsigned int w[kApplyBatch];
    float v[kApplyBatch];
#pragma unroll
    for (int u = 0; u < kApplyBatch; ++u) {
      const int s = s0 + u * (int)blockDim.x;
      w[u] = s >= slots ? kFree : kShared ? mine[s] : __ldcg(mine + s);
    }
#pragma unroll
    for (int u = 0; u < kApplyBatch; ++u) v[u] = w[u] != kFree ? g.pages[w[u] & kKeyMask] : 0.0f;
#pragma unroll
    for (int u = 0; u < kApplyBatch; ++u) {
      if (w[u] == kFree) continue;
      const unsigned int lin = w[u] & kKeyMask;
      const float x = v[u] + ((w[u] >> 31) ? L.hit_increment : L.miss_increment);
      g.pages[lin] = fminf(fmaxf(x, L.min_log_odds), L.max_log_odds);
      g.known[lin] = 1;
    }
  }
  STAMP(5);
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

// The device-memory bytes K9's tables take for one grid: 0 where they fit
// in shared memory.
extern "C" long long paged_insert_3d_scratch_bytes(int n, int free_voxels) {
  const InsertShape s = insert_shape(n, free_voxels);
  return s.shared ? 0 : (long long)s.cluster * 4 << s.slot_bits;
}

// `grids` points to `count` (1 .. 4) InsertGrid descriptors in host memory
// (their pools disjoint, each under 2^30 - 1 cells, each `scratch` holding
// paged_insert_3d_scratch_bytes(n, free_voxels) bytes); they go into the
// launch's parameters. The grids share the sensor origin and the n returns.
extern "C" int paged_insert_3d(const void* grids, int count, const void* sensor_origin,
                               const void* returns, int n, int free_voxels,
                               float hit_increment, float miss_increment, float min_log_odds,
                               float max_log_odds, void* stream) {
  if (count < 1 || count > kMaxInsertGrids || n < 0 || free_voxels < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const InsertShape shape = insert_shape(n, free_voxels);
  InsertLaunch L;
  for (int v = 0; v < count; ++v) {
    L.g[v] = static_cast<const InsertGrid*>(grids)[v];
    const InsertGrid& g = L.g[v];
    const long long cells = (long long)g.num_pages * g.page_size * g.page_size * g.page_size;
    if (g.page_size < 1 || cells >= (long long)kKeyMask || (!shape.shared && !g.scratch) ||
        (g.entry_count > 0 && !g.entries))
      return (int)cudaErrorInvalidValue;
  }
  L.sensor_origin = (const float*)sensor_origin;
  L.returns = (const float*)returns;
  L.n = n;
  L.free_voxels = free_voxels;
  L.cluster = shape.cluster;
  L.slot_bits = shape.slot_bits;
  L.hit_increment = hit_increment;
  L.miss_increment = miss_increment;
  L.min_log_odds = min_log_odds;
  L.max_log_odds = max_log_odds;
  auto kernel = shape.shared ? paged_insert_kernel<true> : paged_insert_kernel<false>;
  const size_t smem = shape.shared ? (size_t)4 << shape.slot_bits : 0;
  // Set once per device, so that a launch under stream capture makes no
  // attribute call.
  static int configured = -1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && device != configured) {
    err = cudaFuncSetAttribute(paged_insert_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, 4 * kMaxSharedSlots);
    if (err == cudaSuccess) configured = device;
  }
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned int)(shape.cluster * count), 1, 1);
  config.blockDim = dim3(kInsertThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = (unsigned int)shape.cluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, L);
  if (err != cudaSuccess) return (int)err;
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
