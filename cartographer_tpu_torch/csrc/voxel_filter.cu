// K2 voxel_filter, K31 voxel_filter_edge
//
// K2 replaces: cartographer_tpu/sensor/voxel_filter.py:voxel_filter_mask
// (l.67, with _packed_voxel_keys l.38) and adaptive_voxel_filter (l.97).
// K31 replaces voxel_filter_edge (l.145, with _run_boundaries l.25); see its
// section at the end of this file.
//
// The JAX filter shuffles the cloud with a permutation, stable-sorts it by
// packed voxel key and keeps the last point of each run of equal keys. The
// last point of a run is the one with the highest position in the shuffled
// order, so here every valid point inserts its key into an open-addressing
// hash and does atomicMax with its rank (its position in the permutation);
// a point is kept when its rank is its voxel's maximum. With the same
// permutation the mask is bit-identical to the JAX one. A voxel count needs
// keys only: the number of keys a point inserted first.
//
// Keys: floor(p / resolution + 0.5) per axis (a division, as JAX; K2 takes
// the product with the float32 reciprocal where that provably gives the same
// index, `axis_index(float, Length)`), clipped to [-2^15, 2^15 - 2] and
// biased by 2^15;
// x and y packed into one 32-bit word, z (3D clouds) into a second word. A
// 2D key is one 32-bit word (a table of 4,096 slots: 16 KB), a 3D key 64 bits.
//
// One launch takes R robots' clouds (robot 0's points, mask and permutation
// plus the robot times a robot stride in elements), an optional random
// filter (`pre`: keys over the first pre_dim coordinates) and up to two
// adaptive filters (keys over the first `dim` coordinates) that read the
// random filter's keep-mask where there is one, else the input mask. The
// keep-masks are (outputs, robots, n): the random filter's first, then one
// per adaptive filter. The 2D step makes its three filters one launch: the
// random filter at voxel_filter_size on the 3D hits, the matcher's and the
// loop closure's adaptive filters on their x and y.
//
// K1 in K2's launch (`scan_filter_2d`, the 2D step's one launch; K1 replaces
// cartographer_tpu/ops/scan_pipeline_2d.py:preprocess_scan_2d, l.40-104,
// up to its voxel filter): instead of reading the hits, each block computes
// the gravity-aligned hits and return flags of its part of the points with
// K1's own code (scan_preprocess_2d.cuh) into its copy of the cloud, in
// shared memory (or its scratch slice); after a cluster barrier each block
// copies the other parts from its peers through distributed shared memory,
// 16 bytes a load. So K1's outputs equal the standalone K1's bit for bit
// and the masks those of K2 on them. The first filter's cluster writes K1's
// outputs for the rest of the step, its block 0 the aligned origin. One
// launch less a scan: the standalone K1's few microseconds were one small
// kernel's floor.
//
// The adaptive search (the JAX program's 7 halving lengths, then 5
// bisection steps, then the mask) is 3 dependent phases, on one thread-block
// cluster of C blocks per (robot, adaptive filter):
//   A. the 7 coarse counts side by side, block k counting max_length / 2^k
//      (block k % C, in rounds, where C < 7);
//   B. only where 1 <= first_ok <= 6 (first_ok as the sequential loop
//      takes it): the 31 lengths the depth-5 bisection can visit below the
//      coarse interval, counted side by side (node j of the tree in heap
//      order on block j % C, up to 4 tables a block at once). Each node's
//      length comes from walking its path from low = max_length /
//      2^first_ok, high = max_length / 2^(first_ok - 1) with the sequential
//      loop's own float32 mid = 0.5f * (low + high), so the length the walk
//      of the 5 counts then chooses is bit-identical;
//   C. the final mask at the chosen length, with the ranks.
// Where the launch's clusters leave fewer than kSmsPerCluster SMs each
// (robots x filters above 4 on an H100's 132), the 31 speculative passes
// cost more than a dependent round saves, and phase B counts in two rounds:
// the 7 nodes of depths 0-2, the walk down them, then the 3 nodes of depths
// 3-4 below the node it reached (4 dependent phases, 10 lengths counted).
// Measured on an H100 (`tests/robot_batch_timing.py ... k2-shapes`): two
// rounds cost 0.0016-0.0019 ms more with 2 clusters, and save 0.0005 /
// 0.0017 / 0.0091 ms with 8 / 16 / 32.
// The search reads each count only against min_num_points, so a table
// stops counting once it reaches it (a fine length's table after a few
// hundred points). Counts pass between the cluster's blocks through
// distributed shared memory and cluster barriers, never through device
// memory; there is no host synchronisation. A mask pass (the random filter,
// phase C) is spread over the cluster: block c inserts only the keys whose
// hash is c modulo the cluster size and writes the flags of those points,
// the random filter's into every block's shared memory (one more cluster
// barrier), so each block makes 1/C of the pass's atomics (a block still
// computes every point's key: sharing the keys through distributed shared
// memory measured slower). A random
// filter alone is one block per robot. C and the block's threads: the
// widest of 16 x 1024, 8 x 1024, 8 x 512, 4 x 1024 of which the card holds
// all the launch's clusters at once, else 4 x 512 (`choose`, from the
// card's occupancy for the launch, cached by shape under a lock; one
// robot's two filters take 16 x 1024); 8 x 512 above kMaxSharedPoints.
//
// Bound: operations, not bytes. A scan of 2,048 points is 25 KB in and 6 KB
// out, but the search inserts points into up to 7 + 31 + 1 tables (+1 for
// the random filter), each insertion a multiply per axis (a division near a
// cell boundary) and a shared memory read or atomic: a plain read finds a
// key already inserted, and a lane whose key equals its left neighbour's (a
// scan comes in angle order) inserts nothing. The kernel is bound by the
// latency of these chains on the few SMs a cluster holds. Up to
// kMaxSharedPoints (4,096) points a block keeps its tables, the inverse
// permutation, per-point slots and flags and a copy of the coordinates in
// dynamic shared memory (108 KB at 2,048 points with 2D keys: two blocks an
// SM); where 4 tables do not fit (3D keys at 4,096 points) a block counts
// its lengths in rounds of as many as fit.
//
// Above kMaxSharedPoints the same kernel, with the same 3 phases in the same
// clusters, keeps those arrays in a device-memory scratch the wrapper
// passes, one slice per block (L2-resident at the 3D path's 16,384 points),
// with global atomics: one template, two storage places, the same mask bit
// for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <map>
#include <mutex>

#include "bitonic_sort.cuh"
#include "scan_preprocess_2d.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned long long kEmpty = 0xFFFFFFFFFFFFFFFFull;
constexpr int kThreads = 512;      // a block's threads, or kMaxThreads (`choose`)
constexpr int kMaxThreads = 1024;
constexpr int kCoarseSteps = 7;
constexpr int kBisectSteps = 5;
constexpr int kNodes = (1 << kBisectSteps) - 1;  // the bisection's tree: 31 lengths
constexpr int kMaxTables = 4;                     // tables a block counts at once
constexpr int kCluster = 8;  // blocks per (robot, adaptive filter) above kMaxSharedPoints
constexpr int kSmsPerCluster = 32;  // fewer SMs a cluster: phase B in two rounds
constexpr int kSplit = 3;           // the first round's levels where it takes two
constexpr int kMaxSharedPoints = 4096;
constexpr int kMaxFilters = 2;
// An H100 block's shared memory (227 KB) less 1 KB for the kernel's static arrays.
constexpr int kSharedBudget = 226 * 1024;

// Per adaptive filter (blockIdx.y): max_length, min_num_points, max_range.
struct Filters {
  float length[kMaxFilters];
  int min_num_points[kMaxFilters];
  float max_range[kMaxFilters];
};

template <typename Key>
struct Empty;
template <>
struct Empty<uint32_t> {
  static constexpr uint32_t value = 0xFFFFFFFFu;  // above every packed 2D key
};
template <>
struct Empty<unsigned long long> {
  static constexpr unsigned long long value = kEmpty;
};

static_assert(sizeof(scan2d::ScanArgs) == 208,
              "sensor/voxel_filter.py _SCAN_ARGS packs this layout");

// A block's arrays, in shared memory or in its scratch slice.
struct Block {
  unsigned char* region;  // the hash tables of the pass at hand
  int* inv;               // [n] rank of point i in the permutation
  int* slot;              // [n] table slot of point i (a mask pass)
  uint8_t* base;          // [n] points taking part
  uint8_t* kept;          // [n] the random filter's mask, written by the points' owners
  const float* pts;       // point i at pts + i * pstride
  int pstride;
  int n;
  int bits;  // log2 of a table's slots
};

__device__ inline int axis_index(float v, float resolution) {
  float f = floorf(v / resolution + 0.5f);
  f = fminf(fmaxf(f, -32768.0f), 32766.0f);
  return (int)f + 32768;
}

__device__ inline unsigned long long voxel_key(const float* p, int dim, float resolution) {
  unsigned int ix = axis_index(p[0], resolution);
  unsigned int iy = axis_index(p[1], resolution);
  unsigned long long key = (ix << 16) | iy;
  if (dim == 3) key |= (unsigned long long)axis_index(p[2], resolution) << 32;
  return key;
}

// K2's voxel length: the resolution and its float32 reciprocal.
struct Length {
  float resolution, inverse;
};

__device__ inline Length length_of(float resolution) { return {resolution, 1.0f / resolution}; }

// axis_index by a multiply: v * inverse lies within 3 ulps of the quotient
// v / resolution, so the two sums with 0.5f lie within 4 ulps of each other
// and have the same floor unless the product's sum lies within 8 ulps of an
// integer; there (rarely) the division decides. The same index, bit for bit.
__device__ inline int axis_index(float v, Length l) {
  const float y = v * l.inverse + 0.5f;
  float f = floorf(y);
  const float guard = fmaxf(fabsf(y), 1.0f) * 9.5367431640625e-07f;  // 8 ulps: 2^-20 |y|
  const float d = y - f;
  if (d < guard || d > 1.0f - guard) f = floorf(v / l.resolution + 0.5f);
  f = fminf(fmaxf(f, -32768.0f), 32766.0f);
  return (int)f + 32768;
}

template <typename Key>
__device__ inline Key key_of(const float* p, int dim, Length l);
template <>
__device__ inline uint32_t key_of<uint32_t>(const float* p, int, Length l) {
  return ((uint32_t)axis_index(p[0], l) << 16) | (uint32_t)axis_index(p[1], l);
}
template <>
__device__ inline unsigned long long key_of<unsigned long long>(const float* p, int dim,
                                                                Length l) {
  unsigned long long key = ((unsigned long long)axis_index(p[0], l) << 16) | axis_index(p[1], l);
  if (dim == 3) key |= (unsigned long long)axis_index(p[2], l) << 32;
  return key;
}

__device__ inline unsigned int hash_of(uint32_t key, int bits) {
  return (key * 0x9E3779B1u) >> (32 - bits);
}
__device__ inline unsigned int hash_of(unsigned long long key, int bits) {
  return (unsigned int)((key * 0x9E3779B97F4A7C15ull) >> (64 - bits));
}

// Inserts `key`, probing from slot h (its hash); returns its slot and sets
// *is_new for the inserting thread. A slot already holding the key is found
// by a plain read, so the points of one voxel do not queue on one atomic.
template <typename Key>
__device__ __forceinline__ int insert_key(Key* keys, int bits, Key key, unsigned int h,
                                          bool* is_new) {
  const unsigned int mask = (1u << bits) - 1u;
  while (true) {
    Key cur = *(volatile Key*)(keys + h);
    if (cur == Empty<Key>::value) {
      cur = atomicCAS(keys + h, Empty<Key>::value, key);
      if (cur == Empty<Key>::value) {
        *is_new = true;
        return (int)h;
      }
    }
    if (cur == key) {
      *is_new = false;
      return (int)h;
    }
    h = (h + 1) & mask;
  }
}

template <typename T>
__device__ __forceinline__ void fill(T* a, int count, T v) {
  for (int k = threadIdx.x; k < count; k += blockDim.x) a[k] = v;
}

// The length of node j (heap order) of the bisection's tree below (low,
// high): the path walked as the sequential loop walks it (bit 1: the count
// was enough, low = mid), then its mid.
__device__ inline float node_length(int j, float low, float high) {
  const int path = j + 1;
  for (int b = 30 - __clz(path); b >= 0; --b) {
    const float mid = 0.5f * (low + high);
    if ((path >> b) & 1) {
      low = mid;
    } else {
      high = mid;
    }
  }
  return 0.5f * (low + high);
}

// The insertions of a mask pass at `resolution` (keys over `dim`
// coordinates): each owned base point's key and rank (atomicMax); its slot
// into s.slot, -1 for the points the block does not own.
template <typename Key>
__device__ __forceinline__ void mask_insert(const Block& s, int dim, float resolution, int c,
                                            int cluster) {
  const int slots = 1 << s.bits;
  Key* keys = reinterpret_cast<Key*>(s.region);
  unsigned int* ranks = reinterpret_cast<unsigned int*>(keys + slots);
  const Length l = length_of(resolution);
  fill(keys, slots, Empty<Key>::value);
  fill(ranks, slots, 0u);
  __syncthreads();
  for (int i = threadIdx.x; i < s.n; i += blockDim.x) {
    int h = -1;
    if (s.base[i]) {
      const Key key = key_of<Key>(s.pts + (size_t)i * s.pstride, dim, l);
      const unsigned int h0 = hash_of(key, s.bits);
      if ((int)(h0 % (unsigned int)cluster) == c) {
        bool is_new;
        h = insert_key(keys, s.bits, key, h0, &is_new);
        const unsigned int rank = (unsigned int)s.inv[i];
        if (*(volatile unsigned int*)(ranks + h) < rank) atomicMax(ranks + h, rank);
      }
    }
    s.slot[i] = h;
  }
  __syncthreads();
}

// Block dst's copy of this block's array `a` (block c of the cluster): in
// its shared memory, or in its slice of the scratch.
template <bool kGlobal, typename T>
__device__ __forceinline__ T* peer_of(T* a, int dst, int c, long long slice) {
  if (kGlobal)
    return reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(a) + (long long)(dst - c) * slice);
  return cg::this_cluster().map_shared_rank(a, (unsigned int)dst);
}

// The flags of a mask pass: each owned point kept when its rank is its
// voxel's highest, into every cluster block's `kept` (with `exchange`) and
// into `out` (device memory, may be null), whose points outside the base
// the blocks clear in stripes.
template <bool kGlobal, typename Key>
__device__ __forceinline__ void mask_write(const Block& s, int c, int cluster, long long slice,
                                           bool exchange, uint8_t* __restrict__ out) {
  const unsigned int* ranks =
      reinterpret_cast<const unsigned int*>(reinterpret_cast<Key*>(s.region) + (1 << s.bits));
  for (int i = threadIdx.x; i < s.n; i += blockDim.x) {
    const int h = s.slot[i];
    if (h >= 0) {
      const uint8_t k = ranks[h] == (unsigned int)s.inv[i];
      if (exchange)
        for (int dst = 0; dst < cluster; ++dst) peer_of<kGlobal>(s.kept, dst, c, slice)[i] = k;
      if (out) out[i] = k;
    } else if (out && !s.base[i] && i % cluster == c) {
      out[i] = 0;
    }
  }
}

// Whether the base points' voxels at lengths[0, nt) number at least
// `enough`, side by side in nt tables: into totals[0, nt) (zeroed by the
// caller before the barrier that follows its clearing of the tables) the
// count, or a number >= `enough` once a table's count reaches it (the walk
// needs only the comparison: a table stops there). A lane whose key equals
// its left neighbour's (a scan comes in angle order) does not insert it.
template <typename Key>
__device__ __forceinline__ void count_pass(const Block& s, int dim,
                                           const float (&lengths)[kMaxTables], int nt,
                                           int enough, int* totals) {
  const int slots = 1 << s.bits, lane = threadIdx.x & 31;
  Key* tables = reinterpret_cast<Key*>(s.region);
  unsigned int open = (1u << nt) - 1u;  // the tables still counting: the same in a warp
  Length l[kMaxTables];
#pragma unroll
  for (int t = 0; t < kMaxTables; ++t) l[t] = length_of(lengths[t]);
  for (int i = threadIdx.x; i - lane < s.n; i += blockDim.x) {
    const bool valid = i < s.n && s.base[i];
    const float* p = s.pts + (size_t)(valid ? i : 0) * s.pstride;
#pragma unroll
    for (int t = 0; t < kMaxTables; ++t) {
      if ((open >> t) & 1u) {  // the same in the warp
        const Key key = valid ? key_of<Key>(p, dim, l[t]) : Empty<Key>::value;
        const Key left = __shfl_up_sync(0xFFFFFFFFu, key, 1);
        bool is_new = false;
        if (valid && (lane == 0 || left != key))
          insert_key(tables + (size_t)t * slots, s.bits, key, hash_of(key, s.bits), &is_new);
        const int v = __reduce_add_sync(0xFFFFFFFFu, (int)is_new);
        if (lane == 0 && v) atomicAdd(totals + t, v);
      }
    }
    unsigned int reached = 0;
    if (lane == 0)
      for (int t = 0; t < nt; ++t)
        if (*(volatile int*)(totals + t) >= enough) reached |= 1u << t;
    open &= ~__shfl_sync(0xFFFFFFFFu, reached, 0);
    if (!open) break;
  }
  __syncthreads();
}

// The counts of lengths 0 .. total - 1 (the coarse lengths max_length / 2^j,
// or the bisection tree's nodes below (low, high)) over the cluster, as
// count_pass leaves them: block c counts lengths c, c + cluster, ... in
// rounds of `tables` and writes each into counts[j] of every block of the
// cluster.
template <typename Key>
__device__ __forceinline__ void count_lengths(const Block& s, int dim, int c, int cluster,
                                              int tables, int total, bool coarse, float a,
                                              float b, int enough, int* totals, int* counts,
                                              cg::cluster_group& team) {
  const int slots = 1 << s.bits;
  Key* table = reinterpret_cast<Key*>(s.region);
  for (int j0 = c; j0 < total; j0 += cluster * tables) {
    float lengths[kMaxTables] = {1.0f, 1.0f, 1.0f, 1.0f};
    int nt = 0;
#pragma unroll
    for (int t = 0; t < kMaxTables; ++t) {
      const int j = j0 + t * cluster;
      if (t < tables && j < total) {
        lengths[t] = coarse ? a / (float)(1 << j) : node_length(j, a, b);
        nt = t + 1;
      }
    }
    fill(table, nt * slots, Empty<Key>::value);
    if (threadIdx.x < kMaxTables) totals[threadIdx.x] = 0;
    __syncthreads();
    count_pass<Key>(s, dim, lengths, nt, enough, totals);
    for (int q = threadIdx.x; q < nt * cluster; q += blockDim.x) {
      const int t = q / cluster;
      *team.map_shared_rank(&counts[j0 + t * cluster], (unsigned int)(q % cluster)) =
          totals[t];
    }
    __syncthreads();  // totals read before the next round zeroes them
  }
}

__device__ inline void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ inline void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Grid (robots x cluster, max(1, filters)); a cluster of `cluster` blocks
// per (robot, adaptive filter), one block per robot without adaptive
// filters. kGlobal: each block's arrays live in its slice of `scratch`.
// kScan: the cloud is K1's aligned hits and return flags of `scan`, and the
// first filter's cluster writes K1's outputs (`points` and `mask` unused).
template <bool kGlobal, typename Key, bool kScan>
__global__ void __launch_bounds__(kMaxThreads)
    voxel_filter_kernel(const __grid_constant__ scan2d::ScanArgs scan,
                        const float* __restrict__ points, int stride, long long points_rs,
                        const uint8_t* __restrict__ mask, long long mask_rs,
                        const int* __restrict__ perm, long long perm_rs, int n, int bits,
                        float pre_resolution, int pre_dim, int filters, int dim,
                        Filters params, int cluster, int split, int tables,
                        long long region_bytes,
                        uint8_t* __restrict__ keep, unsigned char* scratch, long long slice) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int counts[kCoarseSteps + kNodes];  // written by every block of the cluster
  __shared__ int totals[kMaxTables];
  __shared__ int num_base;
  const int c = (int)(blockIdx.x % cluster), f = (int)blockIdx.y;
  const long long robots = gridDim.x / cluster, r = blockIdx.x / cluster;
  const bool clustered = filters > 0;
  points += r * points_rs;
  mask += r * mask_rs;
  perm += r * perm_rs;
  const int pdim = pre_dim > dim ? pre_dim : dim;

  Block s;
  s.region = kGlobal ? scratch + ((long long)f * gridDim.x + blockIdx.x) * slice : smem;
  unsigned char* q = s.region + region_bytes;
  s.inv = reinterpret_cast<int*>(q);
  q += (4LL * n + 15) & ~15LL;
  s.slot = reinterpret_cast<int*>(q);
  q += (4LL * n + 15) & ~15LL;
  float* copy = reinterpret_cast<float*>(q);
  if (!kGlobal || kScan) q += (4LL * n * pdim + 15) & ~15LL;
  s.base = q;
  q += (n + 15) & ~15;
  s.kept = q;
  s.pts = kGlobal && !kScan ? points : copy;
  s.pstride = kGlobal && !kScan ? stride : pdim;
  s.n = n;
  s.bits = bits;

  if (threadIdx.x == 0) num_base = 0;
  if constexpr (kScan) {  // K1: pdim is 3, the hits' coordinates
    // Block c computes K1 for its part of the points (a multiple of 16, so
    // that each part starts on 16 bytes of both arrays) into its own arrays;
    // after a cluster barrier it copies the other parts from its peers, 16
    // bytes a load, every peer's vectors spread over all its threads.
    const scan2d::Rows rows = scan2d::rows_of(scan, r);
    const scan2d::ScanPose pose = scan2d::scan_pose(scan, r);
    const int part = ((n + cluster - 1) / cluster + 15) & ~15;
    for (int j = c * part + (int)threadIdx.x; j < min(n, (c + 1) * part); j += blockDim.x) {
      const scan2d::Aligned a = scan2d::align_point(scan, pose, rows, j);
      copy[3 * j] = a.hit[0];
      copy[3 * j + 1] = a.hit[1];
      copy[3 * j + 2] = a.hit[2];
      s.base[j] = a.is_return;
      if (f == 0) scan2d::write_point(scan, r, n, j, a);
    }
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const int i = perm[j];
      if (i >= 0 && i < n) s.inv[i] = j;
      s.kept[j] = 0;
    }
    if (f == 0 && c == 0 && threadIdx.x == 0) scan2d::write_origin(scan, pose, r);
    if (clustered) {
      cluster_arrive();
      cluster_wait();
      // A part's hits are 3 * part / 4 vectors and its flags part / 16; the
      // arrays' 16-byte padding takes the last part's rounding.
      const int hit_vectors = 3 * part / 4, per_part = hit_vectors + part / 16;
      for (int v = threadIdx.x; v < (cluster - 1) * per_part; v += blockDim.x) {
        const int peer = (c + 1 + v / per_part) % cluster, w = v % per_part, lo = peer * part;
        if (lo >= n) continue;
        if (w < hit_vectors) {
          if (4 * w >= 3 * (n - lo)) continue;
          reinterpret_cast<uint4*>(copy + 3 * lo)[w] =
              reinterpret_cast<const uint4*>(peer_of<kGlobal>(copy, peer, c, slice) + 3 * lo)[w];
        } else if (16 * (w - hit_vectors) < n - lo) {
          reinterpret_cast<uint4*>(s.base + lo)[w - hit_vectors] =
              reinterpret_cast<const uint4*>(peer_of<kGlobal>(s.base, peer, c, slice) +
                                             lo)[w - hit_vectors];
        }
      }
    }
  } else {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const int i = perm[j];  // the loads first, then the stores
      const uint8_t m = mask[j];
      const float* p = points + (size_t)j * stride;
      float x = 0.0f, y = 0.0f, z = 0.0f;
      if (!kGlobal) {
        x = p[0];
        y = p[1];
        if (pdim == 3) z = p[2];
      }
      if (i >= 0 && i < n) s.inv[i] = j;
      s.base[j] = m != 0;
      s.kept[j] = 0;
      if (!kGlobal) {
        copy[j * pdim] = x;
        copy[j * pdim + 1] = y;
        if (pdim == 3) copy[j * pdim + 2] = z;
      }
    }
  }
  // The blocks' start: a block writes into another's `kept` and counts only
  // once every block of the cluster runs and has cleared its own.
  if (clustered) cluster_arrive();
  __syncthreads();
  if (pre_dim > 0) {  // the random filter: its mask becomes the base flags
    mask_insert<unsigned long long>(s, pre_dim, pre_resolution, c, cluster);
    if (clustered) cluster_wait();
    mask_write<kGlobal, unsigned long long>(s, c, cluster, slice, true,
                                            f == 0 ? keep + r * n : nullptr);
    if (clustered) {
      cluster_arrive();
      cluster_wait();
    } else {
      __syncthreads();
    }
    s.base = s.kept;
  } else if (clustered) {
    cluster_wait();
  }
  if (!clustered) return;
  uint8_t* out = keep + (((pre_dim > 0) + f) * robots + r) * n;
  const float max_length = params.length[f], max_range = params.max_range[f];
  const int min_num_points = params.min_num_points[f];

  // The range gate and the number of base points, in every block.
  int local = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    bool b = s.base[i] != 0;
    if (b) {
      const float* p = s.pts + (size_t)i * s.pstride;
      float sq = 0.0f;
      for (int d = 0; d < dim; ++d) sq += p[d] * p[d];
      b = sqrtf(sq) <= max_range;
    }
    s.base[i] = b;
    local += b;
  }
  local = __reduce_add_sync(0xFFFFFFFFu, local);
  if ((threadIdx.x & 31) == 0 && local) atomicAdd(&num_base, local);
  __syncthreads();
  if (num_base <= min_num_points) {  // the same in every block of the cluster
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      if (i % cluster == c) out[i] = s.base[i];
    return;
  }
  cg::cluster_group team = cg::this_cluster();  // the counts' exchange

  // Phase A: the coarse lengths max_length / 2^k.
  count_lengths<Key>(s, dim, c, cluster, tables, kCoarseSteps, true, max_length, 0.0f,
                     min_num_points, totals, counts, team);
  cluster_arrive();
  cluster_wait();
  int first_ok = -1;
  for (int k = 0; k < kCoarseSteps; ++k) {
    if (counts[k] >= min_num_points) {
      first_ok = k;
      break;
    }
  }
  float resolution;
  if (first_ok < 0) {
    resolution = max_length / (float)(1 << (kCoarseSteps - 1));
  } else if (first_ok == 0) {
    resolution = max_length;
  } else {
    // Phase B: the bisection tree's nodes below (low, high), `split` levels
    // a round (all 5, or 3 then 2), each round's counts then the sequential
    // loop's walk down its levels. A round's counts take slots no later
    // round writes, so a block may start the next round while a peer walks.
    float low = max_length / (float)(1 << first_ok);
    float high = max_length / (float)(1 << (first_ok - 1));
    int* level_counts = counts + kCoarseSteps;
    for (int depth = 0; depth < kBisectSteps;) {
      const int levels = split < kBisectSteps - depth ? split : kBisectSteps - depth;
      count_lengths<Key>(s, dim, c, cluster, tables, (1 << levels) - 1, false, low, high,
                         min_num_points, totals, level_counts, team);
      cluster_arrive();
      cluster_wait();
      for (int step = 0, j = 0; step < levels; ++step) {
        const float mid = 0.5f * (low + high);
        if (level_counts[j] >= min_num_points) {
          low = mid;
          j = 2 * j + 2;
        } else {
          high = mid;
          j = 2 * j + 1;
        }
      }
      level_counts += (1 << levels) - 1;
      depth += levels;
    }
    resolution = low;
  }
  // Phase C: the mask, spread over the cluster.
  mask_insert<Key>(s, dim, resolution, c, cluster);
  mask_write<kGlobal, Key>(s, c, cluster, slice, false, out);
}

// A launch's shape: clusters of `cluster` blocks of `threads`, and phase
// B's levels a round (`split`: kBisectSteps, or kSplit where the card is
// short of SMs).
struct Shape {
  int cluster, threads, split;
};

// A launch's table sizes and block bytes.
struct Plan {
  int bits, tables;
  long long region, block;
  bool global;
};

long long align16(long long v) { return (v + 15) / 16 * 16; }

Plan plan_of(int n, int pre_dim, int filters, int dim, Shape shape, bool scan) {
  Plan p;
  int slots = 64;
  p.bits = 6;
  while (slots < 2 * n) {
    slots *= 2;
    ++p.bits;
  }
  const long long key_bytes = dim == 3 ? 8 : 4;
  p.global = n > kMaxSharedPoints;
  const int pdim = p.global && !scan ? 0 : (pre_dim > dim ? pre_dim : dim);
  const long long fixed = 2 * align16(4LL * n) + align16(4LL * n * pdim) + 2 * align16(n);
  long long masks = pre_dim > 0 ? slots * 12LL : 0;  // a mask pass: keys and ranks
  if (filters > 0 && slots * (key_bytes + 4) > masks) masks = slots * (key_bytes + 4);
  const int nodes = (1 << shape.split) - 1;  // the most lengths a round counts
  p.tables = filters > 0 ? ((nodes > kCoarseSteps ? nodes : kCoarseSteps) + shape.cluster - 1) /
                               shape.cluster
                         : 0;
  if (p.tables > kMaxTables) p.tables = kMaxTables;
  auto region = [&](int t) {
    const long long counting = t * slots * key_bytes;
    return align16(counting > masks ? counting : masks);
  };
  while (!p.global && p.tables > 1 && region(p.tables) + fixed > kSharedBudget) --p.tables;
  p.region = region(p.tables);
  p.block = p.region + fixed;
  return p;
}

// The shape of a launch of `clusters` clusters: phase B in two rounds where
// they leave fewer than kSmsPerCluster SMs each; above kMaxSharedPoints
// kCluster blocks of kThreads; else the first of a few shapes, widest first,
// of which the card holds every cluster of the launch at once (one wave),
// or the narrowest. Cached by shape under a lock (launches come from
// several threads): no query under stream capture after a shape's first
// call.
template <bool kGlobal, typename Key, bool kScan>
Shape choose(int n, int pre_dim, int filters, int dim, int clusters) {
  static std::mutex lock;
  static std::map<std::array<int, 6>, Shape> cache;
  int device = 0;
  cudaGetDevice(&device);
  const std::array<int, 6> key = {device, n, pre_dim, filters, dim, clusters};
  std::lock_guard<std::mutex> hold(lock);
  const auto hit = cache.find(key);
  if (hit != cache.end()) return hit->second;
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int split = sms < kSmsPerCluster * clusters ? kSplit : kBisectSteps;
  constexpr int kShapes = 5;
  const int shapes[kShapes][2] = {{16, kMaxThreads}, {8, kMaxThreads}, {8, kThreads},
                                  {4, kMaxThreads}, {4, kThreads}};
  Shape shape = {kCluster, kThreads, split};
  if (!kGlobal) {
    shape = {shapes[kShapes - 1][0], shapes[kShapes - 1][1], split};
    for (int k = 0; k < kShapes - 1; ++k) {
      const Shape candidate = {shapes[k][0], shapes[k][1], split};
      cudaLaunchConfig_t config = {};
      config.gridDim = dim3((unsigned int)(clusters * candidate.cluster), 1, 1);
      config.blockDim = dim3((unsigned int)candidate.threads, 1, 1);
      config.dynamicSmemBytes =
          (size_t)plan_of(n, pre_dim, filters, dim, candidate, kScan).block;
      cudaLaunchAttribute attribute[1];
      attribute[0].id = cudaLaunchAttributeClusterDimension;
      attribute[0].val.clusterDim.x = (unsigned int)candidate.cluster;
      attribute[0].val.clusterDim.y = 1;
      attribute[0].val.clusterDim.z = 1;
      config.attrs = attribute;
      config.numAttrs = 1;
      int active = 0;
      if (cudaOccupancyMaxActiveClusters(&active, voxel_filter_kernel<kGlobal, Key, kScan>,
                                         &config) != cudaSuccess) {
        cudaGetLastError();
        continue;
      }
      if (active >= clusters) {
        shape = candidate;
        break;
      }
    }
  }
  cache[key] = shape;
  return shape;
}

template <bool kGlobal, typename Key, bool kScan>
cudaError_t launch(const scan2d::ScanArgs& scan, int robots, int filters, cudaStream_t st,
                   const float* points, int stride, long long points_rs, const uint8_t* mask,
                   long long mask_rs, const int* perm, long long perm_rs, int n,
                   float pre_resolution, int pre_dim, int dim, Filters params, uint8_t* keep,
                   unsigned char* scratch) {
  auto kernel = voxel_filter_kernel<kGlobal, Key, kScan>;
  // Set once per device, so that a launch under stream capture makes no
  // attribute call.
  static int configured = -1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && device != configured) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSharedBudget);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess) configured = device;
  }
  if (err != cudaSuccess) return err;
  const Shape shape = filters > 0
                          ? choose<kGlobal, Key, kScan>(n, pre_dim, filters, dim, robots * filters)
                          : Shape{1, kThreads, kBisectSteps};
  const Plan plan = plan_of(n, pre_dim, filters, dim, shape, kScan);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned int)(robots * shape.cluster),
                        (unsigned int)(filters > 0 ? filters : 1), 1);
  config.blockDim = dim3((unsigned int)shape.threads, 1, 1);
  config.dynamicSmemBytes = kGlobal ? 0 : (size_t)plan.block;
  config.stream = st;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = (unsigned int)shape.cluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, scan, points, stride, points_rs, mask, mask_rs, perm,
                           perm_rs, n, plan.bits, pre_resolution, pre_dim, filters, dim, params,
                           shape.cluster, shape.split, plan.tables, plan.region, keep, scratch,
                           kGlobal ? plan.block : 0LL);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The scratch bytes a call needs: 16 up to kMaxSharedPoints points, else a
// slice per block of the launch's shape (scan: K1 in the launch, whose
// hits each slice keeps).
extern "C" long long voxel_filter_scratch_bytes(int n, int robots, int pre_dim, int filters,
                                                int dim, int scan) {
  if (n <= kMaxSharedPoints) return 16;
  const int clusters = robots * filters;
  Shape shape = {1, kThreads, kBisectSteps};
  if (filters > 0)
    shape = dim == 3 ? choose<true, unsigned long long, false>(n, pre_dim, filters, dim, clusters)
            : scan   ? choose<true, uint32_t, true>(n, pre_dim, filters, dim, clusters)
                     : choose<true, uint32_t, false>(n, pre_dim, filters, dim, clusters);
  return plan_of(n, pre_dim, filters, dim, shape, scan != 0).block * robots *
         (filters > 0 ? filters * shape.cluster : 1);
}

namespace {

// One launch of the kernel's shared- or device-memory form and key width.
template <bool kScan>
cudaError_t dispatch(const scan2d::ScanArgs& scan, int robots, int filters, cudaStream_t st,
                     const float* p, int stride, long long points_rs, const uint8_t* m,
                     long long mask_rs, const int* q, long long perm_rs, int n,
                     float pre_resolution, int pre_dim, int dim, Filters params, uint8_t* k,
                     unsigned char* sc) {
  const bool global = n > kMaxSharedPoints;
  if (dim == 2)
    return global ? launch<true, uint32_t, kScan>(scan, robots, filters, st, p, stride,
                                                  points_rs, m, mask_rs, q, perm_rs, n,
                                                  pre_resolution, pre_dim, dim, params, k, sc)
                  : launch<false, uint32_t, kScan>(scan, robots, filters, st, p, stride,
                                                   points_rs, m, mask_rs, q, perm_rs, n,
                                                   pre_resolution, pre_dim, dim, params, k, sc);
  if (kScan) return cudaErrorInvalidValue;  // K1's hits take 2D adaptive keys
  return global ? launch<true, unsigned long long, false>(scan, robots, filters, st, p, stride,
                                                          points_rs, m, mask_rs, q, perm_rs, n,
                                                          pre_resolution, pre_dim, dim, params,
                                                          k, sc)
                : launch<false, unsigned long long, false>(scan, robots, filters, st, p, stride,
                                                           points_rs, m, mask_rs, q, perm_rs, n,
                                                           pre_resolution, pre_dim, dim, params,
                                                           k, sc);
}

}  // namespace

// `points` (stride floats a point), `mask` and `perm` are robot 0's; robot
// r's lie `*_rs` elements further. With pre_dim (2 or 3) the random filter
// at pre_resolution over the first pre_dim coordinates; then `filters` (0 to
// 2) adaptive filters, filter k of parameters (length_k, min_num_points_k,
// max_range_k), over the first `dim` coordinates of the random filter's
// keep-mask (or of `mask`). keep: (outputs, robots, n) flags. `scratch`
// holds voxel_filter_scratch_bytes(..., 0) bytes, 16-byte aligned.
extern "C" int voxel_filter(const void* points, int stride, long long points_rs,
                            const void* mask, long long mask_rs, const void* perm,
                            long long perm_rs, int n, int robots, float pre_resolution,
                            int pre_dim, int filters, int dim, float length0,
                            int min_num_points0, float max_range0, float length1,
                            int min_num_points1, float max_range1, void* keep, void* scratch,
                            long long scratch_bytes, void* stream) {
  if (n < 0 || robots < 1 || filters < 0 || filters > kMaxFilters ||
      (pre_dim != 0 && pre_dim != 2 && pre_dim != 3) || (dim != 2 && dim != 3) ||
      (pre_dim == 0 && filters == 0) || scratch == nullptr ||
      stride < (pre_dim > dim ? pre_dim : dim))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (scratch_bytes < voxel_filter_scratch_bytes(n, robots, pre_dim, filters, dim, 0))
    return (int)cudaErrorInvalidValue;
  const Filters params = {{length0, length1}, {min_num_points0, min_num_points1},
                          {max_range0, max_range1}};
  return (int)dispatch<false>(scan2d::ScanArgs{}, robots, filters, (cudaStream_t)stream,
                              (const float*)points, stride, points_rs, (const uint8_t*)mask,
                              mask_rs, (const int*)perm, perm_rs, n, pre_resolution, pre_dim,
                              dim, params, (uint8_t*)keep, (unsigned char*)scratch);
}

// The 2D step's launch: K1 (`scan`, a ScanArgs in host memory: robot 0's
// inputs, their robot strides, K1's parameters and outputs) on the robots'
// n-point scans, the random filter at pre_resolution over its 3D hits and
// `filters` (0 to 2) adaptive filters over their x and y, as voxel_filter
// takes them. `scratch` holds voxel_filter_scratch_bytes(..., 1) bytes.
extern "C" int scan_filter_2d(const void* scan, const void* perm, long long perm_rs, int n,
                              int robots, float pre_resolution, int filters, float length0,
                              int min_num_points0, float max_range0, float length1,
                              int min_num_points1, float max_range1, void* keep, void* scratch,
                              long long scratch_bytes, void* stream) {
  if (scan == nullptr || n < 1 || robots < 1 || filters < 0 || filters > kMaxFilters ||
      scratch == nullptr ||
      scratch_bytes < voxel_filter_scratch_bytes(n, robots, 3, filters, 2, 1))
    return (int)cudaErrorInvalidValue;
  const Filters params = {{length0, length1}, {min_num_points0, min_num_points1},
                          {max_range0, max_range1}};
  return (int)dispatch<true>(*static_cast<const scan2d::ScanArgs*>(scan), robots, filters,
                             (cudaStream_t)stream, nullptr, 3, 0, nullptr, 0,
                             (const int*)perm, perm_rs, n, pre_resolution, 3, 2, params,
                             (uint8_t*)keep, (unsigned char*)scratch);
}

// ---------------------------------------------------------------- K31
//
// The fork's edge filter: keep the valid points whose voxel holds fewer than
// int32(float32(max_count) * float32(ratio)) valid points, max_count being
// the largest voxel's population. The JAX program lexsorts the packed keys,
// counts each run and takes the maximum over the valid points.
//
// Here: one launch writes K2's packed voxel key per valid point (the key
// code above: a true division, floor(p / resolution + 0.5), clipped and
// biased fields, z in the high word) and an all-ones sentinel for masked
// points and the padding to a power of two; bitonic_sort.cuh sorts them
// (any size); then one thread per valid point finds its key's run in the
// sorted keys by two binary searches, so the run's length is its count,
// and takes the block's maximum in shared memory and the cloud's with one
// atomicMax per block; a last launch applies the threshold. Masked points
// never reach the maximum, and every output is an integer, so the mask
// equals the twin's and the JAX program's exactly.
//
// Bound: bytes, N points and flags read and N flags written once; the sort's
// passes and the binary searches (2 log2 N reads of L2 per point) make it
// latency-bound.

namespace {

constexpr int kEdgeThreads = 256;

__global__ void edge_keys_kernel(const float* __restrict__ points, int stride, int dim,
                                 const uint8_t* __restrict__ mask, int n, int npad,
                                 float resolution, unsigned long long* __restrict__ keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npad) return;
  keys[i] = (i < n && mask[i]) ? voxel_key(points + (size_t)i * stride, dim, resolution)
                               : kEmpty;
}

// The first position in keys[0, count) whose key is >= v.
__device__ inline int first_not_below(const unsigned long long* keys, int count,
                                      unsigned long long v) {
  int lo = 0, hi = count;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void edge_counts_kernel(const float* __restrict__ points, int stride, int dim,
                                   const uint8_t* __restrict__ mask, int n, int npad,
                                   float resolution,
                                   const unsigned long long* __restrict__ sorted,
                                   int* __restrict__ counts, int* __restrict__ max_count) {
  __shared__ int block_max;
  if (threadIdx.x == 0) block_max = 0;
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    int c = 0;
    if (mask[i]) {
      // Valid keys are below 0xFFFE'FFFE'FFFF, so key + 1 does not wrap.
      const unsigned long long key =
          voxel_key(points + (size_t)i * stride, dim, resolution);
      c = first_not_below(sorted, npad, key + 1) - first_not_below(sorted, npad, key);
      atomicMax(&block_max, c);
    }
    counts[i] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0 && block_max > 0) atomicMax(max_count, block_max);
}

__global__ void edge_keep_kernel(const uint8_t* __restrict__ mask, int n,
                                 const int* __restrict__ counts,
                                 const int* __restrict__ max_count, float ratio,
                                 uint8_t* __restrict__ keep) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int threshold = (int)((float)*max_count * ratio);  // truncates, as astype(int32)
  keep[i] = mask[i] && counts[i] < threshold;
}

}  // namespace

// `keys` holds max(2, next_pow2(n)) int64 of scratch, `counts` n + 1 int32
// (the last one the maximum).
extern "C" int voxel_filter_edge(const void* points, int stride, int dim, const void* mask,
                                 int n, float resolution, float ratio, void* keep, void* keys,
                                 void* counts, void* stream) {
  if (n < 1 || (dim != 2 && dim != 3) || keys == nullptr || counts == nullptr)
    return (int)cudaErrorInvalidValue;
  int npad = 2;
  while (npad < n) npad <<= 1;
  cudaStream_t st = (cudaStream_t)stream;
  int* max_count = (int*)counts + n;
  cudaError_t err = cudaMemsetAsync(max_count, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  unsigned long long* k = (unsigned long long*)keys;
  edge_keys_kernel<<<(npad + kEdgeThreads - 1) / kEdgeThreads, kEdgeThreads, 0, st>>>(
      (const float*)points, stride, dim, (const uint8_t*)mask, n, npad, resolution, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = bitonic::sort(k, npad, st);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kEdgeThreads - 1) / kEdgeThreads;
  edge_counts_kernel<<<blocks, kEdgeThreads, 0, st>>>(
      (const float*)points, stride, dim, (const uint8_t*)mask, n, npad, resolution, k,
      (int*)counts, max_count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  edge_keep_kernel<<<blocks, kEdgeThreads, 0, st>>>((const uint8_t*)mask, n,
                                                     (const int*)counts, max_count, ratio,
                                                     (uint8_t*)keep);
  return (int)cudaGetLastError();
}
