// K6 bnb_pyramid and K7 bnb_descent
//
// K6 replaces: cartographer_tpu/ops/bnb_2d.py:build_precomputation_pyramid
// (l.60), with the probability image of ops/grid_2d.py:Grid2D.probability.
// Level 0 is the probability of each cell (1 / (1 + exp(-l)) where known,
// UNKNOWN elsewhere); level h is the max of level h-1 over the four cells
// (x, y) + {0, 2^(h-1)}^2, a cell beyond the high edge counting as UNKNOWN.
// That is the JAX form's max of the x- then the y-shifted level: max is
// exact, so the two agree bit for bit. One launch per level, one thread per
// cell. Bound: bytes, each level reads the previous one (4 MB at 1024^2,
// L2-resident) and writes 4 MB; 28 MB written for a depth-7 pyramid.
//
// bnb_pyramid_tsdf is K6's TSDF form: level 0 is the score surface of a TSDF
// grid, weight > 0 ? 1 - |tsd| / truncation : 0 (JAX ops/tsdf_2d.py:
// TsdfGrid2D.correspondence_score, l.71, which the JAX constraint builder
// reads through grid.probability(), constraint_builder_2d.py:195); the
// levels above, padded with UNKNOWN, are the same launches.
//
// K7 replaces: cartographer_tpu/ops/bnb_2d.py:fast_correlative_match_2d
// (l.101), its beam path (l.147-228) with the scorer _score_candidates
// (l.81), for a group of (node, submap) pairs in one launch; it also serves
// match_full_submap_exact (l.398). Each pair's whole descent runs in the
// kernel, in the JAX order:
//  1. score the top level's A x num_off^2 candidates (invalid angles -inf);
//  2. keep the top k0 = min(4 beam, total) stably (value descending, ties to
//     the lower index: lax.top_k), the dropped bound the (k0 + 1)-th value,
//     padded with -inf to 4 beam;
//  3. for h = depth - 2 ... 0: keep the top `beam` of the 4 beam candidates
//     (the first `beam` of the padded list, already in order, at the first
//     step), raise the dropped bound to the (beam + 1)-th value, lay the
//     children out as [sel, sel + (c, 0), sel + (0, c), sel + (c, c)] with
//     c = 2^h, mask each child by its parent's score > min_score, and score
//     the children on level h;
//  4. the argmax (ties to the lowest index), `found` and the certificate,
//     written as the pair's row [score, x, y, theta, found, certified].
// A candidate's score is the mean level value under the scan's precomputed
// cells of its angle, shifted by its offset (UNKNOWN outside the map;
// masked points 0): one warp per candidate, lane k holding points k,
// k + 32, ... of a tile of up to 128 points, each the halving fold
// (halving_fold.cuh) of the points k + j * tile above that, the tile's tree
// added in registers down to 32 and by shuffles below: the plain twin's
// pairwise halving tree, so every score keeps its bits. A selection keeps
// the best `beam` by the scores' order-preserving 32-bit keys, ties to the
// lower index: a radix select of the beam-th key (counts of 8 bits a pass,
// from the top) and one stable compaction of the kept in index order, then
// a stable LSD radix sort of those (4 passes of 8 bits; a pass whose digit
// is one value everywhere is skipped). That is the order of the twin's
// stable torch.sort, so the kernel's rows equal the twin's bit for bit. At
// the top level the k0 list and its first step's beam come to the best
// `beam` of all and the (beam + 1)-th as the dropped bound.
//
// Layout: one cooperative launch of blocks of 1,024 threads, one per SM
// (co-resident, so blocks may wait on each other), phases separated by a
// grid barrier, 2 depth - 1 a call: every block's warps score the group's
// candidates of a level (all pairs', so a group of one pair still spreads
// its gathers over the card: some 15-20 us a level of 16,384 candidates),
// then a thread-block cluster selects each pair (cluster c: pairs c,
// c + clusters, ...), its blocks taking slices of the keys in rank order
// and adding their counts and tallies through distributed shared memory
// (one cluster barrier a radix pass). A group of one pair takes clusters
// of 4 blocks, a larger group clusters of 2, one block a pair above what
// the card holds in clusters of 2: per pair on the H100 at groups of
// 1 / 8 / 64, clusters of 1, 2, 4, 8 and 16 blocks took 0.488 / 0.135 /
// 0.101, 0.471 / 0.133 / 0.099, 0.443 / 0.138 / 0.118, 0.450 / 0.139 /
// 0.125 and 0.504 / 0.186 / 0.158 ms (tests/bnb_lm3d_timing.py clusters).
// More blocks cut little because a selection is a chain of some 30
// dependent barrier steps (about 45 us a level of 16,384 keys at a group
// of one pair, 50 in one block), a larger cluster's barriers cost more,
// and where the card holds fewer clusters than pairs a cluster selects
// several in turn. The keys ((score key, index), 8 bytes) and the kept parents
// (angle, offsets, alive; 16 bytes) live in a device scratch, two buffers
// each a pair, L2-resident (about 0.5 MB a pair at beam 4,096, 8 MB at the
// full-submap search's largest beam, 65,536), read past L1 (__ldcg) since
// other blocks write them: a sort of all 16,384 keys spent most of its
// time in its passes' scattered writes, and the keys in the block's shared
// memory left L1 too small for the scoring. So a group of one pair is
// bound by its selections, a group of 8 or more by its gathers. Each
// pair's pyramid is reached through a pointer table in the launch's
// parameters, up to kMaxPairs pairs a launch (one launch per kMaxPairs
// above).
//
// Bound: the gathers, bytes and L1 wavefronts: a level-step of 16,384
// candidates x 128 points gathers 2 M floats scattered over a 4 MB level
// (L2-resident); then the selections' dependent passes and the grid
// barriers (latency).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "halving_fold.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr float kUnknown = 0.1f;

__global__ void level0_kernel(const float* __restrict__ log_odds,
                              const uint8_t* __restrict__ known, int cells,
                              float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  out[i] = known[i] ? 1.0f / (1.0f + expf(-log_odds[i])) : kUnknown;
}

__global__ void level0_tsdf_kernel(const float* __restrict__ tsd,
                                   const float* __restrict__ weight, float truncation,
                                   int cells, float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  out[i] = weight[i] > 0.0f ? 1.0f - fabsf(tsd[i]) / truncation : 0.0f;
}

__global__ void level_kernel(const float* __restrict__ prev, int size, int shift,
                             float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size * size) return;
  int x = i / size, y = i % size;
  bool xi = x + shift < size, yi = y + shift < size;
  float v = prev[i];
  v = fmaxf(v, xi ? prev[i + shift * size] : kUnknown);
  v = fmaxf(v, yi ? prev[i + shift] : kUnknown);
  v = fmaxf(v, xi && yi ? prev[i + shift * size + shift] : kUnknown);
  out[i] = v;
}

// Levels 1 .. depth - 1 over level 0 in `levels`.
int upper_levels(float* levels, int size, int depth, cudaStream_t s) {
  int cells = size * size;
  int threads = 256, blocks = (cells + threads - 1) / threads;
  for (int h = 1; h < depth; ++h) {
    level_kernel<<<blocks, threads, 0, s>>>(levels + (size_t)(h - 1) * cells, size,
                                            1 << (h - 1), levels + (size_t)h * cells);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- K7

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;       // points a warp's lanes hold, 4 each
constexpr int kMaxPairs = 128;   // pairs a launch: the pointer table's rows
constexpr int kDigits = 256;
constexpr int kRow = kWarps + 1;  // a digit's warp counters, padded against bank conflicts
constexpr int kAhead = 4;  // a selection's loads a thread keeps in flight
constexpr int kMaxCluster = 16;  // Hopper's largest cluster, a non-portable size

struct Pair {
  const float* pyramid;  // (depth, size, size)
  int size;
  int num_off;  // top-level offsets per axis
};

struct Pairs {
  Pair p[kMaxPairs];
};

struct Args {
  const int2* cells;      // (pairs, angles, n): the scan's cells at each angle
  const uint8_t* mask;    // (pairs, n)
  const float* deltas;    // (pairs, angles): angle offsets
  const uint8_t* valid;   // (pairs, angles): angles within the window
  const float* inits;     // (pairs, 3): start poses [x, y, theta]
  int pairs, depth, beam, angles, n;
  float resolution, min_score;
  uint2* items;           // (pairs, 2, mmax): (score key, index), two buffers
  long long mmax;
  int4* parents;          // (pairs, 2, beam): (angle, ox, oy, alive), two buffers
  float* dropped;         // (pairs,)
  unsigned int* barrier;  // (2,): arrivals and generation, zeroed before the launch
  float* out;             // (pairs, 6)
};

struct Shared {
  unsigned int count[kDigits * kRow];  // per digit and warp: counts, then running offsets
  unsigned int base[kDigits];          // the first position of each digit
  unsigned int warp_sum[kWarps];
  unsigned int warp_lt[kWarps], warp_eq[kWarps], warp_min[kWarps];  // block_select's per warp
  unsigned long long best[kWarps];
  unsigned int pick, before;  // block_select's digit and the items below it
  int skip;
  unsigned int share[2][kDigits];  // a block's values for the cluster, double-buffered
};

// The blocks that select one pair together: a thread-block cluster of
// `blocks` (1 to kMaxCluster). A selection's slices are the cluster's warps
// in rank order, so the blocks' counts add up in rank order.
struct Team {
  cg::cluster_group cluster;
  unsigned int blocks, rank;
  int buf;  // the buffer of Shared::share the next exchange writes
  __device__ int warp() const { return (int)rank * kWarps + (threadIdx.x >> 5); }
  __device__ int warps() const { return (int)blocks * kWarps; }
  __device__ int thread() const { return (int)rank * kThreads + threadIdx.x; }
  __device__ int threads() const { return (int)blocks * kThreads; }
  __device__ void sync() const {
    if (blocks > 1)
      cluster.sync();
    else
      __syncthreads();
  }
};

// Thread j < count passes its block's value v: returns the sum of the
// blocks' values j of lower rank in `before` and of all blocks in the
// return value (in rank order). One cluster barrier; the buffers alternate,
// so a block that runs ahead into the next exchange writes the other one.
__device__ inline unsigned int exchange_sum(Team& tm, Shared& s, int count, unsigned int v,
                                            unsigned int& before) {
  before = 0;
  if (tm.blocks == 1) return v;
  const int b = tm.buf;
  tm.buf ^= 1;
  if (threadIdx.x < count) s.share[b][threadIdx.x] = v;
  tm.cluster.sync();
  if (threadIdx.x >= count) return 0;
  unsigned int t[kMaxCluster], total = 0;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)  // the loads in flight together
    t[r] = r < (int)tm.blocks ? tm.cluster.map_shared_rank(&s.share[b][0], (unsigned int)r)
                                    [threadIdx.x] : 0u;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    before += r < (int)tm.rank ? t[r] : 0u;
    total += t[r];
  }
  return total;
}

// Order-preserving keys: a larger score has a smaller key, -inf the largest
// (scores are never NaN or -0).
__device__ inline unsigned int score_key(float s) {
  const unsigned int u = __float_as_uint(s);
  return ~((u & 0x80000000u) ? ~u : (u | 0x80000000u));
}

__device__ inline float key_score(unsigned int key) {
  const unsigned int asc = ~key;
  return __uint_as_float((asc & 0x80000000u) ? (asc & 0x7FFFFFFFu) : ~asc);
}

// Every block waits here until all have arrived (the launch is cooperative,
// so all are resident); writes before it are visible to reads after it
// that bypass L1.
__device__ inline void grid_sync(unsigned int* barrier) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* generation = barrier + 1;
    const unsigned int g = *generation;
    __threadfence();
    if (atomicAdd(barrier, 1u) == gridDim.x - 1) {
      atomicExch(barrier, 0u);
      __threadfence();
      atomicAdd(barrier + 1, 1u);
    } else {
      while (*generation == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// The top level's offset of index k (of num_off), stepping 2^(depth-1).
__device__ inline int top_offset(int k, int num_off, int stride) {
  return (k - num_off / 2) * stride - stride / 2;
}

// v[j] += v[j + h] for h = r / 2, ..., 1 (r is 1, 2 or 4), with constant
// indices so that v stays in registers.
__device__ inline void halve(float v[4], int r) {
  if (r >= 4)
#pragma unroll
    for (int j = 0; j < 2; ++j) v[j] = v[j] + v[j + 2];
  if (r >= 2) v[0] = v[0] + v[1];
}

// The mean level value under the candidate (angle a, offset ox, oy) of pair
// b: the twin's halving tree over the n points (a power of two), in the
// calling warp; the result in every lane.
__device__ inline float score(const Args& g, int b, const float* level, int size, int a,
                              int ox, int oy) {
  const int lane = threadIdx.x & 31;
  const int n = g.n;
  const int2* cells = g.cells + ((size_t)b * g.angles + a) * n;
  const uint8_t* mask = g.mask + (size_t)b * n;
  auto value = [&](int2 c, bool m) {
    const int cx = c.x + ox, cy = c.y + oy;
    const bool inside = cx >= 0 && cx < size && cy >= 0 && cy < size;
    return m ? (inside ? level[(size_t)cx * size + cy] : kUnknown) : 0.0f;
  };
  float v[4];
  int count = 0;
  if (n <= kTile) {
    // Lane k holds points k + 32 j, j < ceil(n / 32); every load issued first.
    const int r = (n + 31) >> 5;
    int2 c[4];
    bool m[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // the masks and the cells together
      const int k = lane + 32 * j;
      const bool in = j < r && k < n;
      m[j] = in && mask[k];
      c[j] = in ? cells[k] : make_int2(0, 0);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = value(c[j], m[j]);  // then every gather
#pragma unroll
    for (int j = 0; j < 4; ++j) count += __popc(__ballot_sync(0xffffffffu, m[j]));
    // The tree's halvings above 32 in registers: v[j] += v[j + h] for
    // h = r / 2, ..., 1 (r is 1, 2 or 4).
    halve(v, r);
  } else {
    // Above the tile: lane k's value j is the fold of points
    // k + 32 j + i * kTile, i < n / kTile, in the tree's pairing.
    const int m = n / kTile;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = lane + 32 * j;
      v[j] = halving::fold(m, [&](int i) {
        const int p = k + i * kTile;
        const bool valid = mask[p];
        return value(valid ? cells[p] : make_int2(0, 0), valid);
      });
    }
    for (int k0 = 0; k0 < n; k0 += 32) count += __popc(__ballot_sync(0xffffffffu, mask[k0 + lane]));
    halve(v, 4);
  }
  float s = v[0];
  for (int off = 16; off > 0; off >>= 1) s = s + __shfl_down_sync(0xffffffffu, s, off);
  s = __shfl_sync(0xffffffffu, s, 0);
  return s / (float)max(count, 1);
}

// The valid lanes whose 8-bit digit equals this lane's (eight ballots).
__device__ inline unsigned int same_digit(unsigned int d, bool valid) {
  unsigned int peers = __ballot_sync(0xFFFFFFFFu, valid);
#pragma unroll
  for (int bit = 0; bit < 8; ++bit) {
    const bool set = (d >> bit) & 1u;
    const unsigned int ballot = __ballot_sync(0xFFFFFFFFu, set);
    peers &= set ? ballot : ~ballot;
  }
  return peers;
}

// A selection's items, (score key, candidate index), in two buffers of the
// device scratch, read and written past L1.
struct Items {
  uint2* buf[2];
  __device__ unsigned int key(int b, int i) const { return __ldcg(&buf[b][i].x); }
  __device__ uint2 load(int b, int i) const { return __ldcg(&buf[b][i]); }
  __device__ void store(int b, int i, uint2 v) const { __stcg(&buf[b][i], v); }
};

// A selection's per-block tallies over the cluster (blocks > 1), in every
// thread: the items below T and equal to T of the blocks of lower rank, the
// items equal to T of all, and the least key above T of all (`above` in and
// out). Lane r of each warp reads block r's; one cluster barrier.
__device__ inline void exchange_tally(Team& tm, Shared& s, unsigned int lt, unsigned int eq,
                                      unsigned int& above, unsigned int& lt_below,
                                      unsigned int& eq_below, unsigned int& eq_all) {
  const int b = tm.buf, lane = threadIdx.x & 31;
  tm.buf ^= 1;
  if (threadIdx.x == 0) {
    s.share[b][0] = lt;
    s.share[b][1] = eq;
    s.share[b][2] = above;
  }
  tm.cluster.sync();
  unsigned int l = 0, e = 0, a = ~0u;
  if (lane < (int)tm.blocks) {
    const unsigned int* o = tm.cluster.map_shared_rank(&s.share[b][0], (unsigned int)lane);
    l = o[0];
    e = o[1];
    a = o[2];
  }
  lt_below = lane < (int)tm.rank ? l : 0u;
  eq_below = lane < (int)tm.rank ? e : 0u;
  eq_all = e;
  for (int off = 16; off > 0; off >>= 1) {
    lt_below += __shfl_xor_sync(0xFFFFFFFFu, lt_below, off);
    eq_below += __shfl_xor_sync(0xFFFFFFFFu, eq_below, off);
    eq_all += __shfl_xor_sync(0xFFFFFFFFu, eq_all, off);
    a = min(a, __shfl_xor_sync(0xFFFFFFFFu, a, off));
  }
  above = a;
}

// Sorts the m items of buffer 0 stably by their key, ascending, in the
// team: LSD radix passes of 8 bits between buffers 0 and 1. Returns the
// buffer that holds the result.
__device__ int block_sort(Team& tm, const Items& it, int m, Shared& s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned int below = (1u << lane) - 1u;
  const int share = (m + tm.warps() - 1) / tm.warps();
  const int lo = min(tm.warp() * share, m), hi = min(lo + share, m);
  int cur = 0;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 8 * pass;
    for (int i = threadIdx.x; i < kDigits * kRow; i += kThreads) s.count[i] = 0;
    if (threadIdx.x == 0) s.skip = 0;
    __syncthreads();
    for (int r0 = lo; r0 < hi; r0 += 32 * kAhead) {
      unsigned int d[kAhead];
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {  // the loads in flight together
        const int i = r0 + 32 * q + lane;
        d[q] = i < hi ? (it.key(cur, i) >> shift) & 0xFFu : kDigits;
      }
      // Shared atomics: a count does not depend on their order.
#pragma unroll
      for (int q = 0; q < kAhead; ++q)
        if (d[q] < kDigits) atomicAdd(&s.count[d[q] * kRow + warp], 1u);
    }
    __syncthreads();
    // Each digit's warp counts -> offsets (digit-major, then block and warp).
    unsigned int mine = 0, x = 0, ranks_below = 0;
    if (threadIdx.x < kDigits) {
      const int d = threadIdx.x;
      for (int w = 0; w < kWarps; ++w) {
        const unsigned int v = s.count[d * kRow + w];
        s.count[d * kRow + w] = mine;
        mine += v;
      }
    }
    const unsigned int total = exchange_sum(tm, s, kDigits, mine, ranks_below);
    if (threadIdx.x < kDigits) {
      if (total == (unsigned int)m) s.skip = 1;  // one digit everywhere: the pass keeps the order
      x = total;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
        if (lane >= o) x += y;
      }
      if (lane == 31) s.warp_sum[warp] = x;
    }
    __syncthreads();
    const bool skip = s.skip != 0;
    if (threadIdx.x < kDigits) {
      unsigned int add = 0;
      for (int w = 0; w < warp; ++w) add += s.warp_sum[w];
      s.base[threadIdx.x] = add + x - total + ranks_below;
    }
    __syncthreads();
    if (skip) continue;
    for (int r0 = lo; r0 < hi; r0 += 32 * kAhead) {
      uint2 items[kAhead];
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {  // kAhead rounds' loads in flight together
        const int i = r0 + 32 * q + lane;
        items[q] = i < hi ? it.load(cur, i) : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {  // the rounds in order
        const bool valid = r0 + 32 * q + lane < hi;
        const uint2 item = items[q];
        const unsigned int d = (item.x >> shift) & 0xFFu;
        const unsigned int peers = same_digit(d, valid);
        const unsigned int off = valid ? s.count[d * kRow + warp] : 0u;
        __syncwarp();
        if (valid) {
          const unsigned int r = __popc(peers & below), group = __popc(peers);
          if (r == group - 1) s.count[d * kRow + warp] = off + group;
          it.store(cur ^ 1, s.base[d] + off + r, item);
        }
        __syncwarp();
      }
    }
    tm.sync();
    cur ^= 1;
  }
  return cur;
}

// The `beam` smallest of the m items of buffer 0 (in index order), ties to
// the lower index, into buffer 1 at [0, beam) in index order: a radix
// select of the beam-th smallest key T, 8 bits a pass from the top (counts
// only), then one stable compaction of the items below T and the first of
// those equal to T. Returns the smallest key left out, the (beam + 1)-th
// (m > beam). The sort then orders beam items, not m.
__device__ unsigned int block_select(Team& tm, const Items& it, int m, int beam, Shared& s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned int below = (1u << lane) - 1u;
  const int share = (m + tm.warps() - 1) / tm.warps();
  const int lo = min(tm.warp() * share, m), hi = min(lo + share, m);
  unsigned int prefix = 0, known = 0;  // T's bits found so far, and their mask
  unsigned int want = beam;  // T's rank among the items that match them (from 1)
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < kDigits * kRow; i += kThreads) s.count[i] = 0;
    __syncthreads();
    for (int r0 = lo; r0 < hi; r0 += 32 * kAhead) {
      unsigned int key[kAhead];
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {  // the loads in flight together
        const int i = r0 + 32 * q + lane;
        key[q] = i < hi ? it.key(0, i) : 0u;
      }
#pragma unroll
      for (int q = 0; q < kAhead; ++q)
        if (r0 + 32 * q + lane < hi && (key[q] & known) == prefix)
          atomicAdd(&s.count[((key[q] >> shift) & 0xFFu) * kRow + warp], 1u);
    }
    __syncthreads();
    // The digits' totals, scanned over the digits: the digit where `want` falls.
    unsigned int mine = 0, x = 0, unused;
    if (threadIdx.x < kDigits)
      for (int w = 0; w < kWarps; ++w) mine += s.count[threadIdx.x * kRow + w];
    const unsigned int total = exchange_sum(tm, s, kDigits, mine, unused);
    if (threadIdx.x < kDigits) {
      x = total;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
        if (lane >= o) x += y;
      }
      if (lane == 31) s.warp_sum[warp] = x;
    }
    __syncthreads();
    if (threadIdx.x < kDigits) {
      unsigned int add = 0;
      for (int w = 0; w < warp; ++w) add += s.warp_sum[w];
      const unsigned int upto = add + x;
      if (upto - total < want && want <= upto) {
        s.pick = threadIdx.x;
        s.before = upto - total;
      }
    }
    __syncthreads();
    prefix |= s.pick << shift;
    known |= 0xFFu << shift;
    want -= s.before;
  }
  const unsigned int T = prefix;
  // Each warp's items below T and equal to T, and the smallest key above T.
  unsigned int lt = 0, eq = 0, above = ~0u;
  for (int r0 = lo; r0 < hi; r0 += 32) {
    const int i = r0 + lane;
    const unsigned int key = i < hi ? it.key(0, i) : ~0u;
    lt += __popc(__ballot_sync(0xFFFFFFFFu, i < hi && key < T));
    eq += __popc(__ballot_sync(0xFFFFFFFFu, i < hi && key == T));
    if (i < hi && key > T) above = min(above, key);
  }
  for (int off = 16; off > 0; off >>= 1) above = min(above, __shfl_xor_sync(0xFFFFFFFFu, above, off));
  if (lane == 0) {
    s.warp_lt[warp] = lt;
    s.warp_eq[warp] = eq;
    s.warp_min[warp] = above;
  }
  __syncthreads();
  unsigned int lt_before = 0, eq_before = 0, lt_block = 0, eq_block = 0;
  above = ~0u;
  for (int w = 0; w < kWarps; ++w) {
    lt_before += w < warp ? s.warp_lt[w] : 0u;
    eq_before += w < warp ? s.warp_eq[w] : 0u;
    lt_block += s.warp_lt[w];
    eq_block += s.warp_eq[w];
    above = min(above, s.warp_min[w]);
  }
  // The blocks of lower rank come first; `above` is the cluster's least.
  unsigned int eq_all = eq_block;
  if (tm.blocks > 1) {
    unsigned int ranks_lt, ranks_eq;
    exchange_tally(tm, s, lt_block, eq_block, above, ranks_lt, ranks_eq, eq_all);
    lt_before += ranks_lt;
    eq_before += ranks_eq;
  }
  // An item kept goes after the kept items before it: those below T and
  // the first `want` equal to T.
  for (int r0 = lo; r0 < hi; r0 += 32) {
    const int i = r0 + lane;
    const uint2 item = i < hi ? it.load(0, i) : make_uint2(~0u, 0u);
    const bool is_lt = i < hi && item.x < T, is_eq = i < hi && item.x == T;
    const unsigned int b_lt = __ballot_sync(0xFFFFFFFFu, is_lt);
    const unsigned int b_eq = __ballot_sync(0xFFFFFFFFu, is_eq);
    const unsigned int my_lt = lt_before + __popc(b_lt & below);
    const unsigned int my_eq = eq_before + __popc(b_eq & below);
    if (is_lt || (is_eq && my_eq < want)) it.store(1, my_lt + min(my_eq, want), item);
    lt_before += __popc(b_lt);
    eq_before += __popc(b_eq);
  }
  tm.sync();
  return eq_all > want ? T : above;
}

// The argmax of the m keys of buf (the smallest (key, index)), in every
// thread of the team.
__device__ unsigned long long block_argmin(Team& tm, const uint2* buf, int m, Shared& s) {
  unsigned long long best = ~0ull;
  for (int i = tm.thread(); i < m; i += tm.threads()) {
    const uint2 item = __ldcg(&buf[i]);
    const unsigned long long k = ((unsigned long long)item.x << 32) | item.y;
    best = k < best ? k : best;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xffffffffu, best, off);
    best = o < best ? o : best;
  }
  if ((threadIdx.x & 31) == 0) s.best[threadIdx.x >> 5] = best;
  __syncthreads();
  best = ~0ull;
  for (int w = 0; w < kWarps; ++w) best = s.best[w] < best ? s.best[w] : best;
  __syncthreads();
  if (tm.blocks > 1) {  // lane r of each warp reads block r's
    const int b = tm.buf, lane = threadIdx.x & 31;
    tm.buf ^= 1;
    if (threadIdx.x == 0) {
      s.share[b][0] = (unsigned int)(best >> 32);
      s.share[b][1] = (unsigned int)best;
    }
    tm.cluster.sync();
    best = ~0ull;
    if (lane < (int)tm.blocks) {
      const unsigned int* o = tm.cluster.map_shared_rank(&s.share[b][0], (unsigned int)lane);
      best = ((unsigned long long)o[0] << 32) | o[1];
    }
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, best, off);
      best = o < best ? o : best;
    }
  }
  return best;
}

__global__ void __launch_bounds__(kThreads, 1) descent_kernel(Pairs pairs, Args g) {
  __shared__ Shared s;
  Team tm{cg::this_cluster(), 0u, 0u, 0};
  tm.blocks = tm.cluster.num_blocks();
  tm.rank = tm.cluster.block_rank();
  const int team = (int)(blockIdx.x / tm.blocks), teams = (int)(gridDim.x / tm.blocks);
  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * kWarps + (threadIdx.x >> 5), nwarps = gridDim.x * kWarps;
  const int top = g.depth - 1, stride = 1 << top;
  const int beam = g.beam, cand = 4 * beam;

  for (int t = 0; t < g.depth; ++t) {
    const int h = top - t;  // the level scored at this step
    // Score every pair's candidates of this level.
    for (int b = 0; b < g.pairs; ++b) {
      const Pair pr = pairs.p[b];
      const float* level = pr.pyramid + (size_t)h * pr.size * pr.size;
      const int no = pr.num_off;
      const int total = t == 0 ? g.angles * no * no : cand;
      uint2* items = g.items + (size_t)b * 2 * g.mmax;
      const int4* par = g.parents + ((size_t)b * 2 + (t & 1)) * beam;
      // The parent of the warp's next candidate is read while it scores this one.
      int4 p = t > 0 && gwarp < total ? __ldcg(&par[gwarp % beam]) : make_int4(0, 0, 0, 0);
      for (int i = gwarp; i < total; i += nwarps) {
        const int next = i + nwarps;
        const int4 pn =
            t > 0 && next < total ? __ldcg(&par[next % beam]) : make_int4(0, 0, 0, 0);
        float sc = -INFINITY;
        if (t == 0) {
          const int a = i / (no * no), r = i % (no * no);
          if (g.valid[(size_t)b * g.angles + a])
            sc = score(g, b, level, pr.size, a, top_offset(r / no, no, stride),
                       top_offset(r % no, no, stride));
        } else {
          const int q = i / beam, c = 1 << h;
          if (p.w) sc = score(g, b, level, pr.size, p.x, p.y + (q & 1) * c, p.z + (q >> 1) * c);
        }
        if (lane == 0) __stcg(&items[i], make_uint2(score_key(sc), (unsigned int)i));
        p = pn;
      }
    }
    grid_sync(g.barrier);

    // Select: cluster c takes pairs c, c + clusters, ...
    for (int b = team; b < g.pairs; b += teams) {
      const Pair pr = pairs.p[b];
      const int no = pr.num_off;
      uint2* items = g.items + (size_t)b * 2 * g.mmax;
      const int4* par = g.parents + ((size_t)b * 2 + (t & 1)) * beam;
      int4* kept = g.parents + ((size_t)b * 2 + ((t + 1) & 1)) * beam;
      const float* init = g.inits + (size_t)b * 3;
      const int m = t == 0 ? g.angles * no * no : cand;
      // A candidate (score key, index) of this level as (angle, ox, oy,
      // alive), and its score.
      auto decode = [&](uint2 item, float& sc) {
        sc = key_score(item.x);
        const int i = (int)item.y;
        int4 c;
        if (t == 0) {
          const int r = i % (no * no);
          c = make_int4(i / (no * no), top_offset(r / no, no, stride),
                        top_offset(r % no, no, stride), 0);
        } else {
          const int4 p4 = __ldcg(&par[i % beam]);
          const int q = i / beam, ch = 1 << h;
          c = make_int4(p4.x, p4.y + (q & 1) * ch, p4.z + (q >> 1) * ch, 0);
        }
        c.w = sc > g.min_score ? 1 : 0;
        return c;
      };
      float best_score;
      int4 best;
      float dropped = t == 0 ? -INFINITY : __ldcg(&g.dropped[b]);
      // The kept parents: the best `beam` of the level's m candidates in
      // order (the top level's padded beyond m), and the dropped bound
      // raised to the (beam + 1)-th (the top level's k0 = min(4 beam, m)
      // and the first step's beam of that padded list come to the same).
      auto keep = [&](const Items& it, int r, int kept_count) {
        float sc;
        const int step = tm.threads();
        for (int p0 = tm.thread(); p0 < beam; p0 += step * kAhead) {
          uint2 item[kAhead];
#pragma unroll
          for (int q = 0; q < kAhead; ++q) {  // the loads in flight together
            const int p = p0 + q * step;
            item[q] = p < kept_count ? it.load(r, p) : make_uint2(0u, 0u);
          }
#pragma unroll
          for (int q = 0; q < kAhead; ++q) {
            const int p = p0 + q * step;
            if (p < beam)
              __stcg(&kept[p], p < kept_count ? decode(item[q], sc) : make_int4(0, 0, 0, 0));
          }
        }
      };
      const Items it = {{items, items + g.mmax}};
      if (t > 0 && h == 0) {
        // The last level: the argmax of the children, ties to the lowest index.
        const unsigned long long k = block_argmin(tm, items, m, s);
        best = decode(make_uint2((unsigned int)(k >> 32), (unsigned int)k), best_score);
      } else if (t == top) {
        // Depth 1: the top list's first, the dropped bound its (k0 + 1)-th.
        const unsigned long long k = block_argmin(tm, items, m, s);
        best = decode(make_uint2((unsigned int)(k >> 32), (unsigned int)k), best_score);
        if (m > cand) dropped = key_score(block_select(tm, it, m, cand, s));
      } else if (m > beam) {
        dropped = fmaxf(dropped, key_score(block_select(tm, it, m, beam, s)));
        const Items chosen = {{items + g.mmax, items}};  // the selection sorts from buffer 1
        keep(chosen, block_sort(tm, chosen, beam, s), beam);
      } else {
        keep(it, block_sort(tm, it, m, s), m);
      }
      if (tm.rank == 0 && threadIdx.x == 0) {
        if (t == top) {
          const float res = g.resolution;
          float* row = g.out + (size_t)b * 6;
          row[0] = best_score;
          row[1] = init[0] + (float)best.y * res;
          row[2] = init[1] + (float)best.z * res;
          row[3] = init[2] + g.deltas[(size_t)b * g.angles + best.x];
          row[4] = best_score > g.min_score ? 1.0f : 0.0f;
          row[5] = (best_score >= dropped || dropped <= g.min_score) ? 1.0f : 0.0f;
        } else {
          __stcg(&g.dropped[b], dropped);
        }
      }
      __syncthreads();
    }
    if (t < top) grid_sync(g.barrier);
  }
  if (tm.blocks > 1) tm.cluster.sync();  // no block leaves while another may read its shared
}

}  // namespace

extern "C" int bnb_pyramid(const void* log_odds, const void* known, int size, int depth,
                           void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int cells = size * size;
  int threads = 256, blocks = (cells + threads - 1) / threads;
  level0_kernel<<<blocks, threads, 0, s>>>((const float*)log_odds, (const uint8_t*)known,
                                           cells, (float*)out);
  return upper_levels((float*)out, size, depth, s);
}

extern "C" int bnb_pyramid_tsdf(const void* tsd, const void* weight, float truncation,
                                int size, int depth, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int cells = size * size;
  int threads = 256, blocks = (cells + threads - 1) / threads;
  level0_tsdf_kernel<<<blocks, threads, 0, s>>>((const float*)tsd, (const float*)weight,
                                                truncation, cells, (float*)out);
  return upper_levels((float*)out, size, depth, s);
}

// K7: the beam descent of `pairs` pairs. `pyramids`, `sizes` and `num_offs`
// are host arrays (a device pointer, the grid's size and the top level's
// offsets per axis, per pair); `cells` (pairs, angles, n, 2) int32, `mask`
// (pairs, n) and `valid` (pairs, angles) uint8, `deltas` (pairs, angles) and
// `inits` (pairs, 3) float32 on the device; the scratch: `items` (pairs, 2,
// mmax) 8-byte items with mmax at least every pair's top-level count and
// 4 beam, `parents` (pairs, 2, beam) 16-byte entries, `dropped` (pairs,)
// floats, `barrier` 2 words; `out` (pairs, 6). n is a power of two.
extern "C" int bnb_descent(const void* const* pyramids, const int* sizes, const int* num_offs,
                           int pairs, int depth, int beam, int angles, int n, const void* cells,
                           const void* mask, const void* deltas, const void* valid,
                           const void* inits, float resolution, float min_score, void* items,
                           long long mmax, void* parents, void* dropped, void* barrier,
                           void* out, void* stream) {
  if (n < 1 || (n & (n - 1)) != 0 || depth < 1 || beam < 1 || angles < 1 || pairs < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // clusters[k]: the co-resident clusters of 2^k blocks on the configured
  // device (k = 0: blocks, launched with no cluster). The rule below takes
  // k <= 2; tests/bnb_lm3d_timing.py clusters times 8 and 16 too.
  static int configured = -1, clusters[5] = {0, 0, 0, 0, 0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && device != configured) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, descent_kernel, kThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    clusters[0] = per_sm * sms;
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(descent_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    for (int k = 1; k < 5 && err == cudaSuccess; ++k) {
      cudaLaunchConfig_t probe = {};
      probe.gridDim = dim3(1u << k, 1, 1);
      probe.blockDim = dim3(kThreads, 1, 1);
      cudaLaunchAttribute cluster[1];
      cluster[0].id = cudaLaunchAttributeClusterDimension;
      cluster[0].val.clusterDim.x = 1u << k;
      cluster[0].val.clusterDim.y = 1;
      cluster[0].val.clusterDim.z = 1;
      probe.attrs = cluster;
      probe.numAttrs = 1;
      err = cudaOccupancyMaxActiveClusters(&clusters[k], descent_kernel, &probe);
    }
    if (err == cudaSuccess && clusters[0] < 1) err = cudaErrorInvalidConfiguration;
    if (err == cudaSuccess) configured = device;
  }
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < pairs; b0 += kMaxPairs) {
    const int count = min(kMaxPairs, pairs - b0);
    // The blocks that select a pair: 4 for a group of one pair, else 2, one
    // above what the card holds in clusters of 2 (the fastest on the H100:
    // tests/bnb_lm3d_timing.py clusters, PERF.md).
    int k = count == 1 ? 2 : 1;
    while (k > 0 && clusters[k] < count) --k;
    const unsigned int size = 1u << k, teams = (unsigned int)clusters[k];
    Pairs table = {};
    for (int b = 0; b < count; ++b)
      table.p[b] = Pair{(const float*)pyramids[b0 + b], sizes[b0 + b], num_offs[b0 + b]};
    Args g;
    g.cells = (const int2*)cells + (size_t)b0 * angles * n;
    g.mask = (const uint8_t*)mask + (size_t)b0 * n;
    g.deltas = (const float*)deltas + (size_t)b0 * angles;
    g.valid = (const uint8_t*)valid + (size_t)b0 * angles;
    g.inits = (const float*)inits + (size_t)b0 * 3;
    g.pairs = count;
    g.depth = depth;
    g.beam = beam;
    g.angles = angles;
    g.n = n;
    g.resolution = resolution;
    g.min_score = min_score;
    g.items = (uint2*)items + (size_t)b0 * 2 * mmax;
    g.mmax = mmax;
    g.parents = (int4*)parents + (size_t)b0 * 2 * beam;
    g.dropped = (float*)dropped + b0;
    g.barrier = (unsigned int*)barrier;
    g.out = (float*)out + (size_t)b0 * 6;
    err = cudaMemsetAsync(barrier, 0, 2 * sizeof(unsigned int), st);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(teams * size, 1, 1);
    config.blockDim = dim3(kThreads, 1, 1);
    config.dynamicSmemBytes = 0;
    config.stream = st;
    cudaLaunchAttribute attribute[2];
    attribute[0].id = cudaLaunchAttributeCooperative;
    attribute[0].val.cooperative = 1;
    attribute[1].id = cudaLaunchAttributeClusterDimension;
    attribute[1].val.clusterDim.x = size;
    attribute[1].val.clusterDim.y = 1;
    attribute[1].val.clusterDim.z = 1;
    config.attrs = attribute;
    config.numAttrs = k > 0 ? 2 : 1;
    err = cudaLaunchKernelEx(&config, descent_kernel, table, g);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
