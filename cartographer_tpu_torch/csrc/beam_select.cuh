// The beam selections of the branch-and-bound descents K7 (bnb_2d.cu) and
// K15 (bnb_3d.cu): one cooperative launch of blocks of 1,024 threads, one
// per SM, whose phases a grid barrier separates, and whose selections a
// thread-block cluster runs for each pair.
//
// A selection keeps the best `beam` of m (score key, index) items by their
// order-preserving 32-bit keys, ties to the lower index: a radix select of
// the beam-th key (counts of 8 bits a pass, from the top) and one stable
// compaction of the kept in index order, then a stable LSD radix sort of
// those (4 passes of 8 bits; a pass whose digit is one value everywhere is
// skipped). That is the order of a stable torch.sort by value, descending
// (lax.top_k's). The cluster's blocks take slices of the keys in rank order
// and add their counts and tallies through distributed shared memory (one
// cluster barrier a radix pass). The items live in a device scratch, two
// buffers a pair, read and written past L1 (__ldcg, __stcg) since other
// blocks write them.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Internal linkage (an unnamed namespace) for everything here, so that the
// libraries that include this header share nothing when loaded into one
// process.
namespace beam {
namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kDigits = 256;
constexpr int kRow = kWarps + 1;  // a digit's warp counters, padded against bank conflicts
constexpr int kAhead = 4;  // a selection's loads a thread keeps in flight
constexpr int kMaxCluster = 16;  // Hopper's largest cluster, a non-portable size

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

// clusters[k]: the co-resident clusters of 2^k blocks of `kernel` (k < 5)
// on the current device (k = 0: blocks, launched with no cluster).
template <typename Kernel>
cudaError_t cluster_capacity(Kernel kernel, int clusters[5]) {
  int device = 0, per_sm = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  clusters[0] = per_sm * sms;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
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
    err = cudaOccupancyMaxActiveClusters(&clusters[k], kernel, &probe);
  }
  if (err == cudaSuccess && clusters[0] < 1) err = cudaErrorInvalidConfiguration;
  return err;
}

// One cooperative launch of `teams` clusters of 2^k blocks (no cluster at
// k = 0) on `stream`, after zeroing the grid barrier's two words.
template <typename Kernel, typename... Params>
cudaError_t launch_descent(Kernel kernel, int teams, int k, unsigned int* barrier,
                           cudaStream_t stream, Params... params) {
  cudaError_t err = cudaMemsetAsync(barrier, 0, 2 * sizeof(unsigned int), stream);
  if (err != cudaSuccess) return err;
  const unsigned int size = 1u << k;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned int)teams * size, 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute attribute[2];
  attribute[0].id = cudaLaunchAttributeCooperative;
  attribute[0].val.cooperative = 1;
  attribute[1].id = cudaLaunchAttributeClusterDimension;
  attribute[1].val.clusterDim.x = size;
  attribute[1].val.clusterDim.y = 1;
  attribute[1].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = k > 0 ? 2 : 1;
  return cudaLaunchKernelEx(&config, kernel, params...);
}

}  // namespace
}  // namespace beam
