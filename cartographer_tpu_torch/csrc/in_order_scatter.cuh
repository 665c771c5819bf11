// In-order segmented scatter-add, shared by K18 (paged_grid_3d.cu), K30
// (grid_3d.cu) and K21 (tsdf_2d.cu): every item that contributes is added
// into its cell, each cell's items added to its old state in input order.
// That is the order of XLA's scatter-add on the CPU and of the twins'
// index_add_in_order_, so the card equals the twin bit for bit and a run
// repeats. No atomics touch the sums (float atomics moved results at
// near-ties).
//
// A `Source` says per item whether it contributes, to which cell and with
// what 32-bit payload, and how a cell takes its items:
//   __device__ unsigned int cell(int i, unsigned int& payload) const
//     returns the cell (below 2^(8 passes)) or kNone, and sets the payload;
//   typename Acc;  __device__ Acc load(unsigned int cell) const
//     the cell's old state;
//   __device__ void add(Acc& acc, unsigned int payload) const
//     adds one item;
//   __device__ void store(unsigned int cell, const Acc& acc) const
//     writes the cell once, after its last item.
// `SumCount` is the sum-and-count cell of K18 and K30 (the payload is the
// intensity's bits); K21's payload is its sample's index, through which it
// recomputes the sample's two addends (w and w x sdf) in the walk.
//
// Groups: a launch may hold several independent groups of items whose
// cells never meet (K21's robots), one cluster each along blockIdx.y. The
// launch's parameters are then not a Source but a table from which
// `source_of(params, group)` (found by argument-dependent lookup beside the
// parameters' type) makes the group's Source; for a Source itself it is the
// Source, one group. Every group has the same item count and is added as a
// launch of its own would add it.
//
// One launch holds up to kChunk = 131,072 items on chip: a thread-block
// cluster of up to 16 blocks of 512 threads, each block up to kTile = 8,192
// items in 147 KB of dynamic shared memory, the blocks reading and writing
// each other's through distributed shared memory. The cluster takes one
// block per kSpread = 512 items, up to 16: one SM issues too few memory
// requests and instructions for a scan's sort, and the old sums' scattered
// loads and stores, on its own (on the card, tests/in_order_scatter_trace.py:
// one block took 2.4x and 2 blocks 1.7x the cycles of 8 at 4,096 returns,
// and 8 blocks 1.2-1.4x those of 16 at 16,384 and 32,768). Above kChunk,
// one launch per kChunk items in input order on the stream keeps each
// cell's order across launches too: a cell whose state is its running sums
// (SumCount) then ends as one launch would leave it; K21, whose state is an
// average, keeps its sums in a scratch across launches. So a call is one
// launch up to 131,072 items, ceil(n / 131,072) above, and allocates nothing.
//
// 1. Compact. Block b takes the b-th slice of the launch's items, each
//    warp a contiguous share of it, staged in shared memory; the items
//    that add nothing drop out (a warp ballot, then one scan of the 16
//    warps' counts) and the rest go to the block's tile in input order, the
//    payload beside the cell in one 8-byte item: the inputs are read from
//    device memory once. The cluster's tiles, block after block, are the
//    contributing items in input order.
// 2. Sort the cells alone, stably: an LSD radix sort with 8-bit digits and
//    `passes` passes (ceil(bits / 8), from the grid's cell count on the
//    host: 3 for the default pool of 2^23 cells, K30's 256^3 window and
//    K21's two 1024^2 slots). Stability keeps the input order within a
//    cell, so the item index never enters the key. Per pass: the block
//    counts its tile's digits per warp share with shared atomics (a count
//    does not depend on their order) and turns each digit's 16 warp counts
//    into offsets; after a cluster barrier each block reads the cluster's
//    per-digit totals at once and scans them over the 256 digits; then each
//    warp walks its share in order and sends every item to base[digit] +
//    its warp's running count + its rank among the lower lanes of equal
//    digit (eight ballots), in the other buffer of whichever block holds
//    that position: positions are dealt out evenly, ceil(all / blocks) to a
//    block. Two cluster barriers and three block barriers a pass, where the
//    bitonic network this replaces took log2 n (log2 n + 1) / 2 dependent
//    steps (78 at 4,096 keys) in one block and, above 8,192 keys, a launch
//    per larger step.
// 3. Add the runs. A position whose cell differs from the one before it
//    starts a run; its thread adds the run's payloads to the cell's old
//    state one after another, reading them from shared memory (a run that
//    crosses into the next block reads that block's), and writes the cell
//    once. A thread per run, the old states of kBatch runs loaded
//    together: a scan's runs are short (a few returns per 0.1 m cell), and
//    one long run costs one thread's walk.
//
// Bound: bytes, each item's inputs read once and each touched cell's state
// read and written once. The time goes to the three passes' barriers and
// traffic between the blocks, and to two round trips to device memory (the
// inputs, the old states); see PERF.md for the card's.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace in_order_scatter {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8192;                  // returns a block holds
constexpr int kMaxCluster = 16;              // Hopper's largest, a non-portable size
constexpr int kChunk = kTile * kMaxCluster;  // returns per launch
constexpr int kSpread = 512;  // returns per block below kMaxCluster * kSpread
constexpr int kDigits = 256;
constexpr int kRow = kWarps + 1;  // a digit's warp counters, padded against bank conflicts
constexpr int kBatch = 4;         // runs per thread whose loads are in flight together
constexpr unsigned int kNone = 0xFFFFFFFFu;

struct Shared {
  uint2 items[2][kTile];  // (cell, payload), double-buffered across the passes
  unsigned int count[kDigits * kRow];  // per digit and warp: counts, then running offsets
  unsigned int total[kDigits];  // the block's count per digit, read by the cluster
  unsigned int base[kDigits];   // the block's first position per digit
  unsigned int warp_sum[kWarps];
  unsigned int all;  // contributing returns in the launch
};

// Blocks of a launch of `count` returns (at most kChunk).
__host__ __device__ inline int cluster_blocks(int count) {
  const int spread = (count + kSpread - 1) / kSpread;
  return spread < 1 ? 1 : spread > kMaxCluster ? kMaxCluster : spread;
}

// A launch of one group: its parameters are the Source.
template <class Source>
__device__ inline const Source& source_of(const Source& src, unsigned int) {
  return src;
}

__device__ inline unsigned int warp_inclusive_sum(unsigned int x, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// The valid lanes whose 8-bit digit equals this lane's: eight ballots, one
// per bit (__match_any_sync made the scatter up to 1.2x as long on the card).
__device__ inline unsigned int same_digit(unsigned int d, bool valid) {
  unsigned int peers = __ballot_sync(0xFFFFFFFFu, valid);
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool bit = (d >> b) & 1u;
    const unsigned int set = __ballot_sync(0xFFFFFFFFu, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

// The cluster's barrier, or the block's where the cluster is one block.
__device__ inline void sync_all(cg::cluster_group& cluster, unsigned int blocks) {
  if (blocks > 1)
    cluster.sync();
  else
    __syncthreads();
}

// The cell of K18 and K30: a running sum of intensities (the payload's
// bits) and a count, in two float arrays.
struct SumCount {
  float* sums;
  float* counts;

  struct Acc {
    float sum, count;
  };
  __device__ Acc load(unsigned int c) const { return {sums[c], counts[c]}; }
  __device__ void add(Acc& a, unsigned int payload) const {
    a.sum = a.sum + __uint_as_float(payload);
    a.count = a.count + 1.0f;
  }
  __device__ void store(unsigned int c, const Acc& a) const {
    sums[c] = a.sum;
    counts[c] = a.count;
  }
};

// Adds the payloads of items[j], items[j + 1], ... while their cell is
// `key`, before `end`.
template <class Source>
__device__ inline void walk(const Source& src, const uint2* items, unsigned int& j,
                            unsigned int end, unsigned int key, typename Source::Acc& acc) {
  for (; j < end; ++j) {
    const uint2 item = items[j];
    if (item.x != key) break;
    src.add(acc, item.y);
  }
}

template <class Params>
__global__ void __launch_bounds__(kThreads, 1)
    scatter_kernel(Params params, int begin, int count, int passes) {
  using Source = std::decay_t<decltype(source_of(params, 0u))>;
  decltype(auto) src = source_of(params, blockIdx.y);  // this cluster's group
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& s = *reinterpret_cast<Shared*>(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned int rank = cluster.block_rank(), blocks = cluster.num_blocks();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned int below = (1u << lane) - 1u;

  // 1. Compact this block's slice of the returns into items[0], staged in
  // input order in items[1].
  const int slice = (count + (int)blocks - 1) / (int)blocks;
  const int first = min(count, (int)rank * slice);
  const int tile = min(slice, count - first);
  const int share = (tile + kWarps - 1) / kWarps;
  const int in_lo = min(warp * share, tile), in_hi = min(in_lo + share, tile);
  unsigned int kept = 0;
#pragma unroll 4
  for (int i0 = in_lo; i0 < in_hi; i0 += 32) {
    const int i = i0 + lane;
    unsigned int payload = 0u;
    const unsigned int cell = i < in_hi ? src.cell(begin + first + i, payload) : kNone;
    if (i < in_hi) s.items[1][i] = make_uint2(cell, payload);
    kept += __popc(__ballot_sync(0xFFFFFFFFu, cell != kNone));
  }
  if (lane == 0) s.warp_sum[warp] = kept;
  for (int i = threadIdx.x; i < kDigits * kRow; i += kThreads) s.count[i] = 0;
  __syncthreads();
  unsigned int at = 0, size = 0;
  for (int w = 0; w < kWarps; ++w) {
    const unsigned int v = s.warp_sum[w];
    at += w < warp ? v : 0u;
    size += v;
  }
  for (int i0 = in_lo; i0 < in_hi; i0 += 32) {
    const int i = i0 + lane;
    const uint2 item = i < in_hi ? s.items[1][i] : make_uint2(kNone, 0u);
    const unsigned int ballot = __ballot_sync(0xFFFFFFFFu, item.x != kNone);
    if (item.x != kNone) s.items[0][at + __popc(ballot & below)] = item;
    at += __popc(ballot);
  }
  __syncthreads();

  // 2. Radix passes. Pass p reads buffer p & 1 and writes the other; the
  // tile is the block's compacted returns, then its `per` positions of the
  // sorted order.
  unsigned int all = 0, per = 1;
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = 8 * pass, cur = pass & 1, next = cur ^ 1;
    if (pass > 0) size = all > rank * per ? min(per, all - rank * per) : 0u;
    const unsigned int part = (size + kWarps - 1) / kWarps;
    const int lo = min(warp * (int)part, (int)size), hi = min(lo + (int)part, (int)size);
    // The digits' counts per warp share: shared atomics, whose order does
    // not matter to a count.
    for (unsigned int i = threadIdx.x; i < size; i += kThreads)
      atomicAdd(&s.count[((s.items[cur][i].x >> shift) & 0xFFu) * kRow + i / part], 1u);
    __syncthreads();
    if (threadIdx.x < kDigits) {  // each digit's warp counts -> offsets; the block's total
      const int d = threadIdx.x;
      unsigned int sum = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const unsigned int v = s.count[d * kRow + w];
        s.count[d * kRow + w] = sum;
        sum += v;
      }
      s.total[d] = sum;
    }
    sync_all(cluster, blocks);
    unsigned int digit_all = 0, before = 0, x = 0;
    if (threadIdx.x < kDigits) {
      const int d = threadIdx.x;
      unsigned int v[kMaxCluster];
#pragma unroll
      for (int b = 0; b < kMaxCluster; ++b)  // the loads in flight together
        v[b] = b >= (int)blocks ? 0u
               : b == (int)rank ? s.total[d]
                                : cluster.map_shared_rank(&s, (unsigned int)b)->total[d];
#pragma unroll
      for (int b = 0; b < kMaxCluster; ++b) {
        digit_all += v[b];
        before += b < (int)rank ? v[b] : 0u;
      }
      x = warp_inclusive_sum(digit_all, lane);
      if (lane == 31) s.warp_sum[warp] = x;
    }
    __syncthreads();
    if (threadIdx.x < kDigits) {
      unsigned int add = 0;
      for (int w = 0; w < warp; ++w) add += s.warp_sum[w];
      s.base[threadIdx.x] = add + x - digit_all + before;
      if (threadIdx.x == kDigits - 1) s.all = add + x;
    }
    __syncthreads();
    all = s.all;
    per = all > 0 ? (all + blocks - 1) / blocks : 1u;
    for (int i0 = lo; i0 < hi; i0 += 32) {
      const int i = i0 + lane;
      const bool valid = i < hi;
      const uint2 item = valid ? s.items[cur][i] : make_uint2(0u, 0u);
      const unsigned int d = (item.x >> shift) & 0xFFu;
      const unsigned int peers = same_digit(d, valid);
      const unsigned int off = valid ? s.count[d * kRow + warp] : 0u;
      __syncwarp();
      if (valid) {
        const unsigned int r = __popc(peers & below), group = __popc(peers);
        if (r == group - 1) s.count[d * kRow + warp] = off + group;
        const unsigned int o = s.base[d] + off + r, owner = o / per;
        Shared* t = owner == rank ? &s : cluster.map_shared_rank(&s, owner);
        t->items[next][o - owner * per] = item;
      }
      __syncwarp();
    }
    for (int d = lane; d < kDigits; d += 32) s.count[d * kRow + warp] = 0;  // the next pass's
    sync_all(cluster, blocks);
  }

  // 3. Add each run that starts in this block's positions, in order. A
  // thread loads the old states of kBatch runs before it walks them, so
  // their loads are in flight together.
  const uint2* items = s.items[passes & 1];  // the last pass's output
  size = all > rank * per ? min(per, all - rank * per) : 0u;
  for (unsigned int start = 0; start < size; start += kThreads * kBatch) {
    unsigned int key[kBatch];
    typename Source::Acc acc[kBatch];
    bool head[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const unsigned int i = start + q * kThreads + threadIdx.x;
      key[q] = 0;
      head[q] = false;
      if (i < size) {
        key[q] = items[i].x;
        const unsigned int prev =
            i > 0 ? items[i - 1].x
                  : rank > 0 ? cluster.map_shared_rank(&s, rank - 1)->items[passes & 1][per - 1].x
                             : ~key[q];
        head[q] = prev != key[q];
      }
      if (head[q]) acc[q] = src.load(key[q]);
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      if (!head[q]) continue;
      unsigned int j = start + q * kThreads + threadIdx.x, end = size;
      walk(src, items, j, end, key[q], acc[q]);
      // A run that reaches the end of this block's positions goes on in the next.
      for (unsigned int r = rank + 1; j == end && r < blocks && r * per < all; ++r) {
        j = 0;
        end = min(per, all - r * per);
        walk(src, cluster.map_shared_rank(&s, r)->items[passes & 1], j, end, key[q], acc[q]);
      }
      src.store(key[q], acc[q]);
    }
  }
  if (blocks > 1) cluster.sync();  // no block leaves while another may read its shared memory
}

// Adds the n items of each of `groups` groups of `params` (a Source: one
// group) into their cells in place; `passes` (1 to 4) radix passes of 8 bits
// cover every cell index. ceil(n / kChunk) launches on `stream`, each a grid
// of `groups` clusters of cluster_blocks(items) blocks.
template <class Params>
inline cudaError_t launch(const Params& params, int n, int passes, cudaStream_t stream,
                          int groups = 1) {
  if (n < 0 || passes < 1 || passes > 4 || groups < 1 || groups > 65535)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  void (*kernel)(Params, int, int, int) = scatter_kernel<Params>;
  const int bytes = (int)sizeof(Shared);
  static int configured = -1;  // the device on which the kernel may take `bytes`
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && device != configured) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess) configured = device;
  }
  if (err != cudaSuccess) return err;
  for (int begin = 0; begin < n; begin += kChunk) {
    const int count = min(kChunk, n - begin);
    const unsigned int blocks = (unsigned int)cluster_blocks(count);
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(blocks, (unsigned int)groups, 1);
    config.blockDim = dim3(kThreads, 1, 1);
    config.dynamicSmemBytes = (size_t)bytes;
    config.stream = stream;
    cudaLaunchAttribute attribute[1];
    attribute[0].id = cudaLaunchAttributeClusterDimension;
    attribute[0].val.clusterDim.x = blocks;
    attribute[0].val.clusterDim.y = 1;
    attribute[0].val.clusterDim.z = 1;
    config.attrs = attribute;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(&config, kernel, params, begin, count, passes);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // namespace in_order_scatter
