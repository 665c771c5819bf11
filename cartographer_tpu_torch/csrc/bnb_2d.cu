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

#include "beam_select.cuh"
#include "halving_fold.cuh"

namespace {

namespace cg = cooperative_groups;
// beam_select.cuh's names (declarations, not a using-directive: the host
// stub of a kernel in this file's unnamed namespace must find that one alone).
using beam::block_argmin;
using beam::block_select;
using beam::block_sort;
using beam::cluster_capacity;
using beam::grid_sync;
using beam::Items;
using beam::kAhead;
using beam::key_score;
using beam::kThreads;
using beam::kWarps;
using beam::launch_descent;
using beam::score_key;
using beam::Shared;
using beam::Team;
using beam::top_offset;

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

constexpr int kTile = 128;       // points a warp's lanes hold, 4 each
constexpr int kMaxPairs = 128;   // pairs a launch: the pointer table's rows

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
  // device. The rule below takes k <= 2; tests/bnb_lm3d_timing.py clusters
  // times 8 and 16 too.
  static int configured = -1, clusters[5] = {0, 0, 0, 0, 0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && device != configured) {
    err = cluster_capacity(descent_kernel, clusters);
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
    const int teams = clusters[k];
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
    err = launch_descent(descent_kernel, teams, k, (unsigned int*)barrier, st, table, g);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
