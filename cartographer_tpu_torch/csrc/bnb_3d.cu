// K14 bnb3d_stack; K15 bnb3d_descent
//
// K14 replaces: cartographer_tpu/ops/bnb_3d.py:build_precomputation_stack_3d
// (l.113) with _quantize (l.90), _shift_max (l.95) and _halve (l.106), on the
// probability image of ops/grid_3d.py:Grid3D.probability.
// The first launch quantizes each cell's probability (1 / (1 + exp(-l))
// where known, 0.1 elsewhere) to round((p - 0.1) / Q) clipped to 0..255,
// straight from the grid's log-odds and known mask, so no float probability
// volume is made. Each later launch is one elementwise pass, one thread per
// output cell: a shift-max (the max over the 2x2x2 corners {0, s}^3 of a
// cell, cells beyond the high edge left out, which is the JAX form's three
// zero-padded axis passes since all values are >= 0) or a halving (the max
// over a 2x2x2 block). Full levels h = 1 .. frd-1 shift by 2^(h-1); each
// coarse level shifts the previous level by 2^(frd-1), halves it, shifts
// by one stored cell and writes the result zero-padded to (S/2)^3. max is
// exact, so the levels are equal bit for bit to the twin's.
// Bound: bytes. At 256^3 the quantization reads 64 MB of log-odds and
// 16 MB of mask; the levels write 3 x 16 MB + 5 x 2 MB; later passes read
// the previous level, mostly from L2.
//
// K15 replaces: cartographer_tpu/ops/bnb_3d.py: the beam search
// _beam_candidates_3d (l.182) with its scorer _score_level (l.152), the
// low-resolution gate and best-candidate selection of _match_tail (l.527)
// with _score_3d (l.724), and the per-yaw discretization of
// fast_correlative_match_3d (l.503-514) and match_full_submap_3d
// (l.655-663), for a group of (node, submap) pairs in one launch. It serves
// match_full_submap_3d_exact (l.685) too, a wave of requests a round. Each
// pair's search runs in the kernel, in the JAX order:
//  0. its high and low clouds rotated by q_init, then by each yaw, shifted
//     and discretized into cells (the twin's sequence of multiplies and
//     adds, v + w (2 qv x v) + qv x (2 qv x v)), and its valid points
//     counted, once;
//  1. the top level's A x nxy^2 x nz candidates scored (dead yaws -inf);
//  2. for h = depth - 2 ... 0: the best `beam` (beam = min(beam width, the
//     top level's count)) of the level's candidates kept in order, the
//     dropped bound raised to the (beam + 1)-th value (at the top level
//     that is also the JAX form's keep-8-beam-or-pad step), the 8 children
//     of parent j laid out at k beam + j with offsets ((k & 1), (k >> 1) &
//     1, k >> 2) 2^h, each masked by its parent's score > min_score, and
//     scored on level h (a full level as is, coarse level j with the cell
//     shifted right by j + 1; a candidate more than 2^h cells below the
//     grid or beyond it reads 0.1);
//  3. the best 64 leaves kept in order, the bound raised to the 65th, each
//     scored on the low grid's probabilities at offsets round(o res /
//     low_res) (rintf: half to even, as torch.round), gated at
//     min_low_score, and the argmax taken (ties to the lowest index),
//     written as the pair's row [found, score, t (3), q (4), rotational
//     score, low-resolution score, certified] (q the yaw's rotation times
//     q_init, normalized as the twin does it, by sqrt(((w w + x x) + y y)
//     + z z)).
// A candidate's score is the mean level value under its yaw's cells shifted
// by its offset (masked points 0), in one warp: lane k holds points k, k +
// 32, ... of a tile of up to 256 points (each the halving fold,
// halving_fold.cuh, of the points k + j * 256 above that), the tile's tree
// added in registers down to 32 and by shuffles below: the twin's pairwise
// halving tree, so every score keeps its bits; the pair's valid count is
// read, not recounted. A warp scores one candidate at a time, reading its
// yaw's cells (4 KB at 256 points) for each: warps that held a yaw's cells
// in registers across a parent's 8 children were 7-26% slower on the H100
// (tests/bnb_lm3d_timing.py variants3d, PERF.md), the gathers and not the
// cell reads setting the time.
// The selections are beam_select.cuh's (a radix select of the beam-th key
// and a stable LSD radix sort of the kept, in a thread-block cluster a
// pair), the order of the twin's stable torch.sort, so the kernel's rows
// equal the twin's bit for bit.
//
// Layout: one cooperative launch of blocks of 1,024 threads, one per SM,
// phases separated by a grid barrier, 2 depth a call: the discretization
// and every level's scoring spread over every block's warps and all the
// group's candidates (flattened over the pairs, which the caller orders by
// submap so that one submap's levels stay in L2 while they are scored),
// each level's selections by a cluster a pair (4 blocks for a lone pair,
// else 2, one above what the card holds in clusters of 2; cluster c takes
// pairs c, c + clusters, ...). The cells (16 bytes a point and yaw), the
// items and the kept parents live in a device scratch. Each pair's stack
// levels, low probabilities, origins, sizes and top-level offsets are
// reached through a pointer table in the launch's parameters, up to
// kMaxPairs pairs a launch (one launch per kMaxPairs above).
//
// Bound: operations (25 a gathered point, 60 a point and yaw discretized),
// but latency sets the time: a level-step of 16,384 candidates x 256 points
// gathers 4 M bytes scattered over a 16 MB level (L2-resident), and each
// level's selection is a chain of some 30 dependent barrier steps. A lone
// pair is bound by its selections (33 us a level against 5 of scoring on
// the H100, PERF.md), a group of 8 or more by its scoring.

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
using beam::block_select;
using beam::block_sort;
using beam::cluster_capacity;
using beam::grid_sync;
using beam::Items;
using beam::key_score;
using beam::kThreads;
using beam::kWarps;
using beam::launch_descent;
using beam::score_key;
using beam::Shared;
using beam::Team;
using beam::top_offset;

constexpr float kUnknown = 0.1f;
constexpr int kStackThreads = 256;

__global__ void quantize_kernel(const float* __restrict__ log_odds,
                                const uint8_t* __restrict__ known, long long cells,
                                float q_scale, float q_min, uint8_t* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  float p = known[i] ? 1.0f / (1.0f + expf(-log_odds[i])) : kUnknown;
  float v = rintf((p - q_min) / q_scale);
  out[i] = (uint8_t)fminf(fmaxf(v, 0.0f), 255.0f);
}

// dst (dst_dim^3) = shift-max of the size^3 volume held in src (src_dim^3);
// cells of dst beyond `size` are zero.
__global__ void shift_max_kernel(const uint8_t* __restrict__ src, int src_dim,
                                 uint8_t* __restrict__ dst, int dst_dim, int size, int shift) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long n = (long long)dst_dim * dst_dim * dst_dim;
  if (i >= n) return;
  int z = (int)(i % dst_dim);
  int y = (int)((i / dst_dim) % dst_dim);
  int x = (int)(i / ((long long)dst_dim * dst_dim));
  uint8_t v = 0;
  if (x < size && y < size && z < size) {
    for (int c = 0; c < 8; ++c) {
      int xx = x + ((c & 1) ? shift : 0);
      int yy = y + ((c & 2) ? shift : 0);
      int zz = z + ((c & 4) ? shift : 0);
      if (xx < size && yy < size && zz < size) {
        uint8_t s = src[((long long)xx * src_dim + yy) * src_dim + zz];
        v = s > v ? s : v;
      }
    }
  }
  dst[i] = v;
}

// dst (size^3) = max over the 2x2x2 blocks of src (2 size)^3.
__global__ void halve_kernel(const uint8_t* __restrict__ src, int src_dim,
                             uint8_t* __restrict__ dst, int size) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long n = (long long)size * size * size;
  if (i >= n) return;
  int z = (int)(i % size);
  int y = (int)((i / size) % size);
  int x = (int)(i / ((long long)size * size));
  uint8_t v = 0;
  for (int c = 0; c < 8; ++c) {
    int xx = 2 * x + (c & 1), yy = 2 * y + ((c >> 1) & 1), zz = 2 * z + (c >> 2);
    uint8_t s = src[((long long)xx * src_dim + yy) * src_dim + zz];
    v = s > v ? s : v;
  }
  dst[i] = v;
}


// ---------------------------------------------------------------- K15

constexpr int kTile = 256;     // points a warp's lanes hold, 8 each
constexpr int kMaxPairs = 64;  // pairs a launch: the pointer table's rows
constexpr int kGate = 64;      // leaves scored on the low-resolution grid

struct Pair {
  const uint8_t* full;      // (frd, S, S, S) uint8 levels
  const uint8_t* coarse;    // (depth - frd, S/2, S/2, S/2)
  const float* low;         // (Sl, Sl, Sl) the low grid's probabilities
  const float* origin;      // (3,) the grid's origin
  const float* low_origin;  // (3,)
  int size, low_size;       // S, Sl
  int nxy, nz;              // top-level offsets per axis
};

struct Pairs {
  Pair p[kMaxPairs];
};

struct Args {
  const float* points;       // (pairs, n, 3) the high-resolution cloud
  const uint8_t* mask;       // (pairs, n)
  const float* low_points;   // (pairs, nl, 3)
  const uint8_t* low_mask;   // (pairs, nl)
  const float* yaw_q;        // (pairs, angles, 4): the yaws, applied after q_init
  const float* q_init;       // (pairs, 4)
  const float* translation;  // (pairs, 3): the start in the grid frame
  const uint8_t* alive;      // (pairs, angles): yaws within the window and the gate
  const float* rot;          // (pairs, angles): rotational scores
  int pairs, depth, frd, beam, angles, n, nl;
  float resolution, low_resolution, ratio, min_score, min_low_score, q_scale, q_min;
  int4* cells;               // (pairs, angles, n): the clouds' cells
  int4* low_cells;           // (pairs, angles, nl)
  int* counts;               // (pairs, 2): valid points, high and low
  uint2* items;              // (pairs, 2, mmax): (score key, index), two buffers
  long long mmax;
  int4* parents;             // (pairs, 2, pstride): ((yaw << 1) | alive, ox, oy, oz)
  int pstride;
  float* dropped;            // (pairs,)
  float* gate;               // (pairs, 2, kGate): the leaves' scores, their low scores
  unsigned int* barrier;     // (2,): arrivals and generation, zeroed before the launch
  float* out;                // (pairs, 12)
};

// A level as a candidate reads it: uint8 (dequantized) or float values.
struct Level {
  const uint8_t* u8;
  const float* f32;
  int dim, size, re, window;
};

// out = q v, the rotation written out as the plain twin computes it.
__device__ inline void rotate(const float* q, const float v[3], float out[3]) {
  float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  float tx = 2.0f * (qy * v[2] - qz * v[1]);
  float ty = 2.0f * (qz * v[0] - qx * v[2]);
  float tz = 2.0f * (qx * v[1] - qy * v[0]);
  out[0] = v[0] + qw * tx + (qy * tz - qz * ty);
  out[1] = v[1] + qw * ty + (qz * tx - qx * tz);
  out[2] = v[2] + qw * tz + (qx * ty - qy * tx);
}

// out = a b, the quaternion product in the order of the twin's
// quat.multiply.
__device__ inline void multiply(const float* a, const float* b, float out[4]) {
  out[0] = ((a[0] * b[0] - a[1] * b[1]) - a[2] * b[2]) - a[3] * b[3];
  out[1] = ((a[0] * b[1] + a[1] * b[0]) + a[2] * b[3]) - a[3] * b[2];
  out[2] = ((a[0] * b[2] - a[1] * b[3]) + a[2] * b[0]) + a[3] * b[1];
  out[3] = ((a[0] * b[3] + a[1] * b[2]) - a[2] * b[1]) + a[3] * b[0];
}

// The level value under a valid point at cell c shifted by o (UNKNOWN when
// the cell lies `window` or more cells below the grid, or beyond it).
__device__ inline float point_value(const Level& L, int4 c, int ox, int oy, int oz,
                                    float q_scale, float q_min) {
  const int cx = c.x + ox, cy = c.y + oy, cz = c.z + oz;
  const bool inside = cx > -L.window && cx < L.size && cy > -L.window && cy < L.size &&
                      cz > -L.window && cz < L.size;
  if (!inside) return kUnknown;
  const long long gx = min(max(cx, 0), L.size - 1) >> L.re;
  const long long gy = min(max(cy, 0), L.size - 1) >> L.re;
  const long long gz = min(max(cz, 0), L.size - 1) >> L.re;
  const long long i = (gx * L.dim + gy) * L.dim + gz;
  return L.u8 ? (float)__ldg(&L.u8[i]) * q_scale + q_min : __ldg(&L.f32[i]);
}

// v[j] += v[j + h] for h = r / 2, ..., 1 (r is 1, 2, 4 or 8), with constant
// indices so that v stays in registers.
__device__ inline void halve(float v[8], int r) {
  if (r >= 8)
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = v[j] + v[j + 4];
  if (r >= 4)
#pragma unroll
    for (int j = 0; j < 2; ++j) v[j] = v[j] + v[j + 2];
  if (r >= 2) v[0] = v[0] + v[1];
}

// The mean value of level L under the n points (a power of two; `count`
// valid) at `cells`, shifted by (ox, oy, oz): the twin's halving tree, in
// the calling warp; the result in every lane.
__device__ inline float score(const Level& L, const int4* cells, const uint8_t* mask, int n,
                              int count, int ox, int oy, int oz, float q_scale, float q_min) {
  const int lane = threadIdx.x & 31;
  float v[8];
  if (n <= kTile) {
    // Lane k holds points k + 32 j, j < ceil(n / 32).
    const int r = (n + 31) >> 5;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = lane + 32 * j;
      const bool valid = j < r && k < n && mask[k];
      v[j] = valid ? point_value(L, cells[k], ox, oy, oz, q_scale, q_min) : 0.0f;
    }
    halve(v, r);
  } else {
    // Above the tile: lane k's value j is the fold of points
    // k + 32 j + i * kTile, i < n / kTile, in the tree's pairing.
    const int m = n / kTile;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = lane + 32 * j;
      v[j] = halving::fold(m, [&](int i) {
        const int p = k + i * kTile;
        return mask[p] ? point_value(L, cells[p], ox, oy, oz, q_scale, q_min) : 0.0f;
      });
    }
    halve(v, 8);
  }
  float s = v[0];
  for (int off = 16; off > 0; off >>= 1) s = s + __shfl_down_sync(0xffffffffu, s, off);
  s = __shfl_sync(0xffffffffu, s, 0);
  return s / (float)max(count, 1);
}

// Candidate j of pair b at step t (scoring level h): (yaw, ox, oy, oz). At
// the top level from its index (yaw-major, then x, y, z; `alive` the yaw's
// flag), below from its parent in `par` (`alive` the parent's flag).
__device__ inline int4 candidate(const Args& g, int nxy, int nz, int b, const int4* par, int t,
                                 int h, int beam_b, int j, bool& alive) {
  if (t == 0) {
    const int stride = 1 << h, per_yaw = nxy * nxy * nz;
    const int a = j / per_yaw, r = j % per_yaw;
    alive = g.alive[(size_t)b * g.angles + a] != 0;
    return make_int4(a, top_offset(r / (nxy * nz), nxy, stride),
                     top_offset((r / nz) % nxy, nxy, stride), top_offset(r % nz, nz, stride));
  }
  const int4 p = __ldcg(&par[j % beam_b]);
  const int k = j / beam_b, c = 1 << h;
  alive = (p.x & 1) != 0;
  return make_int4(p.x >> 1, p.y + (k & 1) * c, p.z + ((k >> 1) & 1) * c, p.w + (k >> 2) * c);
}

// Level h of pair pr's stack.
__device__ inline Level level_of(const Args& g, const Pair pr, int h) {
  Level L;
  L.f32 = nullptr;
  L.size = pr.size;
  L.window = 1 << h;
  if (h >= g.frd) {
    const int half = pr.size / 2;
    L.u8 = pr.coarse + (size_t)(h - g.frd) * half * half * half;
    L.dim = half;
    L.re = h - g.frd + 1;
  } else {
    L.u8 = pr.full + (size_t)h * pr.size * pr.size * pr.size;
    L.dim = pr.size;
    L.re = 0;
  }
  return L;
}

// The argmax of (v, i) over the warp (the larger v, then the lower i; i < 0
// is no value), in every lane.
__device__ inline void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (oi >= 0 && (i < 0 || ov > v || (ov == v && oi < i))) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) descent_kernel(Pairs pairs, Args g) {
  __shared__ Shared s;
  __shared__ int start[2][kMaxPairs + 1];  // each pair's first flattened candidate: top, below
  Team tm{cg::this_cluster(), 0u, 0u, 0};
  tm.blocks = tm.cluster.num_blocks();
  tm.rank = tm.cluster.block_rank();
  const int team = (int)(blockIdx.x / tm.blocks), teams = (int)(gridDim.x / tm.blocks);
  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * kWarps + (threadIdx.x >> 5), nwarps = gridDim.x * kWarps;
  const int top = g.depth - 1;
  if (threadIdx.x == 0) {
    int above = 0, below = 0;
    for (int b = 0; b < g.pairs; ++b) {
      const Pair pr = pairs.p[b];
      const int m0 = g.angles * pr.nxy * pr.nxy * pr.nz;
      start[0][b] = above;
      start[1][b] = below;
      above += m0;
      below += 8 * min(g.beam, m0);
    }
    start[0][g.pairs] = above;
    start[1][g.pairs] = below;
  }

  // 0. Every pair's clouds at every yaw as cells; each pair's valid counts.
  {
    const int per_yaw = g.n + g.nl;
    const long long per_pair = (long long)g.angles * per_yaw, total = per_pair * g.pairs;
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total;
         i += (long long)gridDim.x * kThreads) {
      const int b = (int)(i / per_pair), r = (int)(i % per_pair);
      const int a = r / per_yaw, k = r % per_yaw;
      const bool low = k >= g.n;
      const int p = low ? k - g.n : k;
      const float* pt = low ? g.low_points + ((size_t)b * g.nl + p) * 3
                            : g.points + ((size_t)b * g.n + p) * 3;
      const float* origin = low ? pairs.p[b].low_origin : pairs.p[b].origin;
      const float* t = g.translation + (size_t)b * 3;
      const float res = low ? g.low_resolution : g.resolution;
      const float v[3] = {pt[0], pt[1], pt[2]};
      float q[3], w[3];
      rotate(g.q_init + (size_t)b * 4, v, q);
      rotate(g.yaw_q + ((size_t)b * g.angles + a) * 4, q, w);
      int c[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) c[d] = (int)floorf(((w[d] + t[d]) - origin[d]) / res);
      int4* out = low ? g.low_cells + ((size_t)b * g.angles + a) * g.nl + p
                      : g.cells + ((size_t)b * g.angles + a) * g.n + p;
      *out = make_int4(c[0], c[1], c[2], 0);
    }
    if (gwarp < 2 * g.pairs) {
      const int b = gwarp >> 1, low = gwarp & 1, n = low ? g.nl : g.n;
      const uint8_t* mask = low ? g.low_mask + (size_t)b * g.nl : g.mask + (size_t)b * g.n;
      int count = 0;
      for (int k0 = 0; k0 < n; k0 += 32)
        count += __popc(__ballot_sync(0xffffffffu, k0 + lane < n && mask[k0 + lane]));
      if (lane == 0) g.counts[gwarp] = count;
    }
  }
  grid_sync(g.barrier);

  for (int t = 0; t < g.depth; ++t) {
    const int h = top - t;  // the level scored at this step
    // Score every pair's candidates of this level, flattened over the pairs:
    // a warp a candidate.
    {
      const int* first = start[t == 0 ? 0 : 1];
      int b = -1, beam_b = 0, count = 0, nxy = 0, nz = 0;
      Level L;
      const int4* par = nullptr;
      const int4* cells = nullptr;
      const uint8_t* mask = nullptr;
      uint2* items = nullptr;
      for (int i = gwarp; i < first[g.pairs]; i += nwarps) {
        if (b < 0 || i >= first[b + 1]) {
          do ++b; while (i >= first[b + 1]);
          const Pair pr = pairs.p[b];
          L = level_of(g, pr, h);
          nxy = pr.nxy;
          nz = pr.nz;
          beam_b = min(g.beam, start[0][b + 1] - start[0][b]);
          count = __ldcg(&g.counts[2 * b]);
          par = g.parents + ((size_t)b * 2 + (t & 1)) * g.pstride;
          cells = g.cells + (size_t)b * g.angles * g.n;
          mask = g.mask + (size_t)b * g.n;
          items = g.items + (size_t)b * 2 * g.mmax;
        }
        const int j = i - first[b];
        bool alive;
        const int4 c = candidate(g, nxy, nz, b, par, t, h, beam_b, j, alive);
        const float sc = alive ? score(L, cells + (size_t)c.x * g.n, mask, g.n, count, c.y, c.z,
                                       c.w, g.q_scale, g.q_min)
                               : -INFINITY;
        if (lane == 0) __stcg(&items[j], make_uint2(score_key(sc), (unsigned int)j));
      }
    }
    grid_sync(g.barrier);

    // Select: cluster c takes pairs c, c + clusters, ...
    for (int b = team; b < g.pairs; b += teams) {
      const Pair pr = pairs.p[b];
      const int m0 = start[0][b + 1] - start[0][b], beam_b = min(g.beam, m0);
      const int m = t == 0 ? m0 : 8 * beam_b;
      uint2* items = g.items + (size_t)b * 2 * g.mmax;
      const int4* par = g.parents + ((size_t)b * 2 + (t & 1)) * g.pstride;
      int4* kept = g.parents + ((size_t)b * 2 + ((t + 1) & 1)) * g.pstride;
      float dropped = t == 0 ? -INFINITY : __ldcg(&g.dropped[b]);
      const Items it = {{items, items + g.mmax}};
      const Items chosen = {{items + g.mmax, items}};  // a selection sorts from buffer 1
      // The best `keep` of the m candidates in order (the (keep + 1)-th
      // raising the dropped bound), as candidates with their scores.
      const int leaves = min(kGate, 8 * beam_b);  // the list the gate takes its leaves from
      const int keep = t < top ? beam_b : min(leaves, m);
      const Items* sorted = &it;
      int r;
      if (m > keep) {
        dropped = fmaxf(dropped, key_score(block_select(tm, it, m, keep, s)));
        r = block_sort(tm, chosen, keep, s);
        sorted = &chosen;
      } else {
        r = block_sort(tm, it, m, s);
      }
      const int pad = t < top ? keep : leaves;  // past `keep` (depth 1 only): -inf at index 0
      for (int p = tm.thread(); p < pad; p += tm.threads()) {
        float sc = -INFINITY;
        int4 c = make_int4(0, 0, 0, 0);
        if (p < keep) {
          const uint2 item = sorted->load(r, p);
          bool unused;
          sc = key_score(item.x);
          c = candidate(g, pr.nxy, pr.nz, b, par, t, h, beam_b, (int)item.y, unused);
        }
        if (t < top) {
          c.x = (c.x << 1) | (sc > g.min_score ? 1 : 0);
        } else {
          __stcg(&g.gate[(size_t)b * 2 * kGate + p], sc);
        }
        __stcg(&kept[p], c);
      }
      if (t < top) {
        if (tm.rank == 0 && threadIdx.x == 0) __stcg(&g.dropped[b], dropped);
        __syncthreads();
        continue;
      }
      // The leaves on the low-resolution grid: a warp a leaf.
      tm.sync();
      Level low;
      low.u8 = nullptr;
      low.f32 = pr.low;
      low.dim = low.size = pr.low_size;
      low.re = 0;
      low.window = 1;
      const int low_count = __ldcg(&g.counts[2 * b + 1]);
      for (int p = tm.warp(); p < pad; p += tm.warps()) {
        const int4 c = __ldcg(&kept[p]);
        const int lx = (int)rintf((float)c.y * g.ratio), ly = (int)rintf((float)c.z * g.ratio),
                  lz = (int)rintf((float)c.w * g.ratio);
        const float ls = score(low, g.low_cells + ((size_t)b * g.angles + c.x) * g.nl,
                               g.low_mask + (size_t)b * g.nl, g.nl, low_count, lx, ly, lz,
                               g.q_scale, g.q_min);
        if (lane == 0) __stcg(&g.gate[((size_t)b * 2 + 1) * kGate + p], ls);
      }
      tm.sync();
      if (tm.rank == 0 && threadIdx.x < 32) {
        // The gate, then the argmax (ties to the lowest index).
        float best = -INFINITY;
        int at = -1;
        for (int p = lane; p < pad; p += 32) {
          const float sc = __ldcg(&g.gate[(size_t)b * 2 * kGate + p]);
          const float ls = __ldcg(&g.gate[((size_t)b * 2 + 1) * kGate + p]);
          const float gated = ls >= g.min_low_score ? sc : -INFINITY;
          if (at < 0 || gated > best) {
            best = gated;
            at = p;
          }
        }
        warp_argmax(best, at);
        if (lane == 0) {
          const int4 c = __ldcg(&kept[at]);
          const float* t0 = g.translation + (size_t)b * 3;
          float q[4];
          multiply(g.yaw_q + ((size_t)b * g.angles + c.x) * 4, g.q_init + (size_t)b * 4, q);
          const float norm = sqrtf(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3]);
          float* row = g.out + (size_t)b * 12;
          row[0] = best > g.min_score ? 1.0f : 0.0f;
          row[1] = best;
          row[2] = t0[0] + (float)c.y * g.resolution;
          row[3] = t0[1] + (float)c.z * g.resolution;
          row[4] = t0[2] + (float)c.w * g.resolution;
          for (int d = 0; d < 4; ++d) row[5 + d] = q[d] / norm;
          row[9] = g.rot[(size_t)b * g.angles + c.x];
          row[10] = __ldcg(&g.gate[((size_t)b * 2 + 1) * kGate + at]);
          row[11] = (best >= dropped || dropped <= g.min_score) ? 1.0f : 0.0f;
        }
      }
      __syncthreads();
    }
    if (t < top) grid_sync(g.barrier);
  }
  if (tm.blocks > 1) tm.cluster.sync();  // no block leaves while another may read its shared
}

inline int blocks_for(long long n, int threads) { return (int)((n + threads - 1) / threads); }

}  // namespace

// full: (frd, S, S, S), coarse: (depth - frd, S/2, S/2, S/2); scratch_a holds
// S^3 bytes and scratch_b (S/2)^3 when depth > frd.
extern "C" int bnb3d_stack(const void* log_odds, const void* known, int size, int depth,
                           int frd, float q_scale, float q_min, void* full, void* coarse,
                           void* scratch_a, void* scratch_b, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (frd < 1 || frd > depth || size % (1 << (depth - frd)) != 0)
    return (int)cudaErrorInvalidValue;
  const long long cells = (long long)size * size * size;
  uint8_t* f = (uint8_t*)full;
  quantize_kernel<<<blocks_for(cells, kStackThreads), kStackThreads, 0, st>>>(
      (const float*)log_odds, (const uint8_t*)known, cells, q_scale, q_min, f);
  for (int h = 1; h < frd; ++h)
    shift_max_kernel<<<blocks_for(cells, kStackThreads), kStackThreads, 0, st>>>(
        f + (h - 1) * cells, size, f + h * cells, size, size, 1 << (h - 1));
  const uint8_t* current = f + (frd - 1) * cells;
  int dim = size, cur = size;
  const int half_dim = size / 2;
  const long long coarse_cells = (long long)half_dim * half_dim * half_dim;
  uint8_t* a = (uint8_t*)scratch_a;
  uint8_t* b = (uint8_t*)scratch_b;
  for (int j = 0; j < depth - frd; ++j) {
    long long n = (long long)cur * cur * cur;
    shift_max_kernel<<<blocks_for(n, kStackThreads), kStackThreads, 0, st>>>(
        current, dim, a, cur, cur, 1 << (frd - 1));
    int next = cur / 2;
    halve_kernel<<<blocks_for((long long)next * next * next, kStackThreads), kStackThreads, 0,
                   st>>>(a, cur, b, next);
    uint8_t* out = (uint8_t*)coarse + j * coarse_cells;
    shift_max_kernel<<<blocks_for(coarse_cells, kStackThreads), kStackThreads, 0, st>>>(
        b, next, out, half_dim, next, 1);
    current = out;
    dim = half_dim;
    cur = next;
  }
  return (int)cudaGetLastError();
}


// K15: the searches of `pairs` pairs. `levels` is a host array of 5 device
// pointers a pair (the stack's full and coarse levels, the low grid's
// probabilities, the grid's and the low grid's origins) and `dims` of 4
// ints a pair (S, Sl, nxy, nz); on the device, per pair: `points` (n, 3)
// and `low_points` (nl, 3) float32 with their uint8 masks, `yaw_q` (angles,
// 4), `q_init` (4,), `translation` (3,), `alive` (angles,) uint8 and `rot`
// (angles,). The scratch: `cells` (pairs, angles,
// n) and `low_cells` (pairs, angles, nl) 16-byte cells, `counts` (pairs, 2)
// ints, `items` (pairs, 2, mmax) 8-byte items with mmax at least every
// pair's top-level count and 8 beam, `parents` (pairs, 2, pstride) 16-byte
// entries with pstride >= max(beam, 64), `dropped` (pairs,) and `gate`
// (pairs, 2, 64) floats, `barrier` 2 words; `out` (pairs, 12). n and nl are
// powers of two.
extern "C" int bnb3d_descent(const void* const* levels, const int* dims, int pairs, int depth,
                             int frd, int beam, int angles, int n, int nl, const void* points,
                             const void* mask, const void* low_points, const void* low_mask,
                             const void* yaw_q, const void* q_init, const void* translation,
                             const void* alive, const void* rot,
                             float resolution, float low_resolution, float ratio, float min_score,
                             float min_low_score, float q_scale, float q_min, void* cells,
                             void* low_cells, void* counts, void* items, long long mmax,
                             void* parents, int pstride, void* dropped, void* gate,
                             void* barrier, void* out, void* stream) {
  if (n < 1 || (n & (n - 1)) != 0 || nl < 1 || (nl & (nl - 1)) != 0 || depth < 1 || frd < 1 ||
      frd > depth || beam < 1 || angles < 1 || pairs < 0 || pstride < kGate || pstride < beam)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // clusters[k]: the co-resident clusters of 2^k blocks on the configured device.
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
    // above what the card holds in clusters of 2 (K7's rule).
    int k = count == 1 ? 2 : 1;
    while (k > 0 && clusters[k] < count) --k;
    Pairs table = {};
    for (int b = 0; b < count; ++b) {
      const void* const* l = levels + (size_t)(b0 + b) * 5;
      const int* d = dims + (size_t)(b0 + b) * 4;
      table.p[b] = Pair{(const uint8_t*)l[0], (const uint8_t*)l[1], (const float*)l[2],
                        (const float*)l[3], (const float*)l[4], d[0], d[1], d[2], d[3]};
    }
    Args g;
    g.points = (const float*)points + (size_t)b0 * n * 3;
    g.mask = (const uint8_t*)mask + (size_t)b0 * n;
    g.low_points = (const float*)low_points + (size_t)b0 * nl * 3;
    g.low_mask = (const uint8_t*)low_mask + (size_t)b0 * nl;
    g.yaw_q = (const float*)yaw_q + (size_t)b0 * angles * 4;
    g.q_init = (const float*)q_init + (size_t)b0 * 4;
    g.translation = (const float*)translation + (size_t)b0 * 3;
    g.alive = (const uint8_t*)alive + (size_t)b0 * angles;
    g.rot = (const float*)rot + (size_t)b0 * angles;
    g.pairs = count;
    g.depth = depth;
    g.frd = frd;
    g.beam = beam;
    g.angles = angles;
    g.n = n;
    g.nl = nl;
    g.resolution = resolution;
    g.low_resolution = low_resolution;
    g.ratio = ratio;
    g.min_score = min_score;
    g.min_low_score = min_low_score;
    g.q_scale = q_scale;
    g.q_min = q_min;
    g.cells = (int4*)cells + (size_t)b0 * angles * n;
    g.low_cells = (int4*)low_cells + (size_t)b0 * angles * nl;
    g.counts = (int*)counts + (size_t)b0 * 2;
    g.items = (uint2*)items + (size_t)b0 * 2 * mmax;
    g.mmax = mmax;
    g.parents = (int4*)parents + (size_t)b0 * 2 * pstride;
    g.pstride = pstride;
    g.dropped = (float*)dropped + b0;
    g.gate = (float*)gate + (size_t)b0 * 2 * kGate;
    g.barrier = (unsigned int*)barrier;
    g.out = (float*)out + (size_t)b0 * 12;
    err = launch_descent(descent_kernel, clusters[k], k, (unsigned int*)barrier, st, table, g);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
