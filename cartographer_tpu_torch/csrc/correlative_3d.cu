// K17 correlative_3d
//
// Replaces: cartographer_tpu/ops/scan_matcher_3d.py:real_time_correlative_match_3d
// (l.144), the 3D real-time correlative search (real_time_correlative_scan_matcher_3d.cc).
//
// Every candidate (x, y, z, rx, ry, rz) of a window around the initial pose
// is scored as the mean probability of the cells the rotated and shifted
// cloud falls in (unknown cells and cells outside the dense window count as
// 0.1) times the motion prior exp(-(|dt| w_t + |aa| w_r)^2), and the best is
// taken. The grid of A^3 rotations (A = 2 na + 1, static) is spaced by a
// per-scan angular step, (1 - 1e-3) acos(1 - r^2 / (2 R^2)) with R the
// cloud's largest masked range (at least 3 cells); the rotations with an
// angle beyond the window are skipped.
//
// One launch a call, on a grid sized from the SM count and the occupancy:
//   1. Every block takes the cloud's largest masked range and its number of
//      valid points (7 operations a point, order-free: a maximum and an
//      integer count), and from the range the per-scan step and the largest
//      angle index k still inside the window. The angles (m * step for
//      m = -na..na) grow with |m|, so the rotations inside the window are the
//      (2k + 1)^3 with every |m| <= k: at the defaults (a 1 degree window,
//      0.10 m cells, 60 m max_scan_range) 27 to 125 of the static 9,261.
//   2. A block takes a valid rotation at a time (a grid stride) and computes
//      its cells once, rotate(q_initial, rotate(q_r, p)) + t_initial over the
//      resolution (floor of a true division), into shared memory; an invalid
//      point's cell is a sentinel.
//   3. A warp scores the L translations (dx, dy, -nl..nl) of a column at a
//      time (L = 2 nl + 1 <= 5): lane l holds the points l + 32 k; a point's
//      column of L cells is consecutive in memory, so its log-odds and known
//      bytes come by two 16-byte and two 4-byte loads of the aligned words
//      that hold them through the read-only path (cell by cell at the
//      arrays' ends), issued for 2 points together; an invalid point adds
//      an exact 0.0 without a load. 25 warps a block: a rotation's 25
//      columns at the defaults in one round.
//      The probability is K11's. The lane visits its points in bit-reversed
//      order, so a stack of partial sums a row adds them in the plain twin's
//      halving order (x[i] + x[i + n / 2], from the padded count down to 32:
//      the points above the highest valid one are zeros, which add exactly,
//      so P = the power of two that holds its k leaves a lane), and
//      __shfl_down 16..1 finishes the tree: the sums keep the twin's bits
//      without a block barrier. A wider window, or valid points past 512,
//      take a translation at a time cell by cell, each leaf first folding the
//      points i + j * 512 in the tree's order (halving_fold.cuh).
//   4. The block's best (score bits, ~(r * L^3 + t)) key, r the static
//      rotation index, goes to one 64-bit atomicMax: scores are non-negative,
//      so their bits order as the scores, and of equal scores the lowest flat
//      index wins, as jnp.argmax per rotation and then across rotations gives
//      it. The last block to take a ticket decodes the winner into the score
//      and the pose [t_initial + offset, normalize(q_initial * q_r)] and
//      resets the key and the ticket for the next call.
// The cells stay in shared memory up to kSharedPoints points; above, each
// block keeps them in its slice of a device scratch (the grid capped at the
// scratch's blocks).
//
// Bound: operations. The range maximum reads the N points; each valid
// rotation transforms the valid points once and gathers their cells for
// every translation (125 x 125 x 512 = 8 M cells at most at the defaults, 5
// bytes each from a 256^3 window that mostly stays in L2).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "halving_fold.cuh"
#include "stamps.cuh"

namespace {

constexpr int kThreads = 800;  // 25 warps: a warp a column of the 5 x 5 of a rotation
constexpr int kWarps = kThreads / 32;
constexpr int kLeaves = 16;  // a lane's leaves: 512 padded points
constexpr int kColumn = 5;   // the column form's rows: a window of up to 5 cells an axis
constexpr int kBatch = 2;    // the columns whose loads a lane issues together
constexpr int kSharedPoints = 12288;  // cells in shared memory up to this cloud size
constexpr int kInvalid = INT_MIN;     // the cell of an invalid point

struct Grid {
  const float* log_odds;
  const uint8_t* known;
  const float* origin;  // (3,) world position of the corner of cell (0, 0, 0)
  float resolution;
  int size;
};

struct Search {
  int nl, na;
  float resolution_sq;  // float32(resolution^2)
  float min_range;      // float32(3 * resolution)
  float shrink;         // float32(1 - 1e-3)
  float window;         // float32(angular_search_window + 1e-6)
  float wt, wr;
};

// The call's best key and the blocks' ticket, zero between calls.
struct Sync {
  unsigned long long best;
  unsigned long long ticket;
};

// v + qw * t + cross(qv, t) with t = 2 cross(qv, v), one operation at a time.
__device__ inline void rotate(const float q[4], const float v[3], float out[3]) {
  float t0 = 2.0f * (q[2] * v[2] - q[3] * v[1]);
  float t1 = 2.0f * (q[3] * v[0] - q[1] * v[2]);
  float t2 = 2.0f * (q[1] * v[1] - q[2] * v[0]);
  out[0] = (v[0] + q[0] * t0) + (q[2] * t2 - q[3] * t1);
  out[1] = (v[1] + q[0] * t1) + (q[3] * t0 - q[1] * t2);
  out[2] = (v[2] + q[0] * t2) + (q[1] * t1 - q[2] * t0);
}

// quat.from_axis_angle with the Taylor branch below |aa|^2 = 1e-12; also |aa|.
__device__ inline float from_axis_angle(const float aa[3], float q[4]) {
  float angle_sq = (aa[0] * aa[0] + aa[1] * aa[1]) + aa[2] * aa[2];
  float angle = sqrtf(fmaxf(angle_sq, 1e-32f));
  float half = 0.5f * angle;
  bool small = angle_sq < 1e-12f;
  float k = small ? 0.5f - angle_sq / 48.0f : sinf(half) / angle;
  q[0] = small ? 1.0f - angle_sq / 8.0f : cosf(half);
  for (int a = 0; a < 3; ++a) q[a + 1] = k * aa[a];
  return sqrtf(angle_sq);
}

// The per-scan step, the valid points and the largest |m| inside the window.
struct Step {
  float step;
  int count;
  int k;
  int highest;  // the highest index of a valid point (-1: none)
};

__device__ Step scan_step(const float* __restrict__ points, const uint8_t* __restrict__ mask,
                          int n, const Search& s, float* largest, int* counts, int* highs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float r = 0.0f;
  int count = 0, high = -1;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if (!mask[i]) continue;
    float x = points[3 * i], y = points[3 * i + 1], z = points[3 * i + 2];
    r = fmaxf(r, sqrtf((x * x + y * y) + z * z));
    ++count;
    high = i;
  }
  for (int off = 16; off > 0; off >>= 1) {
    r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, off));
    count += __shfl_xor_sync(0xffffffffu, count, off);
    high = max(high, __shfl_xor_sync(0xffffffffu, high, off));
  }
  if (lane == 0) {
    largest[warp] = r;
    counts[warp] = count;
    highs[warp] = high;
  }
  __syncthreads();
  r = 0.0f;
  count = 0;
  for (int w = 0; w < kWarps; ++w) {
    r = fmaxf(r, largest[w]);
    count += counts[w];
    high = max(high, highs[w]);
  }
  float range = fmaxf(r, s.min_range);
  float step = s.shrink * acosf(1.0f - s.resolution_sq / (2.0f * (range * range)));
  int k = 0;
  while (k < s.na && fabsf((float)(k + 1) * step) <= s.window) ++k;
  return Step{step, count, k, high};
}

__host__ __device__ constexpr int log2_of(int p) { return p > 1 ? 1 + log2_of(p / 2) : 0; }

// The probability of a cell as K11 takes it from `known` and `log_odds`;
// 0.1 outside the window.
__device__ inline float probability(bool inside, unsigned int known, float log_odds) {
  return inside && known ? 1.0f / (1.0f + expf(-log_odds)) : 0.1f;
}

// The column of L <= kColumn cells (a + dx, b + dy, c - nl .. c + nl) of one
// point (a, b, c): its cells' log-odds and known bytes, loaded by two 16-byte
// and two 4-byte loads from the aligned words that hold them (a column's
// cells are consecutive), or cell by cell at the ends of the arrays.
struct Column {
  float w[8];           // log_odds[f0 .. f0 + 8)
  unsigned long long k; // known[f0 .. f0 + 8), byte j at bits 8 j
  int off;              // the column's first cell in w and in k
  int zlo, zhi;         // the rows inside the window: zlo <= j < zhi
  bool point;           // a valid point (else the column adds 0.0)
};

__device__ inline Column load_column(const Grid& g, const int* __restrict__ cells, int i, int n,
                                     int dx, int dy, int nl, int L, bool aligned) {
  Column c;
  c.point = false;
  c.zlo = c.zhi = 0;
  c.off = 0;
  c.k = 0;
  for (int j = 0; j < 8; ++j) c.w[j] = 0.0f;
  const int cx = i < n ? cells[3 * i] : kInvalid;
  if (cx == kInvalid) return c;
  c.point = true;
  const int a = cx + dx, b = cells[3 * i + 1] + dy, z0 = cells[3 * i + 2] - nl;
  if (a < 0 || a >= g.size || b < 0 || b >= g.size) return c;
  c.zlo = min(max(-z0, 0), L);
  c.zhi = max(min(g.size - z0, L), c.zlo);
  if (c.zlo == c.zhi) return c;
  const long long base = ((long long)a * g.size + b) * g.size + z0;
  const long long f0 = base & ~3ll;
  if (aligned && f0 >= 0 && f0 + 8 <= (long long)g.size * g.size * g.size) {
    const float4* lo = reinterpret_cast<const float4*>(g.log_odds + f0);
    const float4 u = __ldg(lo), v = __ldg(lo + 1);
    c.w[0] = u.x; c.w[1] = u.y; c.w[2] = u.z; c.w[3] = u.w;
    c.w[4] = v.x; c.w[5] = v.y; c.w[6] = v.z; c.w[7] = v.w;
    const unsigned int* kn = reinterpret_cast<const unsigned int*>(g.known + f0);
    c.k = (unsigned long long)__ldg(kn) | ((unsigned long long)__ldg(kn + 1) << 32);
    c.off = (int)(base - f0);
  } else {
#pragma unroll
    for (int j = 0; j < kColumn; ++j) {
      if (j >= c.zlo && j < c.zhi) {
        c.w[j] = g.log_odds[base + j];
        c.k |= (unsigned long long)g.known[base + j] << (8 * j);
      }
    }
  }
  return c;
}

// Row j's probability of the column (0.0 without a point).
__device__ inline float column_value(const Column& c, int j) {
  if (!c.point) return 0.0f;
  const float lo = c.off == 0 ? c.w[j] : c.off == 1 ? c.w[j + 1] : c.off == 2 ? c.w[j + 2]
                                                                              : c.w[j + 3];
  const unsigned int known = (unsigned int)(c.k >> (8 * (c.off + j))) & 0xffu;
  return probability(j >= c.zlo && j < c.zhi, known, lo);
}

// Lane 0's halving-tree sums of the L rows (dx, dy, -nl .. nl) over the
// points 0 .. 32 P (P a power of two <= kLeaves; every valid point lies
// below): lane l holds the points l + 32 k, k < P, visited in bit-reversed
// order so that a stack of log2(P) + 1 partial sums a row pairs them as
// x[i] + x[i + n / 2] does; __shfl_down 16..1 finishes each tree. The loads
// of kBatch columns are issued together.
template <int P>
__device__ inline void column_sums(const Grid& g, const int* __restrict__ cells, int n, int dx,
                                   int dy, int nl, int L, bool aligned, float sums[kColumn]) {
  constexpr int kBits = log2_of(P);
  constexpr int kDepth = kBits + 1;
  const int lane = threadIdx.x & 31;
  float stack[kDepth][kColumn];
  int depth = 0;
#pragma unroll
  for (int i0 = 0; i0 < P; i0 += kBatch) {
    Column col[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b;
      const int k = kBits ? (int)(__brev((unsigned int)i) >> (32 - kBits)) : 0;
      if (i < P) col[b] = load_column(g, cells, lane + 32 * k, n, dx, dy, nl, L, aligned);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b;
      if (i >= P) break;
      float v[kColumn];
#pragma unroll
      for (int j = 0; j < kColumn; ++j) v[j] = column_value(col[b], j);
#pragma unroll
      for (int t = i; t & 1; t >>= 1) {
        --depth;
#pragma unroll
        for (int j = 0; j < kColumn; ++j) v[j] = stack[depth][j] + v[j];
      }
#pragma unroll
      for (int j = 0; j < kColumn; ++j) stack[depth][j] = v[j];
      ++depth;
    }
  }
#pragma unroll
  for (int j = 0; j < kColumn; ++j) {
    float a = stack[0][j];
    for (int off = 16; off > 0; off >>= 1) a = a + __shfl_down_sync(0xffffffffu, a, off);
    sums[j] = a;
  }
}

// Lane 0's halving-tree sum of the translation d's probabilities over the
// padded points (kLeaves * 32 * m of them), cell by cell: the form for
// windows of more than kColumn cells an axis and for clouds whose valid
// points reach past 512. Each of a lane's kLeaves leaves first folds the
// points i + j * 512 in the tree's order (halving_fold.cuh).
__device__ float row_sum(const Grid& g, const int* __restrict__ cells, int n, int m,
                         const int d[3]) {
  const int lane = threadIdx.x & 31;
  float v[kLeaves];
#pragma unroll
  for (int k = 0; k < kLeaves; ++k) {
    v[k] = halving::fold(m, [&](int j) {
      const int i = lane + 32 * (k + kLeaves * j);
      const int cx = i < n ? cells[3 * i] : kInvalid;
      if (cx == kInvalid) return 0.0f;
      const int c[3] = {cx + d[0], cells[3 * i + 1] + d[1], cells[3 * i + 2] + d[2]};
      const bool inside = c[0] >= 0 && c[0] < g.size && c[1] >= 0 && c[1] < g.size &&
                          c[2] >= 0 && c[2] < g.size;
      const size_t index =
          inside ? (size_t)(c[0] * g.size + c[1]) * (size_t)g.size + (size_t)c[2] : 0;
      return probability(inside, inside ? g.known[index] : 0u,
                         inside ? g.log_odds[index] : 0.0f);
    });
  }
#pragma unroll
  for (int half = kLeaves / 2; half > 0; half >>= 1) {
#pragma unroll
    for (int k = 0; k < half; ++k) v[k] = v[k] + v[k + half];
  }
  float a = v[0];
  for (int off = 16; off > 0; off >>= 1) a = a + __shfl_down_sync(0xffffffffu, a, off);
  return a;
}

__global__ void __launch_bounds__(kThreads)
    correlative_kernel(Grid g, const float* __restrict__ points, const uint8_t* __restrict__ mask,
                       int n, int m, const float* __restrict__ x0, Search s,
                       int* __restrict__ scratch, Sync* __restrict__ sync,
                       float* __restrict__ x_out, float* __restrict__ score_out,
                       unsigned long long* __restrict__ key_out) {
  extern __shared__ int shared_cells[];
  __shared__ float largest[kWarps];
  __shared__ int counts[kWarps], highs[kWarps];
  __shared__ unsigned long long keys[kWarps];
  __shared__ bool last;
  int* cells = scratch ? scratch + (size_t)blockIdx.x * 3 * n : shared_cells;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  STAMP(0);

  const Step st = scan_step(points, mask, n, s, largest, counts, highs);
  const int A = 2 * s.na + 1, V = 2 * st.k + 1;
  const int L = 2 * s.nl + 1, T = L * L * L;
  const float num = (float)max(st.count, 1);
  const float q0[4] = {x0[3], x0[4], x0[5], x0[6]};
  // The column form while the window is at most kColumn cells an axis and
  // every valid point lies below 512: P leaves a lane, P the power of two
  // that holds the highest valid point's (the leaves above add zeros).
  int P = 1;
  while (32 * P <= st.highest) P *= 2;
  const bool by_columns = L <= kColumn && P <= kLeaves;
  const bool aligned = ((uintptr_t)g.log_odds & 15) == 0 && ((uintptr_t)g.known & 3) == 0;
  unsigned long long best = 0;
  STAMP(1);
  for (int v = blockIdx.x; v < V * V * V; v += gridDim.x) {
    const int mi[3] = {v / (V * V) - st.k, (v / V) % V - st.k, v % V - st.k};
    const int r = ((mi[0] + s.na) * A + (mi[1] + s.na)) * A + (mi[2] + s.na);
    float aa[3], q[4];
    for (int a = 0; a < 3; ++a) aa[a] = (float)mi[a] * st.step;
    const float angle = from_axis_angle(aa, q);
    __syncthreads();  // the previous rotation's rows are done with the cells
    for (int i = threadIdx.x; i < n; i += kThreads) {
      if (!mask[i]) {
        cells[3 * i] = kInvalid;
        continue;
      }
      float p[3] = {points[3 * i], points[3 * i + 1], points[3 * i + 2]};
      float a[3], b[3];
      rotate(q, p, a);
      rotate(q0, a, b);
      for (int c = 0; c < 3; ++c)
        cells[3 * i + c] = (int)floorf(((b[c] + x0[c]) - g.origin[c]) / g.resolution);
    }
    __syncthreads();
    if (v == blockIdx.x) STAMP(2);
    // Lane 0 keeps the best key of the translations d = (t / L^2, t / L % L,
    // t % L) - nl it scores.
    auto consider = [&](int t, float sum) {
      const int d[3] = {t / (L * L) - s.nl, (t / L) % L - s.nl, t % L - s.nl};
      float raw = sum / num;
      float lx = (float)d[0] * g.resolution;
      float ly = (float)d[1] * g.resolution;
      float lz = (float)d[2] * g.resolution;
      float dist = sqrtf((lx * lx + ly * ly) + lz * lz);
      float w = dist * s.wt + angle * s.wr;
      float score = raw * expf(-(w * w));
      unsigned int flat = (unsigned int)r * (unsigned int)T + (unsigned int)t;
      unsigned long long key = ((unsigned long long)__float_as_uint(score) << 32) |
                               (unsigned long long)(~flat);
      best = key > best ? key : best;
    };
    if (by_columns) {
      for (int task = warp; task < L * L; task += kWarps) {
        const int dx = task / L - s.nl, dy = task % L - s.nl;
        float sums[kColumn];
        switch (P) {
          case 1: column_sums<1>(g, cells, n, dx, dy, s.nl, L, aligned, sums); break;
          case 2: column_sums<2>(g, cells, n, dx, dy, s.nl, L, aligned, sums); break;
          case 4: column_sums<4>(g, cells, n, dx, dy, s.nl, L, aligned, sums); break;
          case 8: column_sums<8>(g, cells, n, dx, dy, s.nl, L, aligned, sums); break;
          default: column_sums<16>(g, cells, n, dx, dy, s.nl, L, aligned, sums); break;
        }
        if (lane == 0) {
#pragma unroll
          for (int j = 0; j < kColumn; ++j)
            if (j < L) consider(task * L + j, sums[j]);
        }
      }
    } else {
      for (int t = warp; t < T; t += kWarps) {
        const int d[3] = {t / (L * L) - s.nl, (t / L) % L - s.nl, t % L - s.nl};
        const float sum = row_sum(g, cells, n, m, d);
        if (lane == 0) consider(t, sum);
      }
    }
    if (v == blockIdx.x) STAMP(3);
  }

  // The block's best, one atomicMax; the last block's ticket decodes.
  if (lane == 0) keys[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) best = keys[w] > best ? keys[w] : best;
    if (best) atomicMax(&sync->best, best);
    __threadfence();
    last = atomicAdd(&sync->ticket, 1ull) == (unsigned long long)(gridDim.x - 1);
  }
  __syncthreads();
  STAMP(4);
  if (!last || threadIdx.x != 0) return;
  __threadfence();
  const unsigned long long key = atomicAdd(&sync->best, 0ull);
  sync->best = 0;
  sync->ticket = 0;
  const unsigned int flat = ~(unsigned int)(key & 0xFFFFFFFFull);
  const int r = (int)(flat / (unsigned int)T), t = (int)(flat % (unsigned int)T);
  const int idx[3] = {r / (A * A), (r / A) % A, r % A};
  float aa[3], q[4];
  for (int a = 0; a < 3; ++a) aa[a] = (float)(idx[a] - s.na) * st.step;
  from_axis_angle(aa, q);
  float mq[4] = {q0[0] * q[0] - q0[1] * q[1] - q0[2] * q[2] - q0[3] * q[3],
                 q0[0] * q[1] + q0[1] * q[0] + q0[2] * q[3] - q0[3] * q[2],
                 q0[0] * q[2] - q0[1] * q[3] + q0[2] * q[0] + q0[3] * q[1],
                 q0[0] * q[3] + q0[1] * q[2] - q0[2] * q[1] + q0[3] * q[0]};
  float norm = sqrtf(((mq[0] * mq[0] + mq[1] * mq[1]) + mq[2] * mq[2]) + mq[3] * mq[3]);
  int off[3] = {t / (L * L) - s.nl, (t / L) % L - s.nl, t % L - s.nl};
  for (int a = 0; a < 3; ++a) x_out[a] = x0[a] + (float)off[a] * g.resolution;
  for (int a = 0; a < 4; ++a) x_out[3 + a] = mq[a] / norm;
  score_out[0] = __uint_as_float((unsigned int)(key >> 32));
  key_out[0] = key;
  STAMP_IF(true, 5);
}

// The SM count and the blocks an SM holds at `smem` bytes of shared memory,
// kept for the last device and size asked (host calls of some microseconds).
cudaError_t occupancy(size_t smem, int* sms, int* per_sm) {
  static std::mutex lock;
  static int device_seen = -1, sms_seen = 0, per_sm_seen = 0;
  static size_t smem_seen = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(lock);
  if (device != device_seen || smem != smem_seen) {
    err = cudaDeviceGetAttribute(&sms_seen, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm_seen, correlative_kernel,
                                                          kThreads, smem);
    if (err != cudaSuccess) {
      device_seen = -1;
      return err;
    }
    device_seen = device;
    smem_seen = smem;
  }
  *sms = sms_seen;
  *per_sm = per_sm_seen > 0 ? per_sm_seen : 1;
  return cudaSuccess;
}

}  // namespace

// `sync` holds two zero 64-bit words that each call leaves zero (the best key
// and the blocks' ticket; calls on one stream at a time); above kSharedPoints
// points `cells` holds cell_blocks * 3 * n int32 of scratch and the grid has
// at most cell_blocks blocks (null and 0 below); `x_out` the best pose
// [t, q] (7,), `score_out` its score and `key_out` its key (score bits,
// ~flat index).
extern "C" int correlative_3d(const void* log_odds, const void* known, const void* origin,
                              float resolution, int size, const void* points, const void* mask,
                              int n, int npad, const void* x0, int nl, int na,
                              float resolution_sq, float min_range, float shrink,
                              float window, float translation_weight, float rotation_weight,
                              void* sync, void* cells, int cell_blocks, void* x_out,
                              void* score_out, void* key_out, void* stream) {
  const bool large = n > kSharedPoints;
  if (n <= 0 || npad < n || (npad & (npad - 1)) || (large && (cells == nullptr || cell_blocks < 1)))
    return (int)cudaErrorInvalidValue;
  Grid g{(const float*)log_odds, (const uint8_t*)known, (const float*)origin, resolution, size};
  Search s{nl, na, resolution_sq, min_range, shrink, window, translation_weight,
           rotation_weight};
  const int m = npad > 32 * kLeaves ? npad / (32 * kLeaves) : 1;  // leaves a lane folds
  const size_t smem = large ? 0 : (size_t)3 * n * sizeof(int);
  if (smem > 40 * 1024) {  // with the static shared memory, above the default 48 KB
    cudaError_t err = cudaFuncSetAttribute(
        correlative_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 3 * kSharedPoints * 4);
    if (err != cudaSuccess) return (int)err;
  }
  // The grid: every block the SMs hold at once, no more than the rotations.
  int sms = 0, per_sm = 0;
  cudaError_t err = occupancy(smem, &sms, &per_sm);
  if (err != cudaSuccess) return (int)err;
  const long long A = 2 * na + 1;
  long long blocks = (long long)sms * per_sm;
  if (blocks > A * A * A) blocks = A * A * A;
  if (large && blocks > cell_blocks) blocks = cell_blocks;
  correlative_kernel<<<(int)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      g, (const float*)points, (const uint8_t*)mask, n, m, (const float*)x0, s,
      large ? (int*)cells : nullptr, (Sync*)sync, (float*)x_out, (float*)score_out,
      (unsigned long long*)key_out);
  return (int)cudaGetLastError();
}
