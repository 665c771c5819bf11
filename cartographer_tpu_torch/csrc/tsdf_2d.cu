// K20 tsdf_normals_2d and K21 tsdf_insert_2d
//
// K20 replaces: cartographer_tpu/ops/tsdf_2d.py:estimate_normals_2d (l.86).
// Each point's angle about the sensor origin, atan2 (masked points +inf),
// becomes a 64-bit key (order-preserving angle bits, point index), and the
// keys are sorted ascending by a bitonic network. The keys are distinct, so
// the order is the stable argsort's. Up to 8,192 points (the 2D scan
// capacity is 2,048) this is one launch, one block per robot: the block
// computes the keys into shared memory, sorts them in registers (steps
// between a thread's own keys in registers, steps within a warp by
// shuffles, only the steps across warps through shared memory behind a
// barrier: 8 keys a sorting thread, 256 sorting threads and 6 barriers at
// 2,048), keeps the sorted indices and the points in shared memory and
// computes the normals;
// the keys never touch device memory. Above, three launches: the keys into
// device memory, bitonic_sort.cuh over several blocks, the normals. A
// thread per sorted position then takes the 5 points at positions s - 2 ..
// s + 2 clipped to [0, N - 1] (not wrapped: the padding, sorted last, takes
// part at the end as in JAX), their mean, the 2x2 covariance of the centred
// points and its smallest eigenvector in closed form, flips it toward the
// origin and writes it at the point's own index. JAX takes the eigenvector
// from LAPACK's eigh: up to sign, which the flip fixes, the two agree where
// the two eigenvalues are apart; where they are nearly equal any unit vector
// is an eigenvector and the two may differ.
//
// K21 replaces: cartographer_tpu/ops/tsdf_2d.py:insert_range_data_tsdf
// (l.115), batched over the two active submaps as mapping/submap_2d.py's
// insert_body_cached (l.77). One item per (slot, sample k, point), in that
// flat order: the sample p - t_k d on the ray (d the unit ray, t_k the 16
// offsets of jnp.linspace(-truncation, truncation, 16) in its own float32
// arithmetic, computed here), its signed distance projected on the normal
// (or t_k) and clipped, and the weight range term x angle Gaussian x
// distance Gaussian, in JAX's order of operations with -fmad=false. An item
// adds w and w x sdf to its slot's cell; in_order_scatter.cuh adds each
// cell's items in input order, the order of the JAX scatter-add over
// w.reshape(-1) and of the twin's index_add_in_order_, and then in the same
// thread applies the running weighted average (old_w tsd + sum w sdf) /
// (old_w + sum w) and the weight clamped at max_weight, writing the cell
// once. No atomics: the grids equal the twin's bit for bit and a run
// repeats. The item's payload is its index; the walk recomputes its two
// addends from it (a few dozen flops), so an item stays 8 bytes. Cells this
// scan does not touch keep their values; JAX recomputes every cell, which
// re-rounds (w tsd) / w of an untouched cell by at most an ulp. The items
// read do_insert and the active flags from device memory, so the caller
// never waits. A call whose items take more than one launch of the routine
// (above 4,096 returns into two slots) must not average a cell once per
// launch: the average rounds, and the weight clamps, in between. There each
// launch adds its items to the cell's running sums (sum w, sum w sdf) in a
// zeroed scratch of two floats per cell, continuing the same in-order sums,
// and one pass over the cells then applies the average to every cell whose
// sum of weights is positive (the touched ones).
//
// Robots: the JAX package's _batched_step_cached vmaps the TSDF insertion
// over robots (mapping/local_trajectory_builder_2d.py:191). K20 takes R
// robots' scans in one call: a block per robot up to 8,192 points; above,
// blockIdx.y is the robot of the key and normal passes, and the keys of
// each robot sort on their own, side by side in the launches of one
// robot's sort (bitonic::sort_segments).
// K21 takes R robots' active windows: each robot's items are a cluster of
// their own along blockIdx.y (in_order_scatter.cuh's groups), its chunk
// order and so each cell's input order unchanged, so a robot's grids equal
// those of its own launch bit for bit. Each robot's grids stay where its
// submaps keep them, reached through a pointer table in the launch's
// parameters (kMaxRobots rows, as K4's); above kMaxRobots robots the entry
// point launches once per kMaxRobots. The scans, masks, normals, origins,
// active flags and do_insert are robot 0's plus the robot times a robot
// stride in elements. A one-robot call instantiates the one-robot bodies
// (robot index 0), at their former cost.
//
// Bound: K20 by latency (a sort of 2,048 keys in one block: 66 steps of
// the network, 6 of them behind a barrier, on one SM a robot); its bytes
// are 17 B per point. K21 by bytes:
// it reads the N points, masks and normals and reads and writes the tsd
// and weight of the cells the scan touches, and its 32 N samples are a few
// hundred thousand flops; the radix passes' barriers make it latency-bound.
// Up to 4,096 returns into two slots (the default 2,048: 2 x 16 x 2,048
// samples, one launch of a cluster of 16 blocks) the grids are never swept
// and there is no scratch; above, the running sums take 8 bytes per cell
// and the apply pass sweeps them once.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bitonic_sort.cuh"
#include "in_order_scatter.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSamples = 16;  // insert_range_data_tsdf's samples_per_ray
constexpr int kHalfWindow = 2;  // max(1, num_samples // 2) with num_samples = 4
constexpr int kMaxRobots = 64;  // K21's robots per launch: the pointer table's rows

// K20's robot strides of points, mask and origin, in elements.
struct NormalStrides {
  long long points, mask, origin;
};

__device__ inline uint32_t ordered_bits(float f) {
  uint32_t b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// kRobots: a launch for several robots (blockIdx.y); one robot's launch
// instantiates the same bodies with r = 0.
template <bool kRobots>
__global__ void angle_keys_kernel(const float* __restrict__ points,
                                  const uint8_t* __restrict__ mask,
                                  const float* __restrict__ origin, int n, int npad,
                                  NormalStrides rs, unsigned long long* __restrict__ keys) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npad) return;
  const long long r = kRobots ? blockIdx.y : 0;
  points += r * rs.points;
  mask += r * rs.mask;
  origin += r * rs.origin;
  keys += r * npad;
  uint32_t hi = 0xFFFFFFFFu;  // the power-of-two padding sorts after every point
  if (i < n) {
    float a = INFINITY;
    if (mask[i]) {
      float rx = points[2 * i] - origin[0];
      float ry = points[2 * i + 1] - origin[1];
      a = atan2f(ry, rx) + 0.0f;  // -0 sorts with +0, as argsort compares them
    }
    hi = ordered_bits(a);
  }
  keys[i] = ((unsigned long long)hi << 32) | (unsigned int)i;
}

// The normal of the point whose window (sorted positions s - 2 .. s + 2,
// clipped) holds px, py; flipped toward (ox, oy).
__device__ inline void window_normal(const float (&px)[2 * kHalfWindow + 1],
                                     const float (&py)[2 * kHalfWindow + 1], float ox, float oy,
                                     float* out_x, float* out_y) {
  const int k = 2 * kHalfWindow + 1;
  float mx = 0.0f, my = 0.0f;
  for (int q = 0; q < k; ++q) {
    mx = mx + px[q];
    my = my + py[q];
  }
  mx = mx / (float)k;
  my = my / (float)k;
  float a = 0.0f, b = 0.0f, c = 0.0f;
  for (int q = 0; q < k; ++q) {
    float cx = px[q] - mx, cy = py[q] - my;
    a = a + cx * cx;
    b = b + cx * cy;
    c = c + cy * cy;
  }
  // Smallest eigenvector of [[a, b], [b, c]]: of the two forms (b, l - a)
  // and (l - c, b), the longer; (1, 0) where the matrix is a multiple of I.
  float t = 0.5f * (a - c);
  float lam = 0.5f * (a + c) - sqrtf(t * t + b * b);
  float v1x = b, v1y = lam - a, v2x = lam - c, v2y = b;
  float n1 = v1x * v1x + v1y * v1y, n2 = v2x * v2x + v2y * v2y;
  float nx = 1.0f, ny = 0.0f;
  if (n1 >= n2 && n1 > 0.0f) {
    float r = sqrtf(n1);
    nx = v1x / r;
    ny = v1y / r;
  } else if (n2 > 0.0f) {
    float r = sqrtf(n2);
    nx = v2x / r;
    ny = v2y / r;
  }
  const float sx = px[kHalfWindow], sy = py[kHalfWindow];
  float dot = nx * (ox - sx) + ny * (oy - sy);
  if (dot < 0.0f) {
    nx = -nx;
    ny = -ny;
  }
  *out_x = nx;
  *out_y = ny;
}

template <bool kRobots>
__global__ void normals_kernel(const float* __restrict__ points,
                               const float* __restrict__ origin, int n, int npad,
                               NormalStrides rs, const unsigned long long* __restrict__ keys,
                               float* __restrict__ normals) {
  int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  const long long r = kRobots ? blockIdx.y : 0;
  points += r * rs.points;
  origin += r * rs.origin;
  keys += r * npad;
  normals += r * 2LL * n;
  float px[2 * kHalfWindow + 1], py[2 * kHalfWindow + 1];
  for (int d = -kHalfWindow; d <= kHalfWindow; ++d) {
    int pos = min(max(s + d, 0), n - 1);
    int idx = (int)(keys[pos] & 0xFFFFFFFFull);
    px[d + kHalfWindow] = points[2 * idx];
    py[d + kHalfWindow] = points[2 * idx + 1];
  }
  float nx, ny;
  window_normal(px, py, origin[0], origin[1], &nx, &ny);
  int idx = (int)(keys[s] & 0xFFFFFFFFull);
  normals[2 * idx] = nx;
  normals[2 * idx + 1] = ny;
}

// K20 in one launch, one block per robot (blockIdx.x), up to
// kOneBlockKeys keys. Every thread computes keys into shared memory; then
// npad / kE threads sort them, kE consecutive keys a thread in registers
// (key e of sorting thread t at position t * kE + e): the steps of the
// bitonic network with j < kE pair two of a thread's registers, those with
// j < 32 kE two lanes of a warp (shuffles), and only the longer ones go
// through shared memory (two buffers, one barrier of the sorting threads a
// step: 6 at 2,048 keys). The sorted keys' indices and the points then stay
// in shared memory, and every thread computes normals.
constexpr int kOneBlockKeys = bitonic::kSortTile;  // 8,192: 192 KB of shared memory
constexpr int kOneBlockThreads = 1024;

__device__ inline unsigned long long shfl_xor64(unsigned long long v, int lane_mask) {
  const unsigned int lo = __shfl_xor_sync(0xFFFFFFFFu, (unsigned int)v, lane_mask);
  const unsigned int hi = __shfl_xor_sync(0xFFFFFFFFu, (unsigned int)(v >> 32), lane_mask);
  return ((unsigned long long)hi << 32) | lo;
}

// The barrier of the first `count` threads (whole warps) of the block.
__device__ inline void sorters_sync(int count) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(count) : "memory");
}

template <int kE>
__global__ void __launch_bounds__(kOneBlockThreads)
    normals_one_block_kernel(const float* __restrict__ points, const uint8_t* __restrict__ mask,
                             const float* __restrict__ origin, int n, int npad,
                             NormalStrides rs, float* __restrict__ normals) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* buffers[2] = {reinterpret_cast<unsigned long long*>(smem),
                                    reinterpret_cast<unsigned long long*>(smem) + npad};
  float* sp = reinterpret_cast<float*>(buffers[1] + npad);  // the points, (n, 2)
  const long long r = blockIdx.x;
  points += r * rs.points;
  mask += r * rs.mask;
  origin += r * rs.origin;
  normals += r * 2LL * n;
  const int T = blockDim.x, tid = threadIdx.x, sorters = npad / kE;
  const float ox = origin[0], oy = origin[1];

  // The keys: order-preserving angle bits and the index; the power-of-two
  // padding sorts after every point.
  for (int i = tid; i < npad; i += T) {
    uint32_t hi = 0xFFFFFFFFu;
    if (i < n) {
      const float x = points[2 * i], y = points[2 * i + 1];
      sp[2 * i] = x;
      sp[2 * i + 1] = y;
      float a = INFINITY;
      if (mask[i]) {
        float rx = x - ox;
        float ry = y - oy;
        a = atan2f(ry, rx) + 0.0f;  // -0 sorts with +0, as argsort compares them
      }
      hi = ordered_bits(a);
    }
    buffers[0][i] = ((unsigned long long)hi << 32) | (unsigned int)i;
  }
  __syncthreads();

  // The network: stage k sorts runs of k keys, ascending where (i & k) == 0.
  // Buffer 0 holds the keys until every sorting thread has read its own.
  int which = 1;
  if (tid < sorters) {
    unsigned long long v[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) v[e] = buffers[0][tid * kE + e];
    for (int k = 2; k <= npad; k <<= 1) {
      for (int j = k >> 1; j >= 32 * kE; j >>= 1) {  // across warps
        unsigned long long* buf = buffers[which];
        which ^= 1;
        const int partner = tid ^ (j / kE);
#pragma unroll
        for (int e = 0; e < kE; ++e) buf[e * sorters + tid] = v[e];
        sorters_sync(sorters);
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const int i = tid * kE + e;
          const unsigned long long p = buf[e * sorters + partner];
          const bool keep_min = ((i & j) == 0) == ((i & k) == 0);
          v[e] = keep_min ? (p < v[e] ? p : v[e]) : (p > v[e] ? p : v[e]);
        }
      }
      for (int j = min(k >> 1, 16 * kE); j >= kE; j >>= 1) {  // within a warp
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const int i = tid * kE + e;
          const unsigned long long p = shfl_xor64(v[e], j / kE);
          const bool keep_min = ((i & j) == 0) == ((i & k) == 0);
          v[e] = keep_min ? (p < v[e] ? p : v[e]) : (p > v[e] ? p : v[e]);
        }
      }
#pragma unroll
      for (int j = kE / 2; j >= 1; j >>= 1) {  // within a thread
        if (j > (k >> 1)) continue;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const int g = e ^ j;
          if (g > e) {
            const bool ascending = ((tid * kE + e) & k) == 0;
            const unsigned long long a = v[e], b = v[g];
            if ((a > b) == ascending) {
              v[e] = b;
              v[g] = a;
            }
          }
        }
      }
    }
    // Each sorted position's point index, in the buffer the last exchange
    // did not read.
    int* order = reinterpret_cast<int*>(buffers[which]);
#pragma unroll
    for (int e = 0; e < kE; ++e) order[tid * kE + e] = (int)(v[e] & 0xFFFFFFFFull);
  }
  __syncthreads();
  // `which` is the same in every sorting thread; the others take it from
  // the sort's length: one exchange step per j >= 32 kE of every stage.
  int steps = 0;
  for (int k = 2; k <= npad; k <<= 1)
    for (int j = k >> 1; j >= 32 * kE; j >>= 1) ++steps;
  const int* order = reinterpret_cast<const int*>(buffers[(1 + steps) & 1]);
  for (int s = tid; s < n; s += T) {
    float px[2 * kHalfWindow + 1], py[2 * kHalfWindow + 1];
    for (int d = -kHalfWindow; d <= kHalfWindow; ++d) {
      const int idx = order[min(max(s + d, 0), n - 1)];
      px[d + kHalfWindow] = sp[2 * idx];
      py[d + kHalfWindow] = sp[2 * idx + 1];
    }
    float nx, ny;
    window_normal(px, py, ox, oy, &nx, &ny);
    const int idx = order[s];
    normals[2 * idx] = nx;
    normals[2 * idx + 1] = ny;
  }
}

template <int kE>
cudaError_t launch_one_block(const float* points, const uint8_t* mask, const float* origin,
                             int n, int npad, int robots, NormalStrides rs, float* normals,
                             cudaStream_t stream) {
  auto kernel = normals_one_block_kernel<kE>;
  const int bytes = 2 * kOneBlockKeys * 8 + kOneBlockKeys * 8;
  static int configured = -1;  // the device on which the kernel may take `bytes`
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && device != configured) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) configured = device;
  }
  if (err != cudaSuccess) return err;
  const int threads = npad < kOneBlockThreads ? npad : kOneBlockThreads;
  const size_t shared = (size_t)npad * 16 + (size_t)n * 8;
  kernel<<<robots, threads, shared, stream>>>(points, mask, origin, n, npad, rs, normals);
  return cudaGetLastError();
}

// K21's items for in_order_scatter: one per (slot, sample k, point).
struct TsdfSamples {
  const float* points;
  const uint8_t* mask;
  const float* normals;
  const float* origin;
  int n;
  const float* grid_origins;  // (slots, 2)
  float resolution;
  int size;
  float truncation;
  int range_exponent;
  float angle_denominator;     // 2 * bandwidth^2 rounded to float32
  float distance_denominator;  // the same for the distance Gaussian
  int project_to_normal;
  const uint8_t* active;
  const uint8_t* do_insert;
  float max_weight;
  float* tsd;     // (slots, size, size)
  float* weight;  // (slots, size, size)

  __device__ static float sample_offset(float truncation, int k) {
    if (k == kSamples - 1) return truncation;
    float h = (float)k / (float)(kSamples - 1);
    return -truncation * (1.0f - h) + truncation * h;
  }

  // Item `idx`'s weight and signed distance, and its cell (slot-major), or
  // kNone where it adds nothing.
  __device__ unsigned int sample(int idx, float& w, float& sdf) const {
    const int per_slot = kSamples * n;
    const int slot = idx / per_slot;
    const int rest = idx - slot * per_slot;
    const int k = rest / n;
    const int i = rest - k * n;
    if (!do_insert[0] || !active[slot] || !mask[i]) return in_order_scatter::kNone;
    float hx = points[2 * i], hy = points[2 * i + 1];
    float rx = hx - origin[0], ry = hy - origin[1];
    float len = fmaxf(sqrtf(rx * rx + ry * ry), 1e-6f);
    float dx = rx / len, dy = ry / len;
    float t = sample_offset(truncation, k);
    float sx = hx - t * dx, sy = hy - t * dy;
    float nx = normals[2 * i], ny = normals[2 * i + 1];
    sdf = project_to_normal ? (hx - sx) * (-nx) + (hy - sy) * (-ny) : t;
    sdf = fminf(fmaxf(sdf, -truncation), truncation);
    float w_range = range_exponent == 0 ? 1.0f : 1.0f / powf(len, (float)range_exponent);
    float cosine = fabsf(nx * (-dx) + ny * (-dy));
    float angle = acosf(fminf(fmaxf(cosine, -1.0f), 1.0f));
    float w_angle = expf(-(angle * angle) / angle_denominator);
    float w_dist = expf(-(t * t) / distance_denominator);
    w = (w_range * w_angle) * w_dist;
    if (!(w > 0.0f)) return in_order_scatter::kNone;  // adds nothing
    const float* g = grid_origins + 2 * slot;
    float ci = floorf((sx - g[0]) / resolution);
    float cj = floorf((sy - g[1]) / resolution);
    if (!(ci >= 0.0f && ci < (float)size && cj >= 0.0f && cj < (float)size))
      return in_order_scatter::kNone;
    return (unsigned int)(((long long)slot * size + (long long)ci) * size + (long long)cj);
  }

  __device__ unsigned int cell(int idx, unsigned int& payload) const {
    float w, sdf;
    payload = (unsigned int)idx;
    return sample(idx, w, sdf);
  }

  struct Acc {
    float old_w, old_t, ws, wt;
  };
  __device__ Acc load(unsigned int c) const { return {weight[c], tsd[c], 0.0f, 0.0f}; }
  __device__ void add(Acc& a, unsigned int idx) const {
    float w, sdf;
    sample((int)idx, w, sdf);
    a.ws = a.ws + w;
    a.wt = a.wt + w * sdf;
  }
  __device__ void store(unsigned int c, const Acc& a) const {
    update(c, a.old_w, a.old_t, a.ws, a.wt);
  }
  // The running weighted average of cell c from its sums, as the twin's.
  __device__ void update(unsigned int c, float old_w, float old_t, float ws, float wt) const {
    float new_w = old_w + ws;
    if (new_w > 0.0f) tsd[c] = (old_w * old_t + wt) / fmaxf(new_w, 1e-9f);
    weight[c] = fminf(new_w, max_weight);
  }
};

// The items of a call that takes several launches: each adds to the cells'
// running sums in `sums` (slots, size, size), and apply_sums_kernel updates
// the grids once after the last.
struct TsdfSums : TsdfSamples {
  float2* sums;

  __device__ Acc load(unsigned int c) const {
    const float2 p = sums[c];
    return {0.0f, 0.0f, p.x, p.y};
  }
  __device__ void store(unsigned int c, const Acc& a) const { sums[c] = make_float2(a.ws, a.wt); }
};

// K21's launch parameters for several robots: robot 0's samples and the
// shared options, the robot strides, and each robot's grids.
template <class Samples>
struct TsdfRobots {
  Samples first;
  long long points, mask, normals, origin, active, do_insert;  // robot strides, in elements
  long long cells;  // a robot's cells: the stride of the running sums
  const float* grid_origins[kMaxRobots];
  float* tsd[kMaxRobots];
  float* weight[kMaxRobots];
};

template <class Samples>
__device__ inline void offset_sums(Samples&, long long) {}
__device__ inline void offset_sums(TsdfSums& s, long long cells) { s.sums += cells; }

// Robot r's items (in_order_scatter.cuh's group r).
template <class Samples>
__device__ inline Samples source_of(const TsdfRobots<Samples>& p, unsigned int r) {
  Samples s = p.first;
  s.points += r * p.points;
  s.mask += r * p.mask;
  s.normals += r * p.normals;
  s.origin += r * p.origin;
  s.active += r * p.active;
  s.do_insert += r * p.do_insert;
  s.grid_origins = p.grid_origins[r];
  s.tsd = p.tsd[r];
  s.weight = p.weight[r];
  offset_sums(s, r * p.cells);
  return s;
}

// After a call's launches: every cell of robot blockIdx.y whose sum of
// weights is positive takes its running average from its sums.
__global__ void apply_sums_kernel(TsdfRobots<TsdfSums> p) {
  const long long r = blockIdx.y;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= p.cells) return;
  const float2 sums = p.first.sums[r * p.cells + c];
  if (!(sums.x > 0.0f)) return;
  TsdfSamples cell = p.first;
  cell.tsd = p.tsd[r];
  cell.weight = p.weight[r];
  cell.update((unsigned int)c, cell.weight[c], cell.tsd[c], sums.x, sums.y);
}

// The table of robots r0 .. r0 + count of a call: `first` robot r0's
// samples, `row` the robots' grid pointers.
template <class Samples>
inline TsdfRobots<Samples> robots_table(const Samples& first, const void* const* row, int count,
                                        const long long* st, long long cells) {
  TsdfRobots<Samples> p = {};
  p.first = first;
  p.points = st[0];
  p.mask = st[1];
  p.normals = st[2];
  p.origin = st[3];
  p.active = st[4];
  p.do_insert = st[5];
  p.cells = cells;
  for (int r = 0; r < count; ++r) {
    p.tsd[r] = (float*)row[3 * r];
    p.weight[r] = (float*)row[3 * r + 1];
    p.grid_origins[r] = (const float*)row[3 * r + 2];
  }
  return p;
}

// Inserts the `count` robots of table `p`; one robot launches its own
// Source (robot index 0).
template <class Samples>
inline cudaError_t insert_robots(const TsdfRobots<Samples>& p, int count, int items, int passes,
                                 cudaStream_t stream) {
  if (count == 1) return in_order_scatter::launch(p.first, items, passes, stream);
  return in_order_scatter::launch(p, items, passes, stream, count);
}

}  // namespace

// K20 for `robots` scans of n points: `normals` (robots, n, 2) out;
// `strides` (host memory) the robot strides of points, mask and origin.
// Up to kOneBlockKeys points one launch, a block per robot; above, `keys`
// (robots x next_pow2(n) int64 of scratch) takes the keys through three
// steps: the keys, bitonic::sort_segments (each robot's keys a run of their
// own, sorted side by side in the launches of one robot's sort) and the
// normals.
extern "C" int tsdf_normals_2d(const void* points, const void* mask, const void* origin, int n,
                               int robots, const void* strides, void* keys, void* normals,
                               void* stream) {
  if (robots < 1 || robots > 65535 || strides == nullptr) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int npad = 2;
  while (npad < n) npad <<= 1;
  const long long* st = (const long long*)strides;
  const NormalStrides rs = {st[0], st[1], st[2]};
  cudaStream_t stm = (cudaStream_t)stream;
  if (npad <= kOneBlockKeys) {
    if (npad < 64) npad = 64;  // a warp of sorting threads, 2 keys each
    const float* p = (const float*)points;
    const uint8_t* m = (const uint8_t*)mask;
    const float* o = (const float*)origin;
    float* out = (float*)normals;
    // 8 keys a sorting thread from 2,048 keys (fewer barriers); 2 below, where
    // 8 would leave too few warps to hide the shuffles' latency.
    if (npad >= 2048) return (int)launch_one_block<8>(p, m, o, n, npad, robots, rs, out, stm);
    return (int)launch_one_block<2>(p, m, o, n, npad, robots, rs, out, stm);
  }
  if (keys == nullptr) return (int)cudaErrorInvalidValue;
  unsigned long long* k = (unsigned long long*)keys;
  const dim3 key_grid((npad + kThreads - 1) / kThreads, robots);
  auto angle_keys = robots == 1 ? angle_keys_kernel<false> : angle_keys_kernel<true>;
  angle_keys<<<key_grid, kThreads, 0, stm>>>((const float*)points, (const uint8_t*)mask,
                                              (const float*)origin, n, npad, rs, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = bitonic::sort_segments(k, npad, robots, stm);
  if (err != cudaSuccess) return (int)err;
  const dim3 normal_grid((n + kThreads - 1) / kThreads, robots);
  auto normals_of = robots == 1 ? normals_kernel<false> : normals_kernel<true>;
  normals_of<<<normal_grid, kThreads, 0, stm>>>((const float*)points, (const float*)origin, n,
                                                 npad, rs, k, (float*)normals);
  return (int)cudaGetLastError();
}

// K21: inserts in place into each robot's `tsd` and `weight` (slots, size,
// size). `grids` (host memory): robots x (tsd, weight, grid origins (slots,
// 2)) device pointers; `strides` (host memory): the robot strides of
// points, mask, normals, origin, active and do_insert. `passes` radix
// passes of 8 bits cover one robot's cell indices. Where a robot's items
// take more than one launch (more than kChunk), `sums` holds robots x
// (slots, size, size) zeroed float pairs, the running sums; else it may be
// null.
extern "C" int tsdf_insert_2d(const void* const* grids, int robots, const void* points,
                              const void* mask, const void* normals, const void* origin, int n,
                              const void* strides, float resolution, int size, float truncation,
                              float max_weight, int range_exponent, float angle_denominator,
                              float distance_denominator, int project_to_normal,
                              const void* active, const void* do_insert, int slots, int passes,
                              void* sums, void* stream) {
  const long long cells = (long long)slots * size * size;
  const long long items = (long long)kSamples * n * slots;
  const bool chunked = items > (long long)in_order_scatter::kChunk;
  if (grids == nullptr || strides == nullptr || robots < 1 || n < 0 || size < 1 ||
      cells >= (long long)in_order_scatter::kNone || items > 0x7FFFFFFFll || passes < 1 ||
      (passes < 4 && cells > (1ll << (8 * passes))) || (chunked && sums == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long* st = (const long long*)strides;
  cudaStream_t stm = (cudaStream_t)stream;
  for (int r0 = 0; r0 < robots; r0 += kMaxRobots) {
    const int count = min(kMaxRobots, robots - r0);
    const void* const* row = grids + 3 * r0;
    TsdfSamples src{(const float*)points + r0 * st[0], (const uint8_t*)mask + r0 * st[1],
                    (const float*)normals + r0 * st[2], (const float*)origin + r0 * st[3], n,
                    (const float*)row[2], resolution, size, truncation, range_exponent,
                    angle_denominator, distance_denominator, project_to_normal,
                    (const uint8_t*)active + r0 * st[4], (const uint8_t*)do_insert + r0 * st[5],
                    max_weight, (float*)row[0], (float*)row[1]};
    cudaError_t err;
    if (!chunked) {
      err = insert_robots(robots_table(src, row, count, st, cells), count, (int)items, passes,
                          stm);
    } else {
      TsdfSums partial;
      (TsdfSamples&)partial = src;
      partial.sums = (float2*)sums + r0 * cells;
      const TsdfRobots<TsdfSums> table = robots_table(partial, row, count, st, cells);
      err = insert_robots(table, count, (int)items, passes, stm);
      if (err != cudaSuccess) return (int)err;
      const dim3 grid((unsigned)((cells + kThreads - 1) / kThreads), count);
      apply_sums_kernel<<<grid, kThreads, 0, stm>>>(table);
      err = cudaGetLastError();
    }
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
