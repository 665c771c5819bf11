// K14 bnb3d_stack; K15 bnb3d_discretize and bnb3d_score
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
// K15 replaces: the scorer _score_level (l.152) of the beam search
// _beam_candidates_3d (l.182), the low-resolution gate _score_3d (l.724)
// of _match_tail (l.527), and the per-yaw discretization of
// fast_correlative_match_3d (l.503-514) and match_full_submap_3d
// (l.655-663).
// bnb3d_discretize: one thread per (yaw, point), the cell floor((q_yaw
// (q_init p) + t - origin) / res), each rotation written out as the twin's
// sequence of multiplies and adds (v + w (2 qv x v) + qv x (2 qv x v)).
// bnb3d_score: one warp per candidate (yaw a, offset ox, oy, oz): lane k
// takes the cell of point k at yaw a plus the offset, tests it against
// (-window, size) per axis, clips it into the grid and shifts it right by
// the level's reduction exponent; a uint8 level is dequantized to
// v * Q + 0.1, a float level read as is, a cell out of bounds reads 0.1;
// masked points give 0. The warp sums the point axis (a power of two) as a
// pairwise halving tree in shared memory, the plain twin's order, and
// divides by the valid count.
// Bound: bytes and latency. A level of the default search scores 16,384
// candidates x 256 points: 4 M byte gathers scattered over a 16 MB level
// (L2-resident) and the cells (107 yaws x 256 points x 12 B) read per
// candidate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kUnknown = 0.1f;
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxPoints = 1024;
constexpr int kThreads = 256;

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

__global__ void discretize_kernel(const float* __restrict__ points, int n,
                                  const float* __restrict__ yaw_q, int count,
                                  const float* __restrict__ q_init,
                                  const float* __restrict__ translation,
                                  const float* __restrict__ origin, float resolution,
                                  int* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)count * n) return;
  int a = (int)(i / n), k = (int)(i % n);
  float p[3] = {points[3 * k], points[3 * k + 1], points[3 * k + 2]};
  float r[3], w[3];
  rotate(q_init, p, r);
  rotate(yaw_q + 4 * a, r, w);
  for (int d = 0; d < 3; ++d)
    out[3 * i + d] = (int)floorf(((w[d] + translation[d]) - origin[d]) / resolution);
}

template <typename T>
__device__ inline float level_value(const T* level, long long idx, float q_scale, float q_min);

template <>
__device__ inline float level_value<uint8_t>(const uint8_t* level, long long idx, float q_scale,
                                             float q_min) {
  return (float)level[idx] * q_scale + q_min;
}

template <>
__device__ inline float level_value<float>(const float* level, long long idx, float, float) {
  return level[idx];
}

template <typename T>
__global__ void score_kernel(const T* __restrict__ level, int dim, int size, int re, int window,
                             const int* __restrict__ cells, int n,
                             const uint8_t* __restrict__ mask, const int* __restrict__ a_idx,
                             const int* __restrict__ ox, const int* __restrict__ oy,
                             const int* __restrict__ oz, int b, float q_scale, float q_min,
                             float unknown, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kWarpsPerBlock + warp;
  if (c >= b) return;  // whole warps leave together; no block-wide barrier below
  float* s = smem + warp * n;
  const int* base = cells + (size_t)a_idx[c] * n * 3;
  const int dx = ox[c], dy = oy[c], dz = oz[c];
  int count = 0;
  for (int k = lane; k < n; k += 32) {
    float v = 0.0f;
    if (mask[k]) {
      int cx = base[3 * k] + dx, cy = base[3 * k + 1] + dy, cz = base[3 * k + 2] + dz;
      bool inside = cx > -window && cx < size && cy > -window && cy < size && cz > -window &&
                    cz < size;
      if (inside) {
        long long gx = min(max(cx, 0), size - 1) >> re;
        long long gy = min(max(cy, 0), size - 1) >> re;
        long long gz = min(max(cz, 0), size - 1) >> re;
        v = level_value<T>(level, (gx * dim + gy) * dim + gz, q_scale, q_min);
      } else {
        v = unknown;
      }
      count += 1;
    }
    s[k] = v;
  }
  for (int off = 16; off > 0; off >>= 1) count += __shfl_xor_sync(0xffffffffu, count, off);
  __syncwarp();
  for (int h = n / 2; h >= 1; h >>= 1) {
    for (int k = lane; k < h; k += 32) s[k] = s[k] + s[k + h];
    __syncwarp();
  }
  if (lane == 0) out[c] = s[0] / (float)max(count, 1);
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
  quantize_kernel<<<blocks_for(cells, kThreads), kThreads, 0, st>>>(
      (const float*)log_odds, (const uint8_t*)known, cells, q_scale, q_min, f);
  for (int h = 1; h < frd; ++h)
    shift_max_kernel<<<blocks_for(cells, kThreads), kThreads, 0, st>>>(
        f + (h - 1) * cells, size, f + h * cells, size, size, 1 << (h - 1));
  const uint8_t* current = f + (frd - 1) * cells;
  int dim = size, cur = size;
  const int half_dim = size / 2;
  const long long coarse_cells = (long long)half_dim * half_dim * half_dim;
  uint8_t* a = (uint8_t*)scratch_a;
  uint8_t* b = (uint8_t*)scratch_b;
  for (int j = 0; j < depth - frd; ++j) {
    long long n = (long long)cur * cur * cur;
    shift_max_kernel<<<blocks_for(n, kThreads), kThreads, 0, st>>>(current, dim, a, cur, cur,
                                                                  1 << (frd - 1));
    int next = cur / 2;
    halve_kernel<<<blocks_for((long long)next * next * next, kThreads), kThreads, 0, st>>>(
        a, cur, b, next);
    uint8_t* out = (uint8_t*)coarse + j * coarse_cells;
    shift_max_kernel<<<blocks_for(coarse_cells, kThreads), kThreads, 0, st>>>(
        b, next, out, half_dim, next, 1);
    current = out;
    dim = half_dim;
    cur = next;
  }
  return (int)cudaGetLastError();
}

extern "C" int bnb3d_discretize(const void* points, int n, const void* yaw_q, int count,
                                const void* q_init, const void* translation,
                                const void* origin, float resolution, void* out,
                                void* stream) {
  long long total = (long long)count * n;
  discretize_kernel<<<blocks_for(total, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)points, n, (const float*)yaw_q, count, (const float*)q_init,
      (const float*)translation, (const float*)origin, resolution, (int*)out);
  return (int)cudaGetLastError();
}

// level: (dim, dim, dim), uint8 when is_u8 else float; cells (A, n, 3) int32.
extern "C" int bnb3d_score(const void* level, int is_u8, int dim, int size, int re, int window,
                           const void* cells, int n, const void* mask, const void* a_idx,
                           const void* ox, const void* oy, const void* oz, int b,
                           float q_scale, float q_min, float unknown, void* out,
                           void* stream) {
  if (n > kMaxPoints || (n & (n - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (b == 0) return (int)cudaGetLastError();
  int blocks = (b + kWarpsPerBlock - 1) / kWarpsPerBlock;
  size_t shared = (size_t)kWarpsPerBlock * n * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_u8)
    score_kernel<uint8_t><<<blocks, 32 * kWarpsPerBlock, shared, st>>>(
        (const uint8_t*)level, dim, size, re, window, (const int*)cells, n,
        (const uint8_t*)mask, (const int*)a_idx, (const int*)ox, (const int*)oy,
        (const int*)oz, b, q_scale, q_min, unknown, (float*)out);
  else
    score_kernel<float><<<blocks, 32 * kWarpsPerBlock, shared, st>>>(
        (const float*)level, dim, size, re, window, (const int*)cells, n,
        (const uint8_t*)mask, (const int*)a_idx, (const int*)ox, (const int*)oy,
        (const int*)oz, b, q_scale, q_min, unknown, (float*)out);
  return (int)cudaGetLastError();
}
