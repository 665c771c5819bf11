// K5 correlative_2d
//
// Replaces: cartographer_tpu/ops/correlative_2d.py:real_time_correlative_match
// (l.138) in its gather form _scores_gather (l.82), with _angular_step (l.61)
// and _candidate_geometry (l.69).
//
// One block per candidate (angle a, shift ix, iy), in JAX's flat (a, ix, iy)
// order. Each block computes the data-dependent angular step from the
// largest range of the cloud (every block redoes this 512-point max; it is
// cheaper than a second launch), rotates and discretises the scan at its
// angle, reads the log-odds and known flag of each shifted cell and turns
// them into a probability on the fly (no probability image is built), and
// sums the masked points as a pairwise halving tree in shared memory, the
// order the plain twin uses. Above kMaxPoints padded points each thread first
// folds its k over the points k + j * kMaxPoints in that tree's order
// (halving_fold.cuh), so the shared array holds kMaxPoints floats for any
// cloud and the sum keeps its bits. Thread 0 applies the motion prior, writes the
// score and folds it into one 64-bit atomicMax over (order-preserving score
// bits, ~flat index): the maximum score wins and, among equal scores, the
// lowest flat index, which is jnp.argmax's tie-break. A one-thread launch
// decodes the winner into [score, x, y, theta] on the device, so the caller
// never waits.
//
// correlative_2d_tsdf is K5's TSDF form, on the score surface of a TSDF grid
// (JAX ops/tsdf_2d.py:TsdfGrid2D.correspondence_score, l.71, which the JAX
// search reads through grid.probability()): weight > 0 ? 1 - |tsd| /
// truncation : 0 in the map, UNKNOWN outside it, as the gather form pads.
// One template over the cell's surface serves both exported functions.
//
// Bound: operations and latency. At full width 421 x 5 x 5 candidates x 512
// points are 5.4 M gathers of 5 bytes from a 5 MB grid (L2-resident), a few
// microseconds of bytes; the blocks are short, so launch and tail effects
// dominate. Arithmetic follows the JAX order with -fmad=false.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "halving_fold.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPoints = 4096;  // the shared tile of the point sum

struct Params {
  const float* values;  // log-odds, or tsd (TSDF form)
  const void* flags;    // known (uint8), or weight (float32, TSDF form)
  float truncation;     // TSDF form only
  const float* origin;
  float resolution;
  int size;
  const float* points;
  const uint8_t* mask;
  int n;  // power of two, any size
  const float* init;
  int num_angles;
  int nl;
  float angle_limit;  // angular_search_window + 1e-6
  float tw, rw;       // prior weights
  float res_sq;       // resolution^2 rounded to float
  float min_range;    // 3 * resolution rounded to float
};

__device__ inline uint32_t ordered_bits(float f) {
  uint32_t b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ inline float from_ordered_bits(uint32_t b) {
  return __uint_as_float((b & 0x80000000u) ? (b & 0x7fffffffu) : ~b);
}

template <bool kTsdf>
__device__ inline float probability(const Params& p, int cx, int cy) {
  if (cx < 0 || cx >= p.size || cy < 0 || cy >= p.size) return 0.1f;
  size_t idx = (size_t)cx * p.size + cy;
  if (kTsdf)
    return ((const float*)p.flags)[idx] > 0.0f ? 1.0f - fabsf(p.values[idx]) / p.truncation
                                               : 0.0f;
  return ((const uint8_t*)p.flags)[idx] ? 1.0f / (1.0f + expf(-p.values[idx])) : 0.1f;
}

__global__ void init_key(unsigned long long* key) { key[0] = 0ull; }

template <bool kTsdf>
__global__ void score_kernel(Params p, float* __restrict__ scores, float* __restrict__ deltas,
                             unsigned long long* __restrict__ key) {
  __shared__ float s[kMaxPoints];
  __shared__ float red[kThreads / 32];
  __shared__ int cnt;
  const int w = 2 * p.nl + 1;
  const int flat = blockIdx.x;
  const int a = flat / (w * w);
  const int ix = (flat / w) % w;
  const int iy = flat % w;

  // Largest valid range and the valid count.
  float mr = 0.0f;
  int c = 0;
  for (int k = threadIdx.x; k < p.n; k += blockDim.x) {
    float x = p.points[2 * k], y = p.points[2 * k + 1];
    float r = sqrtf(x * x + y * y);
    if (p.mask[k]) {
      mr = fmaxf(mr, r);
      c += 1;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    mr = fmaxf(mr, __shfl_down_sync(0xffffffffu, mr, off));
    c += __shfl_down_sync(0xffffffffu, c, off);
  }
  if (threadIdx.x == 0) cnt = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = mr;
    atomicAdd(&cnt, c);
  }
  __syncthreads();
  mr = red[0];
  for (int q = 1; q < kThreads / 32; ++q) mr = fmaxf(mr, red[q]);
  mr = fmaxf(mr, p.min_range);
  const float step = 0.999f * acosf(1.0f - p.res_sq / (2.0f * (mr * mr)));
  const int half = (p.num_angles - 1) / 2;
  const float delta = ((float)a - (float)half) * step;
  const float theta = p.init[2] + delta;
  const float ct = cosf(theta), st = sinf(theta);
  const int sx = ix - p.nl, sy = iy - p.nl;

  auto value = [&](int k) {
    float v = 0.0f;
    if (p.mask[k]) {
      float x = p.points[2 * k], y = p.points[2 * k + 1];
      float wx = (ct * x - st * y) + p.init[0];
      float wy = (st * x + ct * y) + p.init[1];
      int cx = (int)floorf((wx - p.origin[0]) / p.resolution);
      int cy = (int)floorf((wy - p.origin[1]) / p.resolution);
      v = probability<kTsdf>(p, cx + sx, cy + sy);
    }
    return v;
  };
  const int tile = min(p.n, kMaxPoints), m = p.n / tile;
  for (int k = threadIdx.x; k < tile; k += blockDim.x)
    s[k] = halving::fold(m, [&](int j) { return value(k + j * tile); });
  __syncthreads();
  for (int h = tile / 2; h >= 1; h >>= 1) {
    for (int k = threadIdx.x; k < h; k += blockDim.x) s[k] = s[k] + s[k + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float raw = s[0] / (float)max(cnt, 1);
    float dx = fabsf((float)sx) * p.resolution;
    float dy = fabsf((float)sy) * p.resolution;
    float dist = sqrtf(dx * dx + dy * dy);
    float q = dist * p.tw + fabsf(delta) * p.rw;
    float score = fabsf(delta) <= p.angle_limit ? raw * expf(-(q * q)) : -INFINITY;
    scores[flat] = score;
    if (ix == 0 && iy == 0) deltas[a] = delta;
    unsigned long long k64 = ((unsigned long long)ordered_bits(score) << 32) |
                             (unsigned long long)(0xffffffffu - (uint32_t)flat);
    atomicMax(key, k64);
  }
}

__global__ void decode_kernel(Params p, const float* __restrict__ deltas,
                              const unsigned long long* __restrict__ key,
                              float* __restrict__ best) {
  const int w = 2 * p.nl + 1;
  unsigned long long k64 = key[0];
  int flat = (int)(0xffffffffu - (uint32_t)(k64 & 0xffffffffull));
  int a = flat / (w * w), ix = (flat / w) % w, iy = flat % w;
  best[0] = from_ordered_bits((uint32_t)(k64 >> 32));
  best[1] = p.init[0] + (float)(ix - p.nl) * p.resolution;
  best[2] = p.init[1] + (float)(iy - p.nl) * p.resolution;
  best[3] = p.init[2] + deltas[a];
}

template <bool kTsdf>
int launch(const void* values, const void* flags, float truncation, const void* grid_origin,
           float resolution, int size, const void* points, const void* mask, int n,
           const void* init, int num_angles, int nl, float angle_limit, float tw, float rw,
           float res_sq, float min_range, void* scores, void* deltas, void* key, void* best,
           void* stream) {
  if (n < 1 || (n & (n - 1)) != 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.values = (const float*)values;
  p.flags = flags;
  p.truncation = truncation;
  p.origin = (const float*)grid_origin;
  p.resolution = resolution;
  p.size = size;
  p.points = (const float*)points;
  p.mask = (const uint8_t*)mask;
  p.n = n;
  p.init = (const float*)init;
  p.num_angles = num_angles;
  p.nl = nl;
  p.angle_limit = angle_limit;
  p.tw = tw;
  p.rw = rw;
  p.res_sq = res_sq;
  p.min_range = min_range;
  cudaStream_t s = (cudaStream_t)stream;
  int w = 2 * nl + 1;
  init_key<<<1, 1, 0, s>>>((unsigned long long*)key);
  score_kernel<kTsdf><<<num_angles * w * w, kThreads, 0, s>>>(
      p, (float*)scores, (float*)deltas, (unsigned long long*)key);
  decode_kernel<<<1, 1, 0, s>>>(p, (const float*)deltas, (const unsigned long long*)key,
                                (float*)best);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int correlative_2d(const void* log_odds, const void* known, const void* grid_origin,
                              float resolution, int size, const void* points, const void* mask,
                              int n, const void* init, int num_angles, int nl, float angle_limit,
                              float tw, float rw, float res_sq, float min_range, void* scores,
                              void* deltas, void* key, void* best, void* stream) {
  return launch<false>(log_odds, known, 0.0f, grid_origin, resolution, size, points, mask, n,
                       init, num_angles, nl, angle_limit, tw, rw, res_sq, min_range, scores,
                       deltas, key, best, stream);
}

// K5's TSDF form: `tsd` and `weight` (float32, size^2) and the truncation.
extern "C" int correlative_2d_tsdf(const void* tsd, const void* weight, float truncation,
                                   const void* grid_origin, float resolution, int size,
                                   const void* points, const void* mask, int n,
                                   const void* init, int num_angles, int nl,
                                   float angle_limit, float tw, float rw, float res_sq,
                                   float min_range, void* scores, void* deltas, void* key,
                                   void* best, void* stream) {
  return launch<true>(tsd, weight, truncation, grid_origin, resolution, size, points, mask, n,
                      init, num_angles, nl, angle_limit, tw, rw, res_sq, min_range, scores,
                      deltas, key, best, stream);
}
