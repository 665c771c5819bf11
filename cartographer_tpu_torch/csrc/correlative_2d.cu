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
// Robots: blockIdx.y is the robot of a cross-robot batch (the JAX package's
// _batched_step_cached vmaps the search over robots); a launch for one
// robot instantiates the same body with the robot index 0, so that it costs
// what the one-robot kernel did. num_angles comes
// from the options, so every robot of a batch has the same grid of
// candidates; each robot has its own grid (a pointer table of values,
// flags and origin in the launch's parameters: no copy to the device),
// padded points and mask, start pose, scores, 64-bit key and decode. One
// init_key launch clears the robots' keys, one decode launch reads them.
// Above kMaxRobots robots the entry point launches once per kMaxRobots.
// One search is the R = 1 case.
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
constexpr int kMaxRobots = 64;    // robots per launch: the pointer table's rows

// Per robot: the surface values, flags and grid origin.
struct Grids {
  const void* values[kMaxRobots];
  const void* flags[kMaxRobots];
  const void* origin[kMaxRobots];
};

// What every robot of a launch shares.
struct Params {
  float truncation;  // TSDF form only
  float resolution;
  int size;
  int n;  // power of two, any size
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

// One robot's grid, padded points, mask and start pose.
struct Robot {
  const float* values;  // log-odds, or tsd (TSDF form)
  const void* flags;    // known (uint8), or weight (float32, TSDF form)
  const float* origin;
  const float* points;
  const uint8_t* mask;
  const float* init;
};

// Robot r's inputs: `points` and `mask` robot 0's, `init` robot 0's start
// pose, robot r's init_rs floats further.
__device__ inline Robot robot_of(const Params& p, const Grids& grids, const float* points,
                                 const uint8_t* mask, const float* init, long long init_rs,
                                 int r) {
  return {(const float*)grids.values[r], grids.flags[r], (const float*)grids.origin[r],
          points + (long long)r * 2 * p.n, mask + (long long)r * p.n, init + r * init_rs};
}

template <bool kTsdf>
__device__ inline float probability(const Params& p, const Robot& q, int cx, int cy) {
  if (cx < 0 || cx >= p.size || cy < 0 || cy >= p.size) return 0.1f;
  size_t idx = (size_t)cx * p.size + cy;
  if (kTsdf)
    return ((const float*)q.flags)[idx] > 0.0f ? 1.0f - fabsf(q.values[idx]) / p.truncation
                                               : 0.0f;
  return ((const uint8_t*)q.flags)[idx] ? 1.0f / (1.0f + expf(-q.values[idx])) : 0.1f;
}

__global__ void init_key(unsigned long long* key, int robots) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < robots) key[r] = 0ull;
}

// kRobots: a launch for several robots (blockIdx.y); one robot's launch
// instantiates the same body with r = 0.
template <bool kTsdf, bool kRobots>
__global__ void score_kernel(Params p, Grids grids, const float* __restrict__ points,
                             const uint8_t* __restrict__ mask, const float* __restrict__ init,
                             long long init_rs, float* __restrict__ scores,
                             float* __restrict__ deltas,
                             unsigned long long* __restrict__ key) {
  const int r = kRobots ? blockIdx.y : 0;
  const Robot q = robot_of(p, grids, points, mask, init, init_rs, r);
  scores += (long long)r * p.num_angles * (2 * p.nl + 1) * (2 * p.nl + 1);
  deltas += (long long)r * p.num_angles;
  key += r;
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
    float x = q.points[2 * k], y = q.points[2 * k + 1];
    float range = sqrtf(x * x + y * y);
    if (q.mask[k]) {
      mr = fmaxf(mr, range);
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
  for (int w_ = 1; w_ < kThreads / 32; ++w_) mr = fmaxf(mr, red[w_]);
  mr = fmaxf(mr, p.min_range);
  const float step = 0.999f * acosf(1.0f - p.res_sq / (2.0f * (mr * mr)));
  const int half = (p.num_angles - 1) / 2;
  const float delta = ((float)a - (float)half) * step;
  const float theta = q.init[2] + delta;
  const float ct = cosf(theta), st = sinf(theta);
  const int sx = ix - p.nl, sy = iy - p.nl;

  auto value = [&](int k) {
    float v = 0.0f;
    if (q.mask[k]) {
      float x = q.points[2 * k], y = q.points[2 * k + 1];
      float wx = (ct * x - st * y) + q.init[0];
      float wy = (st * x + ct * y) + q.init[1];
      int cx = (int)floorf((wx - q.origin[0]) / p.resolution);
      int cy = (int)floorf((wy - q.origin[1]) / p.resolution);
      v = probability<kTsdf>(p, q, cx + sx, cy + sy);
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
    float prior = dist * p.tw + fabsf(delta) * p.rw;
    float score = fabsf(delta) <= p.angle_limit ? raw * expf(-(prior * prior)) : -INFINITY;
    scores[flat] = score;
    if (ix == 0 && iy == 0) deltas[a] = delta;
    unsigned long long k64 = ((unsigned long long)ordered_bits(score) << 32) |
                             (unsigned long long)(0xffffffffu - (uint32_t)flat);
    atomicMax(key, k64);
  }
}

__global__ void decode_kernel(Params p, Grids grids, const float* __restrict__ init,
                              long long init_rs, int robots, const float* __restrict__ deltas,
                              const unsigned long long* __restrict__ key,
                              float* __restrict__ best) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= robots) return;
  const float* start = init + r * init_rs;
  deltas += (long long)r * p.num_angles;
  key += r;
  best += 4 * r;
  const int w = 2 * p.nl + 1;
  unsigned long long k64 = key[0];
  int flat = (int)(0xffffffffu - (uint32_t)(k64 & 0xffffffffull));
  int a = flat / (w * w), ix = (flat / w) % w, iy = flat % w;
  best[0] = from_ordered_bits((uint32_t)(k64 >> 32));
  best[1] = start[0] + (float)(ix - p.nl) * p.resolution;
  best[2] = start[1] + (float)(iy - p.nl) * p.resolution;
  best[3] = start[2] + deltas[a];
}

// `grids` (host memory): robots x (values, flags, origin) device pointers.
// `points` (robots, n, 2) and `mask` (robots, n) contiguous; `init` robot
// 0's start pose, robot r's init_rs floats further; outputs per robot.
template <bool kTsdf>
int launch(const void* const* grids, int robots, float truncation, float resolution, int size,
           const void* points, const void* mask, int n, const void* init, long long init_rs,
           int num_angles, int nl, float angle_limit, float tw, float rw, float res_sq,
           float min_range, void* scores, void* deltas, void* key, void* best, void* stream) {
  if (n < 1 || (n & (n - 1)) != 0 || robots < 1 || grids == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int w = 2 * nl + 1;
  for (int r0 = 0; r0 < robots; r0 += kMaxRobots) {
    const int count = min(kMaxRobots, robots - r0);
    Grids g = {};
    for (int r = 0; r < count; ++r) {
      g.values[r] = grids[3 * (r0 + r)];
      g.flags[r] = grids[3 * (r0 + r) + 1];
      g.origin[r] = grids[3 * (r0 + r) + 2];
    }
    Params p;
    p.truncation = truncation;
    p.resolution = resolution;
    p.size = size;
    p.n = n;
    p.num_angles = num_angles;
    p.nl = nl;
    p.angle_limit = angle_limit;
    p.tw = tw;
    p.rw = rw;
    p.res_sq = res_sq;
    p.min_range = min_range;
    const float* pts = (const float*)points + (long long)r0 * 2 * n;
    const uint8_t* msk = (const uint8_t*)mask + (long long)r0 * n;
    const float* start = (const float*)init + r0 * init_rs;
    float* sc = (float*)scores + (long long)r0 * num_angles * w * w;
    float* de = (float*)deltas + (long long)r0 * num_angles;
    unsigned long long* k = (unsigned long long*)key + r0;
    init_key<<<1, kMaxRobots, 0, s>>>(k, count);
    const dim3 grid(num_angles * w * w, count);
    if (count == 1)
      score_kernel<kTsdf, false><<<grid, kThreads, 0, s>>>(p, g, pts, msk, start, init_rs, sc,
                                                           de, k);
    else
      score_kernel<kTsdf, true><<<grid, kThreads, 0, s>>>(p, g, pts, msk, start, init_rs, sc,
                                                          de, k);
    decode_kernel<<<1, kMaxRobots, 0, s>>>(p, g, start, init_rs, count, de, k,
                                           (float*)best + 4 * r0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// K5 on occupancy grids: per robot the log-odds (float32) and known (uint8)
// grids, size^2, and the grid origin.
extern "C" int correlative_2d(const void* const* grids, int robots, float resolution, int size,
                              const void* points, const void* mask, int n, const void* init,
                              long long init_rs, int num_angles, int nl, float angle_limit,
                              float tw, float rw, float res_sq, float min_range, void* scores,
                              void* deltas, void* key, void* best, void* stream) {
  return launch<false>(grids, robots, 0.0f, resolution, size, points, mask, n, init, init_rs,
                       num_angles, nl, angle_limit, tw, rw, res_sq, min_range, scores, deltas,
                       key, best, stream);
}

// K5's TSDF form: per robot `tsd` and `weight` (float32, size^2) and the
// grid origin; one truncation.
extern "C" int correlative_2d_tsdf(const void* const* grids, int robots, float truncation,
                                   float resolution, int size, const void* points,
                                   const void* mask, int n, const void* init,
                                   long long init_rs, int num_angles, int nl,
                                   float angle_limit, float tw, float rw, float res_sq,
                                   float min_range, void* scores, void* deltas, void* key,
                                   void* best, void* stream) {
  return launch<true>(grids, robots, truncation, resolution, size, points, mask, n, init,
                      init_rs, num_angles, nl, angle_limit, tw, rw, res_sq, min_range, scores,
                      deltas, key, best, stream);
}
