// K5 correlative_2d
//
// Replaces: cartographer_tpu/ops/correlative_2d.py:real_time_correlative_match
// (l.138) in its gather form _scores_gather (l.82), with _angular_step (l.61)
// and _candidate_geometry (l.69).
//
// Three launches a call (for up to kMaxRobots robots):
//  - prelude, one block per robot: the largest valid range and the valid
//    count of the cloud, the data-dependent angular step from them, and the
//    robot's 64-bit argmax key cleared;
//  - score, one block per (angle, 5 x 5 tile of shifts) and robot (the
//    default 0.1 m window at 5 cm is one tile). A block whose angle lies
//    outside the angular window writes its -inf scores and its delta and
//    reads no point: the twin scores those candidates -inf whatever their
//    sum. Otherwise each thread rotates and discretises its points once,
//    reads each point's 5 x 5 neighbourhood as 5 rows of 5 contiguous cells,
//    turns log-odds and known flag into a probability on the fly (no
//    probability image is built) and keeps the 25 partial sums in registers.
//    The sums reproduce the twin's pairwise halving tree (tree_sum): above
//    kThreads padded points a thread first folds its points k + j * kThreads
//    in that tree's order (halving_fold.cuh), the levels from kThreads / 2
//    down to 32 go through shared memory with all 25 trees sharing each
//    barrier, and the last 5 levels are v + __shfl_down_sync(v, h) for
//    h = 16 ... 1, which pairs lane k with lane k + h as the tree does. The
//    lane that ends a sum applies the motion prior and writes the score;
//    the block folds its candidates into one (order-preserving score bits,
//    ~flat index) key and makes one 64-bit atomicMax: the maximum score
//    wins and, among equal scores, the lowest flat index, which is
//    jnp.argmax's tie-break;
//  - decode, one thread per robot: the winner into [score, x, y, theta] on
//    the device, so the caller never waits.
//
// correlative_2d_tsdf is K5's TSDF form, on the score surface of a TSDF grid
// (JAX ops/tsdf_2d.py:TsdfGrid2D.correspondence_score, l.71, which the JAX
// search reads through grid.probability()): weight > 0 ? 1 - |tsd| /
// truncation : 0 in the map, UNKNOWN outside it, as the gather form pads.
// One template over the cell's surface serves both exported functions.
//
// Robots: blockIdx.y of the score launch and blockIdx.x of the prelude are
// the robot of a cross-robot batch (the JAX package's _batched_step_cached
// vmaps the search over robots); a score launch for one robot instantiates
// the same body with the robot index 0. num_angles comes from the options,
// so every robot of a batch has the same grid of candidates; each robot has
// its own grid (a pointer table of values, flags and origin in the launch's
// parameters: no copy to the device), padded points and mask, start pose,
// scores, state (key, step, count) and decode. Above kMaxRobots robots the
// entry point launches once per kMaxRobots. One search is the R = 1 case.
//
// Bound: operations and latency. At full width 421 angles x 5 x 5 shifts x
// 512 points are 5.4 M gathers of 5 bytes from a 5 MB grid (L2-resident), a
// few microseconds of bytes. A point is placed once an angle, whatever the
// shifts, its 25 cells are read by one thread, next to each other, and the
// cloud's max-range pass runs once a call. Arithmetic follows the JAX order
// with -fmad=false.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "halving_fold.cuh"

namespace {

constexpr int kThreads = 256;  // a score block; the fold's tile
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 5;  // a block's tile of kTile x kTile shifts
constexpr int kSums = kTile * kTile;
constexpr int kMaxRobots = 64;  // robots per launch: the pointer table's rows

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

// A robot's search state: the argmax key, written by the prelude (cleared)
// and the score blocks, and the angular step and valid count of its cloud.
struct State {
  unsigned long long key;
  float step;
  int count;
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

// The surface at cell (cx, cy): UNKNOWN (0.1) outside the map.
template <bool kTsdf>
__device__ inline float probability(const Params& p, const Robot& q, int cx, int cy) {
  if (cx < 0 || cx >= p.size || cy < 0 || cy >= p.size) return 0.1f;
  size_t idx = (size_t)cx * p.size + cy;
  if (kTsdf)
    return ((const float*)q.flags)[idx] > 0.0f ? 1.0f - fabsf(q.values[idx]) / p.truncation
                                               : 0.0f;
  return ((const uint8_t*)q.flags)[idx] ? 1.0f / (1.0f + expf(-q.values[idx])) : 0.1f;
}

// One block per robot: the largest valid range (at least min_range) and the
// valid count, the angular step, the key cleared.
__global__ void __launch_bounds__(kThreads)
    prelude_kernel(Params p, const float* __restrict__ points, const uint8_t* __restrict__ mask,
                   State* __restrict__ state) {
  const int r = blockIdx.x;
  points += (long long)r * 2 * p.n;
  mask += (long long)r * p.n;
  __shared__ float red[kWarps];
  __shared__ int cnt[kWarps];
  float mr = 0.0f;
  int c = 0;
  for (int k = threadIdx.x; k < p.n; k += kThreads) {
    float x = points[2 * k], y = points[2 * k + 1];
    float range = sqrtf(x * x + y * y);
    if (mask[k]) {
      mr = fmaxf(mr, range);
      c += 1;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    mr = fmaxf(mr, __shfl_down_sync(0xffffffffu, mr, off));
    c += __shfl_down_sync(0xffffffffu, c, off);
  }
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = mr;
    cnt[threadIdx.x >> 5] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      mr = fmaxf(mr, red[w]);
      c += cnt[w];
    }
    mr = fmaxf(mr, p.min_range);
    state[r].key = 0ull;
    state[r].step = 0.999f * acosf(1.0f - p.res_sq / (2.0f * (mr * mr)));
    state[r].count = c;
  }
}

// kTile x kTile floats added lane by lane.
using Sums = halving::Lanes<kSums>;

// The surface under point k of the tile's shifts (0 for a masked point),
// into `out` (kAdd false) or added to it (kAdd true).
template <bool kTsdf, bool kAdd>
__device__ inline void point_values(const Params& p, const Robot& q, float ct, float st, int sx0,
                                    int sy0, int k, Sums& out) {
  if (!q.mask[k]) {
    if (!kAdd)
#pragma unroll
      for (int c = 0; c < kSums; ++c) out.v[c] = 0.0f;
    return;
  }
  const float x = q.points[2 * k], y = q.points[2 * k + 1];
  const float wx = (ct * x - st * y) + q.init[0];
  const float wy = (st * x + ct * y) + q.init[1];
  const int cx = (int)floorf((wx - q.origin[0]) / p.resolution) + sx0;
  const int cy = (int)floorf((wy - q.origin[1]) / p.resolution) + sy0;
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float v = probability<kTsdf>(p, q, cx + i, cy + j);
      if (kAdd)
        out.v[i * kTile + j] = out.v[i * kTile + j] + v;
      else
        out.v[i * kTile + j] = v;
    }
}

// kRobots: a launch for several robots (blockIdx.y); one robot's launch
// instantiates the same body with r = 0.
template <bool kTsdf, bool kRobots>
__global__ void __launch_bounds__(kThreads)
    score_kernel(Params p, Grids grids, const float* __restrict__ points,
                 const uint8_t* __restrict__ mask, const float* __restrict__ init,
                 long long init_rs, float* __restrict__ scores, float* __restrict__ deltas,
                 State* __restrict__ state) {
  const int r = kRobots ? blockIdx.y : 0;
  const Robot q = robot_of(p, grids, points, mask, init, init_rs, r);
  const int w = 2 * p.nl + 1;
  const int side = (w + kTile - 1) / kTile;
  scores += (long long)r * p.num_angles * w * w;
  deltas += (long long)r * p.num_angles;
  state += r;
  const int a = blockIdx.x / (side * side);
  const int tile = blockIdx.x - a * (side * side);
  const int tx0 = (tile / side) * kTile, ty0 = (tile % side) * kTile;
  const float step = state->step;
  const int half = (p.num_angles - 1) / 2;
  const float delta = ((float)a - (float)half) * step;
  if (tile == 0 && threadIdx.x == 0) deltas[a] = delta;
  if (!(fabsf(delta) <= p.angle_limit)) {
    // Outside the window: -inf whatever the sum, and no point is read.
    if (threadIdx.x < kSums) {
      const int ix = tx0 + threadIdx.x / kTile, iy = ty0 + threadIdx.x % kTile;
      if (ix < w && iy < w) scores[((long long)a * w + ix) * w + iy] = -INFINITY;
    }
    return;
  }
  __shared__ float red[kSums][kThreads];
  __shared__ unsigned long long best[kWarps];
  const float theta = q.init[2] + delta;
  const float ct = cosf(theta), st = sinf(theta);
  const int sx0 = tx0 - p.nl, sy0 = ty0 - p.nl;

  // This thread's fold of the first log2(m) halvings, points k + j * tile.
  const int tile_n = min(p.n, kThreads), m = p.n / tile_n;
  const int k = threadIdx.x;
  Sums acc;
  if (k < tile_n) {
    if (m <= 2) {
      point_values<kTsdf, false>(p, q, ct, st, sx0, sy0, k, acc);
      if (m == 2) point_values<kTsdf, true>(p, q, ct, st, sx0, sy0, k + tile_n, acc);
    } else {
      acc = halving::fold_of<Sums>(m, [&](int j) {
        Sums v;
        point_values<kTsdf, false>(p, q, ct, st, sx0, sy0, k + j * tile_n, v);
        return v;
      });
    }
#pragma unroll
    for (int c = 0; c < kSums; ++c) red[c][k] = acc.v[c];
  }
  __syncthreads();
  // The cross-warp levels, all trees at once.
  for (int h = tile_n / 2; h >= 32; h >>= 1) {
    for (int i = threadIdx.x; i < kSums * h; i += kThreads) {
      const int c = i / h, j = i - c * h;
      red[c][j] = red[c][j] + red[c][j + h];
    }
    __syncthreads();
  }
  // The last levels in a warp: warp wp takes the trees wp, wp + kWarps, ...
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int width = min(tile_n, 32);
  const int count = state->count;
  unsigned long long mine = 0ull;
  for (int c = wp; c < kSums; c += kWarps) {
    float v = lane < width ? red[c][lane] : 0.0f;
    for (int h = width / 2; h >= 1; h >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, h);
    const int ix = tx0 + c / kTile, iy = ty0 + c % kTile;
    if (lane == 0 && ix < w && iy < w) {
      const int sx = ix - p.nl, sy = iy - p.nl;
      const float raw = v / (float)max(count, 1);
      const float dx = fabsf((float)sx) * p.resolution;
      const float dy = fabsf((float)sy) * p.resolution;
      const float dist = sqrtf(dx * dx + dy * dy);
      const float prior = dist * p.tw + fabsf(delta) * p.rw;
      const float score = raw * expf(-(prior * prior));
      const int flat = (a * w + ix) * w + iy;
      scores[flat] = score;
      const unsigned long long k64 = ((unsigned long long)ordered_bits(score) << 32) |
                                     (unsigned long long)(0xffffffffu - (uint32_t)flat);
      mine = k64 > mine ? k64 : mine;
    }
  }
  if (lane == 0) best[wp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kWarps; ++i) mine = best[i] > mine ? best[i] : mine;
    atomicMax(&state->key, mine);
  }
}

__global__ void decode_kernel(Params p, const float* __restrict__ init, long long init_rs,
                              int robots, const float* __restrict__ deltas,
                              const State* __restrict__ state, float* __restrict__ best) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= robots) return;
  const float* start = init + r * init_rs;
  deltas += (long long)r * p.num_angles;
  best += 4 * r;
  const int w = 2 * p.nl + 1;
  unsigned long long k64 = state[r].key;
  int flat = (int)(0xffffffffu - (uint32_t)(k64 & 0xffffffffull));
  int a = flat / (w * w), ix = (flat / w) % w, iy = flat % w;
  best[0] = from_ordered_bits((uint32_t)(k64 >> 32));
  best[1] = start[0] + (float)(ix - p.nl) * p.resolution;
  best[2] = start[1] + (float)(iy - p.nl) * p.resolution;
  best[3] = start[2] + deltas[a];
}

// `grids` (host memory): robots x (values, flags, origin) device pointers.
// `points` (robots, n, 2) and `mask` (robots, n) contiguous; `init` robot
// 0's start pose, robot r's init_rs floats further; outputs per robot;
// `state` 16 bytes per robot.
template <bool kTsdf>
int launch(const void* const* grids, int robots, float truncation, float resolution, int size,
           const void* points, const void* mask, int n, const void* init, long long init_rs,
           int num_angles, int nl, float angle_limit, float tw, float rw, float res_sq,
           float min_range, void* scores, void* deltas, void* state, void* best, void* stream) {
  if (n < 1 || (n & (n - 1)) != 0 || robots < 1 || grids == nullptr || nl < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int w = 2 * nl + 1, side = (w + kTile - 1) / kTile;
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
    State* st = (State*)state + r0;
    prelude_kernel<<<count, kThreads, 0, s>>>(p, pts, msk, st);
    const dim3 grid(num_angles * side * side, count);
    if (count == 1)
      score_kernel<kTsdf, false><<<grid, kThreads, 0, s>>>(p, g, pts, msk, start, init_rs, sc,
                                                           de, st);
    else
      score_kernel<kTsdf, true><<<grid, kThreads, 0, s>>>(p, g, pts, msk, start, init_rs, sc,
                                                          de, st);
    decode_kernel<<<1, kMaxRobots, 0, s>>>(p, start, init_rs, count, de, st,
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
                              void* deltas, void* state, void* best, void* stream) {
  return launch<false>(grids, robots, 0.0f, resolution, size, points, mask, n, init, init_rs,
                       num_angles, nl, angle_limit, tw, rw, res_sq, min_range, scores, deltas,
                       state, best, stream);
}

// K5's TSDF form: per robot `tsd` and `weight` (float32, size^2) and the
// grid origin; one truncation.
extern "C" int correlative_2d_tsdf(const void* const* grids, int robots, float truncation,
                                   float resolution, int size, const void* points,
                                   const void* mask, int n, const void* init,
                                   long long init_rs, int num_angles, int nl,
                                   float angle_limit, float tw, float rw, float res_sq,
                                   float min_range, void* scores, void* deltas, void* state,
                                   void* best, void* stream) {
  return launch<true>(grids, robots, truncation, resolution, size, points, mask, n, init,
                      init_rs, num_angles, nl, angle_limit, tw, rw, res_sq, min_range, scores,
                      deltas, state, best, stream);
}
