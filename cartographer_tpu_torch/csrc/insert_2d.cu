// K4 insert_2d
//
// Replaces: cartographer_tpu/ops/grid_2d.py:insert_range_data, scatter form
// (l.105-189), with _apply_masks (l.192), as batched over the two active
// submaps by mapping/submap_2d.py:_make_insert_body (l.41).
//
// Mark pass, one thread per (ray, run of kRun samples), serving every slot:
// return rays sample t = k/K along [origin, hit), miss rays t = (k+1)/K along
// (origin, end]; the sample point origin + t * delta is computed once, and
// each slot's cell is floor((point - grid_origin) / res) from that slot's
// own grid origin, in JAX's order of operations (built with -fmad=false: a
// contracted FMA moves boundary samples into the neighbouring cell). Sample
// k = 0 of a return ray also marks the hit cell. Consecutive samples of a
// ray mostly fall in one 5 cm cell, so a sample marks only where its cell
// differs from the previous sample's on the same ray (the previous thread's
// last sample comes from the neighbouring lane by a shuffle; the first lane
// of a warp and the first run of a ray always mark). A mark is a bit: each
// (robot, slot) has a bitmap of 2 bits a cell (hit, free), set by an
// atomicOr whose result is not read, so the thread never waits for it.
//
// Apply pass, one thread per bitmap word (16 cells) of each (robot, slot):
// a word with a bit set is cleared and its marked cells updated, hit taking
// precedence over free, log-odds add and clamp, known |= hit | free. The
// word's 16 cells are neighbours in a grid row, so their loads go out
// together. The update is per cell and independent of the order of the
// marks. Both passes read do_insert (the motion filter's decision) and the
// active flags from device memory, so the caller never waits: a robot that
// does not insert or an inactive slot marks nothing, and its sweep finds
// every word clear.
//
// A list of the marked cells, appended by the thread whose atomicOr set a
// cell's first bit (the atomics then return, a round trip to L2 each) and
// walked by the apply pass, lost to the sweep at every shape measured on the
// card (tests/robot_batch_timing.py's k4-forms mode builds that form from
// this file; PERF.md row 5 has its times).
//
// Robots: blockIdx.y of the mark pass and blockIdx.z of the apply pass are
// the robot of a cross-robot batch (the JAX package's _batched_step_cached
// vmaps the insertion over robots). Each robot's grids and bitmaps stay
// where its submaps keep them: a pointer table (log-odds, known, origins,
// bitmaps of the robot's slots) travels in the launch's parameters, so it
// needs no copy to the device; above kMaxRobots robots the entry point
// launches once per kMaxRobots. The scans, their masks, origins, active
// flags and do_insert are robot 0's plus the robot times a robot stride in
// elements. One robot is the R = 1 case.
//
// Bound: bytes. Updated in place, the function reads and writes the log-odds
// (4 B) and known (1 B) of only the cells this scan's rays touch, and reads
// the returns, misses and their masks (18 B per point): a scan of a room
// touches some 10^5 of the 2 x 1024^2 cells, about 2 MB (chip_smoke.py
// counts them). Design: the marks touch a bitmap of 2 bits a cell (256 KB a
// 1024^2 slot, L2-resident), and the sweep reads it once and the log-odds and
// known of the marked cells alone.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRobots = 64;  // robots per launch: the pointer table's rows
constexpr int kThreads = 256;
constexpr int kRun = 4;  // samples of a ray per mark thread
constexpr uint32_t kHit = 1u, kFree = 2u;

// Per robot: its slots' log-odds, known flags, origins and bitmaps (2 bits
// a cell: hit, free).
struct Grids {
  float* log_odds[kMaxRobots];
  uint8_t* known[kMaxRobots];
  const float* origins[kMaxRobots];
  uint32_t* bits[kMaxRobots];
};

// Robot strides of the per-robot inputs, in elements.
struct RobotStrides {
  long long returns, return_mask, misses, miss_mask, origin, active, do_insert;
};

// The linear cell of (x, y) in a size^2 grid at grid_origin, or -1 outside.
__device__ inline int cell_of(const float* grid_origin, float resolution, int size, float x,
                              float y) {
  float ci = floorf((x - grid_origin[0]) / resolution);
  float cj = floorf((y - grid_origin[1]) / resolution);
  if (ci >= 0.0f && ci < (float)size && cj >= 0.0f && cj < (float)size)
    return (int)ci * size + (int)cj;
  return -1;
}

// kRobots: a launch for several robots (blockIdx.y); one robot's launch
// instantiates the same bodies with r = 0, at the one-robot kernels' cost.
template <bool kRobots>
__global__ void __launch_bounds__(kThreads)
    mark_kernel(Grids grids, RobotStrides rs, const float* __restrict__ returns,
                const uint8_t* __restrict__ return_mask, const float* __restrict__ misses,
                const uint8_t* __restrict__ miss_mask, int n, const float* __restrict__ origin,
                float resolution, int size, int samples, int insert_free_space,
                const uint8_t* __restrict__ active, const uint8_t* __restrict__ do_insert,
                int slots) {
  const long long r = kRobots ? blockIdx.y : 0;
  if (!do_insert[r * rs.do_insert]) return;  // the whole block: no lane is left out
  returns += r * rs.returns;
  return_mask += r * rs.return_mask;
  misses += r * rs.misses;
  miss_mask += r * rs.miss_mask;
  origin += r * rs.origin;
  active += r * rs.active;
  const int lane = threadIdx.x & 31;
  // Every lane of a warp goes through the shuffle below: a lane past the
  // last ray or on a masked ray is dead and marks nothing.
  const int runs = (samples + kRun - 1) / kRun;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = t < 2LL * n * runs;
  const int ray = in_range ? (int)(t / runs) : 0;
  const int u = in_range ? (int)(t - (long long)ray * runs) : 0;
  const bool is_return = ray < n;
  const int p = is_return ? ray : ray - n;
  const bool live = in_range && (is_return ? return_mask[p] : miss_mask[p]);
  float px = 0.0f, py = 0.0f;
  if (live) {
    const float* pts = is_return ? returns : misses;
    px = pts[2 * p];
    py = pts[2 * p + 1];
  }
  const float ox = origin[0], oy = origin[1];
  float sx[kRun], sy[kRun];
  bool on[kRun];
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    const int k = u * kRun + i;
    on[i] = live && insert_free_space && k < samples;
    const float tt = (is_return ? (float)k : (float)k + 1.0f) / (float)samples;
    sx[i] = ox + tt * (px - ox);
    sy[i] = oy + tt * (py - oy);
  }
  const bool hit = live && is_return && u == 0;
  const bool first = lane == 0 || u == 0;  // no previous sample of this ray in the warp
  const size_t words = ((size_t)size * size + 15) / 16;

  for (int slot = 0; slot < slots; ++slot) {
    if (!active[slot]) continue;  // the same for every lane
    const float* g = grids.origins[r] + 2 * slot;
    uint32_t* bits = grids.bits[r] + slot * words;
    int cell[kRun];
#pragma unroll
    for (int i = 0; i < kRun; ++i)
      cell[i] = on[i] ? cell_of(g, resolution, size, sx[i], sy[i]) : -1;
    int prev = __shfl_up_sync(0xffffffffu, cell[kRun - 1], 1);
    if (first) prev = -1;
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const int c = cell[i];
      if (c >= 0 && c != prev) atomicOr(bits + (c >> 4), kFree << (2 * (c & 15)));
      prev = c;
    }
    if (hit) {
      const int c = cell_of(g, resolution, size, px, py);
      if (c >= 0) atomicOr(bits + (c >> 4), kHit << (2 * (c & 15)));
    }
  }
}

// A thread per bitmap word: blockIdx.y the slot, blockIdx.z the robot.
template <bool kRobots>
__global__ void __launch_bounds__(kThreads)
    apply_kernel(Grids grids, int size, float hit_log_odds, float miss_log_odds,
                 float min_log_odds, float max_log_odds) {
  const int r = kRobots ? blockIdx.z : 0;
  const int slot = blockIdx.y;
  const size_t cells = (size_t)size * size;
  const size_t words = (cells + 15) / 16;
  const size_t w = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= words) return;
  uint32_t* bits = grids.bits[r] + slot * words;
  const uint32_t word = bits[w];
  if (word == 0u) return;
  bits[w] = 0u;
  float* __restrict__ log_odds = grids.log_odds[r] + slot * cells;
  uint8_t* __restrict__ known = grids.known[r] + slot * cells;
  float lo[16];
  uint8_t kn[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const size_t lin = w * 16 + c;
    if ((word >> (2 * c)) & 3u) {
      lo[c] = log_odds[lin];
      kn[c] = known[lin];
    }
  }
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const uint32_t two = (word >> (2 * c)) & 3u;
    if (!two) continue;
    const size_t lin = w * 16 + c;
    const bool hit = (two & kHit) != 0u;
    const bool fre = (two & kFree) != 0u && !hit;
    float updated = (lo[c] + (hit ? hit_log_odds : 0.0f)) + (fre ? miss_log_odds : 0.0f);
    updated = fminf(fmaxf(updated, min_log_odds), max_log_odds);
    if (updated != lo[c]) log_odds[lin] = updated;
    if (!kn[c]) known[lin] = 1;
  }
}

}  // namespace

// `grids` (host memory): robots x (log_odds, known, grid origins, bitmaps)
// device pointers, each robot's `slots` slots of size^2 cells (bitmaps
// ceil(size^2 / 16) words a slot, zero between calls); `strides` (host
// memory): the robot strides of returns, return_mask, misses, miss_mask,
// origin, active, do_insert.
extern "C" int insert_2d(const void* const* grids, int robots, const void* returns,
                         const void* return_mask, const void* misses, const void* miss_mask,
                         int n, const void* origin, const void* active,
                         const void* do_insert, const void* strides, float resolution,
                         int size, int samples, int insert_free_space, int slots,
                         float hit_log_odds, float miss_log_odds, float min_log_odds,
                         float max_log_odds, void* stream) {
  if (grids == nullptr || strides == nullptr || robots < 1 || slots < 1 || samples < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long* st = (const long long*)strides;
  RobotStrides rs = {st[0], st[1], st[2], st[3], st[4], st[5], st[6]};
  const long long threads = 2LL * n * ((samples + kRun - 1) / kRun);
  const long long words = ((long long)size * size + 15) / 16;
  for (int r0 = 0; r0 < robots; r0 += kMaxRobots) {
    const int count = min(kMaxRobots, robots - r0);
    Grids g = {};
    for (int r = 0; r < count; ++r) {
      const void* const* row = grids + 4 * (r0 + r);
      g.log_odds[r] = (float*)row[0];
      g.known[r] = (uint8_t*)row[1];
      g.origins[r] = (const float*)row[2];
      g.bits[r] = (uint32_t*)row[3];
    }
    const uint8_t* act = (const uint8_t*)active + r0 * rs.active;
    const uint8_t* ins = (const uint8_t*)do_insert + r0 * rs.do_insert;
    const dim3 mark_grid((unsigned)((threads + kThreads - 1) / kThreads), count);
    auto mark = count == 1 ? mark_kernel<false> : mark_kernel<true>;
    mark<<<mark_grid, kThreads, 0, s>>>(
        g, rs, (const float*)returns + r0 * rs.returns,
        (const uint8_t*)return_mask + r0 * rs.return_mask,
        (const float*)misses + r0 * rs.misses, (const uint8_t*)miss_mask + r0 * rs.miss_mask,
        n, (const float*)origin + r0 * rs.origin, resolution, size, samples,
        insert_free_space, act, ins, slots);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 apply_grid((unsigned)((words + kThreads - 1) / kThreads), slots, count);
    auto apply = count == 1 ? apply_kernel<false> : apply_kernel<true>;
    apply<<<apply_grid, kThreads, 0, s>>>(g, size, hit_log_odds, miss_log_odds, min_log_odds,
                                          max_log_odds);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
