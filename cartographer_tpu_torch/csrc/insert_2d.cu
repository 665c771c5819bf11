// K4 insert_2d
//
// Replaces: cartographer_tpu/ops/grid_2d.py:insert_range_data, scatter form
// (l.105-189), with _apply_masks (l.192), as batched over the two active
// submaps by mapping/submap_2d.py:_make_insert_body (l.41).
//
// Mark pass, one thread per (slot, ray, sample): return rays sample
// t = k/K along [origin, hit), miss rays t = (k+1)/K along (origin, end];
// the sample's cell is floor((origin + t * delta - grid_origin) / res) in
// JAX's order of operations (built with -fmad=false: a contracted FMA moves
// boundary samples into the neighbouring cell). Sample k = 0 of a return
// ray also marks the hit cell. Each slot has its own grid origin, so the
// masks are per slot. The stores are idempotent byte stores: no atomics.
//
// Apply pass, one thread per cell of both slots: hit takes precedence over
// free, log-odds add and clamp, known |= hit | free, and the masks are
// zeroed for the next scan. Both passes read do_insert (the motion filter's
// decision) and the active flags from device memory, so the caller never
// waits for them.
//
// Robots: blockIdx.y is the robot of a cross-robot batch (the JAX package's
// _batched_step_cached vmaps the insertion over robots): the mark pass runs
// over (robot, slot, ray, sample), the apply pass over (robot, slot, cell).
// Each robot's grids and masks stay where its submaps keep them: a pointer
// table (log-odds, known, origins, hit and free masks of the robot's slots)
// travels in the launch's parameters, so it needs no copy to the device;
// above kMaxRobots robots the entry point launches once per kMaxRobots.
// The scans, their masks, origins, active flags and do_insert are robot 0's
// plus the robot times a robot stride in elements. One robot is the R = 1
// case.
//
// Bound: bytes. Updated in place, the function reads and writes the log-odds
// (4 B) and known (1 B) of only the cells this scan's rays touch, and reads
// the returns, misses and their masks (18 B per point): a scan of a room
// touches some 10^5 of the 2 x 1024^2 cells, about 2 MB (chip_smoke.py
// counts them). Design: the mark pass writes one byte per sample's cell;
// the apply pass sweeps every cell of both slots, reading both masks and the
// log-odds (about 12.6 MB), and writes only the cells that change. So it
// moves several times the bytes of the bound; a list of the marked cells
// would let it visit only those.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRobots = 64;  // robots per launch: the pointer table's rows

// Per robot: its slots' log-odds, known flags, origins and hit/free masks.
struct Grids {
  float* log_odds[kMaxRobots];
  uint8_t* known[kMaxRobots];
  const float* origins[kMaxRobots];
  uint8_t* hit[kMaxRobots];
  uint8_t* free[kMaxRobots];
};

// Robot strides of the per-robot inputs, in elements.
struct RobotStrides {
  long long returns, return_mask, misses, miss_mask, origin, active, do_insert;
};

__device__ inline void mark(uint8_t* masks, const float* grid_origin, float resolution,
                            int size, float x, float y) {
  float ci = floorf((x - grid_origin[0]) / resolution);
  float cj = floorf((y - grid_origin[1]) / resolution);
  if (ci >= 0.0f && ci < (float)size && cj >= 0.0f && cj < (float)size) {
    masks[(size_t)ci * size + (size_t)cj] = 1;
  }
}

// kRobots: a launch for several robots (blockIdx.y); one robot's launch
// instantiates the same bodies with r = 0, at the one-robot kernels' cost.
template <bool kRobots>
__global__ void mark_kernel(Grids grids, RobotStrides rs, const float* __restrict__ returns,
                            const uint8_t* __restrict__ return_mask,
                            const float* __restrict__ misses,
                            const uint8_t* __restrict__ miss_mask, int n,
                            const float* __restrict__ origin, float resolution, int size,
                            int samples, int insert_free_space,
                            const uint8_t* __restrict__ active,
                            const uint8_t* __restrict__ do_insert, int slots) {
  const long long r = kRobots ? blockIdx.y : 0;
  if (!do_insert[r * rs.do_insert]) return;
  returns += r * rs.returns;
  return_mask += r * rs.return_mask;
  misses += r * rs.misses;
  miss_mask += r * rs.miss_mask;
  origin += r * rs.origin;
  active += r * rs.active;
  const float* __restrict__ grid_origins = grids.origins[r];
  uint8_t* __restrict__ hit_masks = grids.hit[r];
  uint8_t* __restrict__ free_masks = grids.free[r];
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long per_slot = 2LL * n * samples;
  if (idx >= per_slot * slots) return;
  int slot = (int)(idx / per_slot);
  if (!active[slot]) return;
  long long rest = idx - slot * per_slot;
  int ray = (int)(rest / samples);
  int k = (int)(rest - (long long)ray * samples);
  const float* g = grid_origins + 2 * slot;
  size_t cells = (size_t)size * size;
  uint8_t* hit_mask = hit_masks + slot * cells;
  uint8_t* free_mask = free_masks + slot * cells;

  bool is_return = ray < n;
  int p = is_return ? ray : ray - n;
  if (is_return ? !return_mask[p] : !miss_mask[p]) return;
  const float* pts = is_return ? returns : misses;
  float px = pts[2 * p], py = pts[2 * p + 1];
  if (is_return && k == 0) mark(hit_mask, g, resolution, size, px, py);
  if (!insert_free_space) return;
  float t = (is_return ? (float)k : (float)k + 1.0f) / (float)samples;
  float ox = origin[0], oy = origin[1];
  mark(free_mask, g, resolution, size, ox + t * (px - ox), oy + t * (py - oy));
}

template <bool kRobots>
__global__ void apply_kernel(Grids grids, RobotStrides rs, const uint8_t* __restrict__ active,
                             const uint8_t* __restrict__ do_insert, long long cells,
                             int slots, float hit_log_odds, float miss_log_odds,
                             float min_log_odds, float max_log_odds) {
  const long long r = kRobots ? blockIdx.y : 0;
  if (!do_insert[r * rs.do_insert]) return;
  active += r * rs.active;
  float* __restrict__ log_odds = grids.log_odds[r];
  uint8_t* __restrict__ known = grids.known[r];
  uint8_t* __restrict__ hit_masks = grids.hit[r];
  uint8_t* __restrict__ free_masks = grids.free[r];
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= cells * slots) return;
  if (!active[idx / cells]) return;
  bool hit = hit_masks[idx] != 0;
  bool fre = free_masks[idx] != 0;
  if (hit) hit_masks[idx] = 0;
  if (fre) free_masks[idx] = 0;
  fre = fre && !hit;
  float lo = log_odds[idx];
  float updated = (lo + (hit ? hit_log_odds : 0.0f)) + (fre ? miss_log_odds : 0.0f);
  updated = fminf(fmaxf(updated, min_log_odds), max_log_odds);
  if (updated != lo) log_odds[idx] = updated;
  if ((hit || fre) && !known[idx]) known[idx] = 1;
}

}  // namespace

// `grids` (host memory): robots x (log_odds, known, grid origins, hit
// masks, free masks) device pointers, each robot's `slots` slots of size^2
// cells; `strides` (host memory): the robot strides of returns,
// return_mask, misses, miss_mask, origin, active, do_insert.
extern "C" int insert_2d(const void* const* grids, int robots, const void* returns,
                         const void* return_mask, const void* misses, const void* miss_mask,
                         int n, const void* origin, const void* active,
                         const void* do_insert, const void* strides, float resolution,
                         int size, int samples, int insert_free_space, int slots,
                         float hit_log_odds, float miss_log_odds, float min_log_odds,
                         float max_log_odds, void* stream) {
  if (grids == nullptr || strides == nullptr || robots < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  const long long* st = (const long long*)strides;
  RobotStrides rs = {st[0], st[1], st[2], st[3], st[4], st[5], st[6]};
  const long long marks = 2LL * n * samples * slots;
  const long long cells = (long long)size * size;
  for (int r0 = 0; r0 < robots; r0 += kMaxRobots) {
    const int count = min(kMaxRobots, robots - r0);
    Grids g = {};
    for (int r = 0; r < count; ++r) {
      const void* const* row = grids + 5 * (r0 + r);
      g.log_odds[r] = (float*)row[0];
      g.known[r] = (uint8_t*)row[1];
      g.origins[r] = (const float*)row[2];
      g.hit[r] = (uint8_t*)row[3];
      g.free[r] = (uint8_t*)row[4];
    }
    const uint8_t* act = (const uint8_t*)active + r0 * rs.active;
    const uint8_t* ins = (const uint8_t*)do_insert + r0 * rs.do_insert;
    const dim3 mark_grid((unsigned)((marks + threads - 1) / threads), count);
    auto mark = count == 1 ? mark_kernel<false> : mark_kernel<true>;
    mark<<<mark_grid, threads, 0, s>>>(
        g, rs, (const float*)returns + r0 * rs.returns,
        (const uint8_t*)return_mask + r0 * rs.return_mask,
        (const float*)misses + r0 * rs.misses, (const uint8_t*)miss_mask + r0 * rs.miss_mask,
        n, (const float*)origin + r0 * rs.origin, resolution, size, samples,
        insert_free_space, act, ins, slots);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 apply_grid((unsigned)((cells * slots + threads - 1) / threads), count);
    auto apply = count == 1 ? apply_kernel<false> : apply_kernel<true>;
    apply<<<apply_grid, threads, 0, s>>>(g, rs, act, ins, cells, slots, hit_log_odds,
                                        miss_log_odds, min_log_odds, max_log_odds);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
