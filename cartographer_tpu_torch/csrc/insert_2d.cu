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

__device__ inline void mark(uint8_t* masks, const float* grid_origin, float resolution,
                            int size, float x, float y) {
  float ci = floorf((x - grid_origin[0]) / resolution);
  float cj = floorf((y - grid_origin[1]) / resolution);
  if (ci >= 0.0f && ci < (float)size && cj >= 0.0f && cj < (float)size) {
    masks[(size_t)ci * size + (size_t)cj] = 1;
  }
}

__global__ void mark_kernel(const float* __restrict__ returns,
                            const uint8_t* __restrict__ return_mask,
                            const float* __restrict__ misses,
                            const uint8_t* __restrict__ miss_mask, int n,
                            const float* __restrict__ origin,
                            const float* __restrict__ grid_origins, float resolution,
                            int size, int samples, int insert_free_space,
                            const uint8_t* __restrict__ active,
                            const uint8_t* __restrict__ do_insert, int slots,
                            uint8_t* __restrict__ hit_masks,
                            uint8_t* __restrict__ free_masks) {
  if (!do_insert[0]) return;
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

__global__ void apply_kernel(float* __restrict__ log_odds, uint8_t* __restrict__ known,
                             uint8_t* __restrict__ hit_masks,
                             uint8_t* __restrict__ free_masks,
                             const uint8_t* __restrict__ active,
                             const uint8_t* __restrict__ do_insert, long long cells,
                             int slots, float hit_log_odds, float miss_log_odds,
                             float min_log_odds, float max_log_odds) {
  if (!do_insert[0]) return;
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

extern "C" int insert_2d(const void* returns, const void* return_mask, const void* misses,
                         const void* miss_mask, int n, const void* origin,
                         const void* grid_origins, float resolution, int size, int samples,
                         int insert_free_space, const void* active, const void* do_insert,
                         int slots, float hit_log_odds, float miss_log_odds,
                         float min_log_odds, float max_log_odds, void* log_odds,
                         void* known, void* hit_masks, void* free_masks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  long long marks = 2LL * n * samples * slots;
  mark_kernel<<<(unsigned)((marks + threads - 1) / threads), threads, 0, s>>>(
      (const float*)returns, (const uint8_t*)return_mask, (const float*)misses,
      (const uint8_t*)miss_mask, n, (const float*)origin, (const float*)grid_origins,
      resolution, size, samples, insert_free_space, (const uint8_t*)active,
      (const uint8_t*)do_insert, slots, (uint8_t*)hit_masks, (uint8_t*)free_masks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  long long cells = (long long)size * size;
  apply_kernel<<<(unsigned)((cells * slots + threads - 1) / threads), threads, 0, s>>>(
      (float*)log_odds, (uint8_t*)known, (uint8_t*)hit_masks, (uint8_t*)free_masks,
      (const uint8_t*)active, (const uint8_t*)do_insert, cells, slots, hit_log_odds,
      miss_log_odds, min_log_odds, max_log_odds);
  return (int)cudaGetLastError();
}
