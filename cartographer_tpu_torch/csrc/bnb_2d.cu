// K6 bnb_pyramid and K7 bnb_score
//
// K6 replaces: cartographer_tpu/ops/bnb_2d.py:build_precomputation_pyramid
// (l.60), with the probability image of ops/grid_2d.py:Grid2D.probability.
// Level 0 is the probability of each cell (1 / (1 + exp(-l)) where known,
// UNKNOWN elsewhere); level h is the max of level h-1 over the four cells
// (x, y) + {0, 2^(h-1)}^2, a cell beyond the high edge counting as UNKNOWN.
// That is the JAX form's max of the x- then the y-shifted level: max is
// exact, so the two agree bit for bit. One launch per level, one thread per
// cell. Bound: bytes, each level reads the previous one (4 MB at 1024^2,
// L2-resident) and writes 4 MB; 28 MB written for a depth-7 pyramid.
//
// bnb_pyramid_tsdf is K6's TSDF form: level 0 is the score surface of a TSDF
// grid, weight > 0 ? 1 - |tsd| / truncation : 0 (JAX ops/tsdf_2d.py:
// TsdfGrid2D.correspondence_score, l.71, which the JAX constraint builder
// reads through grid.probability(), constraint_builder_2d.py:195); the
// levels above, padded with UNKNOWN, are the same launches.
//
// K7 replaces: cartographer_tpu/ops/bnb_2d.py:_score_candidates (l.81), the
// scorer of the beam search fast_correlative_match_2d (l.101, beam path
// l.147-228) and of match_full_submap_exact (l.398).
// One warp per candidate (angle a, offset ox, oy): lane k reads the level
// value under the scan's precomputed cell of point k at angle a, shifted by
// the offset (UNKNOWN outside the map), masked points give 0, and the warp
// sums the point axis (a power of two) as a pairwise halving tree in shared
// memory, the plain twin's order, then divides by the valid count. Above
// kMaxPoints points each lane first folds its k over the points
// k + j * kMaxPoints in that tree's order (halving_fold.cuh), so a warp keeps
// at most kMaxPoints floats for any cloud and the sum keeps its bits. Bound:
// bytes and latency. A level-step of 16,384 candidates x 128 points gathers
// 2 M floats scattered over a 4 MB level (L2-resident); the cells (a few
// hundred KB) are read once per candidate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "halving_fold.cuh"

namespace {

constexpr float kUnknown = 0.1f;
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxPoints = 1024;  // a warp's shared tile of the point sum

__global__ void level0_kernel(const float* __restrict__ log_odds,
                              const uint8_t* __restrict__ known, int cells,
                              float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  out[i] = known[i] ? 1.0f / (1.0f + expf(-log_odds[i])) : kUnknown;
}

__global__ void level0_tsdf_kernel(const float* __restrict__ tsd,
                                   const float* __restrict__ weight, float truncation,
                                   int cells, float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  out[i] = weight[i] > 0.0f ? 1.0f - fabsf(tsd[i]) / truncation : 0.0f;
}

__global__ void level_kernel(const float* __restrict__ prev, int size, int shift,
                             float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size * size) return;
  int x = i / size, y = i % size;
  bool xi = x + shift < size, yi = y + shift < size;
  float v = prev[i];
  v = fmaxf(v, xi ? prev[i + shift * size] : kUnknown);
  v = fmaxf(v, yi ? prev[i + shift] : kUnknown);
  v = fmaxf(v, xi && yi ? prev[i + shift * size + shift] : kUnknown);
  out[i] = v;
}

__global__ void score_kernel(const float* __restrict__ level, int size,
                             const int* __restrict__ cells, int n,
                             const uint8_t* __restrict__ mask, const int* __restrict__ a_idx,
                             const int* __restrict__ ox, const int* __restrict__ oy, int b,
                             float* __restrict__ out) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kWarpsPerBlock + warp;
  if (c >= b) return;  // whole warps leave together; no block-wide barrier below
  const int tile = min(n, kMaxPoints), m = n / tile;
  float* s = smem + warp * tile;
  const int* base = cells + (size_t)a_idx[c] * n * 2;
  const int dx = ox[c], dy = oy[c];
  int count = 0;
  auto value = [&](int k) {
    float v = 0.0f;
    if (mask[k]) {
      int cx = base[2 * k] + dx, cy = base[2 * k + 1] + dy;
      bool inside = cx >= 0 && cx < size && cy >= 0 && cy < size;
      v = inside ? level[(size_t)cx * size + cy] : kUnknown;
      count += 1;
    }
    return v;
  };
  for (int k = lane; k < tile; k += 32)
    s[k] = halving::fold(m, [&](int j) { return value(k + j * tile); });
  for (int off = 16; off > 0; off >>= 1) count += __shfl_xor_sync(0xffffffffu, count, off);
  __syncwarp();
  for (int h = tile / 2; h >= 1; h >>= 1) {
    for (int k = lane; k < h; k += 32) s[k] = s[k] + s[k + h];
    __syncwarp();
  }
  if (lane == 0) out[c] = s[0] / (float)max(count, 1);
}

// Levels 1 .. depth - 1 over level 0 in `levels`.
int upper_levels(float* levels, int size, int depth, cudaStream_t s) {
  int cells = size * size;
  int threads = 256, blocks = (cells + threads - 1) / threads;
  for (int h = 1; h < depth; ++h) {
    level_kernel<<<blocks, threads, 0, s>>>(levels + (size_t)(h - 1) * cells, size,
                                            1 << (h - 1), levels + (size_t)h * cells);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bnb_pyramid(const void* log_odds, const void* known, int size, int depth,
                           void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int cells = size * size;
  int threads = 256, blocks = (cells + threads - 1) / threads;
  level0_kernel<<<blocks, threads, 0, s>>>((const float*)log_odds, (const uint8_t*)known,
                                           cells, (float*)out);
  return upper_levels((float*)out, size, depth, s);
}

extern "C" int bnb_pyramid_tsdf(const void* tsd, const void* weight, float truncation,
                                int size, int depth, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int cells = size * size;
  int threads = 256, blocks = (cells + threads - 1) / threads;
  level0_tsdf_kernel<<<blocks, threads, 0, s>>>((const float*)tsd, (const float*)weight,
                                                truncation, cells, (float*)out);
  return upper_levels((float*)out, size, depth, s);
}

extern "C" int bnb_score(const void* level, int size, const void* cells, int n,
                         const void* mask, const void* a_idx, const void* ox, const void* oy,
                         int b, void* out, void* stream) {
  if (n < 1 || (n & (n - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (b == 0) return (int)cudaGetLastError();
  int blocks = (b + kWarpsPerBlock - 1) / kWarpsPerBlock;
  size_t shared = (size_t)kWarpsPerBlock * (n < kMaxPoints ? n : kMaxPoints) * sizeof(float);
  score_kernel<<<blocks, 32 * kWarpsPerBlock, shared, (cudaStream_t)stream>>>(
      (const float*)level, size, (const int*)cells, n, (const uint8_t*)mask,
      (const int*)a_idx, (const int*)ox, (const int*)oy, b, (float*)out);
  return (int)cudaGetLastError();
}
