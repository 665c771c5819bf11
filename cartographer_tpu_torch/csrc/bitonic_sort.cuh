// Bitonic sort of distinct 64-bit keys in device memory, ascending, in place,
// over as many blocks as the keys need. Included by K20 (tsdf_2d.cu) and
// K31 (voxel_filter.cu, whose keys repeat: equal keys
// end up together, in some order). K18, K30, K21 and K28 add in input order
// through in_order_scatter.cuh instead.
//
// The count is a power of two. Every stage k and step j of the network that
// stays within a tile of kSortTile keys runs in shared memory, one tile per
// block: first all stages up to the tile's size in one launch, then, for
// each larger stage, one launch per step j >= kSortTile over device memory
// (one compare-exchange per thread) and one launch for the steps below it in
// shared memory. The direction of each compare-exchange comes from the
// key's global index, so the blocks' runs merge into one ascending order.
// With distinct keys the result is the one sorted order, whatever the
// launch layout: a (value, index) key sorts stably by value.
//
// sort_segments sorts several independent runs of one power-of-two count
// side by side (K20's robots) with the same launches as one run: the
// network runs stages up to the run's count over all the keys, and the last
// stage sorts every run ascending.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bitonic {

constexpr int kSortTile = 8192;  // keys per block: 64 KB of shared memory
constexpr int kSortThreads = 1024;

// Steps j = j_start, j_start / 2, ..., 1 of stage k on the tile in `s`
// whose first key has global index `base`; stage `span` (the run's count)
// sorts ascending.
__device__ inline void tile_steps(unsigned long long* s, int tile, int base, int k, int j_start,
                                  int span) {
  for (int j = j_start; j > 0; j >>= 1) {
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
      int l = i ^ j;
      if (l > i) {
        unsigned long long a = s[i], b = s[l];
        if ((a > b) == (k == span || ((base + i) & k) == 0)) {
          s[i] = b;
          s[l] = a;
        }
      }
    }
    __syncthreads();
  }
}

// Stages 2 .. tile of each tile; `tile` = min(kSortTile, span).
__global__ void __launch_bounds__(kSortThreads)
    sort_tiles(unsigned long long* __restrict__ keys, int tile, int span) {
  extern __shared__ unsigned long long s[];
  const int base = blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) s[i] = keys[base + i];
  __syncthreads();
  for (int k = 2; k <= tile; k <<= 1) tile_steps(s, tile, base, k, k >> 1, span);
  for (int i = threadIdx.x; i < tile; i += blockDim.x) keys[base + i] = s[i];
}

// One step j >= kSortTile of stage k: pair p compares keys i and i + j.
__global__ void merge_step(unsigned long long* __restrict__ keys, int count, int k, int j,
                           int span) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= count / 2) return;
  int i = (p / j) * 2 * j + (p % j);
  int l = i + j;
  unsigned long long a = keys[i], b = keys[l];
  if ((a > b) == (k == span || (i & k) == 0)) {
    keys[i] = b;
    keys[l] = a;
  }
}

// Steps kSortTile / 2 .. 1 of stage k, one tile per block.
__global__ void __launch_bounds__(kSortThreads)
    merge_tiles(unsigned long long* __restrict__ keys, int k, int span) {
  extern __shared__ unsigned long long s[];
  const int base = blockIdx.x * kSortTile;
  for (int i = threadIdx.x; i < kSortTile; i += blockDim.x) s[i] = keys[base + i];
  __syncthreads();
  tile_steps(s, kSortTile, base, k, kSortTile >> 1, span);
  for (int i = threadIdx.x; i < kSortTile; i += blockDim.x) keys[base + i] = s[i];
}

// Sorts `segments` runs of `count` keys each (keys[s * count, (s + 1) *
// count)) ascending, each on its own; count is a power of two >= 2.
inline cudaError_t sort_segments(unsigned long long* keys, int count, int segments,
                                 cudaStream_t stream) {
  if (segments < 1 || count < 2 || (count & (count - 1)) != 0 ||
      (long long)count * segments > 0x7FFFFFFFll)
    return cudaErrorInvalidValue;
  const int total = count * segments;
  const int tile = count < kSortTile ? count : kSortTile;
  const size_t bytes = (size_t)tile * sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(sort_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  sort_tiles<<<total / tile, kSortThreads, bytes, stream>>>(keys, tile, count);
  if (count <= kSortTile) return cudaGetLastError();
  err = cudaFuncSetAttribute(merge_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  const int pairs = total / 2, threads = 256;
  for (int k = 2 * kSortTile; k <= count; k <<= 1) {
    for (int j = k >> 1; j >= kSortTile; j >>= 1) {
      merge_step<<<(pairs + threads - 1) / threads, threads, 0, stream>>>(keys, total, k, j,
                                                                           count);
    }
    merge_tiles<<<total / kSortTile, kSortThreads, bytes, stream>>>(keys, k, count);
  }
  return cudaGetLastError();
}

// Sorts keys[0, count) ascending; count is a power of two >= 2.
inline cudaError_t sort(unsigned long long* keys, int count, cudaStream_t stream) {
  return sort_segments(keys, count, 1, stream);
}

}  // namespace bitonic
