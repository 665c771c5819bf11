// K2 voxel_filter, K31 voxel_filter_edge
//
// K2 replaces: cartographer_tpu/sensor/voxel_filter.py:voxel_filter_mask
// (l.67, with _packed_voxel_keys l.38) and adaptive_voxel_filter (l.97).
// K31 replaces voxel_filter_edge (l.145, with _run_boundaries l.25); see its
// section at the end of this file.
//
// The JAX filter shuffles the cloud with a permutation, stable-sorts it by
// packed voxel key and keeps the last point of each run of equal keys. The
// last point of a run is the one with the highest position in the shuffled
// order, so here every valid point inserts its key into an open-addressing
// hash in shared memory and does atomicMax with its rank (its position in
// the permutation); a point is kept when its rank is its voxel's maximum.
// With the same permutation the mask is bit-identical to the JAX one.
// The number of voxels is the number of keys a point inserted first.
//
// Keys: floor(p / resolution + 0.5) per axis (a division, as JAX, not a
// reciprocal multiply), clipped to [-2^15, 2^15 - 2] and biased by 2^15;
// x and y packed into one 32-bit word, z (3D clouds) into a second word.
//
// The adaptive filter's range gate, 7 halving lengths, 5 bisection steps and
// final mask all run inside one launch: the counts never leave the block.
//
// Robots and filters: blockIdx.x is the robot of a cross-robot batch (the
// JAX package vmaps the step over robots), each with its own cloud, mask
// and permutation (robot 0's plus the robot times a robot stride in
// elements); blockIdx.y picks one of up to two filters that read the same
// clouds, so a scan's two adaptive filters (the matcher's and the loop
// closure's) share one launch. The keep-masks are (filters, robots, n).
// One cloud and one filter is the grid's 1 x 1 case.
//
// Bound: operations, not bytes. A scan of 2048 points is 25 KB in and 2 KB
// out, but the adaptive filter makes up to 13 passes of hashing with shared
// memory atomics. Design: one block of 1024 threads per cloud; the table of
// next_pow2(2N) slots (8-byte key, 4-byte rank: 48 KB at N = 2048) with the
// inverse permutation and per-point slots lives in dynamic shared memory, so
// no pass touches device memory after the first load.
//
// Above kMaxSharedPoints (4,096) the table and the per-point arrays do not
// fit one block's shared memory. The same block then keeps them in a
// global-memory scratch the wrapper passes, one slice per (filter, robot)
// (393 KB of table at N = 16,384, resident in the 50 MB L2), and runs the
// same passes over it with
// global atomics: one template, two storage places, the same mask bit for
// bit, and still no host synchronisation between the 13 passes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitonic_sort.cuh"

namespace {

constexpr unsigned long long kEmpty = 0xFFFFFFFFFFFFFFFFull;
constexpr int kThreads = 1024;
constexpr int kCoarseSteps = 7;
constexpr int kBisectSteps = 5;
constexpr int kMaxSharedPoints = 4096;
constexpr int kMaxFilters = 2;

// Per filter (blockIdx.y): the resolution, or the adaptive filter's
// max_length, min_num_points and max_range.
struct Filters {
  float length[kMaxFilters];
  int min_num_points[kMaxFilters];
  float max_range[kMaxFilters];
};

struct Shared {
  unsigned long long* keys;  // [slots]
  unsigned int* ranks;       // [slots]
  int* inv;                  // [n] rank of point i in the permutation
  int* slot;                 // [n] table slot of point i (final pass)
  uint8_t* base;             // [n] points taking part
};

__device__ inline int axis_index(float v, float resolution) {
  float f = floorf(v / resolution + 0.5f);
  f = fminf(fmaxf(f, -32768.0f), 32766.0f);
  return (int)f + 32768;
}

__device__ inline unsigned long long voxel_key(const float* p, int dim, float resolution) {
  unsigned int ix = axis_index(p[0], resolution);
  unsigned int iy = axis_index(p[1], resolution);
  unsigned long long key = (ix << 16) | iy;
  if (dim == 3) key |= (unsigned long long)axis_index(p[2], resolution) << 32;
  return key;
}

// Inserts `key`; returns its slot and sets *is_new for the inserting thread.
__device__ inline int insert_key(unsigned long long* keys, unsigned int mask,
                                 unsigned long long key, bool* is_new) {
  unsigned int h = (unsigned int)((key * 0x9E3779B97F4A7C15ull) >> 32) & mask;
  while (true) {
    unsigned long long prev = atomicCAS(&keys[h], kEmpty, key);
    if (prev == kEmpty) {
      *is_new = true;
      return (int)h;
    }
    if (prev == key) {
      *is_new = false;
      return (int)h;
    }
    h = (h + 1) & mask;
  }
}

__device__ void clear_table(const Shared& s, int slots) {
  for (int k = threadIdx.x; k < slots; k += blockDim.x) {
    s.keys[k] = kEmpty;
    s.ranks[k] = 0u;
  }
}

// Number of distinct voxels among the base points at `resolution`.
__device__ int count_voxels(const Shared& s, int* counter, const float* points,
                            int stride, int dim, int n, int slots, float resolution) {
  clear_table(s, slots);
  if (threadIdx.x == 0) *counter = 0;
  __syncthreads();
  int local = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (!s.base[i]) continue;
    bool is_new;
    insert_key(s.keys, slots - 1, voxel_key(points + (size_t)i * stride, dim, resolution),
               &is_new);
    local += is_new;
  }
  if (local) atomicAdd(counter, local);
  __syncthreads();
  int count = *counter;
  __syncthreads();
  return count;
}

// Keep-mask of the highest-ranked base point of every voxel.
__device__ void final_mask(const Shared& s, const float* points, int stride, int dim,
                           int n, int slots, float resolution, uint8_t* keep) {
  clear_table(s, slots);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (!s.base[i]) continue;
    bool is_new;
    int h = insert_key(s.keys, slots - 1,
                       voxel_key(points + (size_t)i * stride, dim, resolution), &is_new);
    s.slot[i] = h;
    atomicMax(&s.ranks[h], (unsigned int)s.inv[i]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    keep[i] = s.base[i] && s.ranks[s.slot[i]] == (unsigned int)s.inv[i];
  }
}

// kGlobal: the table and per-point arrays live in `scratch` (device memory)
// instead of dynamic shared memory.
template <bool kGlobal>
__global__ void voxel_filter_kernel(const float* __restrict__ points, int stride,
                                    long long points_rs, int dim,
                                    const uint8_t* __restrict__ mask, long long mask_rs,
                                    const int* __restrict__ perm, long long perm_rs, int n,
                                    int slots, int adaptive, Filters filters,
                                    uint8_t* __restrict__ keep, unsigned char* scratch,
                                    long long slice) {
  extern __shared__ unsigned char smem[];
  __shared__ int counter;
  const long long r = blockIdx.x, f = blockIdx.y;
  points += r * points_rs;
  mask += r * mask_rs;
  perm += r * perm_rs;
  keep += (f * gridDim.x + r) * n;
  const float resolution_or_max_length = filters.length[f];
  const int min_num_points = filters.min_num_points[f];
  const float max_range = filters.max_range[f];
  Shared s;
  s.keys = reinterpret_cast<unsigned long long*>(
      kGlobal ? scratch + (f * gridDim.x + r) * slice : smem);
  s.ranks = reinterpret_cast<unsigned int*>(s.keys + slots);
  s.inv = reinterpret_cast<int*>(s.ranks + slots);
  s.slot = s.inv + n;
  s.base = reinterpret_cast<uint8_t*>(s.slot + n);

  if (threadIdx.x == 0) counter = 0;
  __syncthreads();
  int local = 0;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    int i = perm[j];
    if (i >= 0 && i < n) s.inv[i] = j;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    bool b = mask[i] != 0;
    if (adaptive) {
      const float* p = points + (size_t)i * stride;
      float sq = 0.0f;
      for (int d = 0; d < dim; ++d) sq += p[d] * p[d];
      b = b && sqrtf(sq) <= max_range;
    }
    s.base[i] = b;
    local += b;
  }
  if (local) atomicAdd(&counter, local);
  __syncthreads();
  const int num_base = counter;
  __syncthreads();

  float resolution = resolution_or_max_length;
  if (adaptive) {
    if (num_base <= min_num_points) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) keep[i] = s.base[i];
      return;
    }
    const float max_length = resolution_or_max_length;
    int first_ok = -1;
    for (int k = 0; k < kCoarseSteps; ++k) {
      float length = max_length / (float)(1 << k);
      if (count_voxels(s, &counter, points, stride, dim, n, slots, length) >=
          min_num_points) {
        first_ok = k;
        break;
      }
    }
    if (first_ok < 0) {
      resolution = max_length / (float)(1 << (kCoarseSteps - 1));
    } else if (first_ok == 0) {
      resolution = max_length;
    } else {
      float low = max_length / (float)(1 << first_ok);
      float high = max_length / (float)(1 << (first_ok - 1));
      for (int step = 0; step < kBisectSteps; ++step) {
        float mid = 0.5f * (low + high);
        if (count_voxels(s, &counter, points, stride, dim, n, slots, mid) >=
            min_num_points) {
          low = mid;
        } else {
          high = mid;
        }
      }
      resolution = low;
    }
  }
  final_mask(s, points, stride, dim, n, slots, resolution, keep);
}

}  // namespace

extern "C" int voxel_filter_shared_bytes(int n, int slots) {
  return slots * (8 + 4) + n * (4 + 4 + 1);
}

// The scratch bytes of one (filter, robot) block: voxel_filter_shared_bytes
// rounded up to 8.
extern "C" long long voxel_filter_scratch_slice(int n, int slots) {
  return ((long long)voxel_filter_shared_bytes(n, slots) + 7) / 8 * 8;
}

// `points`, `mask` and `perm` are robot 0's; robot r's lie `*_rs` elements
// further. `filters` (1 or 2) filters, filter k of parameters (length_k,
// min_num_points_k, max_range_k), each run over every robot's cloud into
// keep[filter][robot]; without `adaptive` the length is the resolution. `scratch` holds filters
// x robots x voxel_filter_scratch_slice(n, slots) bytes (8-byte aligned),
// used when n > kMaxSharedPoints.
extern "C" int voxel_filter(const void* points, int stride, long long points_rs, int dim,
                            const void* mask, long long mask_rs, const void* perm,
                            long long perm_rs, int n, int slots, int robots, int filters,
                            int adaptive, float length0, int min_num_points0,
                            float max_range0, float length1, int min_num_points1,
                            float max_range1, void* keep, void* scratch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (scratch == nullptr || robots < 1 || filters < 1 || filters > kMaxFilters)
    return (int)cudaErrorInvalidValue;
  Filters f = {{length0, length1}, {min_num_points0, min_num_points1},
               {max_range0, max_range1}};
  const dim3 grid(robots, filters);
  const long long slice = voxel_filter_scratch_slice(n, slots);
  if (n > kMaxSharedPoints) {
    voxel_filter_kernel<true><<<grid, kThreads, 0, st>>>(
        (const float*)points, stride, points_rs, dim, (const uint8_t*)mask, mask_rs,
        (const int*)perm, perm_rs, n, slots, adaptive, f, (uint8_t*)keep,
        (unsigned char*)scratch, slice);
    return (int)cudaGetLastError();
  }
  int shared = voxel_filter_shared_bytes(n, slots);
  // Raised once per device to the largest size asked so far, so that a
  // launch under stream capture makes no attribute call.
  static int configured_device = -1, configured_bytes = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device != configured_device || shared > configured_bytes) {
    err = cudaFuncSetAttribute(voxel_filter_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return (int)err;
    configured_device = device;
    configured_bytes = shared;
  }
  voxel_filter_kernel<false><<<grid, kThreads, shared, st>>>(
      (const float*)points, stride, points_rs, dim, (const uint8_t*)mask, mask_rs,
      (const int*)perm, perm_rs, n, slots, adaptive, f, (uint8_t*)keep, nullptr, 0);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- K31
//
// The fork's edge filter: keep the valid points whose voxel holds fewer than
// int32(float32(max_count) * float32(ratio)) valid points, max_count being
// the largest voxel's population. The JAX program lexsorts the packed keys,
// counts each run and takes the maximum over the valid points.
//
// Here: one launch writes K2's packed voxel key per valid point (the key
// code above: a true division, floor(p / resolution + 0.5), clipped and
// biased fields, z in the high word) and an all-ones sentinel for masked
// points and the padding to a power of two; bitonic_sort.cuh sorts them
// (any size); then one thread per valid point finds its key's run in the
// sorted keys by two binary searches, so the run's length is its count,
// and takes the block's maximum in shared memory and the cloud's with one
// atomicMax per block; a last launch applies the threshold. Masked points
// never reach the maximum, and every output is an integer, so the mask
// equals the twin's and the JAX program's exactly.
//
// Bound: bytes, N points and flags read and N flags written once; the sort's
// passes and the binary searches (2 log2 N reads of L2 per point) make it
// latency-bound.

namespace {

constexpr int kEdgeThreads = 256;

__global__ void edge_keys_kernel(const float* __restrict__ points, int stride, int dim,
                                 const uint8_t* __restrict__ mask, int n, int npad,
                                 float resolution, unsigned long long* __restrict__ keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npad) return;
  keys[i] = (i < n && mask[i]) ? voxel_key(points + (size_t)i * stride, dim, resolution)
                               : kEmpty;
}

// The first position in keys[0, count) whose key is >= v.
__device__ inline int first_not_below(const unsigned long long* keys, int count,
                                      unsigned long long v) {
  int lo = 0, hi = count;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void edge_counts_kernel(const float* __restrict__ points, int stride, int dim,
                                   const uint8_t* __restrict__ mask, int n, int npad,
                                   float resolution,
                                   const unsigned long long* __restrict__ sorted,
                                   int* __restrict__ counts, int* __restrict__ max_count) {
  __shared__ int block_max;
  if (threadIdx.x == 0) block_max = 0;
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    int c = 0;
    if (mask[i]) {
      // Valid keys are below 0xFFFE'FFFE'FFFF, so key + 1 does not wrap.
      const unsigned long long key =
          voxel_key(points + (size_t)i * stride, dim, resolution);
      c = first_not_below(sorted, npad, key + 1) - first_not_below(sorted, npad, key);
      atomicMax(&block_max, c);
    }
    counts[i] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0 && block_max > 0) atomicMax(max_count, block_max);
}

__global__ void edge_keep_kernel(const uint8_t* __restrict__ mask, int n,
                                 const int* __restrict__ counts,
                                 const int* __restrict__ max_count, float ratio,
                                 uint8_t* __restrict__ keep) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int threshold = (int)((float)*max_count * ratio);  // truncates, as astype(int32)
  keep[i] = mask[i] && counts[i] < threshold;
}

}  // namespace

// `keys` holds max(2, next_pow2(n)) int64 of scratch, `counts` n + 1 int32
// (the last one the maximum).
extern "C" int voxel_filter_edge(const void* points, int stride, int dim, const void* mask,
                                 int n, float resolution, float ratio, void* keep, void* keys,
                                 void* counts, void* stream) {
  if (n < 1 || (dim != 2 && dim != 3) || keys == nullptr || counts == nullptr)
    return (int)cudaErrorInvalidValue;
  int npad = 2;
  while (npad < n) npad <<= 1;
  cudaStream_t st = (cudaStream_t)stream;
  int* max_count = (int*)counts + n;
  cudaError_t err = cudaMemsetAsync(max_count, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  unsigned long long* k = (unsigned long long*)keys;
  edge_keys_kernel<<<(npad + kEdgeThreads - 1) / kEdgeThreads, kEdgeThreads, 0, st>>>(
      (const float*)points, stride, dim, (const uint8_t*)mask, n, npad, resolution, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = bitonic::sort(k, npad, st);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kEdgeThreads - 1) / kEdgeThreads;
  edge_counts_kernel<<<blocks, kEdgeThreads, 0, st>>>(
      (const float*)points, stride, dim, (const uint8_t*)mask, n, npad, resolution, k,
      (int*)counts, max_count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  edge_keep_kernel<<<blocks, kEdgeThreads, 0, st>>>((const uint8_t*)mask, n,
                                                     (const int*)counts, max_count, ratio,
                                                     (uint8_t*)keep);
  return (int)cudaGetLastError();
}
