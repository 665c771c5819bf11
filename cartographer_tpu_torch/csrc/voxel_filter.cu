// K2 voxel_filter
//
// Replaces: cartographer_tpu/sensor/voxel_filter.py:voxel_filter_mask (l.67,
// with _packed_voxel_keys l.38) and adaptive_voxel_filter (l.97).
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
// Bound: operations, not bytes. A scan of 2048 points is 25 KB in and 2 KB
// out, but the adaptive filter makes up to 13 passes of hashing with shared
// memory atomics. Design: one block of 1024 threads per cloud; the table of
// next_pow2(2N) slots (8-byte key, 4-byte rank: 48 KB at N = 2048) with the
// inverse permutation and per-point slots lives in dynamic shared memory, so
// no pass touches device memory after the first load.
//
// Above kMaxSharedPoints (4,096) the table and the per-point arrays do not
// fit one block's shared memory. The same block then keeps them in a
// global-memory scratch the wrapper always passes (393 KB of table at N =
// 16,384, resident in the 50 MB L2) and runs the same passes over it with
// global atomics: one template, two storage places, the same mask bit for
// bit, and still no host synchronisation between the 13 passes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned long long kEmpty = 0xFFFFFFFFFFFFFFFFull;
constexpr int kThreads = 1024;
constexpr int kCoarseSteps = 7;
constexpr int kBisectSteps = 5;
constexpr int kMaxSharedPoints = 4096;

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
__global__ void voxel_filter_kernel(const float* __restrict__ points, int stride, int dim,
                                    const uint8_t* __restrict__ mask,
                                    const int* __restrict__ perm, int n, int slots,
                                    int adaptive, float resolution_or_max_length,
                                    int min_num_points, float max_range,
                                    uint8_t* __restrict__ keep, unsigned char* scratch) {
  extern __shared__ unsigned char smem[];
  __shared__ int counter;
  Shared s;
  s.keys = reinterpret_cast<unsigned long long*>(kGlobal ? scratch : smem);
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

// `scratch` holds voxel_filter_shared_bytes(n, slots) bytes (8-byte aligned),
// used when n > kMaxSharedPoints.
extern "C" int voxel_filter(const void* points, int stride, int dim, const void* mask,
                            const void* perm, int n, int slots, int adaptive,
                            float resolution_or_max_length, int min_num_points,
                            float max_range, void* keep, void* scratch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (n > kMaxSharedPoints) {
    voxel_filter_kernel<true><<<1, kThreads, 0, st>>>(
        (const float*)points, stride, dim, (const uint8_t*)mask, (const int*)perm, n, slots,
        adaptive, resolution_or_max_length, min_num_points, max_range, (uint8_t*)keep,
        (unsigned char*)scratch);
    return (int)cudaGetLastError();
  }
  int shared = voxel_filter_shared_bytes(n, slots);
  cudaError_t err = cudaFuncSetAttribute(
      voxel_filter_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return (int)err;
  voxel_filter_kernel<false><<<1, kThreads, shared, st>>>(
      (const float*)points, stride, dim, (const uint8_t*)mask, (const int*)perm, n, slots,
      adaptive, resolution_or_max_length, min_num_points, max_range, (uint8_t*)keep, nullptr);
  return (int)cudaGetLastError();
}
