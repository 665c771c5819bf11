// K12 rot_histogram, rot_histogram_rotate; K13 rot_match
//
// K12 replaces: cartographer_tpu/ops/rot_histogram.py:compute_rotational_histogram
// (l.27) and rotate_histogram (l.94). K13 replaces match_histograms (l.107).
//
// Up to kMaxPoints points one block computes a scan's histogram, one thread
// per point of the cloud padded to a power of two (32..1024):
//   1. z-min of the valid points, the 0.2 m slice of each point;
//   2. per-slice sums of x and y and counts, the centroids;
//   3. the angle around the slice's centroid, the keep test at 0.2 m, and a
//      64-bit sort key (slice at bit 54, order-preserving angle bits at 22,
//      the point index in 22 bits): sorting it is the stable sort by
//      (slice, angle) of jnp.lexsort;
//   4. a bitonic sort of the keys in shared memory;
//   5. the anchor walk, sequential inside a slice and independent across
//      slices: the thread at the start of each run of equal slices walks it;
//   6. the accumulation of the weights into the bins.
// The JAX program adds the slice sums and the bins by scatter-add. Here both
// are added in one fixed order, a pairwise halving tree over the (padded)
// points, by one warp per slice or bin, as the plain twin adds them: a sum
// that differs in its last bit can flip the 0.2 m tests or a bin edge.
//
// Above kMaxPoints (the large form) the same steps run as one block of 1,024
// threads, each looping over its points, on a device-memory scratch: steps
// 1-3 in one launch, the sort over the keys in device memory by the
// multi-block bitonic network of bitonic_sort.cuh (the keys are distinct,
// so it gives the one sorted order), steps 5-6 in a second launch. A warp's
// halving tree over more than 1,024 values first folds each lane's values in
// that tree's order (halving_fold.cuh). The results equal the one-block
// form's and the twin's to the bit at any cloud size and bin count.
//
// rot_histogram_rotate shifts a histogram by a yaw that lives on the device,
// with linear interpolation between bins.
//
// rot_match (K13) scores candidate yaws, one block per yaw and one thread per
// bin (padded to a power of two; above 1,024 bins each of 1,024 threads
// folds its bins k + j * 1,024 in the tree's order first): the bin of the
// scan histogram rotated by the yaw (the shift floor(angle * size / pi) and
// its fractional blend, as rot_histogram_rotate), then the dot product with
// the submap histogram and both squared norms, each summed as the halving
// tree of the plain twin, and the cosine dot / max(|r| |s|, 1e-9). Bound:
// latency; 1259 yaws x 120 bins read 0.6 MB of L1-resident histograms and do
// some 1 M operations.
//
// Bound: latency. 512 points are 6.5 KB; the block runs a chain of a sort
// (45 compare-exchange rounds at 512 keys), 129 + 120 warp reductions and
// the walk. Design: up to 1,024 points everything stays in shared memory,
// one launch; above, the large form's three launches and its warps' folds
// cost more per point (PERF.md, row 16a).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bitonic_sort.cuh"
#include "halving_fold.cuh"

namespace {

constexpr int kMaxPoints = 1024;  // one block, one thread per point or bin
constexpr int kSliceShift = 54;
constexpr int kAngleShift = 22;
constexpr unsigned long long kIndexMask = (1ull << kAngleShift) - 1;
constexpr int kMaxSlices = 128;
constexpr float kMinDistance = 0.2f;
constexpr float kMaxDistance = 0.9f;
constexpr float kSliceHeight = 0.2f;
constexpr float kPi = 3.14159274101257324f;  // float32(pi)

// Sum over the n values value(i), i < n (n a power of two >= 32), as the
// halving tree x[i] + x[i + n / 2] ...; one warp, the result in lane 0.
template <typename F>
__device__ inline float warp_tree_sum(int n, F value) {
  const int lane = threadIdx.x & 31;
  const int per_lane = n >> 5;
  float a;
  if (per_lane <= 32) {
    float v[32];
    for (int k = 0; k < per_lane; ++k) v[k] = value(lane + 32 * k);
    for (int half = per_lane >> 1; half > 0; half >>= 1)
      for (int k = 0; k < half; ++k) v[k] = v[k] + v[k + half];
    a = v[0];
  } else {
    a = halving::fold(per_lane, [&](int k) { return value(lane + 32 * k); });
  }
  for (int off = 16; off > 0; off >>= 1) a = a + __shfl_down_sync(0xffffffffu, a, off);
  return a;
}

__device__ inline unsigned int ordered_bits(float x) {
  unsigned int b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ inline float norm2(float x, float y) { return sqrtf(x * x + y * y); }

__device__ inline unsigned long long sort_key(int slice, float angle, int i) {
  return ((unsigned long long)slice << kSliceShift) |
         ((unsigned long long)ordered_bits(angle) << kAngleShift) | (unsigned long long)i;
}

// The anchor walk over the run of sorted positions i.. of slice `s` (the
// run's first position): the weight and bin of each emitted direction.
__device__ inline void anchor_walk(int i, int s, int padded, int bins,
                                   const unsigned long long* key, const float* sx,
                                   const float* sy, const float* cx, const float* cy, int* bin,
                                   float* weight) {
  if (s >= kMaxSlices) return;
  const float centroid_x = cx[s], centroid_y = cy[s];
  float last_x = sx[i], last_y = sy[i];
  for (int j = i; j < padded && (j == i || (int)(key[j] >> kSliceShift) == s); ++j) {
    float ddx = sx[j] - last_x, ddy = sy[j] - last_y;
    float ex = sx[j] - centroid_x, ey = sy[j] - centroid_y;
    float distance = norm2(ddx, ddy), dirn = norm2(ex, ey);
    bool emit = j != i && distance >= kMinDistance && dirn >= kMinDistance &&
                distance <= kMaxDistance;
    if (emit) {
      float md = fmaxf(distance, 1e-9f), mn = fmaxf(dirn, 1e-9f);
      float dot = (ddx / md) * (ex / mn) + (ddy / md) * (ey / mn);
      float a = fmodf(atan2f(ddy, ddx), kPi);
      if (a != 0.0f && a < 0.0f) a = a + kPi;
      float b = floorf(((float)bins * a) / kPi - 0.5f + 0.5f);
      bin[j] = (int)fminf(fmaxf(b, 0.0f), (float)(bins - 1));
      weight[j] = fmaxf(1.0f - fabsf(dot), 0.0f);
    }
    if (distance > kMaxDistance && dirn >= kMinDistance) {
      last_x = sx[j];
      last_y = sy[j];
    }
  }
}

__global__ void rot_histogram_kernel(const float* __restrict__ points,
                                     const uint8_t* __restrict__ mask, int n, int padded,
                                     int bins, float* __restrict__ histogram) {
  __shared__ float px[kMaxPoints], py[kMaxPoints];  // the cloud, then the sorted cloud
  __shared__ float sx[kMaxPoints], sy[kMaxPoints];  // sorted x, y; then weights
  __shared__ int slice[kMaxPoints];                 // slice, then bin of each sorted point
  __shared__ unsigned long long key[kMaxPoints];
  __shared__ float reduce[kMaxPoints];
  __shared__ float cx[kMaxSlices + 1], cy[kMaxSlices + 1];

  const int i = threadIdx.x;  // blockDim.x == padded
  const int warp = i >> 5, lane = i & 31, warps = padded >> 5;
  const bool valid = i < n && mask[i];
  const float x = i < n ? points[3 * i] : 0.0f;
  const float y = i < n ? points[3 * i + 1] : 0.0f;
  const float z = i < n ? points[3 * i + 2] : 0.0f;

  // 1. z-min and slices.
  reduce[i] = valid ? z : INFINITY;
  __syncthreads();
  for (int half = padded >> 1; half > 0; half >>= 1) {
    if (i < half) reduce[i] = fminf(reduce[i], reduce[i + half]);
    __syncthreads();
  }
  const float zmin = reduce[0];
  int s = (int)fminf(fmaxf(floorf((z - zmin) / kSliceHeight), 0.0f), (float)(kMaxSlices - 1));
  if (!valid) s = kMaxSlices;
  slice[i] = s;
  px[i] = x;
  py[i] = y;
  __syncthreads();

  // 2. Centroids: one warp per slice.
  for (int t = warp; t <= kMaxSlices; t += warps) {
    float sum_x = warp_tree_sum(padded, [&](int k) { return slice[k] == t ? px[k] : 0.0f; });
    float sum_y = warp_tree_sum(padded, [&](int k) { return slice[k] == t ? py[k] : 0.0f; });
    int count = 0;
    for (int k = lane; k < padded; k += 32) count += slice[k] == t && t < kMaxSlices;
    for (int off = 16; off > 0; off >>= 1) count += __shfl_down_sync(0xffffffffu, count, off);
    if (lane == 0) {
      float c = fmaxf((float)count, 1.0f);
      cx[t] = (t < kMaxSlices ? sum_x : 0.0f) / c;
      cy[t] = (t < kMaxSlices ? sum_y : 0.0f) / c;
    }
  }
  __syncthreads();

  // 3. Sort keys.
  {
    float dx = x - cx[s], dy = y - cy[s];
    float angle = atan2f(dy, dx) + 0.0f;
    bool keep = valid && norm2(dx, dy) >= kMinDistance;
    key[i] = sort_key(keep ? s : kMaxSlices, angle, i);
  }
  __syncthreads();

  // 4. Bitonic sort, ascending.
  for (int size = 2; size <= padded; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      int partner = i ^ stride;
      if (partner > i) {
        bool ascending = (i & size) == 0;
        unsigned long long a = key[i], b = key[partner];
        if ((a > b) == ascending) {
          key[i] = b;
          key[partner] = a;
        }
      }
      __syncthreads();
    }
  }

  // Sorted cloud: position i holds point key & kIndexMask of slice key >> 54.
  const int src = (int)(key[i] & kIndexMask);
  const int my_slice = (int)(key[i] >> kSliceShift);
  sx[i] = px[src];
  sy[i] = py[src];
  __syncthreads();
  px[i] = 0.0f;       // weight of sorted point i
  slice[i] = 0;       // bin of sorted point i
  __syncthreads();

  // 5. The anchor walk: the first thread of each run of a valid slice.
  if (i == 0 || (int)(key[i - 1] >> kSliceShift) != my_slice)
    anchor_walk(i, my_slice, padded, bins, key, sx, sy, cx, cy, slice, px);
  __syncthreads();

  // 6. Bins: one warp per bin.
  for (int b = warp; b < bins; b += warps) {
    float sum = warp_tree_sum(padded, [&](int k) { return slice[k] == b ? px[k] : 0.0f; });
    if (lane == 0) histogram[b] = sum;
  }
}

// The large form's scratch (padded = the power of two that holds the n
// points): sorted x and y, the weights, the slice of each point and then the
// bin of each sorted position (int), the centroids (kMaxSlices + 1 each).
struct Scratch {
  float* sx;
  float* sy;
  float* weight;
  int* slice;
  float* cx;
  float* cy;
  unsigned long long* key;
};

// Steps 1-3 of the large form: one block of kMaxPoints threads.
__global__ void __launch_bounds__(kMaxPoints)
    large_keys_kernel(const float* __restrict__ points, const uint8_t* __restrict__ mask, int n,
                      int padded, Scratch w) {
  __shared__ float reduce[kMaxPoints];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  auto x = [&](int i) { return i < n ? points[3 * i] : 0.0f; };
  auto y = [&](int i) { return i < n ? points[3 * i + 1] : 0.0f; };
  auto valid = [&](int i) { return i < n && mask[i]; };

  // 1. z-min (a minimum: any order gives its bits) and slices.
  float zmin = INFINITY;
  for (int i = threadIdx.x; i < padded; i += blockDim.x)
    if (valid(i)) zmin = fminf(zmin, points[3 * i + 2]);
  reduce[threadIdx.x] = zmin;
  __syncthreads();
  for (int half = blockDim.x >> 1; half > 0; half >>= 1) {
    if ((int)threadIdx.x < half)
      reduce[threadIdx.x] = fminf(reduce[threadIdx.x], reduce[threadIdx.x + half]);
    __syncthreads();
  }
  zmin = reduce[0];
  for (int i = threadIdx.x; i < padded; i += blockDim.x) {
    const float z = i < n ? points[3 * i + 2] : 0.0f;
    int s = (int)fminf(fmaxf(floorf((z - zmin) / kSliceHeight), 0.0f), (float)(kMaxSlices - 1));
    w.slice[i] = valid(i) ? s : kMaxSlices;
  }
  __syncthreads();

  // 2. Centroids: one warp per slice.
  for (int t = warp; t <= kMaxSlices; t += warps) {
    float sum_x = warp_tree_sum(padded, [&](int k) { return w.slice[k] == t ? x(k) : 0.0f; });
    float sum_y = warp_tree_sum(padded, [&](int k) { return w.slice[k] == t ? y(k) : 0.0f; });
    int count = 0;
    for (int k = lane; k < padded; k += 32) count += w.slice[k] == t && t < kMaxSlices;
    for (int off = 16; off > 0; off >>= 1) count += __shfl_down_sync(0xffffffffu, count, off);
    if (lane == 0) {
      float c = fmaxf((float)count, 1.0f);
      w.cx[t] = (t < kMaxSlices ? sum_x : 0.0f) / c;
      w.cy[t] = (t < kMaxSlices ? sum_y : 0.0f) / c;
    }
  }
  __syncthreads();

  // 3. Sort keys.
  for (int i = threadIdx.x; i < padded; i += blockDim.x) {
    const int s = w.slice[i];
    float dx = x(i) - w.cx[s], dy = y(i) - w.cy[s];
    float angle = atan2f(dy, dx) + 0.0f;
    bool keep = valid(i) && norm2(dx, dy) >= kMinDistance;
    w.key[i] = sort_key(keep ? s : kMaxSlices, angle, i);
  }
}

// Steps 5-6 of the large form, after the sort: one block of kMaxPoints threads.
__global__ void __launch_bounds__(kMaxPoints)
    large_bins_kernel(const float* __restrict__ points, int n, int padded, int bins, Scratch w,
                      float* __restrict__ histogram) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int i = threadIdx.x; i < padded; i += blockDim.x) {
    const int src = (int)(w.key[i] & kIndexMask);
    w.sx[i] = src < n ? points[3 * src] : 0.0f;
    w.sy[i] = src < n ? points[3 * src + 1] : 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < padded; i += blockDim.x) {
    w.weight[i] = 0.0f;
    w.slice[i] = 0;  // now the bin of each sorted position
  }
  __syncthreads();
  for (int i = threadIdx.x; i < padded; i += blockDim.x) {
    const int s = (int)(w.key[i] >> kSliceShift);
    if (i == 0 || (int)(w.key[i - 1] >> kSliceShift) != s)
      anchor_walk(i, s, padded, bins, w.key, w.sx, w.sy, w.cx, w.cy, w.slice, w.weight);
  }
  __syncthreads();
  for (int b = warp; b < bins; b += warps) {
    float sum = warp_tree_sum(padded, [&](int k) { return w.slice[k] == b ? w.weight[k] : 0.0f; });
    if (lane == 0) histogram[b] = sum;
  }
}

__global__ void rotate_kernel(const float* __restrict__ histogram,
                              const float* __restrict__ angle, int size,
                              float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float shift = (angle[0] * (float)size) / kPi;
  float lo = floorf(shift);
  float frac = shift - lo;
  int upper = (int)(((long long)i - (long long)lo) % size);
  if (upper < 0) upper += size;
  int lower = (upper - 1 + size) % size;
  out[i] = (1.0f - frac) * histogram[upper] + frac * histogram[lower];
}

// Sum of s[0..n) (n a power of two) as the halving tree s[i] + s[i + n / 2],
// in place; all threads of the block take part, the result is in s[0].
__device__ inline void block_tree_sum(float* s, int n) {
  for (int half = n >> 1; half > 0; half >>= 1) {
    __syncthreads();
    if ((int)threadIdx.x < half) s[threadIdx.x] = s[threadIdx.x] + s[threadIdx.x + half];
  }
  __syncthreads();
}

// blockDim.x == tile = min(padded, kMaxPoints); bin k + j * tile folds into k.
__global__ void match_kernel(const float* __restrict__ scan, const float* __restrict__ submap,
                             const float* __restrict__ angles, int size, int padded,
                             float* __restrict__ out) {
  extern __shared__ float smem[];
  const int tile = blockDim.x, m = padded / tile;
  float* dot = smem;
  float* rr = smem + tile;
  float* ss = smem + 2 * tile;
  const int i = threadIdx.x;
  const float shift = (angles[blockIdx.x] * (float)size) / kPi;
  const float lo = floorf(shift);
  const float frac = shift - lo;
  auto rotated = [&](int b) {
    if (b >= size) return 0.0f;
    int upper = (int)(((long long)b - (long long)lo) % size);
    if (upper < 0) upper += size;
    int lower = (upper - 1 + size) % size;
    return (1.0f - frac) * scan[upper] + frac * scan[lower];
  };
  const halving::Lanes<3> sums = halving::fold_of<halving::Lanes<3>>(m, [&](int j) {
    const int b = i + j * tile;
    const float r = rotated(b), s = b < size ? submap[b] : 0.0f;
    return halving::Lanes<3>{{r * s, r * r, s * s}};
  });
  dot[i] = sums.v[0];
  rr[i] = sums.v[1];
  ss[i] = sums.v[2];
  block_tree_sum(dot, tile);
  block_tree_sum(rr, tile);
  block_tree_sum(ss, tile);
  if (i == 0) {
    float denom = sqrtf(rr[0]) * sqrtf(ss[0]);
    out[blockIdx.x] = dot[0] / fmaxf(denom, 1e-9f);
  }
}

}  // namespace

// `padded` is the power of two (>= 32) that holds the n points; above
// kMaxPoints `scratch` holds 4 * padded + 2 * (kMaxSlices + 1) floats and
// `keys` padded int64 (both unused below).
extern "C" int rot_histogram(const void* points, const void* mask, int n, int padded,
                             int bins, void* histogram, void* scratch, void* keys,
                             void* stream) {
  if (padded < 32 || (padded & (padded - 1)) || n > padded || padded > (1 << kAngleShift) ||
      bins < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (padded <= kMaxPoints) {
    rot_histogram_kernel<<<1, padded, 0, st>>>((const float*)points, (const uint8_t*)mask, n,
                                               padded, bins, (float*)histogram);
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr || keys == nullptr) return (int)cudaErrorInvalidValue;
  float* f = (float*)scratch;
  Scratch w{f, f + padded, f + 2 * padded, (int*)(f + 3 * padded), f + 4 * padded,
            f + 4 * padded + kMaxSlices + 1, (unsigned long long*)keys};
  large_keys_kernel<<<1, kMaxPoints, 0, st>>>((const float*)points, (const uint8_t*)mask, n,
                                              padded, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = bitonic::sort(w.key, padded, st);
  if (err != cudaSuccess) return (int)err;
  large_bins_kernel<<<1, kMaxPoints, 0, st>>>((const float*)points, n, padded, bins, w,
                                              (float*)histogram);
  return (int)cudaGetLastError();
}

extern "C" int rot_histogram_rotate(const void* histogram, const void* angle, int size,
                                    void* out, void* stream) {
  rotate_kernel<<<(size + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const float*)histogram, (const float*)angle, size, (float*)out);
  return (int)cudaGetLastError();
}

// `padded` is the power of two (>= 32) that holds the bins.
extern "C" int rot_match(const void* scan, const void* submap, const void* angles, int count,
                         int size, int padded, void* out, void* stream) {
  if (padded < 32 || (padded & (padded - 1)) || size > padded) return (int)cudaErrorInvalidValue;
  const int tile = padded < kMaxPoints ? padded : kMaxPoints;
  match_kernel<<<count, tile, 3 * tile * sizeof(float), (cudaStream_t)stream>>>(
      (const float*)scan, (const float*)submap, (const float*)angles, size, padded,
      (float*)out);
  return (int)cudaGetLastError();
}
