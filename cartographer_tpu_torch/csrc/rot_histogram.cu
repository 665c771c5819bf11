// K12 rot_histogram, rot_histogram_rotate
//
// Replaces: cartographer_tpu/ops/rot_histogram.py:compute_rotational_histogram
// (l.27) and rotate_histogram (l.94).
//
// One block computes a scan's histogram, one thread per point of the cloud
// padded to a power of two (32..1024):
//   1. z-min of the valid points, the 0.2 m slice of each point;
//   2. per-slice sums of x and y and counts, the centroids;
//   3. the angle around the slice's centroid, the keep test at 0.2 m, and a
//      64-bit sort key (slice, order-preserving angle bits, point index):
//      sorting it is the stable sort by (slice, angle) of jnp.lexsort;
//   4. a bitonic sort of the keys in shared memory;
//   5. the anchor walk, sequential inside a slice and independent across
//      slices: the thread at the start of each run of equal slices walks it;
//   6. the accumulation of the weights into the bins.
// The JAX program adds the slice sums and the bins by scatter-add. Here both
// are added in one fixed order, a pairwise halving tree over the (padded)
// points, by one warp per slice or bin, as the plain twin adds them: a sum
// that differs in its last bit can flip the 0.2 m tests or a bin edge.
//
// rot_histogram_rotate shifts a histogram by a yaw that lives on the device,
// with linear interpolation between bins.
//
// Bound: latency. 512 points are 6.5 KB; the block runs a chain of a sort
// (45 compare-exchange rounds at 512 keys), 129 + 120 warp reductions and
// the walk. Design: everything stays in shared memory, one launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxPoints = 1024;
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
  const int per_lane = n >> 5;  // <= 32
  float v[32];
  for (int k = 0; k < per_lane; ++k) v[k] = value(lane + 32 * k);
  for (int half = per_lane >> 1; half > 0; half >>= 1)
    for (int k = 0; k < half; ++k) v[k] = v[k] + v[k + half];
  float a = v[0];
  for (int off = 16; off > 0; off >>= 1) a = a + __shfl_down_sync(0xffffffffu, a, off);
  return a;
}

__device__ inline unsigned int ordered_bits(float x) {
  unsigned int b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ inline float norm2(float x, float y) { return sqrtf(x * x + y * y); }

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
    unsigned long long ks = keep ? s : kMaxSlices;
    key[i] = (ks << 42) | ((unsigned long long)ordered_bits(angle) << 10) |
             (unsigned long long)i;
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

  // Sorted cloud: position i holds point key & 1023 of slice key >> 42.
  const int src = (int)(key[i] & 1023ull);
  const int my_slice = (int)(key[i] >> 42);
  sx[i] = px[src];
  sy[i] = py[src];
  __syncthreads();
  px[i] = 0.0f;       // weight of sorted point i
  slice[i] = 0;       // bin of sorted point i
  __syncthreads();

  // 5. The anchor walk: the first thread of each run of a valid slice.
  const bool starts = i == 0 || (int)(key[i - 1] >> 42) != my_slice;
  if (starts && my_slice < kMaxSlices) {
    const float centroid_x = cx[my_slice], centroid_y = cy[my_slice];
    float last_x = sx[i], last_y = sy[i];
    for (int j = i; j < padded && (j == i || (int)(key[j] >> 42) == my_slice); ++j) {
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
        slice[j] = (int)fminf(fmaxf(b, 0.0f), (float)(bins - 1));
        px[j] = fmaxf(1.0f - fabsf(dot), 0.0f);
      }
      if (distance > kMaxDistance && dirn >= kMinDistance) {
        last_x = sx[j];
        last_y = sy[j];
      }
    }
  }
  __syncthreads();

  // 6. Bins: one warp per bin.
  for (int b = warp; b < bins; b += warps) {
    float sum = warp_tree_sum(padded, [&](int k) { return slice[k] == b ? px[k] : 0.0f; });
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

}  // namespace

// `padded` is the power of two (32..1024) that holds the n points.
extern "C" int rot_histogram(const void* points, const void* mask, int n, int padded,
                             int bins, void* histogram, void* stream) {
  rot_histogram_kernel<<<1, padded, 0, (cudaStream_t)stream>>>(
      (const float*)points, (const uint8_t*)mask, n, padded, bins, (float*)histogram);
  return (int)cudaGetLastError();
}

extern "C" int rot_histogram_rotate(const void* histogram, const void* angle, int size,
                                    void* out, void* stream) {
  rotate_kernel<<<(size + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const float*)histogram, (const float*)angle, size, (float*)out);
  return (int)cudaGetLastError();
}
