// K12 rot_histogram, rot_histogram_rotate; K13 rot_match
//
// K12 replaces: cartographer_tpu/ops/rot_histogram.py:compute_rotational_histogram
// (l.27) and rotate_histogram (l.94). K13 replaces match_histograms (l.107).
//
// rot_histogram is one launch of one block (up to 1,024 threads, each taking
// the points i + j * threads) for a scan's histogram and, with a yaw, its
// rotation; with a gravity quaternion it levels the cloud first, so the 3D
// step's histogram and its rotation by the matched yaw are one kernel:
//   1. The levelling quaternion from_yaw(-yaw(g)) * g and the matched yaw
//      are taken on the device in the twin's operation order; each point is
//      rotated by it; the z-minimum of the valid points by warp shuffles.
//   2. The 0.2 m slice of each valid point; the slices' members listed in
//      input order (`group_in_order`: counts by shared atomics, a scan, a
//      placement, and each member's rank among its group's members).
//   3. The slices' centroids: a thread a slice adds its members' x and y in
//      input order (XLA's CPU scatter order; the twin adds so too).
//   4. The angle of each point around its slice's centroid and the keep test
//      at 0.2 m; the kept points' sorted position is their slice's offset plus
//      their rank among the slice's kept members by (angle, index), so no
//      sort network: the keys are distinct, and this is the stable sort by
//      (slice, angle) of jnp.lexsort.
//   5. The anchor walk in parallel. A slice's anchor advances at a point more
//      than 0.9 m from it (every kept point lies 0.2 m or more from its
//      centroid), so each sorted position's next anchor f(p) is the first
//      later position of its slice that far from it; the chain from each
//      slice's first position is marked by pointer doubling (a round a
//      barrier, until no marked position jumps on), and each position's
//      anchor is the last marked position before it.
//   6. The emitted directions' weights and bins; the bins' members listed in
//      sorted order (`group_in_order`), and a thread a bin adds them in that
//      order; with a yaw, the histogram rotated (rot_histogram_rotate's
//      arithmetic) from shared memory.
// A sum that differs in its last bit can flip a 0.2 m test or a bin edge, so
// kernel and twin add in the same order; the results equal the twin's to the
// bit. The arrays live in shared memory while a cloud's 60 bytes a point and
// a histogram's 16 bytes a bin fit (kSharedBytes); above, in a device-memory
// scratch the wrapper passes (rot_histogram_scratch_bytes).
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
// Bound: latency. 512 points are 6.5 KB; the block runs a chain of some 20
// barriers, the rank scans over a slice's members and the doubling rounds.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "halving_fold.cuh"
#include "stamps.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSlices = 128;
constexpr float kMinDistance = 0.2f;
constexpr float kMaxDistance = 0.9f;
constexpr float kSliceHeight = 0.2f;
constexpr float kPi = 3.14159274101257324f;  // float32(pi)
constexpr size_t kSharedBytes = 200 * 1024;   // the dynamic shared memory the arrays may take

__device__ inline unsigned int ordered_bits(float x) {
  unsigned int b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ inline float norm2(float x, float y) { return sqrtf(x * x + y * y); }

// quat.get_yaw: atan2(2 (x y + w z), 1 - 2 (y y + z z)).
__device__ inline float get_yaw(const float* q) {
  return atan2f(2.0f * (q[1] * q[2] + q[0] * q[3]), 1.0f - 2.0f * (q[2] * q[2] + q[3] * q[3]));
}

// quat.multiply(quat.from_yaw(-get_yaw(g)), g), every product and sum of the
// twin's written out (the zero components included).
__device__ inline void level_quaternion(const float* g, float q[4]) {
  const float half = 0.5f * -get_yaw(g);
  const float aw = cosf(half), ax = 0.0f, ay = 0.0f, az = sinf(half);
  q[0] = aw * g[0] - ax * g[1] - ay * g[2] - az * g[3];
  q[1] = aw * g[1] + ax * g[0] + ay * g[3] - az * g[2];
  q[2] = aw * g[2] - ax * g[3] + ay * g[0] + az * g[1];
  q[3] = aw * g[3] + ax * g[2] - ay * g[1] + az * g[0];
}

// quat.rotate_expanded: v + qw * t + cross(qv, t), t = 2 cross(qv, v).
__device__ inline void rotate(const float q[4], const float v[3], float out[3]) {
  float t0 = 2.0f * (q[2] * v[2] - q[3] * v[1]);
  float t1 = 2.0f * (q[3] * v[0] - q[1] * v[2]);
  float t2 = 2.0f * (q[1] * v[1] - q[2] * v[0]);
  out[0] = (v[0] + q[0] * t0) + (q[2] * t2 - q[3] * t1);
  out[1] = (v[1] + q[0] * t1) + (q[3] * t0 - q[1] * t2);
  out[2] = (v[2] + q[0] * t2) + (q[1] * t1 - q[2] * t0);
}

// The per-point and per-bin arrays, in shared memory or in the scratch.
struct Arrays {
  float *px, *py;       // the (levelled) cloud's x and y, input order
  float *sx, *sy;       // z (step 1), then x and y at the sorted positions
  int* slice;           // each point's slice; kMaxSlices: invalid
  int* kept;            // each point's slice if it is kept, else -1
  unsigned int* angle;  // order-preserving bits of its angle about the centroid
  int *members, *ordered;  // a grouping's members: arrival, then input order
  int* sslice;          // the slice of each sorted position
  int *jump, *jump2;    // the anchor chain's pointers, doubled
  int* mark;            // on the chain
  int* bin;             // each sorted position's bin; -1: nothing emitted
  float* weight;        // its weight
  int *bcount, *bstart, *bcursor;  // per bin
  float* hist;          // per bin
};

__host__ __device__ inline size_t arrays_bytes(int n, int bins) {
  return (size_t)n * 15 * 4 + (size_t)bins * 4 * 4;
}

__device__ inline Arrays layout(unsigned char* base, int n, int bins) {
  float* f = (float*)base;
  Arrays a;
  a.px = f;
  a.py = f + n;
  a.sx = f + 2 * n;
  a.sy = f + 3 * n;
  a.weight = f + 4 * n;
  int* i = (int*)(f + 5 * n);
  a.slice = i;
  a.kept = i + n;
  a.angle = (unsigned int*)(i + 2 * n);
  a.members = i + 3 * n;
  a.ordered = i + 4 * n;
  a.sslice = i + 5 * n;
  a.jump = i + 6 * n;
  a.jump2 = i + 7 * n;
  a.mark = i + 8 * n;
  a.bin = i + 9 * n;
  a.bcount = i + 10 * n;
  a.bstart = a.bcount + bins;
  a.bcursor = a.bstart + bins;
  a.hist = (float*)(a.bcursor + bins);
  return a;
}

// out[k] = the sum of in[j < k] for k < K; every thread of the block calls it.
__device__ void block_exclusive_scan(const int* in, int* out, int K, int* warp_sums) {
  const int T = blockDim.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (K + T - 1) / T, b = min((int)threadIdx.x * per, K), e = min(b + per, K);
  int local = 0;
  for (int j = b; j < e; ++j) local += in[j];
  int x = local;
  for (int off = 1; off < 32; off <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (T >> 5) ? warp_sums[lane] : 0, v = w;
    for (int off = 1; off < 32; off <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += y;
    }
    if (lane < (T >> 5)) warp_sums[lane] = v - w;
  }
  __syncthreads();
  int run = warp_sums[warp] + x - local;
  for (int j = b; j < e; ++j) {
    out[j] = run;
    run += in[j];
  }
  __syncthreads();
}

// Lists the items i < m with key(i) in [0, K) by key, each key's items in
// item order: ordered[start[k] + r] is key k's r-th item. count[k] holds each
// key's items; cursor[] is zero. Every thread of the block calls it.
template <typename Key>
__device__ void group_in_order(int m, Key key, int K, const int* count, int* start,
                               int* cursor, int* members, int* ordered, int* warp_sums) {
  block_exclusive_scan(count, start, K, warp_sums);
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int k = key(i);
    if (k >= 0) members[start[k] + atomicAdd(&cursor[k], 1)] = i;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int k = key(i);
    if (k < 0) continue;
    const int b = start[k], e = b + count[k];
    int r = 0;
    for (int j = b; j < e; ++j) r += members[j] < i;
    ordered[b + r] = i;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kMaxThreads)
    histogram_kernel(const float* __restrict__ points, const uint8_t* __restrict__ mask, int n,
                     int bins, const float* __restrict__ gravity,
                     const float* __restrict__ est_q, float* __restrict__ histogram,
                     float* __restrict__ rotated, unsigned char* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char dynamic[];
  __shared__ int count[kMaxSlices], start[kMaxSlices], cursor[kMaxSlices];
  __shared__ int kcount[kMaxSlices], kstart[kMaxSlices];
  __shared__ float cx[kMaxSlices + 1], cy[kMaxSlices + 1];
  __shared__ float warp_min[32];
  __shared__ int warp_sums[32];
  const Arrays a = layout(scratch ? scratch : dynamic, n, bins);
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  STAMP(0);

  // 1. The levelled cloud and the z-minimum of its valid points.
  float lq[4] = {1.0f, 0.0f, 0.0f, 0.0f};
  if (gravity) level_quaternion(gravity, lq);
  float zmin = INFINITY;
  for (int i = tid; i < n; i += T) {
    float p[3] = {points[3 * i], points[3 * i + 1], points[3 * i + 2]}, o[3];
    if (gravity) {
      rotate(lq, p, o);
    } else {
      o[0] = p[0];
      o[1] = p[1];
      o[2] = p[2];
    }
    a.px[i] = o[0];
    a.py[i] = o[1];
    a.sx[i] = o[2];
    if (mask[i]) zmin = fminf(zmin, o[2]);
  }
  for (int s = tid; s < kMaxSlices; s += T) count[s] = cursor[s] = kcount[s] = 0;
  for (int b = tid; b < bins; b += T) a.bcount[b] = a.bcursor[b] = 0;
  for (int off = 16; off > 0; off >>= 1) zmin = fminf(zmin, __shfl_xor_sync(0xffffffffu, zmin, off));
  if (lane == 0) warp_min[warp] = zmin;
  __syncthreads();
  for (int w = 0; w < (T >> 5); ++w) zmin = fminf(zmin, warp_min[w]);
  STAMP(1);

  // 2. Slices, and their members in input order.
  for (int i = tid; i < n; i += T) {
    int s = kMaxSlices;
    if (mask[i]) {
      s = (int)fminf(fmaxf(floorf((a.sx[i] - zmin) / kSliceHeight), 0.0f),
                     (float)(kMaxSlices - 1));
      atomicAdd(&count[s], 1);
    }
    a.slice[i] = s;
  }
  __syncthreads();
  group_in_order(
      n, [&](int i) { return a.slice[i] < kMaxSlices ? a.slice[i] : -1; }, kMaxSlices, count,
      start, cursor, a.members, a.ordered, warp_sums);
  STAMP(2);

  // 3. Centroids: each slice's x and y added in input order.
  for (int s = tid; s <= kMaxSlices; s += T) {
    float sum_x = 0.0f, sum_y = 0.0f, c = 1.0f;
    if (s < kMaxSlices) {
      const int* list = a.ordered + start[s];
      for (int j = 0; j < count[s]; ++j) {
        sum_x = sum_x + a.px[list[j]];
        sum_y = sum_y + a.py[list[j]];
      }
      c = fmaxf((float)count[s], 1.0f);
    }
    cx[s] = sum_x / c;
    cy[s] = sum_y / c;
  }
  __syncthreads();
  STAMP(3);

  // 4. Angles about the centroids, the keep test, the sorted positions.
  for (int i = tid; i < n; i += T) {
    const int s = a.slice[i];
    float dx = a.px[i] - cx[s], dy = a.py[i] - cy[s];
    a.angle[i] = ordered_bits(atan2f(dy, dx) + 0.0f);
    const bool keep = s < kMaxSlices && norm2(dx, dy) >= kMinDistance;
    a.kept[i] = keep ? s : -1;
    if (keep) atomicAdd(&kcount[s], 1);
  }
  __syncthreads();
  block_exclusive_scan(kcount, kstart, kMaxSlices, warp_sums);
  const int kept_points = kstart[kMaxSlices - 1] + kcount[kMaxSlices - 1];
  for (int i = tid; i < n; i += T) {
    const int s = a.kept[i];
    if (s < 0) continue;
    const unsigned int key = a.angle[i];
    const int* list = a.ordered + start[s];
    int r = 0;
    for (int j = 0; j < count[s]; ++j) {
      const int o = list[j];
      const unsigned int other = a.angle[o];
      r += a.kept[o] >= 0 && (other < key || (other == key && o < i));
    }
    const int p = kstart[s] + r;
    a.sx[p] = a.px[i];
    a.sy[p] = a.py[i];
    a.sslice[p] = s;
  }
  __syncthreads();
  STAMP(4);

  // 5. The anchor walk: each position's next anchor, the chains by pointer
  // doubling, each position's anchor.
  for (int p = tid; p < kept_points; p += T) {
    const int s = a.sslice[p], e = kstart[s] + kcount[s];
    int f = -1;
    for (int q = p + 1; q < e; ++q) {
      float ddx = a.sx[q] - a.sx[p], ddy = a.sy[q] - a.sy[p];
      if (norm2(ddx, ddy) > kMaxDistance) {
        f = q;
        break;
      }
    }
    a.jump[p] = f;
    a.mark[p] = p == kstart[s];
  }
  __syncthreads();
  STAMP(5);
  int* cur = a.jump;
  int* next = a.jump2;
  int rounds = 0;
  for (;;) {
    int more = 0;
    for (int p = tid; p < kept_points; p += T) {
      const int f = cur[p];
      if (f >= 0 && a.mark[p]) {
        a.mark[f] = 1;
        more = 1;
      }
      next[p] = f >= 0 ? cur[f] : -1;
    }
    ++rounds;
    if (!__syncthreads_or(more)) break;
    int* t = cur;
    cur = next;
    next = t;
  }
  STAMP(6);
  for (int p = tid; p < kept_points; p += T) {
    const int s = a.sslice[p], first = kstart[s];
    int anchor = p;
    if (p != first) {
      anchor = p - 1;
      while (!a.mark[anchor]) --anchor;
    }
    float ddx = a.sx[p] - a.sx[anchor], ddy = a.sy[p] - a.sy[anchor];
    float ex = a.sx[p] - cx[s], ey = a.sy[p] - cy[s];
    float distance = norm2(ddx, ddy), dirn = norm2(ex, ey);
    int b = -1;
    if (p != first && distance >= kMinDistance && dirn >= kMinDistance &&
        distance <= kMaxDistance) {
      float md = fmaxf(distance, 1e-9f), mn = fmaxf(dirn, 1e-9f);
      float dot = (ddx / md) * (ex / mn) + (ddy / md) * (ey / mn);
      float angle = fmodf(atan2f(ddy, ddx), kPi);
      if (angle != 0.0f && angle < 0.0f) angle = angle + kPi;
      float fb = floorf(((float)bins * angle) / kPi - 0.5f + 0.5f);
      b = (int)fminf(fmaxf(fb, 0.0f), (float)(bins - 1));
      a.weight[p] = fmaxf(1.0f - fabsf(dot), 0.0f);
      atomicAdd(&a.bcount[b], 1);
    }
    a.bin[p] = b;
  }
  __syncthreads();
  STAMP(7);

  // 6. The bins, each adding its weights in sorted order; the rotation.
  group_in_order(
      kept_points, [&](int p) { return a.bin[p]; }, bins, a.bcount, a.bstart, a.bcursor,
      a.members, a.ordered, warp_sums);
  STAMP(8);
  for (int b = tid; b < bins; b += T) {
    const int* list = a.ordered + a.bstart[b];
    float sum = 0.0f;
    for (int j = 0; j < a.bcount[b]; ++j) sum = sum + a.weight[list[j]];
    a.hist[b] = sum;
    histogram[b] = sum;
  }
  if (rotated) {
    __syncthreads();
    const float shift = (get_yaw(est_q) * (float)bins) / kPi;
    const float lo = floorf(shift), frac = shift - lo;
    for (int i = tid; i < bins; i += T) {
      int upper = (int)(((long long)i - (long long)lo) % bins);
      if (upper < 0) upper += bins;
      const int lower = (upper - 1 + bins) % bins;
      rotated[i] = (1.0f - frac) * a.hist[upper] + frac * a.hist[lower];
    }
  }
  STAMP(9);
  STAMP_VALUE(63, rounds);
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

// blockDim.x == tile = min(padded, kMaxThreads); bin k + j * tile folds into k.
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

// The scratch bytes rot_histogram needs for n points and `bins` bins: 0 while
// its arrays fit in shared memory.
extern "C" long long rot_histogram_scratch_bytes(int n, int bins) {
  const size_t bytes = arrays_bytes(n, bins);
  return bytes <= kSharedBytes ? 0 : (long long)bytes;
}

// The histogram (bins,) of the n points (n >= 0) and their mask; with
// `gravity` (4,) of the cloud levelled by from_yaw(-yaw(g)) * g; with
// `est_q` (4,) also the histogram rotated by yaw(est_q) into `rotated`.
// `scratch` holds rot_histogram_scratch_bytes(n, bins) bytes (null at 0).
extern "C" int rot_histogram(const void* points, const void* mask, int n, int bins,
                             const void* gravity, const void* est_q, void* histogram,
                             void* rotated, void* scratch, void* stream) {
  const size_t bytes = arrays_bytes(n, bins);
  const bool shared = bytes <= kSharedBytes;
  if (n < 0 || bins < 1 || (!shared && scratch == nullptr) ||
      ((est_q == nullptr) != (rotated == nullptr)))
    return (int)cudaErrorInvalidValue;
  int threads = 32;
  while (threads < n && threads < kMaxThreads) threads *= 2;
  const size_t smem = shared ? bytes : 0;
  if (smem > 40 * 1024) {  // with the static shared memory, above the default 48 KB
    cudaError_t err = cudaFuncSetAttribute(
        histogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSharedBytes);
    if (err != cudaSuccess) return (int)err;
  }
  histogram_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      (const float*)points, (const uint8_t*)mask, n, bins, (const float*)gravity,
      (const float*)est_q, (float*)histogram, (float*)rotated,
      shared ? nullptr : (unsigned char*)scratch);
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
  const int tile = padded < kMaxThreads ? padded : kMaxThreads;
  match_kernel<<<count, tile, 3 * tile * sizeof(float), (cudaStream_t)stream>>>(
      (const float*)scan, (const float*)submap, (const float*)angles, size, padded,
      (float*)out);
  return (int)cudaGetLastError();
}
