// K20 tsdf_normals_2d and K21 tsdf_insert_2d
//
// K20 replaces: cartographer_tpu/ops/tsdf_2d.py:estimate_normals_2d (l.86).
// Each point's angle about the sensor origin, atan2 (masked points +inf),
// becomes a 64-bit key (order-preserving angle bits, point index), and the
// keys are sorted ascending by the bitonic network of bitonic_sort.cuh: one
// block in shared memory for the 2D scan capacity (2,048), several above
// 8,192. The keys are distinct, so the order is the stable argsort's. One
// thread per sorted position then takes the 5 points at positions s - 2 ..
// s + 2 clipped to [0, N - 1] (not wrapped: the padding, sorted last, takes
// part at the end as in JAX), their mean, the 2x2 covariance of the centred
// points and its smallest eigenvector in closed form, flips it toward the
// origin and writes it at the point's own index. JAX takes the eigenvector
// from LAPACK's eigh: up to sign, which the flip fixes, the two agree where
// the two eigenvalues are apart; where they are nearly equal any unit vector
// is an eigenvector and the two may differ.
//
// K21 replaces: cartographer_tpu/ops/tsdf_2d.py:insert_range_data_tsdf
// (l.115), batched over the two active submaps as mapping/submap_2d.py's
// insert_body_cached (l.77). One item per (slot, sample k, point), in that
// flat order: the sample p - t_k d on the ray (d the unit ray, t_k the 16
// offsets of jnp.linspace(-truncation, truncation, 16) in its own float32
// arithmetic, computed here), its signed distance projected on the normal
// (or t_k) and clipped, and the weight range term x angle Gaussian x
// distance Gaussian, in JAX's order of operations with -fmad=false. An item
// adds w and w x sdf to its slot's cell; in_order_scatter.cuh adds each
// cell's items in input order, the order of the JAX scatter-add over
// w.reshape(-1) and of the twin's index_add_in_order_, and then in the same
// thread applies the running weighted average (old_w tsd + sum w sdf) /
// (old_w + sum w) and the weight clamped at max_weight, writing the cell
// once. No atomics: the grids equal the twin's bit for bit and a run
// repeats. The item's payload is its index; the walk recomputes its two
// addends from it (a few dozen flops), so an item stays 8 bytes. Cells this
// scan does not touch keep their values; JAX recomputes every cell, which
// re-rounds (w tsd) / w of an untouched cell by at most an ulp. The items
// read do_insert and the active flags from device memory, so the caller
// never waits.
//
// Bound: K20 by latency (a sort of 2,048 keys in one block, a few dozen
// barrier-separated steps); its bytes are 29 B per point. K21 by bytes:
// it reads the N points, masks and normals and reads and writes the tsd
// and weight of the cells the scan touches, and its 32 N samples are a few
// hundred thousand flops; the radix passes' barriers make it latency-bound.
// The grids are never swept, and there is no scratch: 2 x 16 x 2,048
// samples are one launch (a cluster of 16 blocks).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bitonic_sort.cuh"
#include "in_order_scatter.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSamples = 16;  // insert_range_data_tsdf's samples_per_ray
constexpr int kHalfWindow = 2;  // max(1, num_samples // 2) with num_samples = 4

__device__ inline uint32_t ordered_bits(float f) {
  uint32_t b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__global__ void angle_keys_kernel(const float* __restrict__ points,
                                  const uint8_t* __restrict__ mask,
                                  const float* __restrict__ origin, int n, int npad,
                                  unsigned long long* __restrict__ keys) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npad) return;
  uint32_t hi = 0xFFFFFFFFu;  // the power-of-two padding sorts after every point
  if (i < n) {
    float a = INFINITY;
    if (mask[i]) {
      float rx = points[2 * i] - origin[0];
      float ry = points[2 * i + 1] - origin[1];
      a = atan2f(ry, rx) + 0.0f;  // -0 sorts with +0, as argsort compares them
    }
    hi = ordered_bits(a);
  }
  keys[i] = ((unsigned long long)hi << 32) | (unsigned int)i;
}

__global__ void normals_kernel(const float* __restrict__ points,
                               const float* __restrict__ origin, int n,
                               const unsigned long long* __restrict__ keys,
                               float* __restrict__ normals) {
  int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  float px[2 * kHalfWindow + 1], py[2 * kHalfWindow + 1];
  for (int d = -kHalfWindow; d <= kHalfWindow; ++d) {
    int pos = min(max(s + d, 0), n - 1);
    int idx = (int)(keys[pos] & 0xFFFFFFFFull);
    px[d + kHalfWindow] = points[2 * idx];
    py[d + kHalfWindow] = points[2 * idx + 1];
  }
  const int k = 2 * kHalfWindow + 1;
  float mx = 0.0f, my = 0.0f;
  for (int q = 0; q < k; ++q) {
    mx = mx + px[q];
    my = my + py[q];
  }
  mx = mx / (float)k;
  my = my / (float)k;
  float a = 0.0f, b = 0.0f, c = 0.0f;
  for (int q = 0; q < k; ++q) {
    float cx = px[q] - mx, cy = py[q] - my;
    a = a + cx * cx;
    b = b + cx * cy;
    c = c + cy * cy;
  }
  // Smallest eigenvector of [[a, b], [b, c]]: of the two forms (b, l - a)
  // and (l - c, b), the longer; (1, 0) where the matrix is a multiple of I.
  float t = 0.5f * (a - c);
  float lam = 0.5f * (a + c) - sqrtf(t * t + b * b);
  float v1x = b, v1y = lam - a, v2x = lam - c, v2y = b;
  float n1 = v1x * v1x + v1y * v1y, n2 = v2x * v2x + v2y * v2y;
  float nx = 1.0f, ny = 0.0f;
  if (n1 >= n2 && n1 > 0.0f) {
    float r = sqrtf(n1);
    nx = v1x / r;
    ny = v1y / r;
  } else if (n2 > 0.0f) {
    float r = sqrtf(n2);
    nx = v2x / r;
    ny = v2y / r;
  }
  const float sx = px[kHalfWindow], sy = py[kHalfWindow];
  float dot = nx * (origin[0] - sx) + ny * (origin[1] - sy);
  if (dot < 0.0f) {
    nx = -nx;
    ny = -ny;
  }
  int idx = (int)(keys[s] & 0xFFFFFFFFull);
  normals[2 * idx] = nx;
  normals[2 * idx + 1] = ny;
}

// K21's items for in_order_scatter: one per (slot, sample k, point).
struct TsdfSamples {
  const float* points;
  const uint8_t* mask;
  const float* normals;
  const float* origin;
  int n;
  const float* grid_origins;  // (slots, 2)
  float resolution;
  int size;
  float truncation;
  int range_exponent;
  float angle_denominator;     // 2 * bandwidth^2 rounded to float32
  float distance_denominator;  // the same for the distance Gaussian
  int project_to_normal;
  const uint8_t* active;
  const uint8_t* do_insert;
  float max_weight;
  float* tsd;     // (slots, size, size)
  float* weight;  // (slots, size, size)

  __device__ static float sample_offset(float truncation, int k) {
    if (k == kSamples - 1) return truncation;
    float h = (float)k / (float)(kSamples - 1);
    return -truncation * (1.0f - h) + truncation * h;
  }

  // Item `idx`'s weight and signed distance, and its cell (slot-major), or
  // kNone where it adds nothing.
  __device__ unsigned int sample(int idx, float& w, float& sdf) const {
    const int per_slot = kSamples * n;
    const int slot = idx / per_slot;
    const int rest = idx - slot * per_slot;
    const int k = rest / n;
    const int i = rest - k * n;
    if (!do_insert[0] || !active[slot] || !mask[i]) return in_order_scatter::kNone;
    float hx = points[2 * i], hy = points[2 * i + 1];
    float rx = hx - origin[0], ry = hy - origin[1];
    float len = fmaxf(sqrtf(rx * rx + ry * ry), 1e-6f);
    float dx = rx / len, dy = ry / len;
    float t = sample_offset(truncation, k);
    float sx = hx - t * dx, sy = hy - t * dy;
    float nx = normals[2 * i], ny = normals[2 * i + 1];
    sdf = project_to_normal ? (hx - sx) * (-nx) + (hy - sy) * (-ny) : t;
    sdf = fminf(fmaxf(sdf, -truncation), truncation);
    float w_range = range_exponent == 0 ? 1.0f : 1.0f / powf(len, (float)range_exponent);
    float cosine = fabsf(nx * (-dx) + ny * (-dy));
    float angle = acosf(fminf(fmaxf(cosine, -1.0f), 1.0f));
    float w_angle = expf(-(angle * angle) / angle_denominator);
    float w_dist = expf(-(t * t) / distance_denominator);
    w = (w_range * w_angle) * w_dist;
    if (!(w > 0.0f)) return in_order_scatter::kNone;  // adds nothing
    const float* g = grid_origins + 2 * slot;
    float ci = floorf((sx - g[0]) / resolution);
    float cj = floorf((sy - g[1]) / resolution);
    if (!(ci >= 0.0f && ci < (float)size && cj >= 0.0f && cj < (float)size))
      return in_order_scatter::kNone;
    return (unsigned int)(((long long)slot * size + (long long)ci) * size + (long long)cj);
  }

  __device__ unsigned int cell(int idx, unsigned int& payload) const {
    float w, sdf;
    payload = (unsigned int)idx;
    return sample(idx, w, sdf);
  }

  struct Acc {
    float old_w, old_t, ws, wt;
  };
  __device__ Acc load(unsigned int c) const { return {weight[c], tsd[c], 0.0f, 0.0f}; }
  __device__ void add(Acc& a, unsigned int idx) const {
    float w, sdf;
    sample((int)idx, w, sdf);
    a.ws = a.ws + w;
    a.wt = a.wt + w * sdf;
  }
  __device__ void store(unsigned int c, const Acc& a) const {
    float new_w = a.old_w + a.ws;
    if (new_w > 0.0f) tsd[c] = (a.old_w * a.old_t + a.wt) / fmaxf(new_w, 1e-9f);
    weight[c] = fminf(new_w, max_weight);
  }
};

}  // namespace

// K20. `keys` holds next_pow2(n) int64 of scratch; `normals` (n, 2) out.
extern "C" int tsdf_normals_2d(const void* points, const void* mask, const void* origin, int n,
                               void* keys, void* normals, void* stream) {
  if (n == 0) return 0;
  int npad = 2;
  while (npad < n) npad <<= 1;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* k = (unsigned long long*)keys;
  angle_keys_kernel<<<(npad + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      (const float*)points, (const uint8_t*)mask, (const float*)origin, n, npad, k);
  cudaError_t err = bitonic::sort(k, npad, st);
  if (err != cudaSuccess) return (int)err;
  normals_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      (const float*)points, (const float*)origin, n, k, (float*)normals);
  return (int)cudaGetLastError();
}

// K21: inserts in place into `tsd` and `weight` (slots, size, size);
// `passes` radix passes of 8 bits cover the slots' cell indices.
extern "C" int tsdf_insert_2d(const void* points, const void* mask, const void* normals,
                              const void* origin, int n, const void* grid_origins,
                              float resolution, int size, float truncation, float max_weight,
                              int range_exponent, float angle_denominator,
                              float distance_denominator, int project_to_normal,
                              const void* active, const void* do_insert, int slots, int passes,
                              void* tsd, void* weight, void* stream) {
  const long long cells = (long long)slots * size * size;
  const long long items = (long long)kSamples * n * slots;
  if (n < 0 || size < 1 || cells >= (long long)in_order_scatter::kNone || items > 0x7FFFFFFFll ||
      passes < 1 || (passes < 4 && cells > (1ll << (8 * passes))))
    return (int)cudaErrorInvalidValue;
  TsdfSamples src{(const float*)points, (const uint8_t*)mask, (const float*)normals,
                  (const float*)origin, n, (const float*)grid_origins, resolution, size, truncation, range_exponent,
                  angle_denominator, distance_denominator, project_to_normal,
                  (const uint8_t*)active, (const uint8_t*)do_insert, max_weight, (float*)tsd,
                  (float*)weight};
  return (int)in_order_scatter::launch(src, (int)items, passes, (cudaStream_t)stream);
}
