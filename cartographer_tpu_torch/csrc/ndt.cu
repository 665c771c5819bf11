// K28 ndt_grid and K29 ndt_lm
//
// K28 replaces: cartographer_tpu/ops/icp.py:build_ndt_grid (l.179). K29
// replaces ndt_match's residual_fn and lm_solve (l.219-230;
// ops/gauss_newton.py:22, se3_retract in ops/scan_matcher_3d.py:45).
//
// K28: the per-voxel Gaussians of a g^3 grid. A point's cell is
// floor((p - origin) / resolution) per axis (a true division, as the port
// divides everywhere); an in-bounds masked-in point keys (cell << 32 |
// index), every other point (cell g^3 << 32 | index), and the padding to a
// power of two all ones. The keys are sorted (bitonic_sort.cuh), so each
// cell's points lie together in input order. One thread per cell then
// finds its run by binary search and adds, in that order from zero, the
// count, the sum of p and the sum of p p^T in float32 (the order of XLA's
// scatter-add on the CPU and of the plain twin, so the sums keep their
// bits: sq / n - mu mu^T cancels about 4 of float32's 7 digits at the
// hall's 2-13 m, and float atomics would move L between runs). Then mean =
// sum / max(count, 1), cov = sq / n - mu mu^T + reg I and valid = count >=
// min_points in float32, as JAX; inv(cov) by its adjugate and the lower
// Cholesky factor of that inverse in double precision, rounded to float32.
// Bound: bytes, the points read once (12 + 1 bytes each) and the grid
// written once (13 floats and a flag a cell); the sort's passes and the
// longest cell's serial sum make it latency-bound.
//
// K29: the whole <= max_iterations LM of ndt_match in one launch
// (se3_lm.cuh), three rows per source point: world = R p + t, its cell as
// above, ok = in bounds & mask & valid[cell], r = L^T (world - mean) (each
// sum left to right) where ok, else 0, with the tangent gradients of the
// columns of L, [L[:, a], p x (R^T L[:, a])] (the floor contributes no
// derivative, as under jax.jacfwd).
// Bound: latency (the LM's dependent block-wide passes); bytes per pass
// 32,768 x 13 for the points and up to 52 per point from the grid, from L2.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bitonic_sort.cuh"
#include "se3_lm.cuh"

namespace {

constexpr int kThreads = 256;

// The cell index (i * g + j) * g + k of the world point w, or -1 outside.
__device__ inline int cell_of(const float w[3], const float* origin, float resolution, int g) {
  int c[3];
  for (int a = 0; a < 3; ++a) {
    const float f = floorf((w[a] - origin[a]) / resolution);
    if (!(f >= 0.0f && f < (float)g)) return -1;
    c[a] = (int)f;
  }
  return (c[0] * g + c[1]) * g + c[2];
}

__global__ void keys_kernel(const float* __restrict__ target, const uint8_t* __restrict__ mask,
                            int n, int padded, const float* __restrict__ origin, float resolution,
                            int g, unsigned long long* __restrict__ keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= padded) return;
  if (i >= n) {
    keys[i] = ~0ull;
    return;
  }
  long long cell = (long long)g * g * g;
  if (mask[i]) {
    const float p[3] = {target[3 * i], target[3 * i + 1], target[3 * i + 2]};
    const int c = cell_of(p, origin, resolution, g);
    if (c >= 0) cell = c;
  }
  keys[i] = ((unsigned long long)cell << 32) | (unsigned int)i;
}

// The first position in keys[0, count) whose key is >= v.
__device__ inline int lower_bound(const unsigned long long* keys, int count,
                                  unsigned long long v) {
  int lo = 0, hi = count;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void cells_kernel(const float* __restrict__ target,
                             const unsigned long long* __restrict__ keys, int padded, int cells,
                             float regularization, float min_points, float* __restrict__ means,
                             float* __restrict__ chol, uint8_t* __restrict__ valid) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= cells) return;
  const int lo = lower_bound(keys, padded, (unsigned long long)cell << 32);
  const int hi = lower_bound(keys, padded, (unsigned long long)(cell + 1) << 32);
  float count = 0.0f, s[3] = {0.0f, 0.0f, 0.0f};
  float sq[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int q = lo; q < hi; ++q) {
    const size_t i = (size_t)(keys[q] & 0xffffffffull);
    const float p[3] = {target[3 * i], target[3 * i + 1], target[3 * i + 2]};
    count = count + 1.0f;
    for (int a = 0; a < 3; ++a) {
      s[a] = s[a] + p[a];
      for (int b = 0; b < 3; ++b) sq[3 * a + b] = sq[3 * a + b] + p[a] * p[b];
    }
  }
  const float n = fmaxf(count, 1.0f);
  float mu[3];
  for (int a = 0; a < 3; ++a) mu[a] = s[a] / n;
  double c[3][3];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      float v = sq[3 * a + b] / n - mu[a] * mu[b];
      if (a == b) v = v + regularization;
      c[a][b] = v;
    }
  // inv(c) by its adjugate (c is symmetric, so is the inverse).
  const double k00 = c[1][1] * c[2][2] - c[1][2] * c[2][1];
  const double k01 = c[1][2] * c[2][0] - c[1][0] * c[2][2];
  const double k02 = c[1][0] * c[2][1] - c[1][1] * c[2][0];
  const double k11 = c[0][0] * c[2][2] - c[0][2] * c[2][0];
  const double k12 = c[0][1] * c[2][0] - c[0][0] * c[2][1];
  const double k22 = c[0][0] * c[1][1] - c[0][1] * c[1][0];
  const double det = c[0][0] * k00 + c[0][1] * k01 + c[0][2] * k02;
  const double i00 = k00 / det, i10 = k01 / det, i20 = k02 / det;
  const double i11 = k11 / det, i21 = k12 / det, i22 = k22 / det;
  // Lower Cholesky factor of the inverse.
  const double l00 = sqrt(i00);
  const double l10 = i10 / l00, l20 = i20 / l00;
  const double l11 = sqrt(i11 - l10 * l10);
  const double l21 = (i21 - l20 * l10) / l11;
  const double l22 = sqrt(i22 - l20 * l20 - l21 * l21);
  const double L[9] = {l00, 0.0, 0.0, l10, l11, 0.0, l20, l21, l22};
  for (int a = 0; a < 3; ++a) means[3 * (size_t)cell + a] = mu[a];
  for (int q = 0; q < 9; ++q) chol[9 * (size_t)cell + q] = (float)L[q];
  valid[cell] = count >= min_points;
}

struct NdtRows {
  static constexpr int kRows = 3;
  const float* source;
  const uint8_t* mask;
  int n;
  const float* means;
  const float* chol;  // (g^3, 3, 3) row-major lower factors
  const uint8_t* valid;
  const float* origin;
  float resolution;
  int g;

  __device__ void rows(const float x[7], int k, float r[3], float jac[3][6], bool with_jac) const {
    for (int a = 0; a < 3; ++a) {
      r[a] = 0.0f;
      if (with_jac)
        for (int b = 0; b < 6; ++b) jac[a][b] = 0.0f;
    }
    if (!mask[k]) return;
    const float p[3] = {source[3 * k], source[3 * k + 1], source[3 * k + 2]};
    float w[3];
    se3lm::transform(x, p, w);
    const int cell = cell_of(w, origin, resolution, g);
    if (cell < 0 || !valid[cell]) return;
    const float* mu = means + 3 * (size_t)cell;
    const float* L = chol + 9 * (size_t)cell;
    const float d[3] = {w[0] - mu[0], w[1] - mu[1], w[2] - mu[2]};
    for (int a = 0; a < 3; ++a) {
      r[a] = (L[a] * d[0] + L[3 + a] * d[1]) + L[6 + a] * d[2];
      if (with_jac) {
        const float col[3] = {L[a], L[3 + a], L[6 + a]};
        se3lm::tangent_gradient(x, p, col, jac[a]);
      }
    }
  }
};

__global__ void __launch_bounds__(se3lm::kThreads)
    ndt_lm_kernel(NdtRows rows, const float* x0, int num_iterations, float function_tolerance,
                  float* x_out, float* cost_out, int* iterations_out) {
  se3lm::solve(rows, x0, num_iterations, function_tolerance, x_out, cost_out, iterations_out);
}

}  // namespace

// K28: means (g^3, 3), chol (g^3, 3, 3) and valid (g^3,) uint8 of the
// target (n, 3) with mask (n,) uint8; `keys` is a scratch of at least
// max(2, the power of two >= n) 64-bit words.
extern "C" int ndt_grid(const void* target, const void* mask, int n, const void* origin,
                        float resolution, int g, float regularization, float min_points,
                        void* keys, void* means, void* chol, void* valid, void* stream) {
  if (n < 1 || g < 1 || (long long)g * g * g >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int padded = 2;
  while (padded < n) padded <<= 1;
  unsigned long long* k = (unsigned long long*)keys;
  keys_kernel<<<(padded + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      (const float*)target, (const uint8_t*)mask, n, padded, (const float*)origin, resolution, g,
      k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = bitonic::sort(k, padded, s);
  if (err != cudaSuccess) return (int)err;
  const int cells = g * g * g;
  cells_kernel<<<(cells + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      (const float*)target, k, padded, cells, regularization, min_points, (float*)means,
      (float*)chol, (uint8_t*)valid);
  return (int)cudaGetLastError();
}

// K29: the NDT solve of the source (n, 3) with mask (n,) uint8 on K28's
// grid from x0 [t, q] (7,) to x_out; cost_out and iterations_out nullable.
extern "C" int ndt_lm(const void* source, const void* mask, int n, const void* means,
                      const void* chol, const void* valid, const void* origin, float resolution,
                      int g, const void* x0, int num_iterations, float function_tolerance,
                      void* x_out, void* cost_out, void* iterations_out, void* stream) {
  if (n < 1 || g < 1) return (int)cudaErrorInvalidValue;
  NdtRows rows{(const float*)source, (const uint8_t*)mask, n, (const float*)means,
               (const float*)chol, (const uint8_t*)valid, (const float*)origin, resolution, g};
  ndt_lm_kernel<<<1, se3lm::kThreads, 0, (cudaStream_t)stream>>>(
      rows, (const float*)x0, num_iterations, function_tolerance, (float*)x_out,
      (float*)cost_out, (int*)iterations_out);
  return (int)cudaGetLastError();
}
