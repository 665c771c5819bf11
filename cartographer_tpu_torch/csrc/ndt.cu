// K28 ndt_grid and K29 ndt_lm
//
// K28 replaces: cartographer_tpu/ops/icp.py:build_ndt_grid (l.179). K29
// replaces ndt_match's residual_fn and lm_solve (l.219-230;
// ops/gauss_newton.py:22, se3_retract in ops/scan_matcher_3d.py:45).
//
// K28: the per-voxel Gaussians of a g^3 grid. A point's cell is
// floor((p - origin) / resolution) per axis (a true division, as the port
// divides everywhere); a masked-out or out-of-bounds point adds nothing.
// in_order_scatter.cuh adds each cell's points, in input order from zero,
// into the count, the sum of p and the six distinct sums of p p^T in
// float32 (the order of XLA's scatter-add on the CPU and of the plain
// twin, so the sums keep their bits: sq / n - mu mu^T cancels about 4 of
// float32's 7 digits at the hall's 2-13 m, and float atomics would move L
// between runs); an item is the point's index, through which the walk
// reads the point again. The thread that ends a cell's run then writes the
// cell once: mean = sum / max(count, 1), cov = sq / n - mu mu^T + reg I and
// valid = count >= min_points in float32, as JAX; inv(cov) by its adjugate
// and the lower Cholesky factor of that inverse in double precision,
// rounded to float32. A pass over every cell first writes the cells no
// point reaches (those of a zero count), so a call is two launches up to
// in_order_scatter's kChunk = 131,072 points. Above, each chunk's launch
// continues the cells' running sums in a zeroed scratch of 10 floats a
// cell, and one pass over the cells then writes every cell from its sums:
// ceil(n / kChunk) + 1 launches and a memset. The bitonic sort of
// (cell, index) keys that this replaces took about ten launches a call.
// Bound: bytes, the points read once (12 + 1 bytes each) and the grid
// written once (13 floats and a flag a cell); the radix passes' cluster
// barriers and the longest cell's serial sum make it latency-bound.
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

#include "in_order_scatter.cuh"
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

// The sums of a cell's points: the count, sum p and the six distinct
// entries of sum p p^T (xx, xy, xz, yy, yz, zz).
struct NdtAcc {
  float count, s[3], sq[6];
};

// The slot of entry (a, b) of p p^T among the six.
__device__ inline int pair(int a, int b) {
  const int lo = min(a, b), hi = max(a, b);
  return lo == 0 ? hi : lo == 1 ? hi + 2 : 5;
}

// Cell `cell`'s mean, factor and flag from its sums.
__device__ void write_cell(const NdtAcc& acc, unsigned int cell, float regularization,
                           float min_points, float* means, float* chol, uint8_t* valid) {
  const float n = fmaxf(acc.count, 1.0f);
  float mu[3];
  for (int a = 0; a < 3; ++a) mu[a] = acc.s[a] / n;
  double c[3][3];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      float v = acc.sq[pair(a, b)] / n - mu[a] * mu[b];
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
  valid[cell] = acc.count >= min_points;
}

// K28's items for in_order_scatter: one per target point, its index the
// payload; a cell's run is written once, from zero sums.
struct NdtPoints {
  const float* target;
  const uint8_t* mask;
  const float* center;
  float half;  // the origin is center - half, as the twin rounds it
  float* origin;  // (3,) out
  float resolution;
  int g;
  float regularization;
  float min_points;
  float* means;
  float* chol;
  uint8_t* valid;

  using Acc = NdtAcc;
  struct Item {
    float p[3];
  };
  static constexpr int kAhead = 8;  // a run's points fetched together (in_order_scatter's walk)
  __device__ unsigned int cell(int i, unsigned int& payload) const {
    payload = (unsigned int)i;
    if (!mask[i]) return in_order_scatter::kNone;
    const float p[3] = {target[3 * i], target[3 * i + 1], target[3 * i + 2]};
    const float o[3] = {center[0] - half, center[1] - half, center[2] - half};
    const int c = cell_of(p, o, resolution, g);
    return c < 0 ? in_order_scatter::kNone : (unsigned int)c;
  }
  __device__ Acc load(unsigned int) const { return {}; }
  __device__ Item fetch(unsigned int i) const {  // any index below n, or 0
    return {{target[3 * (size_t)i], target[3 * (size_t)i + 1], target[3 * (size_t)i + 2]}};
  }
  __device__ void add(Acc& acc, const Item& item) const {
    const float* p = item.p;
    acc.count = acc.count + 1.0f;
    for (int a = 0; a < 3; ++a) {
      acc.s[a] = acc.s[a] + p[a];
      for (int b = a; b < 3; ++b) acc.sq[pair(a, b)] = acc.sq[pair(a, b)] + p[a] * p[b];
    }
  }
  __device__ void store(unsigned int c, const Acc& acc) const {
    write_cell(acc, c, regularization, min_points, means, chol, valid);
  }
};

// The items of a call above one launch: each launch continues the cells'
// running sums in `sums` (g^3, 10), and sums_kernel writes the cells after
// the last.
struct NdtSums : NdtPoints {
  NdtAcc* sums;

  __device__ Acc load(unsigned int c) const { return sums[c]; }
  __device__ void store(unsigned int c, const Acc& acc) const { sums[c] = acc; }
};

// Every cell from zero sums (the cells no point reaches) or, with `sums`,
// from its running sums; and the grid's origin.
__global__ void cells_kernel(NdtPoints p, const NdtAcc* sums, int cells) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell < 3) p.origin[cell] = p.center[cell] - p.half;
  if (cell >= cells) return;
  p.store((unsigned int)cell, sums ? sums[cell] : NdtAcc{});
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

// K28: origin (3,) = center - half, means (g^3, 3), chol (g^3, 3, 3) and
// valid (g^3,) uint8 of the target (n, 3) with mask (n,) uint8; `passes`
// radix passes of 8 bits cover the cell indices. Above
// in_order_scatter::kChunk points `sums` is a scratch of g^3 x 10 floats
// (zeroed here), else it may be null.
extern "C" int ndt_grid(const void* target, const void* mask, int n, const void* center,
                        float half, float resolution, int g, float regularization,
                        float min_points, int passes, void* sums, void* origin, void* means,
                        void* chol, void* valid, void* stream) {
  const long long cells = (long long)g * g * g;
  const bool chunked = n > in_order_scatter::kChunk;
  if (n < 1 || g < 1 || cells >= (1ll << 31) || passes < 1 || passes > 4 ||
      (passes < 4 && cells > (1ll << (8 * passes))) || (chunked && sums == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  NdtPoints p{(const float*)target, (const uint8_t*)mask, (const float*)center, half,
              (float*)origin, resolution, g, regularization, min_points, (float*)means,
              (float*)chol, (uint8_t*)valid};
  const int blocks = (int)((cells + kThreads - 1) / kThreads);
  if (!chunked) {
    cells_kernel<<<blocks, kThreads, 0, s>>>(p, nullptr, (int)cells);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)in_order_scatter::launch(p, n, passes, s);
  }
  NdtSums partial;
  (NdtPoints&)partial = p;
  partial.sums = (NdtAcc*)sums;
  cudaError_t err = cudaMemsetAsync(sums, 0, cells * sizeof(NdtAcc), s);
  if (err == cudaSuccess) err = in_order_scatter::launch(partial, n, passes, s);
  if (err != cudaSuccess) return (int)err;
  cells_kernel<<<blocks, kThreads, 0, s>>>(p, partial.sums, (int)cells);
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
